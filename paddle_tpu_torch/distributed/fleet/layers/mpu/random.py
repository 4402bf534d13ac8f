"""Tensor-parallel random state (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/random.py``; reference
random.py ``RNGStatesTracker``).

The tracker keeps named seeds and one ``torch.Generator`` a name and
device. Inside ``rng_state(name)`` the port's generator of a device
(``core.random.generator``, which dropout and the initializers draw
from) is that name's. ``model_parallel_random_seed(seed)`` seeds the
port's generators with ``seed`` on every rank (the global state: equal
draws outside the tracker) and the tracker's ``model_parallel_rng`` with
a seed of its own for each mp rank (the local state: different dropout
masks inside it). The draws are torch's, not JAX's threefry: the tests
hold the two properties, not the values."""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from .....core import random as random_mod

MODEL_PARALLEL_RNG = "model_parallel_rng"
#: the local seed's distance between mp ranks
_LOCAL_STRIDE = 1024


class RNGStatesTracker:
    def __init__(self):
        self.reset()

    def reset(self):
        self.seeds_: Dict[str, int] = {}
        self.states_: Dict[tuple, torch.Generator] = {}

    def add(self, name: str, seed: int):
        if seed in self.seeds_.values():
            raise ValueError(f"seed {seed} already exists")
        if name in self.seeds_:
            raise ValueError(f"state {name} already exists")
        self.seeds_[name] = int(seed)

    def _generator(self, name, device):
        key = (name, torch.device(device))
        gen = self.states_.get(key)
        if gen is None:
            gen = torch.Generator(device=key[1]).manual_seed(self.seeds_[name])
            self.states_[key] = gen
        return gen

    def get_states_tracker(self):
        return {f"{n}@{d}": g.get_state()
                for (n, d), g in self.states_.items()}

    def set_states_tracker(self, states):
        for key, st in states.items():
            name, dev = key.rsplit("@", 1)
            self._generator(name, dev).set_state(st)

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG, device=None):
        """Draws on ``device`` (the current rank's by default) come from
        the named state inside the block."""
        if name not in self.seeds_:
            raise ValueError(f"state {name} does not exist: "
                             "model_parallel_random_seed() adds it")
        from .... import env
        dev = torch.device(device if device is not None else env.device())
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        saved = random_mod._generators.get(dev)
        random_mod._generators[dev] = self._generator(name, dev)
        try:
            yield
        finally:
            if saved is None:
                random_mod._generators.pop(dev, None)
            else:
                random_mod._generators[dev] = saved


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER


def _mp_rank():
    from .... import mesh as mesh_mod
    if mesh_mod.get_mesh() is None:
        return 0
    return mesh_mod.get_hybrid_communicate_group().get_model_parallel_rank()


def model_parallel_random_seed(seed: int = 2021):
    """The global seed ``seed`` on every rank, the local one
    ``seed + 1 + 1024 * mp_rank`` under ``model_parallel_rng``."""
    tracker = get_rng_state_tracker()
    tracker.reset()
    random_mod.seed(int(seed))
    tracker.add(MODEL_PARALLEL_RNG, int(seed) + 1 + _LOCAL_STRIDE * _mp_rank())


def determinate_seed(rng_name: str):
    """The seed of the named state."""
    return get_rng_state_tracker().seeds_.get(rng_name, 0)


def dropout(x, p=0.5, axis=None, rng_name=MODEL_PARALLEL_RNG,
            training=True, mode="upscale_in_train", name=None):
    """Dropout whose mask comes from the named state (different on each
    mp rank under ``model_parallel_rng``); ``rng_name=None`` draws from
    the global state."""
    from .....nn import functional as F
    dev = getattr(x, "_data", x).device
    if rng_name is None:
        return F.dropout(x, p=p, axis=axis, training=training, mode=mode,
                         generator=random_mod.generator(dev))
    with get_rng_state_tracker().rng_state(rng_name, dev):
        return F.dropout(x, p=p, axis=axis, training=training, mode=mode,
                         generator=random_mod.generator(dev))
