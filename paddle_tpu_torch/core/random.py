"""Random state of the eager surface (counterpart of ``paddle_tpu/core/random.py``).

One ``torch.Generator`` per device, owned by the port and made on first
use from the global seed; ``seed(s)`` reseeds every one of them (and
numpy's global state, as the JAX package does). The creation ops,
``dropout`` and the initializers draw from the generator of the device
they write to. The JAX package splits threefry keys, whose streams torch
cannot reproduce: the two packages agree on distributions, not on bits.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

_seed = 0
_generators: Dict[torch.device, torch.Generator] = {}
_numpy_generator = None


def generator(device) -> torch.Generator:
    """The port's generator of ``device`` (made from the seed once)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen = _generators.get(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(_seed)
        _generators[device] = gen
    return gen


def draw_generator(device):
    """The generator an op on ``device`` draws from: the port's
    (``generator``), or None (torch's default one) while ``jit.to_static``
    traces the op. A traced graph cannot take a generator object: the
    compiled graph draws from its backend's generator (Inductor's, seeded
    from torch's default one), so compiled dropout draws other bits than
    eager dropout, from the same distribution."""
    return None if torch.compiler.is_compiling() else generator(device)


def numpy_generator() -> np.random.Generator:
    """The port's numpy generator for host-side draws (the graph
    samplers), made from the seed once and remade by ``seed``."""
    global _numpy_generator
    if _numpy_generator is None:
        _numpy_generator = np.random.default_rng(_seed)
    return _numpy_generator


def seed(s: int = None):
    """paddle.seed: reseed every device's generator and the host numpy
    generator (a new time-based seed when ``s`` is None)."""
    global _seed, _numpy_generator
    _seed = int(s) if s is not None else time.time_ns() & 0xFFFFFFFF
    _numpy_generator = None
    np.random.seed(_seed & 0xFFFFFFFF)
    for gen in _generators.values():
        gen.manual_seed(_seed)
    return _seed


def get_rng_state():
    """[(device, generator state)] of every generator made so far."""
    return [(str(d), g.get_state()) for d, g in _generators.items()]


def set_rng_state(state):
    for dev, st in state:
        generator(dev).set_state(st)
