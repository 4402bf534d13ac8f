"""Multi-tick greedy decode: k decode ticks per host round trip.

Counterpart of the JAX engine's ``_get_multi_fn`` / ``_multi_body``
(``paddle_tpu/inference/engine.py:895-956``), where k greedy ticks run as
one ``lax.scan`` executable per dispatch. In eager PyTorch the
counterpart of "one executable a dispatch" is a CUDA graph replayed a
dispatch:

* the k-tick body reads and advances STATIC device buffers — the last
  tokens, positions, live flags, eos ids, remaining budgets and the
  engine's block table — and writes the [S, k] tokens and finite-logit
  flags into static outputs. The engine ``copy_``s into the buffers and
  never rebinds them (a captured graph keeps reading the addresses it
  was captured with);
* on ``cuda`` the body is captured once per k bucket as a
  ``torch.cuda.CUDAGraph`` (after a warm-up tick on the capture's side
  stream, every lane frozen), all buckets sharing one graph memory pool;
  each dispatch replays one graph. A capture that fails raises, naming
  what broke it — there is no eager path on ``cuda``. The warm-up and
  the capture run under ``torch.cuda.set_sync_debug_mode("error")``, so
  a host sync left in the body is an error, not a stall. Python's
  cyclic collector is off during the capture (``gc_paused``): a dropped
  Engine is a reference cycle, and a collection inside the capture would
  free its graphs and memory with CUDA calls that invalidate the
  capture;
* on ``cpu`` the same body runs as a Python loop.

Tick j of the body: a row still ALIVE (live, budget > 0) feeds its
newest token at its position; a frozen row rides at cache index -1 (a
dead slot for the decode kernel, its write in scratch page 0); an eos
or a spent budget zeroes the row's budget in the loop. Argmax only: no
generator is touched, so the tokens are those of k single greedy ticks.

Kernel launch counts: the wrappers count in Python, which a replay does
not run. The change of every ``monitor`` counter and every wrapper's
``launches*`` attribute during a capture is recorded with its graph and
credited again at each replay, so ``paged_decode.launches`` still reads
one a layer a device tick. Each capture (its warm-up tick included) is
one ``profiler.stats.compile_event("graph_capture", seconds)``.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from .. import monitor
from ..profiler.stats import compile_event
from ..text.generation import _model_forward


def _launch_attrs():
    """(function, attribute) of every kernel wrapper's launch count."""
    from ..kernels import _build, flash_attention, moe, paged_attention
    out = []
    for mod in (_build, flash_attention, moe, paged_attention):
        for fn in vars(mod).values():
            if callable(fn):
                out.extend((fn, a) for a in getattr(fn, "__dict__", ())
                           if a.startswith("launches"))
    return out


def _launch_counts() -> Dict[object, int]:
    counts: Dict[object, int] = dict(monitor.counters())
    for fn, attr in _launch_attrs():
        counts[(fn, attr)] = getattr(fn, attr)
    return counts


@dataclass
class _Graph:
    graph: object                 # torch.cuda.CUDAGraph
    credit: Dict[object, int]     # counter changes one replay stands for


class MultiTick:
    """The k-tick greedy decode of one ``Engine`` over static buffers.

    ``load`` uploads the host mirrors; ``run(k)`` runs k ticks (a graph
    replay on ``cuda``) and returns the [S, k] tokens and ok flags,
    leaving the advanced state in the buffers for the next dispatch."""

    def __init__(self, engine):
        self._eng = engine
        S, dev = engine.max_slots, engine.device
        self.last = torch.zeros((S,), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((S,), dtype=torch.int64, device=dev)
        self.live = torch.zeros((S,), dtype=torch.int64, device=dev)
        self.eos = torch.full((S,), -1, dtype=torch.int64, device=dev)
        self.bud = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._outs: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._graphs: Dict[int, _Graph] = {}
        self._pool = None
        self._stream = None

    @property
    def captured(self):
        """The k buckets captured so far (``cuda`` only)."""
        return sorted(self._graphs)

    def load(self, last, pos, live, eos, bud) -> None:
        """Copy the host mirrors ([S] int arrays) into the buffers."""
        for dst, src in ((self.last, last), (self.pos, pos),
                         (self.live, live), (self.eos, eos),
                         (self.bud, bud)):
            dst.copy_(torch.from_numpy(np.asarray(src, np.int64)))

    def _outputs(self, k: int):
        out = self._outs.get(k)
        if out is None:
            S, dev = self._eng.max_slots, self._eng.device
            out = (torch.zeros((S, k), dtype=torch.int64, device=dev),
                   torch.zeros((S, k), dtype=torch.bool, device=dev))
            self._outs[k] = out
        return out

    def ticks(self, k: int, toks=None, oks=None):
        """The k-tick body, run eagerly: advances the buffers in place
        and writes tick j's argmax and ok flag into column j of ``toks``
        / ``oks`` (the k bucket's static outputs by default)."""
        if toks is None:
            toks, oks = self._outputs(k)
        eng = self._eng
        caches = eng._inject_bt(eng._bt_dev)
        tok, p, b = self.last, self.pos, self.bud
        for j in range(k):
            alive = (self.live > 0) & (b > 0)
            idx = torch.where(alive, p, torch.full_like(p, -1))
            logits = _model_forward(eng.model, tok[:, None], caches, idx)
            cur = logits[:, -1].float()
            oks[:, j] = torch.isfinite(cur).all(dim=-1)
            sampled = torch.argmax(cur, dim=-1)
            toks[:, j] = sampled
            b = torch.where(alive, torch.where(sampled == self.eos,
                                               torch.zeros_like(b), b - 1),
                            b)
            tok = torch.where(alive, sampled, tok)
            p = p + alive.to(p.dtype)
        self.last.copy_(tok)
        self.pos.copy_(p)
        self.bud.copy_(b)
        return toks, oks

    def run(self, k: int):
        """k ticks from the buffers: the captured graph of bucket k on
        ``cuda`` (captured at its first use), the eager body on ``cpu``.
        Returns the bucket's (tokens [S, k], ok [S, k]) outputs."""
        if self._eng.device.type != "cuda":
            return self.ticks(k)
        g = self._graphs.get(k)
        if g is None:
            g = self._graphs[k] = self._capture(k)
        g.graph.replay()
        for key, d in g.credit.items():
            if isinstance(key, str):
                monitor.counter(key).increase(d)
            else:
                setattr(key[0], key[1], getattr(key[0], key[1]) + d)
        return self._outs[k]

    def _capture(self, k: int) -> _Graph:
        """Warm the body up on the side stream (one tick, every lane
        frozen: nothing advances and every write lands in the scratch
        page), then capture the k-tick body into the shared pool."""
        eng = self._eng
        t0 = time.perf_counter()
        toks, oks = self._outputs(k)
        if self._stream is None:
            self._stream = torch.cuda.Stream(eng.device)
        stage = "warm-up"
        try:
            self._stream.wait_stream(torch.cuda.current_stream(eng.device))
            with torch.cuda.stream(self._stream), _no_host_sync():
                saved = self.bud.clone()
                self.bud.zero_()
                try:
                    self.ticks(1, torch.empty_like(toks[:, :1]),
                               torch.empty_like(oks[:, :1]))
                finally:
                    self.bud.copy_(saved)
            torch.cuda.current_stream(eng.device).wait_stream(self._stream)
            eng._ticks += 1
            monitor.counter("serving.multi_tick.warmup_ticks").increase()
            stage = "capture"
            graph = torch.cuda.CUDAGraph()
            before = _launch_counts()
            with gc_paused(), torch.cuda.graph(graph, pool=self._pool,
                                               stream=self._stream):
                with _no_host_sync():
                    self.ticks(k, toks, oks)
            after = _launch_counts()
        except RuntimeError as e:
            raise RuntimeError(
                f"multi-tick decode: the {stage} of the k={k} tick graph "
                f"of {type(eng.model).__name__} failed: {e}") from e
        if self._pool is None:
            self._pool = graph.pool()
        credit = {key: v - before.get(key, 0) for key, v in after.items()
                  if v != before.get(key, 0)}
        # the capture bumped each counter once as it traced: undo that,
        # so only replays count launches
        for key, d in credit.items():
            if isinstance(key, str):
                monitor.counter(key).increase(-d)
            else:
                setattr(key[0], key[1], getattr(key[0], key[1]) - d)
        compile_event("graph_capture", time.perf_counter() - t0)
        return _Graph(graph=graph, credit=credit)


class gc_paused:
    """Python's cyclic garbage collector off for the block (back on after
    it, if it was on). Wrap a CUDA graph capture in it: a collection
    there can reach a dead cycle that holds CUDA graphs or memory (a
    dropped Engine), and freeing them while a stream captures fails the
    capture with ``cudaErrorStreamCaptureInvalidated``. Dead cycles are
    collected after the block as usual."""

    def __enter__(self):
        self._was_enabled = gc.isenabled()
        gc.disable()

    def __exit__(self, *exc):
        if self._was_enabled:
            gc.enable()
        return False


class _no_host_sync:
    """``torch.cuda.set_sync_debug_mode("error")`` for the block: a
    host sync inside raises."""

    def __enter__(self):
        self._prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self._prev)
        return False
