"""Disaggregated prefill / decode serving: many engines, one driver.

Counterpart of ``paddle_tpu/inference/disagg.py``. The single-loop
Engine (engine.py) runs prefill and decode on one set of pools; this
module splits the loop into whole workers under a host DRIVER
(:class:`DisaggEngine`):

* **Prefill workers** (:class:`PrefillWorker`): Engines that only run
  prefills. Each owns its page pool, allocator and prefix cache (and
  the draft's pools under speculation). A finished prefill does not
  enter the worker's decode plane: the request parks as ``MIGRATING``,
  its pages held until the driver moves it.
* **Decode workers** (:class:`DecodeWorker`): Engines whose requests
  arrive prefilled (:meth:`DecodeWorker.admit_migrated`: pages
  allocated, the migrated KV scattered in, the slot activated) and that
  run the decode ticks, the multi-tick CUDA graphs included.
* **KV-page migration**: one fixed-shape gather of the request's pool
  rows (``index_select`` into a ``[max_blocks, hkv, page, hd]`` block a
  pool, pad rows reading the scratch page), :func:`migration_collective`
  (the identity on the block in one process), and one fixed-shape
  scatter (``index_copy_`` into the decode worker's EXISTING pool
  tensors, pad rows landing in its scratch page). The pools are written
  in place because the decode worker's captured graphs read them by
  address.

The driver's contract is the JAX driver's:

* **Token exactness.** A request served disaggregated emits exactly the
  single-loop Engine's tokens, greedy and seeded sampling, through
  prefix hits, speculative decoding, preemption / resume and worker
  deaths: the migrated pages are bit copies, a request's generator
  moves with it, and a lost generator is replayed from (seed, tokens
  emitted) alone (:func:`replay_rng_key`).
* **Multi-tenant fairness.** ``add_request(..., tenant=)`` queues per
  tenant; dispatch round-robins one request a tenant a turn, and
  re-admissions (preempted or failed-over requests) go first.
* **Worker-death chaos.** ``kill_worker(kind, i)`` (or the seeded
  ``worker.die_prefill`` / ``worker.die_decode`` fault sites) drops a
  worker wholesale, its pools released; every request that lived there
  re-admits from the host truth (prompt, tokens so far, the replayed
  generator) and finishes token-exact.
* **Streaming front door.** ``add_request`` returns at once;
  ``stream(rid)`` / ``astream(rid)`` yield tokens as steps produce them.

Every worker serves on the driver's device (``device=None`` is
``cuda``, raising without a GPU; ``device="cpu"`` runs the kernels'
plain versions). The prefill workers attend through the Engine's paged
gather (plain PyTorch, as the JAX engine's XLA gather path is); on the
card the decode workers' attention is the split paged-decode kernel.

Not carried yet, raising with the ROADMAP item that brings them:
``lint_migration``, ``inspect_hotpath`` and ``steady_state_recompiles``
(the analysis slice, item 6), and ``migration_collective`` over a
process group or ``from_plan`` with ``decode_mp > 1`` (the Engine on mp
ranks, item 3, D5b).

Observability: counters ``serving.migrated_pages`` /
``serving.disagg.migrations`` / ``serving.disagg.worker_kills`` /
``serving.disagg.readmitted`` / ``serving.disagg.migration_preempts``,
gauges ``serving.disagg.queue_depth`` / ``serving.disagg.migrating`` and
per worker ``serving.disagg.<kind><i>.slots_active`` /
``serving.disagg.<kind><i>.pages_free``.
"""
from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import asdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import monitor
from ..core.device import resolve_device
from ..text.generation import gumbel_noise
from . import tracing
from .engine import (FAILED, FINISHED, PREEMPTED, WAITING, Engine, Output,
                     Request, SamplingParams, _ceil_div, _normalize_prompt)
from .reliability import _dtype_name

#: lifecycle state between a finished prefill and decode admission: the
#: request holds its prefill-worker pages (the migration source) but no
#: slot on either side
MIGRATING = "MIGRATING"

#: the worker mesh axis the migration collective redistributes over
WORKER_AXIS = "worker"

DISAGG_SNAPSHOT_VERSION = 1

_ITEM3 = ("the Engine on mp ranks (ROADMAP section 1, item 3, D5b)")
_ITEM6 = ("the analysis slice of the port (ROADMAP section 1, item 6)")


def replay_rng_key(seed: int, n_generated: int, temperature: float, *,
                   vocab_size: int, device=None) -> torch.Tensor:
    """The generator state a request holds after ``n_generated`` emitted
    tokens, recomputed from the host truth alone: a ``torch.Generator``
    on ``device`` seeded with ``seed`` and advanced by one
    ``gumbel_noise`` draw of ``[vocab_size]`` per token when
    ``temperature > 0`` (none when greedy).

    Every sampler of the Engine (the prefill's first token, a decode
    tick, a speculative tick after its reset to the accepted draws) makes
    exactly that draw per emitted token from the request's own generator,
    so a dead worker's generator is a pure function of (seed, tokens
    emitted) and failover never reads it. Returns ``get_state()``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    if float(temperature) > 0.0:
        for _ in range(int(n_generated)):
            gumbel_noise(int(vocab_size), gen, dev)
    return gen.get_state()


def _replayed_generator(req: Request, vocab_size: int, device
                        ) -> torch.Generator:
    """A fresh generator holding ``replay_rng_key``'s state for ``req``."""
    gen = torch.Generator(device=device)
    gen.set_state(replay_rng_key(req.params.seed, len(req.generated),
                                 req.params.temperature,
                                 vocab_size=vocab_size, device=device))
    return gen


def migration_collective(block_tree, n_workers: int, src: int, dst: int,
                         group=None):
    """The migrated page block's redistribution over the worker axis. In
    one process (``group=None``) the JAX package's ``alltoall_single``
    over an unbound axis is the identity on the block, and so is this:
    the block comes back as it is (JAX builds the ``[n_workers *
    max_blocks, ...]`` contribution only for its lint recorder). Over a
    process group it is the Engine on ranks' collective, not ported
    yet."""
    if group is not None:
        raise NotImplementedError(
            f"migration_collective over a process group comes with {_ITEM3}")
    del n_workers, src, dst
    return block_tree


def lint_migration(n_workers: int, max_blocks: int, kv_heads: int,
                   page_size: int, head_dim: int, layers: int = 1,
                   quant: bool = False) -> List[str]:
    """Device-free lint of the migration collective: it records the
    redistribution under ``analysis.shard_lint``, which comes with
    ROADMAP item 6."""
    raise NotImplementedError(
        f"lint_migration runs analysis.shard_lint: it comes with {_ITEM6}")


class PrefillWorker(Engine):
    """An Engine that only prefills: a finished prefill parks the request
    as MIGRATING (its slot freed for the next prompt, its pages held as
    the migration source) instead of entering the local decode plane, so
    no slot state (block table, positions, live flags) is written."""

    def __init__(self, *args, **kwargs):
        self.ready: List[Request] = []
        super().__init__(*args, **kwargs)

    def _activate(self, req: Request) -> None:
        i = req.slot
        if i is not None:
            self._slots[i] = None
            req.slot = None
        req.state = MIGRATING
        self._open_span(req, tracing.MIGRATING, kind="pages")
        self.ready.append(req)


class DecodeWorker(Engine):
    """An Engine whose requests arrive prefilled: admission copies the
    migrated KV block into this worker's pools and puts the request
    straight into a decode slot. The driver sends every resume prefill
    back to the prefill workers."""

    def can_admit(self, n_pages: int) -> bool:
        """True when a migrated request needing ``n_pages`` would be
        admitted now (a free slot, and pages above the busy engine's
        watermark): the one admission predicate, shared by the driver's
        pre-check and ``admit_migrated``."""
        if not any(r is None for r in self._slots):
            return False
        busy = any(r is not None for r in self._slots)
        wm = self.watermark_pages if busy else 0
        return self._alloc.can_alloc(n_pages, wm)

    def admit_migrated(self, req: Request, block, n_pages: int) -> bool:
        """Take a MIGRATING request: allocate ``n_pages`` local pages,
        scatter the ``[max_blocks, ...]`` block into this worker's pools
        at those rows and activate the slot. False when no slot or no
        pages are free now (the request stays MIGRATING, its pages safe
        on the prefill side)."""
        if not self.can_admit(n_pages):
            return False
        slot = next(i for i, r in enumerate(self._slots) if r is None)
        pages = self._alloc.alloc(n_pages, seq=req.req_id)
        idx = np.zeros((self.max_blocks,), np.int64)
        idx[:n_pages] = pages
        self._scatter(block, self._up(idx))
        req.pages = pages
        req.shared_pages = None
        req.prefix_len = 0
        req.slot = slot
        self._slots[slot] = req
        self.requests[req.req_id] = req
        Engine._activate(self, req)
        # the step dispatches decode FIRST (its _ensure_pages pass runs
        # after the harvest), so a slot activated between steps gets its
        # first write position covered now: a migrated prompt that fills
        # its pages exactly would otherwise write token one into the
        # scratch page
        self._ensure_pages()
        return True

    def _scatter(self, block, idx: torch.Tensor) -> None:
        """Write a migrated block into the pools at rows ``idx`` in place
        (``index_copy_`` into the existing tensors: the captured
        multi-tick graphs read them by address); pad entries point at row
        0, the scratch page."""
        tgt, drf = block
        _scatter_pools(self._pools, tgt, idx)
        if self._spec is not None and drf is not None:
            _scatter_pools(self._spec._pools, drf, idx)


def _gather_pools(pools, idx: torch.Tensor):
    """Rows ``idx`` of every layer's pool tuple (k, v[, ks, vs]) as new
    ``[len(idx), ...]`` tensors."""
    return [tuple(p.index_select(0, idx) for p in layer) for layer in pools]


def _scatter_pools(pools, block, idx: torch.Tensor) -> None:
    for layer, blk in zip(pools, block):
        for p, b in zip(layer, blk):
            p.index_copy_(0, idx, b.to(p.dtype))


def release_device_memory() -> None:
    """Free a dropped engine's device memory now (call it once the last
    reference is gone): its multi-tick graphs are reference cycles that
    hold their memory pool until collected (never inside a capture), and
    the caching allocator keeps freed blocks until emptied."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class _ServingDriver:
    """The front door of a driver over many engines (:class:`DisaggEngine`
    and ``fleet.ServingFleet``): the fault-injector arming, per-tenant
    FIFO queues under one round robin, request ids and the driver's
    arrival order, ``stream`` / ``astream`` / ``run``, ``cancel`` and the
    deadline sweep of driver-held requests, and the retirement of
    Outputs. A driver adds its admission checks
    (``_check_admissible``), names the engine that holds a live request
    (``_cancel_live``) and the requests it holds itself besides the
    tenant queues (``_held``), and dispatches and steps its engines."""

    #: retired Outputs kept for late and streaming readers; past this many
    #: the OLDEST go (``step()``'s return value is the durable delivery)
    MAX_RETAINED_OUTPUTS = 4096

    def __init__(self, model, label: str, device, clock, fault_injector):
        self.model = model
        self.label = label
        self.device = resolve_device(device)
        self._clock = clock if clock is not None else time.perf_counter
        # the Engine's arming contract: an explicit FaultInjector, None =
        # armed from FLAGS_serving_fault_* (ONE injector shared by the
        # driver and every engine, so the chaos replays from one seed),
        # False = off
        if fault_injector is False:
            self._injector = None
        elif fault_injector is None:
            from .reliability import injector_from_flags
            self._injector = injector_from_flags()
        else:
            self._injector = fault_injector
        self._queues: Dict[str, deque] = {}
        self._rr: deque = deque()
        self.requests: Dict[int, Request] = {}
        self._tenant: Dict[int, str] = {}
        # the DRIVER's arrival order (req_id -> sequence): migration
        # priority, the parked victim and failover re-admission sort by
        # it. req.admit_seq is each engine's LOCAL counter.
        self._order: Dict[int, int] = {}
        self._next_id = 0
        self._steps = 0
        self._outputs: Dict[int, Output] = {}
        self._stream_cursor: Dict[int, int] = {}

    @property
    def _engine_injector(self):
        """The ``fault_injector`` argument of the driver's engines."""
        return self._injector if self._injector is not None else False

    # -- front door ----------------------------------------------------------

    def add_request(self, ids, sampling_params=None,
                    tenant: str = "default") -> int:
        """Queue a prompt under ``tenant``'s share of the dispatch and
        return its id at once: tokens stream out of ``stream(rid)`` /
        ``astream(rid)`` as later ``step()``s produce them, and the
        finished Output comes out of ``step()``."""
        params = sampling_params or SamplingParams()
        if isinstance(params, dict):
            params = SamplingParams(**params)
        params.validate()
        prompt = _normalize_prompt(ids)
        rid = self._next_id
        self._check_admissible(rid, prompt, params)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(params.seed))
        req = Request(req_id=rid, prompt=prompt, params=params,
                      generator=gen, arrival_t=self._clock(),
                      queued_step=self._steps)
        tracing.open_span(req.spans, tracing.QUEUED,
                          req.arrival_t * 1e3, self.label)
        self._next_id += 1
        self.requests[rid] = req
        self._tenant[rid] = str(tenant)
        self._order[rid] = len(self._order)
        self._enqueue(req, str(tenant))
        monitor.counter("serving.requests").increase()
        return rid

    def _check_admissible(self, rid: int, prompt: List[int],
                          params: SamplingParams) -> None:
        raise NotImplementedError

    def _enqueue(self, req: Request, tenant: str, front: bool = False):
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._rr.append(tenant)
        if front:
            q.appendleft(req)
        else:
            q.append(req)

    def cancel(self, req_id: int) -> Optional[Output]:
        """Abort a request wherever it is (queued or parked on the
        driver, or live on an engine, whose own cancel frees its pages):
        the partial Output returned."""
        req = self.requests.get(int(req_id))
        if req is None or req.state in (FINISHED, FAILED):
            return None
        out = self._cancel_live(req)
        if out is not None:
            self._retired(out)
            return out
        self._drop_from_queues(req)
        # the counter pair Engine.cancel emits (cancelled and FAILED)
        monitor.counter("serving.cancelled").increase()
        return self._fail_held(req, "cancelled", self._clock())

    def _cancel_live(self, req: Request) -> Optional[Output]:
        """The Output of the engine that holds ``req`` live and cancelled
        it; None when no engine does."""
        raise NotImplementedError

    def stream(self, req_id: int):
        """Yield ``req_id``'s tokens as steps produce them, driving
        ``step()`` while the request is unfinished."""
        rid = int(req_id)
        while True:
            tok, done = self._stream_poll(rid)
            yield from tok
            if done:
                return
            if not tok:
                self.step()

    async def astream(self, req_id: int):
        """The awaitable front door: yields tokens and control between
        steps, so many consumers interleave over one event loop; a
        consumer that finds its stream stalled drives the next
        ``step()``."""
        import asyncio
        rid = int(req_id)
        while True:
            tok, done = self._stream_poll(rid)
            for t in tok:
                yield t
                await asyncio.sleep(0)
            if done:
                return
            if not tok:
                self.step()
                await asyncio.sleep(0)

    def _stream_poll(self, rid: int) -> Tuple[List[int], bool]:
        cur = self._stream_cursor.get(rid, 0)
        out = self._outputs.get(rid)
        if out is not None:
            self._stream_cursor.pop(rid, None)
            return out.token_ids[cur:], True
        req = self.requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request id {rid}")
        toks = list(req.generated[cur:])
        self._stream_cursor[rid] = cur + len(toks)
        return toks, False

    def run(self, requests: Sequence, max_steps: int = 100_000
            ) -> List[Output]:
        """Offline driver: queue every (ids, SamplingParams) pair and step
        until all finish. Returns Outputs ordered by request id."""
        want = set()
        for item in requests:
            if isinstance(item, (tuple, list)) and len(item) == 2 and \
                    isinstance(item[1], (SamplingParams, dict)):
                want.add(self.add_request(item[0], item[1]))
            else:
                want.add(self.add_request(item))
        outs: List[Output] = []
        for _ in range(max_steps):
            outs.extend(o for o in self.step() if o.req_id in want)
            if len(outs) == len(want):
                break
        else:
            raise RuntimeError(
                f"{type(self).__name__} did not drain in {max_steps} steps "
                f"({len(outs)}/{len(want)} finished)")
        return sorted(outs, key=lambda o: o.req_id)

    # -- driver-held requests ------------------------------------------------

    def _held(self) -> List[Request]:
        """The requests the driver holds besides its tenant queues
        (re-admissions, parked migrations)."""
        raise NotImplementedError

    def _expire(self) -> List[Output]:
        """Deadline / queue-budget sweep over DRIVER-held requests
        (queued or parked; the engines sweep their live ones)."""
        outs: List[Output] = []
        now = self._clock()
        held = [r for q in self._queues.values() for r in q]
        held += self._held()
        for req in held:
            if req.state in (FINISHED, FAILED):
                continue
            p = req.params
            reason = None
            if p.deadline_ms is not None and \
                    (now - req.arrival_t) * 1e3 > float(p.deadline_ms):
                reason = "deadline"
            elif p.max_queue_steps is not None and \
                    req.state in (WAITING, PREEMPTED) and \
                    self._steps - req.queued_step \
                    > int(p.max_queue_steps):
                reason = "queue_timeout"
            if reason is None:
                continue
            monitor.counter("serving.timeouts").increase()
            self._drop_from_queues(req)
            outs.append(self._fail_held(req, reason, now))
        return outs

    def _drop_from_queues(self, req: Request) -> None:
        for q in self._queues.values():
            try:
                q.remove(req)
            except ValueError:
                pass

    @staticmethod
    def _drop_from_engine(w: Engine, req: Request) -> None:
        """Forget ``req`` on engine ``w`` if it waits there unstarted (no
        slot, no pages)."""
        if req.req_id in w.requests and req.slot is None \
                and not req.pages:
            w.requests.pop(req.req_id, None)
            try:
                w._waiting.remove(req)
            except ValueError:
                pass

    def _fail_held(self, req: Request, reason: str, now: float) -> Output:
        """Retire a driver-held request as FAILED with ``reason``."""
        req.state = FAILED
        req.finish_reason = reason
        req.finish_t = now
        monitor.counter("serving.failed").increase()
        out = driver_output(req, reason, True, self.label)
        self._retired(out)
        return out

    def _retired(self, out: Output) -> None:
        self._outputs[out.req_id] = out
        self.requests.pop(out.req_id, None)
        tenant = self._tenant.pop(out.req_id, None)
        self._order.pop(out.req_id, None)
        # a drained tenant's queue and round-robin turn go (a tenant's
        # next request makes them again)
        q = self._queues.get(tenant)
        if q is not None and not q:
            del self._queues[tenant]
            try:
                self._rr.remove(tenant)
            except ValueError:
                pass
        while len(self._outputs) > self.MAX_RETAINED_OUTPUTS:
            oldest = next(iter(self._outputs))
            self._outputs.pop(oldest)
            self._stream_cursor.pop(oldest, None)


class DisaggEngine(_ServingDriver):
    """Disaggregated serving driver: N prefill workers and M decode
    workers, KV pages migrating between them, one multi-tenant front
    door.

        eng = DisaggEngine(model, prefill_workers=2, decode_workers=2,
                           max_slots=4, page_size=8, pool_pages=64)
        rid = eng.add_request(ids, SamplingParams(max_new_tokens=32),
                              tenant="team-a")
        for tok in eng.stream(rid):
            ...
        outs = eng.run([(ids_a, pa), (ids_b, pb)])   # or offline

    The geometry (page_size / prefill_bucket / max_context / cache_dtype /
    spec_k) is every worker's: the migration block's shape depends on
    it. ``max_slots`` / ``pool_pages`` size each DECODE worker,
    ``prefill_slots`` / ``prefill_pool_pages`` each prefill worker (the
    decode side's by default). Only decode workers take ``multi_tick``.
    ``device``: the device every worker serves on (``cuda`` by default,
    raising without a GPU)."""

    def __init__(self, model, prefill_workers: int = 1,
                 decode_workers: int = 1, max_slots: int = 8,
                 page_size: int = 16,
                 pool_pages: Optional[int] = None,
                 prefill_slots: Optional[int] = None,
                 prefill_pool_pages: Optional[int] = None,
                 cache_dtype: str = "auto",
                 max_context: Optional[int] = None,
                 prefill_bucket: int = 32,
                 watermark_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 draft_model=None, spec_k: int = 4,
                 clock=None, fault_injector=None,
                 max_prefill_tokens_per_step: Optional[int] = None,
                 multi_tick: int = 1, device=None):
        if int(prefill_workers) < 1 or int(decode_workers) < 1:
            raise ValueError(
                f"need at least one worker of each kind, got "
                f"prefill_workers={prefill_workers} "
                f"decode_workers={decode_workers}")
        super().__init__(model, "disagg", device, clock, fault_injector)
        common = dict(page_size=page_size, cache_dtype=cache_dtype,
                      max_context=max_context,
                      prefill_bucket=prefill_bucket,
                      watermark_pages=watermark_pages,
                      draft_model=draft_model, spec_k=spec_k,
                      clock=self._clock, device=self.device,
                      fault_injector=self._engine_injector)
        self.prefill: List[Optional[PrefillWorker]] = [
            PrefillWorker(
                model, max_slots=(prefill_slots or max_slots),
                pool_pages=(prefill_pool_pages
                            if prefill_pool_pages is not None
                            else pool_pages),
                prefix_cache=prefix_cache,
                max_prefill_tokens_per_step=max_prefill_tokens_per_step,
                label=f"prefill{i}", **common)
            for i in range(int(prefill_workers))]
        self.decode: List[Optional[DecodeWorker]] = [
            DecodeWorker(model, max_slots=max_slots,
                         pool_pages=pool_pages, prefix_cache=False,
                         multi_tick=multi_tick,
                         label=f"decode{i}", **common)
            for i in range(int(decode_workers))]
        w0 = self.decode[0]
        self.page_size = w0.page_size
        self.max_blocks = w0.max_blocks
        self.max_context = w0.max_context
        self.prefill_bucket = w0.prefill_bucket
        self.cache_dtype = w0.cache_dtype
        self.vocab_size = w0.vocab_size
        self._lookahead = w0._lookahead
        for w in self.prefill:
            if w.max_blocks != self.max_blocks:
                raise RuntimeError(
                    "prefill/decode worker page geometry diverged "
                    f"({w.max_blocks} vs {self.max_blocks} blocks): "
                    "migration blocks must be shape-identical")
        # re-admissions (preemption sweep-backs, worker deaths) go to
        # _resume, served before the tenant queues: they carry partial
        # progress
        self._resume: deque = deque()
        self._ready: List[Tuple[PrefillWorker, Request]] = []
        self._admit_counter = 0
        # per-worker accounting (the replay tool's per-worker report)
        self.worker_stats: Dict[str, Dict[str, int]] = {}
        for kind, fleet in (("prefill", self.prefill),
                            ("decode", self.decode)):
            for i in range(len(fleet)):
                self.worker_stats[f"{kind}{i}"] = {
                    "busy_steps": 0, "steps": 0, "migrations": 0,
                    "pages_migrated": 0}

    @classmethod
    def from_plan(cls, model, plan, **overrides) -> "DisaggEngine":
        """A driver sized by a serving plan (any dict with
        ``prefill_workers`` / ``decode_workers``). A ``decode_mp`` above 1
        (tensor-parallel decode workers) needs the Engine on mp ranks."""
        if int(plan.get("decode_mp", 1) or 1) > 1:
            raise NotImplementedError(
                f"from_plan with decode_mp={plan['decode_mp']} shards the "
                f"decode workers over mp ranks: it comes with {_ITEM3}")
        kw = dict(prefill_workers=int(plan.get("prefill_workers", 1)),
                  decode_workers=int(plan.get("decode_workers", 1)))
        kw.update(overrides)
        eng = cls(model, **kw)
        eng.plan = dict(plan)
        return eng

    # -- front door ----------------------------------------------------------

    def _check_admissible(self, rid: int, prompt: List[int],
                          params: SamplingParams) -> None:
        need = len(prompt) + int(params.max_new_tokens)
        cap = self.max_blocks * self.page_size - (self._lookahead - 1)
        if self._pbucket(need) > cap:
            raise ValueError(
                f"request {rid} needs {need} token slots, beyond the "
                f"engine's max_context capacity {cap}")
        # decode-side lifetime demand: every written token plus the
        # per-tick write lookahead must fit ONE decode worker's pool
        worst = _ceil_div(need - 1 + self._lookahead, self.page_size)
        pool = min(w.pool_pages for w in self.decode if w is not None)
        if worst > pool:
            raise RuntimeError(
                f"request {rid} can never be scheduled: it needs up to "
                f"{worst} page(s) but the smallest decode worker pool "
                f"has {pool}")
        # prefill-side: the deepest resume prefix must fit too
        pworst = _ceil_div(max(len(prompt), need - 2), self.page_size)
        ppool = min(w.pool_pages for w in self.prefill if w is not None)
        if pworst > ppool:
            raise RuntimeError(
                f"request {rid} can never be prefilled: its prefix "
                f"needs up to {pworst} page(s) but the smallest "
                f"prefill worker pool has {ppool}")

    def _cancel_live(self, req: Request) -> Optional[Output]:
        # the worker's own cancel frees the pages (a MIGRATING request is
        # still in its prefill worker's table; its parked entry is purged
        # here)
        for fleet in (self.prefill, self.decode):
            for w in fleet:
                if w is not None and req.req_id in w.requests:
                    out = w.cancel(req.req_id)
                    if out is not None:
                        self._ready = [(pw, r) for pw, r in self._ready
                                       if r.req_id != req.req_id]
                        return out
        return None

    # -- driver loop ---------------------------------------------------------

    def step(self) -> List[Output]:
        """One driver step: chaos, the deadline sweep over driver-held
        requests, tenant-fair dispatch to prefill workers, prefill steps,
        page migration, decode steps, the preemption sweep-back. Returns
        every request that finished or failed in it."""
        outs: List[Output] = []
        self._maybe_chaos()
        outs.extend(self._expire())
        self._dispatch()
        for i, w in enumerate(self.prefill):
            if w is None:
                continue
            busy = (w.num_prefilling > 0 or w.num_waiting > 0
                    or any(r is not None for r in w._slots))
            for out in w.step():
                self._retired(out)
                outs.append(out)
            st = self.worker_stats[f"prefill{i}"]
            st["steps"] += 1
            st["busy_steps"] += int(busy)
            for req in w.ready:
                self._ready.append((w, req))
            w.ready.clear()
        self._migrate()
        for i, w in enumerate(self.decode):
            if w is None:
                continue
            busy = w.num_active > 0
            for out in w.step():
                self._retired(out)
                outs.append(out)
            st = self.worker_stats[f"decode{i}"]
            st["steps"] += 1
            st["busy_steps"] += int(busy)
            # preempted requests go back to the DRIVER: their resume
            # prefill belongs on the prefill workers
            while w._waiting:
                req = w._waiting.popleft()
                w.requests.pop(req.req_id, None)
                req.queued_step = self._steps
                self._resume.append(req)
                monitor.counter("serving.disagg.readmitted").increase()
        self._relieve_prefill_pressure()
        self._steps += 1
        self._publish_gauges()
        return outs

    # -- scheduling internals ------------------------------------------------

    def _pbucket(self, n: int) -> int:
        return _ceil_div(n, self.prefill_bucket) * self.prefill_bucket

    def _held(self) -> List[Request]:
        return list(self._resume) + [r for _, r in self._ready]

    def _next_candidate(self) -> Optional[Request]:
        if self._resume:
            return self._resume.popleft()
        for _ in range(len(self._rr)):
            tenant = self._rr[0]
            self._rr.rotate(-1)
            q = self._queues.get(tenant)
            if q:
                return q.popleft()
        return None

    def _dispatch(self) -> None:
        """Tenant-fair dispatch: hand queued requests to prefill workers
        with a free slot and an empty queue, one a tenant a turn
        (re-admissions first), to the least loaded worker."""
        while True:
            targets = [w for w in self.prefill
                       if w is not None
                       and any(r is None for r in w._slots)
                       and len(w._waiting) == 0]
            if not targets:
                return
            req = self._next_candidate()
            if req is None:
                return
            # most free slots, then most free pages (a parked backlog
            # shows up as held pages)
            w = max(targets,
                    key=lambda x: (sum(1 for r in x._slots if r is None),
                                   x._alloc.free_pages))
            req.queued_step = w._steps
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            w.requests[req.req_id] = req
            w._waiting.append(req)

    def _gather(self, w: Engine, pages: List[int]):
        """A request's pool rows on worker ``w`` (target and draft) as one
        fixed-shape ``[max_blocks, ...]`` block a pool; pad rows read the
        scratch page."""
        idx = np.zeros((self.max_blocks,), np.int64)
        idx[:len(pages)] = pages
        rows = w._up(idx)
        tgt = _gather_pools(w._pools, rows)
        drf = (_gather_pools(w._spec._pools, rows)
               if w._spec is not None else None)
        return (tgt, drf)

    def _migrate(self) -> None:
        """Move every migration-ready request whose KV fits a decode
        worker: gather its page block from the prefill pools, pass it
        through the migration collective, scatter it into the decode
        pools, free the prefill-side references (prefix-cache pages live
        on under the cache's) and activate the slot."""
        if not self._ready:
            return
        still: List[Tuple[PrefillWorker, Request]] = []
        # the worker axis is the topology: a killed worker keeps its
        # coordinate
        n_workers = len(self.prefill) + len(self.decode)
        for pw, req in sorted(
                self._ready,
                key=lambda e: self._order.get(e[1].req_id, 10**9)):
            if req.state != MIGRATING:
                continue     # cancelled or expired while parked
            # the DRIVER's global order before decode admission: the
            # decode worker's preempt-youngest choice compares admit_seq
            # over its slots, which came through different prefill
            # workers with local counters
            req.admit_seq = self._order.get(req.req_id, req.admit_seq)
            n_pages = len(req.pages)
            targets = [(i, w) for i, w in enumerate(self.decode)
                       if w is not None]
            targets.sort(key=lambda e: (
                -sum(1 for r in e[1]._slots if r is None),
                -e[1]._alloc.free_pages))
            admitted = False
            src_block = None
            for di, dw in targets:
                # the cheap pre-check: a back-pressured step pays no
                # gather for an admission that would refuse
                if not dw.can_admit(n_pages):
                    continue
                if src_block is None:
                    src_block = self._gather(pw, req.pages)
                src_i = self.prefill.index(pw)
                block = migration_collective(
                    src_block, n_workers, src=src_i,
                    dst=len(self.prefill) + di)
                src_pages = req.pages
                if dw.admit_migrated(req, block, n_pages):
                    pw._alloc.free(src_pages)
                    pw.requests.pop(req.req_id, None)
                    monitor.counter("serving.migrated_pages").increase(
                        n_pages)
                    monitor.counter("serving.disagg.migrations").increase()
                    self.worker_stats[f"prefill{src_i}"][
                        "pages_migrated"] += n_pages
                    self.worker_stats[f"decode{di}"]["migrations"] += 1
                    self.worker_stats[f"decode{di}"][
                        "pages_migrated"] += n_pages
                    admitted = True
                    break
            if not admitted:
                still.append((pw, req))
        self._ready = still

    def preempt_migrating(self, req_id: int) -> bool:
        """Mid-migration preemption: drop a MIGRATING request's
        prefill-side pages now and requeue it at the resume front. Its
        generator made no draw while parked, so its re-prefill continues
        the same tokens. The driver calls this under prefill pool
        pressure."""
        for i, (pw, req) in enumerate(list(self._ready)):
            if req.req_id == int(req_id):
                pw._alloc.free(req.pages)
                pw.requests.pop(req.req_id, None)
                req.pages = []
                req.shared_pages = None
                req.prefix_len = 0
                req.written = 0
                req.preemptions += 1
                req.state = PREEMPTED if req.generated else WAITING
                req.queued_step = self._steps
                # an aborted migration: its MIGRATING span closes
                # without a latency record
                tracing.open_span(req.spans, tracing.PREEMPTED,
                                  self._clock() * 1e3, self.label,
                                  kind="migration")
                del self._ready[i]
                self._resume.appendleft(req)
                monitor.counter("serving.preemptions").increase()
                monitor.counter(
                    "serving.disagg.migration_preempts").increase()
                return True
        return False

    def _relieve_prefill_pressure(self) -> None:
        """A prefill worker short of pages while parked requests hold
        them (the decode workers full) preempts its YOUNGEST parked
        request, which re-prefills once decode capacity returns: without
        this the pool can wedge."""
        for w in self.prefill:
            if w is None or not w._waiting:
                continue
            if w._alloc.free_pages * w.page_size >= w.prefill_bucket:
                continue
            parked = [r for pw, r in self._ready if pw is w]
            if parked:
                victim = max(parked, key=lambda r: self._order.get(
                    r.req_id, -1))
                self.preempt_migrating(victim.req_id)

    # -- chaos / worker death ------------------------------------------------

    def _maybe_chaos(self) -> None:
        if self._injector is None:
            return
        self._injector.on_step(self._steps)
        for kind, fleet in (("prefill", self.prefill),
                            ("decode", self.decode)):
            site = f"worker.die_{kind}"
            if not self._injector.fire(site, record=False):
                continue
            alive = [i for i, w in enumerate(fleet) if w is not None]
            if len(alive) <= 1:
                continue    # never the last worker of a kind
            self._injector.record(site)
            victim = alive[int(
                self._injector.rng.integers(0, len(alive)))]
            self.kill_worker(kind, victim)

    def kill_worker(self, kind: str, index: int) -> int:
        """Drop a worker wholesale (pools, allocator, slot state, with no
        goodbye; its device memory released) and re-admit every request
        that lived there from the host truth: the prompt, the tokens so
        far and a generator replayed from them (the dead worker's is
        never read). Returns the number re-admitted. The last worker of
        a kind cannot be killed."""
        if kind not in ("prefill", "decode"):
            raise ValueError(
                f"kill_worker kind must be 'prefill' or 'decode', "
                f"got {kind!r}")
        fleet = self.prefill if kind == "prefill" else self.decode
        index = int(index)
        if not 0 <= index < len(fleet):
            raise ValueError(
                f"kill_worker index {index} out of range for "
                f"{len(fleet)} {kind} worker(s)")
        w = fleet[index]
        if w is None:
            return 0
        if sum(1 for x in fleet if x is not None) <= 1:
            raise RuntimeError(
                f"cannot kill the last {kind} worker: the fleet must keep "
                f"serving")
        monitor.counter("serving.disagg.worker_kills").increase()
        # parked requests of this worker die with their pages
        doomed: Dict[int, Request] = {}
        still: List[Tuple[PrefillWorker, Request]] = []
        for pw, req in self._ready:
            if pw is w:
                doomed[req.req_id] = req
            else:
                still.append((pw, req))
        self._ready = still
        for r in w.requests.values():
            if r.state not in (FINISHED, FAILED):
                doomed.setdefault(r.req_id, r)
        n = 0
        now_ms = self._clock() * 1e3
        zero_progress: List[Request] = []
        for req in sorted(doomed.values(), key=lambda r: (
                self._order.get(r.req_id, 10**9), r.req_id)):
            req.slot = None
            req.pages = []
            req.shared_pages = None
            req.prefix_len = 0
            req.written = 0
            req.preemptions += 1
            req.generator = _replayed_generator(req, self.vocab_size,
                                                self.device)
            req.state = PREEMPTED if req.generated else WAITING
            tracing.open_span(
                req.spans,
                tracing.PREEMPTED if req.generated else tracing.QUEUED,
                now_ms, self.label, kind="failover")
            req.queued_step = self._steps
            if req.generated:
                self._resume.append(req)    # partial progress goes first
            else:
                # a dispatched, unstarted request holds nothing: it
                # rejoins its tenant's queue front, not the fast lane
                zero_progress.append(req)
            monitor.counter("serving.disagg.readmitted").increase()
            n += 1
        for req in reversed(zero_progress):
            self._enqueue(req, self._tenant.get(req.req_id, "default"),
                          front=True)
        w.close()
        fleet[index] = None
        del w
        release_device_memory()
        return n

    # -- reliability surfaces ------------------------------------------------

    def snapshot(self) -> dict:
        """Crash-exact host-state snapshot of the whole driver: every
        queued, prefilling, MIGRATING and decoding request's host truth.
        Generators are replayed from (seed, tokens emitted) on restore,
        never saved, so a live snapshot and a post-mortem one are the
        same. The format is the JAX driver's; ``torch_rng_device`` names
        the device type whose generator stream a sampled request
        continues."""
        reqs = []
        for fleet in (self.decode, self.prefill):
            for w in fleet:
                if w is None:
                    continue
                reqs.extend(r for r in w.requests.values()
                            if r.state not in (FINISHED, FAILED))
        reqs.extend(r for _, r in self._ready)
        reqs.extend(self._resume)
        for q in self._queues.values():
            reqs.extend(q)
        reqs.sort(key=lambda r: (self._order.get(r.req_id, 10**9),
                                 r.req_id))
        now = self._clock()
        entries, seen = [], set()
        for req in reqs:
            if req.req_id in seen:
                continue
            seen.add(req.req_id)
            entries.append({
                "req_id": int(req.req_id),
                "prompt": [int(t) for t in req.prompt],
                "generated": [int(t) for t in req.generated],
                "params": asdict(req.params),
                "tenant": self._tenant.get(req.req_id, "default"),
                "preemptions": int(req.preemptions),
                "elapsed_ms": (now - req.arrival_t) * 1e3,
                "spans": tracing.copy_spans(req.spans),
            })
        monitor.counter("serving.snapshot_saves").increase()
        return {
            "version": DISAGG_SNAPSHOT_VERSION,
            "kind": "disagg",
            "topology": {
                "prefill_workers": len(self.prefill),
                "decode_workers": len(self.decode),
            },
            "fingerprint": self._fingerprint(),
            "next_id": int(self._next_id),
            "admit_counter": int(self._admit_counter),
            "torch_rng_device": self.device.type,
            "requests": entries,
        }

    def restore(self, snap: dict) -> int:
        """Re-admit a snapshot's requests into this fresh driver: those
        with tokens resume through the prefill workers with replayed
        generators, untouched ones queue under their tenant; the outputs
        are the uninterrupted run's. The worker topology may differ. A
        sampled request with tokens needs the snapshot's generator device
        type (a JAX snapshot has none: only greedy progress restores
        from it)."""
        restore_check(self, snap, "disagg", DISAGG_SNAPSHOT_VERSION)
        n = 0
        for ent in snap["requests"]:
            req = restored_request(self, ent)
            tenant = str(ent.get("tenant", "default"))
            self.requests[req.req_id] = req
            self._tenant[req.req_id] = tenant
            self._order[req.req_id] = len(self._order)
            if req.generated:
                self._resume.append(req)
            else:
                self._enqueue(req, tenant)
            n += 1
        self._next_id = max(self._next_id, int(snap.get("next_id", 0)))
        self._admit_counter = max(self._admit_counter,
                                  int(snap.get("admit_counter", 0)))
        monitor.counter("serving.snapshot_restores").increase()
        return n

    def _fingerprint(self) -> Dict[str, object]:
        # spec_k from any LIVE decode worker: worker 0 may be dead
        live = next(w for w in self.decode if w is not None)
        return driver_fingerprint(self.model, self.cache_dtype, live)

    def leaked_pages(self) -> int:
        """Pages still held on the live workers after their prefix caches
        are released (``Engine.leaked_pages``; a dead worker's pool died
        with it)."""
        return sum(w.leaked_pages()
                   for fleet in (self.prefill, self.decode)
                   for w in fleet if w is not None)

    def check_invariants(self, repair: bool = False) -> List[str]:
        findings: List[str] = []
        for kind, fleet in (("prefill", self.prefill),
                            ("decode", self.decode)):
            for i, w in enumerate(fleet):
                if w is None:
                    continue
                findings += [f"{kind}{i}: {f}"
                             for f in w.check_invariants(repair=repair)]
        return findings

    def steady_state_recompiles(self) -> int:
        raise NotImplementedError(
            f"steady_state_recompiles reads the compile tracker: it comes "
            f"with {_ITEM6}")

    def inspect_hotpath(self):
        raise NotImplementedError(
            f"inspect_hotpath runs analysis.hotpath_lint: it comes with "
            f"{_ITEM6}")

    def close(self):
        for fleet in (self.prefill, self.decode):
            for w in fleet:
                if w is not None:
                    w.close()

    # -- bookkeeping ---------------------------------------------------------

    def _drop_from_queues(self, req: Request) -> None:
        super()._drop_from_queues(req)
        try:
            self._resume.remove(req)
        except ValueError:
            pass
        # a parked migration holds its prefill worker's pages
        for i, (pw, r) in enumerate(self._ready):
            if r is req:
                pw._alloc.free(req.pages)
                pw.requests.pop(req.req_id, None)
                req.pages = []
                del self._ready[i]
                break
        for fleet in (self.prefill, self.decode):
            for w in fleet:
                if w is not None:
                    self._drop_from_engine(w, req)

    def _publish_gauges(self):
        monitor.gauge("serving.disagg.queue_depth").set(self.num_waiting)
        monitor.gauge("serving.disagg.migrating").set(len(self._ready))
        for kind, fleet in (("prefill", self.prefill),
                            ("decode", self.decode)):
            for i, w in enumerate(fleet):
                if w is None:
                    continue
                monitor.gauge(
                    f"serving.disagg.{kind}{i}.slots_active").set(
                    sum(1 for r in w._slots if r is not None))
                monitor.gauge(
                    f"serving.disagg.{kind}{i}.pages_free").set(
                    w._alloc.free_pages)

    # -- introspection -------------------------------------------------------

    @property
    def num_waiting(self) -> int:
        return (sum(len(q) for q in self._queues.values())
                + len(self._resume))

    @property
    def num_migrating(self) -> int:
        return len(self._ready)

    @property
    def num_active(self) -> int:
        return sum(w.num_active for w in self.decode if w is not None)

    @property
    def num_prefilling(self) -> int:
        return sum(
            sum(1 for r in w._slots if r is not None)
            for w in self.prefill if w is not None)

    @property
    def idle(self) -> bool:
        return (self.num_waiting == 0 and self.num_active == 0
                and self.num_prefilling == 0
                and self.num_migrating == 0)

    @property
    def pages_free(self) -> Dict[str, int]:
        return {f"{kind}{i}": w._alloc.free_pages
                for kind, fleet in (("prefill", self.prefill),
                                    ("decode", self.decode))
                for i, w in enumerate(fleet) if w is not None}

    @property
    def prefix_hit_rate(self) -> float:
        rates = [w.prefix_hit_rate for w in self.prefill
                 if w is not None and w._prefix is not None]
        return float(np.mean(rates)) if rates else 0.0

    @property
    def spec_accept_rate(self) -> float:
        drafted = sum(w._spec_drafted for w in self.decode
                      if w is not None)
        accepted = sum(w._spec_accepted for w in self.decode
                       if w is not None)
        return accepted / drafted if drafted else 0.0

    def utilization(self) -> Dict[str, Dict[str, object]]:
        """Per-worker utilization for the replay report: the busy-step
        share, migrations and pages migrated; a dead worker reports
        ``alive: False``."""
        out: Dict[str, Dict[str, object]] = {}
        for kind, fleet in (("prefill", self.prefill),
                            ("decode", self.decode)):
            for i, w in enumerate(fleet):
                st = self.worker_stats[f"{kind}{i}"]
                out[f"{kind}{i}"] = {
                    "alive": w is not None,
                    "utilization": round(
                        st["busy_steps"] / max(st["steps"], 1), 4),
                    "migrations": st["migrations"],
                    "pages_migrated": st["pages_migrated"],
                }
        return out


# -- helpers the serving fleet shares ---------------------------------------

def driver_fingerprint(model, cache_dtype, live: Engine) -> Dict[str, object]:
    """The token-compatibility signature of a driver's snapshot (the JAX
    drivers' ``_fingerprint``)."""
    cfg = model.config
    return {
        "vocab_size": int(cfg.vocab_size),
        "num_hidden_layers": int(cfg.num_hidden_layers),
        "hidden_size": int(cfg.hidden_size),
        "num_attention_heads": int(cfg.num_attention_heads),
        "num_key_value_heads": int(cfg.num_key_value_heads),
        "cache_dtype": _dtype_name(cache_dtype),
        "spec_k": int(live._spec.k) if live._spec is not None else 0,
    }


def restore_check(driver, snap: dict, kind: str, version: int) -> None:
    """Refuse a snapshot of another kind or version, a busy driver, a
    token-incompatible fingerprint, or sampled progress made on another
    device type (its generator stream differs)."""
    if snap.get("kind") != kind or snap.get("version") != version:
        raise ValueError(
            f"not a {kind} snapshot (kind={snap.get('kind')!r} "
            f"version={snap.get('version')!r})")
    if driver.requests:
        raise RuntimeError(
            f"restore onto a busy {kind} driver: "
            f"{len(driver.requests)} live request(s) present")
    fp = driver._fingerprint()
    saved = snap.get("fingerprint", {})
    diff = {k: (saved.get(k), v) for k, v in fp.items()
            if saved.get(k) != v}
    if diff:
        raise ValueError(
            f"snapshot is token-incompatible with this {kind} driver: "
            f"{diff} (saved vs current)")
    dev = snap.get("torch_rng_device")
    for ent in snap["requests"]:
        if float(ent["params"].get("temperature", 0.0)) > 0 \
                and ent["generated"] and dev != driver.device.type:
            raise ValueError(
                f"snapshot request {ent['req_id']} samples and has "
                f"emitted tokens on device type {dev!r}; this driver "
                f"serves on {driver.device.type!r}, whose generator "
                f"stream differs, so it cannot continue exactly")


def restored_request(driver, ent: dict) -> Request:
    """A snapshot entry as a Request of ``driver``: PREEMPTED with its
    tokens (or WAITING), its generator replayed on the driver's
    device."""
    params = SamplingParams(**ent["params"])
    now = driver._clock()
    req = Request(
        req_id=int(ent["req_id"]),
        prompt=[int(t) for t in ent["prompt"]],
        params=params,
        state=PREEMPTED if ent["generated"] else WAITING,
        generated=[int(t) for t in ent["generated"]],
        preemptions=int(ent.get("preemptions", 0)),
        arrival_t=now - float(ent.get("elapsed_ms", 0.0)) / 1e3,
        queued_step=driver._steps)
    req.generator = _replayed_generator(req, driver.vocab_size,
                                        driver.device)
    req.spans = tracing.restore_spans(
        ent.get("spans"), req.arrival_t * 1e3, now * 1e3, driver.label,
        bool(req.generated))
    return req


def driver_output(req: Request, reason: str, failed: bool,
                  label: str) -> Output:
    """The Output of a request a driver retires itself (cancelled or
    expired while queued or parked)."""
    n = len(req.generated)
    got_first = req.first_token_t > 0.0
    ttft = ((req.first_token_t - req.arrival_t) * 1e3
            if got_first else 0.0)
    tpot = ((req.finish_t - req.first_token_t) / (n - 1) * 1e3
            if got_first and n > 1 else 0.0)
    tracing.seal(req.spans, tracing.FAILED if failed else tracing.FINISHED,
                 req.finish_t * 1e3, label,
                 reason=reason if failed else None)
    return Output(req_id=req.req_id, prompt_ids=list(req.prompt),
                  token_ids=list(req.generated),
                  finish_reason=reason, ttft_ms=ttft, tpot_ms=tpot,
                  preemptions=req.preemptions,
                  error=reason if failed else None,
                  spans=tracing.copy_spans(req.spans))
