"""paddle_tpu_torch.inference.engine — in-process continuous batching.

Counterpart of ``paddle_tpu/inference/engine.py``:

* Request state machine WAITING -> PREFILL -> DECODE -> FINISHED, with
  PREEMPTED looping back into the waiting queue (pages freed, tokens and
  the request's generator kept, cache rebuilt by a resume prefill on
  re-admission — token for token the uninterrupted run).
* Slot scheduler: ``max_slots`` decode lanes; each ``step()`` admits
  waiting requests into free slots while the page pool keeps
  ``watermark_pages`` of headroom (``_admit``).
* Paged allocator (allocator.PageAllocator): page 0 is the scratch page
  every inactive slot's block-table row points at, so idle lanes write
  garbage harmlessly; a sequence's pages are freed the step it finishes.
* Bucketed prefill: the prompt padded to a ``prefill_bucket`` multiple,
  written into the pools through the paged gather path at its start
  offset, the first token sampled from its last real position.
* The fused ``[max_slots]`` decode tick: one single-token forward over
  every slot — the CUDA paged-decode kernel on the GPU — plus per-slot
  sampling in one of three variants (all-greedy argmax, no-filter,
  full-filter). Idle lanes ride at cache index -1 (context 0: dead slots
  for the kernel).
* Page growth before each tick, preempting the YOUNGEST sequence when
  the pool runs dry (``_ensure_pages``), after evicting idle prefix-cache
  pages.

Four accelerators ride on the same scheduler:

* Multi-tick decode (``multi_tick=k``): when every live slot is in a
  greedy stretch — nothing waiting, no slot mid-prefill, no draft model —
  up to k device ticks run per host round trip (``decode_graph.py``: a
  CUDA graph replayed a dispatch on ``cuda``), clamped by the longest
  remaining budget and the tightest page coverage and rounded down to a
  bucket (powers of two, plus k). An in-loop eos or spent budget freezes
  a row, so the tokens are those of the single-tick loop.
* Prefix caching (``prefix_cache=True``; prefix_cache.py): the longest
  cached page-aligned prefix of a prompt maps straight into its block
  table (allocator refcounts), capped so that one real token is left;
  only the uncached tail is charged and prefilled, at its page-aligned
  start, and the page it appends into stays private.
* Chunked prefill (``max_prefill_tokens_per_step=N``, rounded up to the
  bucket): a long prompt is written in bounded slices interleaved with
  decode ticks, shortest remaining first, within N tokens a step (the
  oldest always gets one bucket). A request holds its pages between
  slices and stays preemptible at a slice boundary; admission charges
  only the first slice.
* Speculative decoding (``draft_model=..., spec_k=k``; speculative.py):
  the draft proposes k tokens a slot, the target scores all k+1
  positions in one forward, and exact-match acceptance
  (``generation.verify_token_arrays``) keeps the output the draft-free
  engine's — 1 to k+1 tokens a tick. The draft's pools share the
  engine's page ids, so one allocator and one prefix cache govern both.

The step order is the JAX engine's: dispatch the decode work for the
slots settled by the last step, then admit and prefill, then harvest the
tokens, then grow pages for the next dispatch.

The pools are updated IN PLACE (the JAX engine donates them to its
executables). Sampling draws Gumbel noise from each request's own
``torch.Generator`` (seeded by ``SamplingParams.seed``), only for rows
with temperature > 0, so a request's sampled tokens do not depend on
its slot or on its batch-mates; greedy rows consume nothing.

MoE models (ERNIE-MoE) serve like dense ones: the model runs its MoE
blocks in decode mode under a cache (no capacity drops, idle lanes
masked), and the engine reports which dispatch they ran
(``moe_decode_path()``, ``serving.moe.decode_path.*``).

The reliability and observability plane (``reliability.py`` has the
fault catalog and the snapshot format, ``tracing.py`` the span
timelines):

* Request lifecycle hardening: per-request ``deadline_ms`` /
  ``max_queue_steps`` enforced on the engine's injectable ``clock`` in
  the step's overlap window (``_expire``), ``cancel(req_id)``, and a
  terminal FAILED(reason) state — one bad request (NaN logits, an
  injected device error, a prefill that keeps failing) is retired with
  its pages freed while every other slot keeps serving; ``step()`` never
  raises for a per-request failure. A NaN in one slot's sampling logits
  fails that slot alone (``serving.nan_quarantines``).
* Deterministic fault injection: a seeded ``FaultInjector``
  (``fault_injector=`` or ``FLAGS_serving_fault_*``) fires named faults
  at the allocator, the prefix cache, the prefill / decode / verify
  forwards and the draft loop, queried at the JAX engine's call sites in
  its order, so a seed replays the same faults in both frameworks. The
  unarmed path pays one ``is not None`` test a site. An armed injector
  (or ``debug_invariants``) audits the allocator every step
  (``check_invariants``).
* Crash-exact snapshot/restore: ``snapshot()`` serializes the host-side
  truth (tokens, sampling params, generator states, admission order) and
  ``restore()`` re-admits it through the preemption / resume-prefill
  machinery. ``run(heartbeat_timeout=...)`` attaches a
  ``distributed.watchdog.Heartbeat`` that snapshots and reports a
  stalled loop.
* Span timelines: every request carries QUEUED -> PREFILL slices ->
  DECODE -> ... -> FINISHED / FAILED on the engine clock
  (``Output.spans``); ``label`` names the engine in them and scopes its
  metrics (``monitor.scope``).

``extract_request`` / ``readmit`` move a live request to another Engine
over the same weights (the serving fleet's migration, fleet.py), and the
disaggregated driver (disagg.py) subclasses the Engine into prefill and
decode workers through ``_activate``. Left out: mesh/TP decode (ROADMAP
section 1, item 3) and the compile tracker (item 6).

``monitor`` surface: counters ``serving.requests`` / ``serving.tokens``
/ ``serving.finished`` / ``serving.failed`` / ``serving.preemptions`` /
``serving.steps`` / ``serving.prefill_tokens`` /
``serving.prefill_slices`` / ``serving.prefix_{lookups,hits,
tokens_reused}`` / ``serving.spec_{drafted,accepted}`` /
``serving.multi_tick.{dispatches,ticks,warmup_ticks}`` /
``serving.multi_tick.clamp.{max_new,pages,spec,deadline}`` /
``serving.multi_tick.scan_exit.{eos,length,nan_logits,horizon}`` /
``serving.{timeouts,cancelled,nan_quarantines,step_errors,
invariant_repairs,stalls,snapshot_saves,snapshot_restores}`` /
``serving.fault_injected.<site>``;
gauges ``serving.slots_active`` / ``serving.pages_free`` /
``serving.queue_depth`` / ``serving.ttft_ms`` / ``serving.tpot_ms`` /
``serving.prefill_tokens_per_step`` / ``serving.prefix_hit_rate`` /
``serving.prefix_pages_shared`` / ``serving.spec_accept_rate`` /
``serving.multi_tick.ticks_per_dispatch`` /
``serving.{host,device,overlap}_ms_per_tick`` (a step's wall time split
at the host's waits for device results, host work hidden under a
dispatch booked as device time and shown as overlap — ``_sync_timed``);
histograms ``serving.hist.{host,device,overlap}_ms_per_tick`` /
``serving.hist.tick_ms`` / ``serving.hist.{queue_wait,ttft,tpot}_ms``.
A labeled engine writes each also under ``serving.<label>.…``.
"""
from __future__ import annotations

import inspect
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import monitor
from ..core.device import resolve_device
from ..core.flags import get_flag
from ..kernels.paged_attention import paged_kernel_requirements
from ..text.generation import (_model_forward, _resolve_cache_dtype,
                               gumbel_noise, sample_token_arrays,
                               verify_token_arrays)
from . import tracing
from .allocator import PageAllocator
from .prefix_cache import PrefixCache
from .reliability import InjectedFault, injector_from_flags

# request lifecycle states
WAITING = "WAITING"
PREFILL = "PREFILL"
DECODE = "DECODE"
FINISHED = "FINISHED"
PREEMPTED = "PREEMPTED"
FAILED = "FAILED"

#: prefill attempts before a transiently failing request is FAILED
#: (injected device errors and unexpected prefill errors requeue up to
#: this many times). Pool-pressure requeues (PoolPressure) are exempt:
#: under chunked prefill, admission charges only the first slice, so a
#: dry pool mid-prompt is the normal backpressure path.
MAX_PREFILL_RETRIES = 3


class PoolPressure(RuntimeError):
    """A prefill slice could not get pages (pool dry after eviction):
    the request goes back to the queue and retries without burning its
    retry budget; running sequences finishing or being preempted free
    the pages it waits for."""


@dataclass
class SamplingParams:
    """Per-request generation config (every field may differ per request
    inside one batch)."""

    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    eos_token_id: Optional[int] = None
    seed: int = 0
    # enforced on the engine clock at every step: a request past its
    # deadline — or one still waiting for a slot after max_queue_steps
    # steps — is FAILED ("deadline" / "queue_timeout"), pages freed
    deadline_ms: Optional[float] = None
    max_queue_steps: Optional[int] = None

    def validate(self):
        if int(self.max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if float(self.temperature) < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.deadline_ms is not None and float(self.deadline_ms) <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {self.deadline_ms}")
        if self.max_queue_steps is not None \
                and int(self.max_queue_steps) < 1:
            raise ValueError(
                f"max_queue_steps must be >= 1, got "
                f"{self.max_queue_steps}")


@dataclass
class Output:
    """One retired request: the generated continuation (including the
    eos token when one was emitted) plus serving latencies. A FAILED
    request surfaces here too: ``finish_reason`` names the failure
    ("cancelled" / "deadline" / "queue_timeout" / "nan_logits" /
    "error:…"), ``error`` carries it, and ``token_ids`` holds what was
    generated before it."""

    req_id: int
    prompt_ids: List[int]
    token_ids: List[int]
    finish_reason: str            # "eos" | "length" | failure reason
    ttft_ms: float                # arrival -> first token
    tpot_ms: float                # mean inter-token latency after that
    preemptions: int = 0
    error: Optional[str] = None   # None iff the request FINISHED
    # the request's span timeline (tracing.py): QUEUED -> PREFILL slices
    # -> DECODE -> ... -> FINISHED / FAILED, contiguous on the engine clock
    spans: List[dict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclass
class Request:
    req_id: int
    prompt: List[int]
    params: SamplingParams
    generator: Optional[torch.Generator] = None   # this request's rng
    state: str = WAITING
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    pages: List[int] = field(default_factory=list)
    # prefix-cache pages acquired (refcounted) at admission and the
    # tokens they cover; None until the admission lookup ran (reset on
    # preemption: the resume prefix is looked up again)
    shared_pages: Optional[List[int]] = None
    prefix_len: int = 0
    written: int = 0                      # tokens in the paged cache
    admit_seq: int = -1                   # admission order (preemption)
    preemptions: int = 0
    retries: int = 0                      # failed prefill attempts
    queued_step: int = -1                 # step the request last queued
    arrival_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    finish_reason: Optional[str] = None
    # host-truth span log (tracing.py) on the engine clock: plain dicts,
    # so it rides snapshot/restore
    spans: List[dict] = field(default_factory=list)

    def resume_tokens(self) -> List[int]:
        """The prefix a (re-)prefill writes into the cache: the prompt
        plus every generated token except the newest (which the next
        decode step consumes — and writes)."""
        if self.generated:
            return self.prompt + self.generated[:-1]
        return self.prompt

    def resume_len(self) -> int:
        """len(resume_tokens()) without building the list."""
        if self.generated:
            return len(self.prompt) + len(self.generated) - 1
        return len(self.prompt)


def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def serving_model_spec(model) -> dict:
    """The engine's model-geometry probe: ``model.serving_spec()``, a
    plain dict with ``kind`` plus, for decoders, the KV geometry
    (``num_layers`` / ``kv_heads`` / ``num_heads`` / ``head_dim`` /
    ``max_context`` / ``vocab_size``)."""
    fn = getattr(model, "serving_spec", None)
    if not callable(fn):
        raise ValueError(
            f"cannot derive a serving spec for {type(model).__name__}: "
            f"it has no serving_spec() method returning its KV geometry")
    spec = dict(fn())
    if spec.get("kind") == "decoder":
        missing = [k for k in ("num_layers", "kv_heads", "num_heads",
                               "head_dim", "max_context")
                   if spec.get(k) is None]
        if missing:
            raise ValueError(
                f"{type(model).__name__}.serving_spec() is missing "
                f"decoder geometry key(s) {missing}")
    return spec


def has_kv_forward(model) -> bool:
    """True when ``model.forward`` takes ``kv_caches`` (a decoder the
    engine can serve through its paged cache)."""
    try:
        fsig = inspect.signature(model.forward)
    except (TypeError, ValueError):
        return False
    return "kv_caches" in fsig.parameters


def _normalize_prompt(ids) -> List[int]:
    """One prompt as a python int list: [s] or [1, s] ids in, loud
    errors for batches and empties."""
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    arr = np.asarray(ids)
    if arr.ndim == 2 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim != 1:
        raise ValueError(
            f"add_request takes ONE prompt ([s] or [1, s] ids); got "
            f"shape {arr.shape} — queue a batch as separate requests")
    prompt = [int(t) for t in arr]
    if not prompt:
        raise ValueError("empty prompt")
    return prompt


def _make_paged_pools(layers, rows, hkv, page_size, hd, dtype, quant,
                      device):
    """Per-layer paged KV pool tuples — (k, v[, ks, vs]) zeros in the
    head-major layout kernels/paged_attention.py expects (the target's
    pools and the draft's)."""
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    return [
        (z(rows, hkv, page_size, hd), z(rows, hkv, page_size, hd))
        + ((z(rows, hkv, page_size, dt=torch.float32),
            z(rows, hkv, page_size, dt=torch.float32)) if quant else ())
        for _ in range(layers)]


def inject_bt(pools, bt):
    """Pool tuples -> the model's per-layer paged cache tuples
    (k, v, bt[, ks, vs]): the block table is engine state shared by
    every layer."""
    return [(c[0], c[1], bt) + tuple(c[2:]) for c in pools]


@dataclass
class _PendingTick:
    """One queued decode dispatch: the device outputs to fetch, the
    (slot, request) pairs it covered (harvest skips rows whose request
    left DECODE in between), the attribution bookkeeping (the host clock
    when the dispatch's launches returned and the ``_device_s`` mark, for
    ``_sync_timed``'s window), and what the harvest needs of its kind."""

    kind: str                 # "single" | "multi" | "spec"
    data: tuple
    active: list
    t_dispatch: float         # perf_counter after the launches
    dev_mark: float           # self._device_s at dispatch
    ticks: int = 1            # device ticks this dispatch covers
    k: int = 0                # multi: fused ticks; spec: draft length
    # spec: each sampled row's generator state after 1..k+1 draws
    gen_states: Dict[int, list] = field(default_factory=dict)


class Engine:
    """In-process continuous-batching engine over the paged KV stack.

        eng = Engine(model, max_slots=8, page_size=16, pool_pages=256)
        rid = eng.add_request(ids, SamplingParams(max_new_tokens=32))
        while ...:
            for out in eng.step():
                ...                      # finished requests
        # or offline:
        outs = eng.run([(ids_a, pa), (ids_b, pb)])

    ``device=None`` serves on ``cuda`` (raising when no GPU is visible);
    ``device="cpu"`` runs the plain kernel versions on the CPU. The
    model (and a draft model) must live on that device. On ``cuda`` the
    constructor checks that the decode kernel takes the pool geometry
    and launches the kernel library's probe once.

    Reliability knobs: ``clock`` (the injectable clock every timestamp,
    deadline and span reads; ``time.perf_counter`` by default),
    ``fault_injector`` (a ``FaultInjector``; None arms one from
    ``FLAGS_serving_fault_*``, off by default; False forces it off),
    ``debug_invariants`` (audit the allocator after every step and
    raise on a finding; None reads ``FLAGS_serving_debug_invariants``)
    and ``label`` (names the engine in span timelines and writes its
    metrics also under ``serving.<label>.…``).
    """

    def __init__(self, model, max_slots: int = 8, page_size: int = 16,
                 pool_pages: Optional[int] = None,
                 cache_dtype: str = "auto",
                 max_context: Optional[int] = None,
                 prefill_bucket: int = 32,
                 watermark_pages: Optional[int] = None,
                 device=None,
                 prefix_cache: bool = False,
                 draft_model=None,
                 spec_k: int = 4,
                 max_prefill_tokens_per_step: Optional[int] = None,
                 multi_tick: int = 1,
                 fault_injector=None,
                 clock=None,
                 debug_invariants: Optional[bool] = None,
                 label: Optional[str] = None):
        spec = serving_model_spec(model)
        if spec.get("kind") == "encoder":
            raise ValueError(
                f"{type(model).__name__} is an ENCODER — it has no KV "
                f"decode surface for the continuous-batching Engine")
        if not has_kv_forward(model):
            raise ValueError(
                "Engine requires a model with kv_caches/cache_index "
                f"forward kwargs; {type(model).__name__}.forward has none")
        self.device = resolve_device(device)
        params = list(model.parameters())
        if params and params[0].device != self.device:
            raise ValueError(
                f"the model lives on {params[0].device} but the engine "
                f"serves on {self.device}: build both on one device")
        self.serving_spec = spec
        self.model = model
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.prefill_bucket = int(prefill_bucket)
        # chunked prefill: at most this many prefill tokens a step,
        # rounded UP to the bucket so every slice is whole buckets
        if max_prefill_tokens_per_step is not None:
            if int(max_prefill_tokens_per_step) < 1:
                raise ValueError(
                    f"max_prefill_tokens_per_step must be >= 1, got "
                    f"{max_prefill_tokens_per_step}")
            max_prefill_tokens_per_step = self._pbucket(
                int(max_prefill_tokens_per_step))
        self.max_prefill_tokens_per_step = max_prefill_tokens_per_step
        self._pf_step_tokens = 0
        if int(multi_tick) < 1:
            raise ValueError(f"multi_tick must be >= 1, got {multi_tick}")
        self.multi_tick = int(multi_tick)
        self.max_context = int(max_context or spec["max_context"])
        # a speculative tick writes k+1 positions: the block tables carry
        # that lookahead past max_context
        self._lookahead = (int(spec_k) + 1) if draft_model is not None \
            else 1
        self.max_blocks = _ceil_div(
            self._pbucket(self.max_context) + self._lookahead - 1,
            self.page_size)
        if pool_pages is None:
            # default: every slot can hold a max-context sequence
            pool_pages = self.max_slots * self.max_blocks
        self.pool_pages = int(pool_pages)
        self.watermark_pages = (max(1, self.pool_pages // 50)
                                if watermark_pages is None
                                else int(watermark_pages))
        self.cache_dtype = _resolve_cache_dtype(cache_dtype, params,
                                                self.device)
        self._quant = self.cache_dtype == torch.int8
        hkv = int(spec["kv_heads"])
        hd = int(spec["head_dim"])
        self.vocab_size = int(spec["vocab_size"])
        if self.device.type == "cuda":
            # the decode kernel's limits, validated ONCE here (the
            # counterpart of the JAX engine's Pallas eligibility check):
            # a geometry it does not take is an error, never a fallback
            why = paged_kernel_requirements(int(spec["num_heads"]), hkv,
                                            hd, self.cache_dtype)
            if why:
                raise ValueError(
                    f"the CUDA paged-decode kernel cannot serve this "
                    f"geometry: {why}")
            from ..kernels import probe
            probe("paged_decode", self.device)
        self._init_moe(spec)
        # pool row 0 is the scratch page (inactive lanes) — the
        # allocator hands out ids [1, pool_pages]
        self._alloc = PageAllocator(self.pool_pages, base=1)
        self._pools = _make_paged_pools(
            int(spec["num_layers"]), self.pool_pages + 1, hkv,
            self.page_size, hd, self.cache_dtype, self._quant, self.device)
        S, MB = self.max_slots, self.max_blocks
        self._bt = np.zeros((S, MB), np.int32)
        self._pos = np.zeros((S,), np.int64)
        self._last = np.zeros((S,), np.int64)
        self._temps = np.zeros((S,), np.float32)
        self._topks = np.zeros((S,), np.int64)
        self._topps = np.zeros((S,), np.float32)
        self._live = np.zeros((S,), np.int64)
        # ONE device block table for the life of the engine, written
        # with copy_ (the multi-tick graphs read it at a fixed address)
        self._bt_dev = self._up(self._bt)
        self._bt_dirty = False
        self._slots: List[Optional[Request]] = [None] * S
        self._waiting: "deque[Request]" = deque()
        self._next_id = 0
        self._admit_counter = 0
        self._steps = 0
        self._ticks = 0
        self._device_s = 0.0
        self._prefix = (PrefixCache(self._alloc, self.page_size)
                        if prefix_cache else None)
        self._spec = None
        self._spec_drafted = 0
        self._spec_accepted = 0
        if draft_model is not None:
            from .speculative import SpeculativeDecoder
            self._spec = SpeculativeDecoder(self, draft_model, spec_k)
        self._multi = None
        if self.multi_tick > 1:
            from .decode_graph import MultiTick
            self._multi = MultiTick(self)
        # the multi-tick buffers hold the host mirrors' values: cleared by
        # any host-side slot change or token emitted outside the fused
        # path, so the next fused dispatch uploads them again
        self._multi_clean = False
        self._init_reliability(clock, fault_injector, debug_invariants,
                               label)

    def _init_reliability(self, clock, fault_injector, debug_invariants,
                          label):
        """The reliability and observability state (the JAX engine's
        ``__init__`` :637-698)."""
        # every timestamp, deadline and span reads this clock (tests and
        # replays inject a virtual one); host/device attribution alone
        # stays on time.perf_counter
        self._clock = clock if clock is not None else time.perf_counter
        self.label = str(label) if label is not None else "engine"
        self._mon = monitor.scope(label)
        # LIVE requests only (retired ones leave at _retire)
        self.requests: Dict[int, Request] = {}
        if fault_injector is False:
            self._injector = None
        elif fault_injector is None:
            self._injector = injector_from_flags()
        else:
            self._injector = fault_injector
        self._debug_invariants = (
            bool(get_flag("serving_debug_invariants"))
            if debug_invariants is None else bool(debug_invariants))
        # the decode.nan fault: a [S] vector with a NaN at the victim's
        # row, uploaded on the fault tick and added to that dispatch's
        # sampling logits only (a clean tick launches nothing for it)
        self._poison_dev: Optional[torch.Tensor] = None
        self._poisoned = False
        # host work that ran while the device executed the in-flight
        # dispatch (_sync_timed): booked as device time, published as
        # serving.overlap_ms_per_tick
        self._overlap_s = 0.0
        # EWMA of a device tick on the injectable clock: the unit of the
        # multi-tick deadline clamp (_deadline_ticks)
        self._tick_est_ms = 0.0
        self.last_stall_snapshot: Optional[dict] = None

    def _init_moe(self, spec):
        """MoE models: read the MoE layer's fallback reason once, as the
        JAX engine does (:742-750) — ``moe_fallback_reason`` /
        ``moe_pallas_eligible``, and ``serving.moe.decode_fallback`` when
        the decode ticks take the scatter path — and baseline the
        ``kernels.moe.decode_path.*`` counters this engine republishes as
        ``serving.moe.decode_path.*`` after each step. On ``cuda`` the
        grouped-FFN kernel library is loaded (and probed) here."""
        self._moe_layer = spec.get("moe_layer")
        self.moe_spec = spec.get("moe")
        self.moe_fallback_reason = None
        self.moe_pallas_eligible = None
        self._moe_paths: Dict[str, int] = {}
        self._moe_seen = self._moe_counters()
        if self._moe_layer is None:
            return
        self.moe_fallback_reason = self._moe_layer._pallas_fallback_reason()
        self.moe_pallas_eligible = self.moe_fallback_reason is None
        if not self.moe_pallas_eligible:
            monitor.counter("serving.moe.decode_fallback").increase()
        elif self.device.type == "cuda":
            from ..kernels import probe
            probe("grouped_ffn_fwd", self.device)

    @staticmethod
    def _moe_counters() -> Dict[str, int]:
        prefix = "kernels.moe.decode_path."
        return {k: int(v) for k, v in monitor.counters().items()
                if k.startswith(prefix)}

    def _republish_moe_paths(self) -> None:
        """Mirror this step's ``kernels.moe.decode_path.*`` deltas (one per
        MoE layer per prefill chunk, decode tick, draft-free verify)
        into ``serving.moe.decode_path.*`` and ``moe_decode_path()``."""
        now = self._moe_counters()
        for key, val in now.items():
            delta = val - self._moe_seen.get(key, 0)
            if delta > 0:
                suffix = key[len("kernels.moe.decode_path."):]
                monitor.counter("serving.moe.decode_path." + suffix).increase(
                    delta)
                self._moe_paths[suffix] = self._moe_paths.get(suffix, 0) + delta
        self._moe_seen = now

    def moe_decode_path(self) -> Dict[str, int]:
        """This engine's MoE dispatch breakdown (suffix -> MoE-layer calls):
        ``{"pallas": n}`` with no ``fallback.*`` key means every MoE block
        of every prefill chunk and decode tick ran the grouped-FFN
        kernels. Empty for dense models."""
        return dict(self._moe_paths)

    # -- helpers -------------------------------------------------------------

    def _up(self, x) -> torch.Tensor:
        """Host -> device upload of engine state."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _sync_timed(self, ts, dispatch_t: Optional[float] = None,
                    dev_mark: float = 0.0):
        """Device -> host numpy copies of ``ts`` (the first copy waits for
        the dispatched work), the wait charged to the step's DEVICE share
        (the JAX engine's ``_sync_timed``).

        A decode harvest passes ``dispatch_t``, the host clock when its
        dispatch's launches had all returned, and ``dev_mark``, the
        ``_device_s`` reading then. When the wait actually blocked, the
        device was busy for the whole dispatch -> ready window (its work
        was queued and not done), so the host work that ran inside it is
        charged to the device share and counted as OVERLAP (device
        seconds other syncs already claimed inside the window are
        subtracted). A wait that returns at once means the device
        finished at an unknown point during the host work, so only the
        measured wait is charged: the conservative split that keeps the
        host share honest when the host is the bottleneck. The window
        opens after the launches, where the JAX engine opens it before
        its executable call: an eager dispatch's launches are host work
        (at k=1 most of a tick), and the device may idle behind them."""
        t0 = time.perf_counter()
        out = [t.cpu().numpy() for t in ts]
        t1 = time.perf_counter()
        blocked = t1 - t0
        if dispatch_t is not None:
            extra = (t1 - dispatch_t) - (self._device_s - dev_mark)
            if blocked > 5e-5 and extra > blocked:
                self._device_s += extra
                self._overlap_s += extra - blocked
                return out
        self._device_s += blocked
        return out

    def _pbucket(self, n: int) -> int:
        return _ceil_div(n, self.prefill_bucket) * self.prefill_bucket

    def _lifetime_pages(self, plen: int, max_new: int) -> int:
        """Peak page demand of a request over its whole lifetime (the
        can-it-ever-be-scheduled admission check). Monolithic prefill
        pads the whole need to the bucket; chunked prefill allocates
        pages for real tokens only, so the peak is every written token
        plus the per-tick write lookahead."""
        need = plen + max_new
        if self.max_prefill_tokens_per_step is None:
            return _ceil_div(self._pbucket(need) + self._lookahead - 1,
                             self.page_size)
        return _ceil_div(need - 1 + self._lookahead, self.page_size)

    def _inject_bt(self, bt):
        return inject_bt(self._pools, bt)

    def _noise(self, reqs: Sequence[Optional[Request]]) -> torch.Tensor:
        """[len(reqs), V] Gumbel noise: drawn from each SAMPLING
        request's own generator, zeros elsewhere (greedy rows and idle
        lanes consume no randomness)."""
        noise = torch.zeros((len(reqs), self.vocab_size),
                            dtype=torch.float32, device=self.device)
        for i, req in enumerate(reqs):
            if req is not None and req.params.temperature > 0:
                noise[i] = gumbel_noise(self.vocab_size, req.generator,
                                        self.device)
        return noise

    def _flush_bt(self):
        """Copy the host block table into the device one when a slot or
        a page changed since the last dispatch."""
        if self._bt_dirty:
            self._bt_dev.copy_(torch.from_numpy(self._bt))
            self._bt_dirty = False

    # -- public API ----------------------------------------------------------

    def add_request(self, ids, sampling_params=None) -> int:
        """Queue a prompt (1-D token ids, or [1, s]) for generation under
        ``sampling_params``. Returns the request id; a later ``step()``
        admits it to a slot."""
        params = sampling_params or SamplingParams()
        if isinstance(params, dict):
            params = SamplingParams(**params)
        params.validate()
        prompt = _normalize_prompt(ids)
        rid = self._next_id
        need = len(prompt) + int(params.max_new_tokens)
        cap = self.max_blocks * self.page_size - (self._lookahead - 1)
        # chunked prefill pads one slice at a time (clipped at the block
        # table), so only the real tokens must fit; monolithic prefill
        # pads the whole prompt to the bucket
        chunk_cap = (need if self.max_prefill_tokens_per_step is not None
                     else self._pbucket(need))
        if chunk_cap > cap:
            raise ValueError(
                f"request {rid} needs {need} token slots (prompt "
                f"{len(prompt)} + {params.max_new_tokens} new), beyond "
                f"the engine's max_context capacity {cap}")
        worst = self._lifetime_pages(len(prompt),
                                     int(params.max_new_tokens))
        if worst > self.pool_pages:
            raise RuntimeError(
                f"request {rid} can never be scheduled: it needs up to "
                f"{worst} page(s) but the pool has {self.pool_pages} — "
                f"grow pool_pages or shrink the request")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(params.seed))
        req = Request(req_id=rid, prompt=prompt, params=params,
                      generator=gen, arrival_t=self._clock(),
                      queued_step=self._steps)
        self._next_id += 1
        self.requests[rid] = req
        self._waiting.append(req)
        tracing.open_span(req.spans, tracing.QUEUED, req.arrival_t * 1e3,
                          self.label)
        self._mon.counter("serving.requests").increase()
        return rid

    def step(self) -> List[Output]:
        """One scheduler tick, in the JAX engine's order: queue the
        decode work for the slots the last step settled, then — while
        the device works — the deadline sweep, admission and prefill,
        then harvest the tokens (retiring finished requests) and grow
        pages for the next dispatch. Returns the requests that finished
        or failed during this tick; a per-request failure (deadline, NaN
        logits, a prefill error) retires that request and never raises
        out of here. Under ``multi_tick`` one step may cover up to k
        device ticks, and a deadline may be overrun by one dispatch."""
        outputs: List[Output] = []
        wall0 = time.perf_counter()
        clk0 = self._clock()
        self._device_s = 0.0
        self._overlap_s = 0.0
        if self._injector is not None:
            self._injector.on_step(self._steps)
            self._prefix_faults()
        with torch.no_grad():
            # (a) the decode work of the slots settled by the last step
            pending = self._safe_decode()
            # (b) the overlap window: a request retired here has its
            # in-flight tokens discarded at harvest; pages it frees may
            # go to a prefill below, whose writes follow the dispatch on
            # the stream
            outputs.extend(self._expire())
            self._pf_step_tokens = 0
            self._admit()
            outputs.extend(self._run_prefills())
            # (c) sync + harvest, (d) page growth for the next dispatch
            outputs.extend(self._decode_harvest(pending))
            self._ensure_pages()
        if self._injector is not None and \
                self._injector.fire("alloc.refcount_skew", record=False):
            # a stray reference on a live page (a lost free, a doubled
            # share): the audit below must repair it; recorded only when
            # a live page existed to skew
            held = [p for r in self._slots if r is not None
                    for p in r.pages]
            if held:
                self._injector.record("alloc.refcount_skew")
                self._alloc.share(
                    held[int(self._injector.rng.integers(0, len(held)))])
        self._maybe_audit()
        if self._moe_layer is not None:
            self._republish_moe_paths()
        self._mon.counter("serving.steps").increase()
        self._publish_gauges()
        # host/device attribution on the wall clock (never the
        # injectable one); under multi_tick these are per dispatch
        wall_ms = (time.perf_counter() - wall0) * 1e3
        dev_ms = min(self._device_s * 1e3, wall_ms)
        ov_ms = min(self._overlap_s * 1e3, dev_ms)
        for name, v in (("host", wall_ms - dev_ms), ("device", dev_ms),
                        ("overlap", ov_ms)):
            self._mon.gauge(f"serving.{name}_ms_per_tick").set(v)
            self._mon.histogram(f"serving.hist.{name}_ms_per_tick").record(v)
        self._mon.histogram("serving.hist.tick_ms").record(wall_ms)
        if pending is not None:
            if self.multi_tick > 1:
                self._mon.gauge("serving.multi_tick.ticks_per_dispatch").set(
                    pending.ticks)
            # a device tick's duration on the INJECTABLE clock: the unit
            # of the deadline clamp
            d_ms = (self._clock() - clk0) * 1e3 / max(1, pending.ticks)
            self._tick_est_ms = d_ms if self._tick_est_ms <= 0.0 \
                else 0.7 * self._tick_est_ms + 0.3 * d_ms
        self._steps += 1
        return outputs

    def run(self, requests: Sequence, max_steps: int = 100_000,
            heartbeat_timeout: Optional[float] = None,
            snapshot_path: Optional[str] = None) -> List[Output]:
        """Offline serving: queue every (ids, SamplingParams) pair — bare
        ids get default params — then step until all finish or fail.
        Returns Outputs ordered by request id.

        ``heartbeat_timeout=T`` attaches a ``Heartbeat``: every step
        ticks it, and a loop that makes no progress for T seconds (one
        step is one DISPATCH, up to k device ticks under
        ``multi_tick``) triggers ``_stall_report`` — a stack dump of
        every thread plus a host-state snapshot, written to
        ``snapshot_path`` when given and kept on ``last_stall_snapshot``."""
        ids_list = []
        for item in requests:
            if isinstance(item, (tuple, list)) and len(item) == 2 and \
                    isinstance(item[1], (SamplingParams, dict)):
                ids_list.append(self.add_request(item[0], item[1]))
            else:
                ids_list.append(self.add_request(item))
        want = set(ids_list)
        hb = None
        if heartbeat_timeout is not None:
            from ..distributed.watchdog import Heartbeat
            hb = Heartbeat(float(heartbeat_timeout),
                           on_stall=lambda age: self._stall_report(
                               age, snapshot_path))
            hb.start()
        outs: List[Output] = []
        try:
            for _ in range(max_steps):
                outs.extend(o for o in self.step() if o.req_id in want)
                if hb is not None:
                    hb.tick()
                if len(outs) == len(want):
                    break
            else:
                raise RuntimeError(
                    f"engine did not drain in {max_steps} steps "
                    f"({len(outs)}/{len(want)} finished)")
        finally:
            if hb is not None:
                hb.stop()
        return sorted(outs, key=lambda o: o.req_id)

    def cancel(self, req_id: int) -> Optional[Output]:
        """Abort a live or queued request now: its slot is freed, its
        pages return to the pool, and its Output (``finish_reason``
        "cancelled", the tokens generated so far) is returned. Unknown or
        already-retired ids return None. Safe at any point of the
        lifecycle: waiting, preempted, mid-prefill or mid-decode."""
        req = self.requests.get(int(req_id))
        if req is None or req.state in (FINISHED, FAILED):
            return None
        self._mon.counter("serving.cancelled").increase()
        return self._fail(req, "cancelled")

    def snapshot(self, sync: bool = True) -> dict:
        """Crash-exact host-state snapshot (reliability.py has the
        format): queued and live requests' tokens, sampling params,
        generator states, admission order, prefix-index metadata — not
        the KV pools. ``sync`` is the JAX engine's knob (skip the device
        fetch of live rng keys on a wedged device); the port's generator
        states are host bookkeeping, so the snapshot is exact either
        way."""
        from .reliability import snapshot_engine
        return snapshot_engine(self, sync=sync)

    def restore(self, snap: dict, strict: bool = True) -> int:
        """Re-admit a snapshot's requests into this (fresh or drained)
        engine through the preemption / resume-prefill machinery; the
        restored run emits the uninterrupted run's tokens. Returns the
        number of requests re-admitted."""
        from .reliability import restore_engine
        return restore_engine(self, snap, strict=strict)

    def snapshot_to(self, path: str, sync: bool = True) -> str:
        from .reliability import save_snapshot
        return save_snapshot(self.snapshot(sync=sync), path)

    def restore_from(self, path: str, strict: bool = True) -> int:
        from .reliability import load_snapshot
        return self.restore(load_snapshot(path), strict=strict)

    def close(self) -> None:
        """The JAX engine's ``close`` detaches its compile listener; the
        port's Engine has none, so this is a no-op (the drivers call it on
        every worker they drop)."""

    def check_invariants(self, repair: bool = False) -> List[str]:
        """Cross-check the allocator against every reference the engine
        can account for (live requests' pages plus one per prefix-cache
        entry), the allocator's own free-list / refcount consistency and
        the prefix index's digest integrity. Returns the findings (empty
        = healthy); ``repair=True`` also fixes them. Run each step under
        ``debug_invariants`` (raise on findings) or an injector armed at
        ``alloc.refcount_skew`` (repair and count)."""
        expected: Dict[int, int] = {}
        for r in self.requests.values():
            held = r.pages if r.pages else (r.shared_pages or [])
            for p in held:
                expected[p] = expected.get(p, 0) + 1
        if self._prefix is not None:
            for ent in self._prefix._store.values():
                expected[ent.page] = expected.get(ent.page, 0) + 1
        findings = self._alloc.check_invariants(expected=expected,
                                                repair=repair)
        if self._prefix is not None:
            findings += self._prefix.check_integrity(repair=repair)
        return findings

    @property
    def num_waiting(self) -> int:
        return len(self._waiting)

    @property
    def num_active(self) -> int:
        return sum(1 for r in self._slots
                   if r is not None and r.state == DECODE)

    @property
    def num_prefilling(self) -> int:
        """Slots holding a request mid-prefill between steps (chunked
        prefill only)."""
        return sum(1 for r in self._slots
                   if r is not None and r.state == PREFILL)

    @property
    def idle(self) -> bool:
        """True when a step() would do no work."""
        return (not self._waiting and self.num_active == 0
                and self.num_prefilling == 0)

    @property
    def pages_free(self) -> int:
        return self._alloc.free_pages

    @property
    def decode_ticks(self) -> int:
        """Device ticks run so far, each a [max_slots] forward: one a
        single or speculative dispatch, k a multi-tick one, and one a
        captured multi-tick bucket (its warm-up tick, every lane idle)."""
        return self._ticks

    @property
    def prefix_hit_rate(self) -> float:
        """Share of admission-time prefix lookups that mapped at least
        one cached page (0.0 with the cache off)."""
        return self._prefix.hit_rate if self._prefix is not None else 0.0

    @property
    def spec_accept_rate(self) -> float:
        """Share of drafted tokens the target accepted (0.0 before any
        draft ran or with speculation off)."""
        if not self._spec_drafted:
            return 0.0
        return self._spec_accepted / self._spec_drafted

    def leaked_pages(self) -> int:
        """Pages still allocated after the prefix cache's idle entries
        are released — 0 on a healthy drained engine (destructive to the
        cache: call it on a drained engine)."""
        if self._prefix is not None:
            self._prefix.clear()
        return self.pool_pages - self.pages_free

    # -- reliability internals -----------------------------------------------

    def _fault(self, site: str) -> bool:
        """One fault-point query (False with no injector armed: the
        production path's one ``is not None`` test)."""
        return self._injector is not None and self._injector.fire(site)

    def _fault_raise(self, site: str) -> None:
        if self._fault(site):
            raise InjectedFault(site)

    def _prefix_faults(self) -> None:
        """The step's prefix-cache fault points: a forced digest
        collision (the exact-token compare must make it a miss) and a
        corrupted entry (never hit again; the audit or eviction reclaims
        it)."""
        if self._prefix is None:
            return
        if self._fault("prefix.hash_collision"):
            self._prefix.force_collision()
        if self._injector.fire("prefix.stale_entry", record=False) \
                and len(self._prefix):
            # recorded only when there was an entry to corrupt
            self._injector.record("prefix.stale_entry")
            self._prefix.corrupt_entry(self._injector.rng)

    def _maybe_audit(self) -> None:
        auditing = self._debug_invariants or (
            self._injector is not None
            and self._injector.enabled("alloc.refcount_skew"))
        if not auditing:
            return
        repair = self._injector is not None
        findings = self.check_invariants(repair=repair)
        if findings:
            if repair:
                monitor.counter("serving.invariant_repairs").increase(
                    len(findings))
            else:
                raise RuntimeError(
                    "engine invariant audit failed "
                    "(FLAGS_serving_debug_invariants):\n  "
                    + "\n  ".join(findings))

    def _expire(self) -> List[Output]:
        """The step's deadline sweep, in the overlap window: fail every
        request past its deadline (waiting OR running: its pages free
        now) and every waiting request past its queue-step budget.
        Enforcement lands on dispatch boundaries: under ``multi_tick``
        a deadline can be overrun by one dispatch (``_deadline_ticks``
        shrinks the fused k toward the nearest deadline), and an expired
        request's in-flight tokens are discarded at harvest."""
        outs: List[Output] = []
        now = self._clock()
        for req in list(self._waiting) + [r for r in self._slots
                                          if r is not None]:
            p = req.params
            if p.deadline_ms is not None and \
                    (now - req.arrival_t) * 1e3 > float(p.deadline_ms):
                self._mon.counter("serving.timeouts").increase()
                outs.append(self._fail(req, "deadline"))
            elif p.max_queue_steps is not None and \
                    req.state in (WAITING, PREEMPTED) and \
                    self._steps - req.queued_step \
                    > int(p.max_queue_steps):
                self._mon.counter("serving.timeouts").increase()
                outs.append(self._fail(req, "queue_timeout"))
        return outs

    def _stall_report(self, age: float,
                      snapshot_path: Optional[str] = None) -> None:
        """Heartbeat stall callback (the watcher thread): dump every
        thread's stack to stderr and snapshot the host state — the trail
        a wedged serving process leaves before it is killed. The snapshot
        reads no device memory (``sync=False``)."""
        import faulthandler
        monitor.counter("serving.stalls").increase()
        print(f"engine watchdog: run() loop stalled for {age:.1f}s at "
              f"step {self._steps} ({self.num_active} active, "
              f"{len(self._waiting)} waiting, "
              f"{self._alloc.free_pages} pages free) — dumping stacks "
              f"and snapshotting", flush=True)
        try:
            faulthandler.dump_traceback(all_threads=True)
        except (OSError, RuntimeError, ValueError):
            pass    # stderr gone: the snapshot below still matters
        try:
            self.last_stall_snapshot = self.snapshot(sync=False)
            if snapshot_path:
                from .reliability import save_snapshot
                save_snapshot(self.last_stall_snapshot, snapshot_path)
        except Exception as e:  # noqa: BLE001 — diagnostics must not raise
            print(f"engine watchdog: stall snapshot failed: {e!r}",
                  flush=True)

    def _safe_prefill(self, req: Request,
                      cap: Optional[int] = None) -> Optional[Output]:
        """Isolation wrapper: a failing prefill requeues or retires THIS
        request, with the pages it took rolled back; the other slots are
        untouched and step() goes on."""
        try:
            return self._prefill(req, cap)
        except PoolPressure as e:
            # backpressure, not a failure: wait for pages without
            # burning the retry budget
            return self._requeue(req, str(e).partition("\n")[0],
                                 count_retry=False)
        except InjectedFault:
            monitor.counter("serving.step_errors").increase()
            return self._requeue(req, "injected device error")
        except RuntimeError as e:
            # other transient prefill errors retry on a later step,
            # against the retry budget
            return self._requeue(req, str(e).partition("\n")[0]
                                 or type(e).__name__)
        except Exception as e:  # noqa: BLE001 — request isolation
            monitor.counter("serving.step_errors").increase()
            return self._fail(req, f"error:{type(e).__name__}")

    def _requeue(self, req: Request, why: str,
                 count_retry: bool = True) -> Optional[Output]:
        self._rollback_prefill(req)
        if count_retry:
            req.retries += 1
            if req.retries > MAX_PREFILL_RETRIES:
                return self._fail(req, f"error:prefill ({why})")
        req.state = PREEMPTED if req.generated else WAITING
        req.queued_step = self._steps
        self._waiting.appendleft(req)
        return None

    def _rollback_prefill(self, req: Request) -> None:
        """Undo a partly run prefill: drop every page reference the
        request holds (merged or still admission-only) and hand its slot
        back."""
        self._clear_slot(req)

    def _safe_decode(self) -> Optional[_PendingTick]:
        """Isolation wrapper around the decode dispatch: an injected
        device error fires BEFORE anything is launched (host state
        coherent), so the step just skips the tick and the next retries
        it — one step of latency, never corruption."""
        try:
            return self._decode_dispatch()
        except InjectedFault:
            monitor.counter("serving.step_errors").increase()
            return None

    def _poison_slot(self, active: List[int]) -> None:
        """The decode.nan fault point: pick one active slot (the
        injector's Generator) and add a NaN to its sampling logits this
        tick; the finite-logits flag must fail exactly that slot. The
        vector goes up on the current stream, ahead of the dispatch."""
        if active and self._fault("decode.nan"):
            victim = active[int(
                self._injector.rng.integers(0, len(active)))]
            pz = np.zeros((self.max_slots,), np.float32)
            pz[victim] = np.nan
            self._poison_dev = self._up(pz)
            self._poisoned = True

    def _unpoison(self) -> None:
        if self._poisoned:
            self._poison_dev = None
            self._poisoned = False

    def _poison(self, logits: torch.Tensor) -> torch.Tensor:
        """``logits`` ([S, ...] f32) plus this tick's poison vector on a
        fault tick; unchanged (nothing launched) otherwise."""
        if not self._poisoned:
            return logits
        pv = self._poison_dev.view((-1,) + (1,) * (logits.dim() - 1))
        return logits + pv

    def _open_span(self, req: Request, phase: str,
                   slot: Optional[int] = None, **detail) -> None:
        """Open the request's next span at the engine clock, closing the
        one before at the same instant. A QUEUED or PREEMPTED span that
        closes into PREFILL is a queue wait
        (``serving.hist.queue_wait_ms``)."""
        t = self._clock() * 1e3
        closed = tracing.close_open(req.spans, t)
        if closed is not None:
            dur = closed["t1_ms"] - closed["t0_ms"]
            if closed["phase"] == tracing.MIGRATING:
                self._mon.histogram("serving.hist.migration_ms").record(dur)
            elif closed["phase"] in (tracing.QUEUED, tracing.PREEMPTED) \
                    and phase == tracing.PREFILL:
                self._mon.histogram("serving.hist.queue_wait_ms").record(dur)
        tracing.open_span(req.spans, phase, t, self.label, slot=slot,
                          **detail)

    # -- scheduler internals -------------------------------------------------

    def _admit(self) -> None:
        reserved = 0          # pages already promised this tick: the
        while self._waiting:  # prefills run AFTER the admit loop
            slot = next((i for i, r in enumerate(self._slots)
                         if r is None), None)
            if slot is None:
                break
            req = self._waiting[0]
            toks = req.resume_tokens()
            if self._prefix is not None and req.shared_pages is None:
                # map the longest cached prefix now (references taken,
                # so eviction cannot pull it from under the decision),
                # leaving one real token for the tail: the page the
                # request appends into stays private
                req.shared_pages, req.prefix_len = self._prefix.acquire(
                    toks, max_chunks=(len(toks) - 1) // self.page_size)
                self._mon.counter("serving.prefix_lookups").increase()
                if req.prefix_len:
                    self._mon.counter("serving.prefix_hits").increase()
            # shared pages are resident: charge the uncached tail only,
            # and under chunked prefill only its first slice
            tail = len(toks) - req.prefix_len
            if self.max_prefill_tokens_per_step is not None:
                tail = min(tail, self.max_prefill_tokens_per_step)
            need = _ceil_div(self._pbucket(tail), self.page_size)
            # the watermark reserves growth headroom for RUNNING
            # sequences; an otherwise-empty engine admits with the whole
            # pool
            busy = any(r is not None for r in self._slots)
            wm = self.watermark_pages if busy else 0
            if not self._alloc.can_alloc(need + reserved, wm):
                # reclaim idle prefix-cache pages before refusing
                short = need + reserved + wm - self._alloc.free_pages
                if self._prefix is None or \
                        self._prefix.evict(short) < short:
                    break
            reserved += need
            self._waiting.popleft()
            req.slot = slot
            req.state = PREFILL
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            self._slots[slot] = req

    def _run_prefills(self) -> List[Output]:
        """This step's prefill work over every PREFILL-state slot.
        Monolithic: each writes its whole tail in admission order.
        Chunked: each gets at most one slice, shortest remaining first,
        capped at the step budget left when its turn comes; the oldest
        always gets at least one bucket, so a flood of small prompts
        slows a long one but never starves it."""
        pending = [r for r in self._slots
                   if r is not None and r.state == PREFILL]
        budget = self.max_prefill_tokens_per_step
        if budget is None:
            order = sorted(pending, key=lambda r: r.admit_seq)
            oldest = None
        else:
            # remaining real work: a prefix hit's cached tokens never run
            order = sorted(pending, key=lambda r: (
                r.resume_len() - max(r.written, r.prefix_len), r.admit_seq))
            oldest = min(pending, key=lambda r: r.admit_seq, default=None)
        outs: List[Output] = []
        for req in order:
            cap = None
            if budget is not None:
                left = budget - self._pf_step_tokens
                if left <= 0 and req is not oldest:
                    continue
                cap = max(self.prefill_bucket, left)
            out = self._safe_prefill(req, cap)
            if out is not None:
                outs.append(out)
        return outs

    def _prefill(self, req: Request, cap: Optional[int] = None
                 ) -> Optional[Output]:
        """Write the next chunk of the request's prefix into the pools —
        the whole uncached tail, or one slice of at most ``cap`` tokens
        under chunked prefill — attended through the paged gather path
        at its start offset. The shared prefix pages acquired at
        admission land in the block table first; every page written from
        there on is private. A fresh request samples its first token on
        its final chunk; a resumed one only rebuilds its cache and draws
        no noise, so its generator continues where it stopped."""
        toks = req.resume_tokens()
        fresh = not req.generated
        P = len(toks)
        if not req.pages:
            req.pages = list(req.shared_pages or [])
            req.written = req.prefix_len   # page-aligned by construction
        start = req.written
        T = P - start
        if self.max_prefill_tokens_per_step is not None:
            limit = self.max_prefill_tokens_per_step
            if cap is not None:
                limit = min(limit, max(self.prefill_bucket, int(cap)))
            T = min(T, limit)
        final = start + T >= P
        # bucket the chunk, never past the block table (add_request
        # guarantees the REAL tokens fit; clipping only drops padding)
        pb = min(self._pbucket(T), self.max_blocks * self.page_size - start)
        # pages for REAL tokens only: block-table entries beyond them
        # stay 0, so bucket-padding writes land in the scratch page
        need = _ceil_div(start + T, self.page_size) - len(req.pages)
        if self._fault("alloc.exhausted"):
            # a simulated admission race: pool pressure, which
            # _safe_prefill turns into a budget-free requeue
            raise PoolPressure(
                f"injected pool exhaustion: sequence {req.req_id} "
                f"requested {need} page(s)")
        if need > 0:
            try:
                priv = self._alloc.alloc(need, seq=req.req_id)
            except RuntimeError:
                if self._prefix is not None:
                    self._prefix.evict(need)
                try:
                    priv = self._alloc.alloc(need, seq=req.req_id)
                except RuntimeError as e:
                    raise PoolPressure(str(e)) from e
            req.pages = req.pages + priv
        bt_row = np.zeros((1, self.max_blocks), np.int32)
        bt_row[0, :len(req.pages)] = req.pages
        prompt = np.zeros((1, pb), np.int64)
        prompt[0, :T] = toks[start:start + T]
        # one span per slice: the QUEUED (or PREEMPTED) wait closes here
        self._open_span(req, tracing.PREFILL, slot=req.slot,
                        start=int(start), tokens=int(T))
        bt_dev, prompt_dev = self._up(bt_row), self._up(prompt)
        start_dev = torch.tensor([start], dtype=torch.int64,
                                 device=self.device)
        self._fault_raise("prefill.device_error")
        poisoned = self._fault("prefill.nan")
        logits = _model_forward(self.model, prompt_dev,
                                self._inject_bt(bt_dev), start_dev)
        if self._spec is not None:
            # the same chunk into the draft pools (same pages, positions)
            self._spec.prefill(bt_dev, prompt_dev, start_dev)
        cur = logits[:, T - 1].float()                       # [1, V]
        if poisoned:
            cur = cur + float("nan")
        ok = torch.isfinite(cur).all(dim=-1)
        if fresh and final:
            p = req.params
            tok = sample_token_arrays(
                cur, self._noise([req]),
                torch.tensor([p.temperature], device=self.device),
                torch.tensor([p.top_k], device=self.device),
                torch.tensor([p.top_p], device=self.device))
            ok_h, tok_h = self._sync_timed((ok, tok))
        else:
            ok_h, = self._sync_timed((ok,))
        self._mon.counter("serving.prefill_tokens").increase(pb)
        self._mon.counter("serving.prefill_slices").increase()
        self._pf_step_tokens += pb
        if start == req.prefix_len:
            monitor.counter("serving.prefix_tokens_reused").increase(start)
        if not bool(ok_h[0]):
            # the request is quarantined: pages freed, nothing enters the
            # prefix cache, the other slots never see it
            self._mon.counter("serving.nan_quarantines").increase()
            return self._fail(req, "nan_logits")
        req.written = start + T
        if not final:
            return None       # stays PREFILL; a later step continues
        if self._prefix is not None:
            # register the prefix's full pages (the chunks matched at
            # admission are cached already)
            self._prefix.insert(toks, req.pages, P)
        if fresh:
            t = int(tok_h[0])
            req.generated.append(t)
            req.first_token_t = self._clock()
            self._mon.counter("serving.tokens").increase()
            reason = self._finish_reason(req, t)
            if reason:
                return self._finish(req, reason)
        self._activate(req)
        return None

    def _activate(self, req: Request):
        i = req.slot
        self._bt[i] = 0
        self._bt[i, :len(req.pages)] = req.pages
        self._pos[i] = req.written
        self._last[i] = req.generated[-1]
        self._temps[i] = req.params.temperature
        self._topks[i] = req.params.top_k
        self._topps[i] = req.params.top_p
        self._live[i] = 1
        self._bt_dirty = True
        self._multi_clean = False
        req.state = DECODE
        # one DECODE span from activation to finish / preemption (not one
        # a tick: the timeline stays O(lifecycle transitions))
        self._open_span(req, tracing.DECODE, slot=i)

    def _ensure_pages(self):
        """Before the decode dispatch, every active slot must own every
        page its writes land in — one position a plain tick, k+1 a
        speculative one; allocate lazily, preempting the YOUNGEST
        sequence when the pool runs dry (after evicting idle prefix-cache
        pages). Under multi-tick the horizon stretches toward
        ``multi_tick`` positions from FREE pages only (no eviction, no
        preemption): a short coverage just clamps the fused k."""
        for i in range(self.max_slots):
            req = self._slots[i]
            if req is None or req.state != DECODE:
                continue
            need = _ceil_div(req.written + self._lookahead, self.page_size)
            while len(req.pages) < need:
                page = self._alloc_or_preempt(req)
                if page is None:      # req itself got preempted
                    break
                req.pages.extend(page)
                self._bt[i, :len(req.pages)] = req.pages
                self._bt_dirty = True
        if self.multi_tick > 1 and self._spec is None:
            for i in range(self.max_slots):
                req = self._slots[i]
                if req is None or req.state != DECODE:
                    continue
                rem = int(req.params.max_new_tokens) - len(req.generated)
                want = _ceil_div(
                    req.written + min(max(rem, 1), self.multi_tick),
                    self.page_size)
                while len(req.pages) < want and \
                        self._alloc.can_alloc(1, self.watermark_pages):
                    req.pages.extend(self._alloc.alloc(1, seq=req.req_id))
                    self._bt[i, :len(req.pages)] = req.pages
                    self._bt_dirty = True

    def _alloc_or_preempt(self, req: Request):
        while True:
            try:
                if self._fault("alloc.exhausted"):
                    # simulated mid-decode pool pressure: the same
                    # evict-or-preempt ladder a real dry pool takes
                    raise RuntimeError(
                        f"injected pool exhaustion: sequence "
                        f"{req.req_id} requested 1 page")
                return self._alloc.alloc(1, seq=req.req_id)
            except RuntimeError:
                # an idle cached prefix goes before any live sequence;
                # mid-prefill requests are victims too (they sit at a
                # slice boundary)
                if self._prefix is not None and self._prefix.evict(1):
                    continue
                victims = [r for r in self._slots
                           if r is not None
                           and r.state in (DECODE, PREFILL)]
                if not victims:
                    raise
                victim = max(victims, key=lambda r: r.admit_seq)
                self._preempt(victim)
                if victim is req:
                    return None

    def extract_request(self, req_id: int,
                        device_key: bool = False) -> Optional[Request]:
        """Remove a live request from this engine whole — slot cleared,
        pages freed, dropped from the queue and the request table — and
        return it (prompt, tokens generated so far, sampling params, its
        generator), ready for re-admission elsewhere through the
        preemption / resume-prefill path: another Engine over the same
        weights takes it in with ``readmit``, and the token stream
        continues bit for bit, greedy and sampled.
        The state becomes PREEMPTED when tokens were generated (a resume
        prefill rebuilds the cache from them), else WAITING; a MIGRATING
        span opens, closed by the destination's next span. Returns None
        for unknown or retired ids.

        Every step harvests its tokens before it returns, so between
        steps the generator has made exactly one draw per generated token
        of a sampled request (a speculative tick resets it to its
        accepted draws), and it leaves in that state. ``device_key`` is
        the JAX engine's switch for fetching the rng key from the device;
        the generator lives on the request here, so only False, the
        caller-sets-the-state contract, is taken."""
        if device_key:
            raise ValueError(
                "device_key=True reads a device-side rng key; the port "
                "keeps each request's torch.Generator on the request: "
                "pass device_key=False")
        req = self.requests.get(int(req_id))
        if req is None or req.state in (FINISHED, FAILED):
            return None
        self._clear_slot(req)
        try:
            self._waiting.remove(req)
        except ValueError:
            pass
        self.requests.pop(req.req_id, None)
        req.state = PREEMPTED if req.generated else WAITING
        # the open span (QUEUED / PREFILL / DECODE / PREEMPTED) closes
        # here; origin stays this engine's label
        self._open_span(req, tracing.MIGRATING)
        return req

    def readmit(self, req: Request, waited_steps: int = 0) -> None:
        """Take in a request another engine gave up whole
        (``extract_request``, or a snapshot's entry): it joins the back of
        the waiting queue and the request table, with ``waited_steps`` of
        its queue-age budget already spent, and resumes through the
        preemption / resume-prefill path."""
        if req.req_id in self.requests:
            raise ValueError(f"request id {req.req_id} is already live on "
                             f"this engine")
        req.queued_step = self._steps - int(waited_steps)
        self.requests[req.req_id] = req
        self._waiting.append(req)

    def _preempt(self, req: Request):
        """Evict back to the front of the waiting queue: pages freed,
        tokens and generator kept — a resume prefill rebuilds the
        cache."""
        self._mon.counter("serving.preemptions").increase()
        req.preemptions += 1
        self._open_span(req, tracing.PREEMPTED, kind="pages")
        self._clear_slot(req)
        req.state = PREEMPTED if req.generated else WAITING
        req.queued_step = self._steps       # a fresh queue-age budget
        self._waiting.appendleft(req)

    def _decode_dispatch(self) -> Optional[_PendingTick]:
        """Queue this step's decode work and return without waiting: a
        speculative draft/verify tick, a fused multi-tick stretch, or one
        [max_slots] single-token forward (idle lanes at cache index -1)
        plus per-slot sampling in the cheapest variant the active slots
        need. Only the tokens and NaN flags come back, at harvest."""
        active = [i for i in range(self.max_slots)
                  if self._slots[i] is not None
                  and self._slots[i].state == DECODE]
        if not active:
            return None
        sampling = [i for i in active if self._temps[i] > 0.0]
        if not sampling:
            variant = "greedy"
        elif any(self._topks[i] > 0 or 0.0 < self._topps[i] < 1.0
                 for i in sampling):
            variant = "filtered"
        else:
            variant = "plain"
        # an injected device loss fires BEFORE anything is launched or
        # any generator drawn: _safe_decode skips the tick
        self._fault_raise("decode.device_error")
        self._poison_slot(active)
        snap = [(i, self._slots[i]) for i in active]
        self._flush_bt()
        if self._spec is not None:
            if self.multi_tick > 1:
                # speculation owns the horizon: every dispatch of a
                # multi_tick config is counted as an exclusion
                self._mon.counter("serving.multi_tick.clamp.spec").increase()
            return self._dispatch_spec(snap, variant)
        mk = self._multi_k(active, variant)
        if mk > 1:
            return self._dispatch_multi(snap, mk)
        idx = np.where(self._live > 0, self._pos, -1)
        logits = _model_forward(self.model, self._up(self._last)[:, None],
                                self._inject_bt(self._bt_dev),
                                self._up(idx))
        cur = self._poison(logits[:, -1].float())
        self._unpoison()
        ok = torch.isfinite(cur).all(dim=-1)
        if variant == "greedy":
            nxt = torch.argmax(cur, dim=-1)
        else:
            rows = [self._slots[i] if i in active else None
                    for i in range(self.max_slots)]
            nxt = sample_token_arrays(
                cur, self._noise(rows), self._up(self._temps),
                self._up(self._topks), self._up(self._topps),
                use_filters=variant == "filtered")
        self._ticks += 1
        return _PendingTick(kind="single", data=(nxt, ok), active=snap,
                            t_dispatch=time.perf_counter(),
                            dev_mark=self._device_s)

    def _multi_k(self, active: List[int], variant: str) -> int:
        """Eligibility ladder and clamp of the fused multi-tick decode:
        only when every live slot is in a greedy stretch with nothing
        pending host-side (greedy variant, nothing waiting, no slot
        mid-prefill, no draft model, no NaN armed for this tick — the
        quarantine must land on the tick single-tick decoding gives it).
        k is clamped to the longest remaining budget (shorter rows
        freeze in the loop), to the tightest allocated page coverage (no
        allocator inside the loop) and to the nearest deadline
        (``_deadline_ticks``), then rounded DOWN to a bucket."""
        K = self.multi_tick
        if (K <= 1 or self._spec is not None or variant != "greedy"
                or self._waiting or self._poisoned
                or self.num_prefilling):
            return 1
        horizon = 0      # longest remaining budget over live rows
        cov = None       # tightest allocated-page coverage
        for i in active:
            req = self._slots[i]
            horizon = max(horizon, int(req.params.max_new_tokens)
                          - len(req.generated))
            c = len(req.pages) * self.page_size - req.written
            cov = c if cov is None else min(cov, c)
        k = K
        if horizon < k:
            k = horizon
            self._mon.counter("serving.multi_tick.clamp.max_new").increase()
        if cov is not None and cov < k:
            k = cov
            self._mon.counter("serving.multi_tick.clamp.pages").increase()
        dl = self._deadline_ticks(active)
        if dl < k:
            k = dl
            self._mon.counter(
                "serving.multi_tick.clamp.deadline").increase()
        if k < 2:
            return 1
        return self._multi_bucket(k)

    def _deadline_ticks(self, active: List[int]) -> int:
        """Ticks until the nearest active deadline, in units of the
        device-tick EWMA on the injectable clock (``_tick_est_ms``): the
        deadline leg of the multi-tick clamp. ``multi_tick`` when no slot
        has a deadline or no estimate exists yet; a slot that still
        overshoots is expired by ``_expire`` on the next step."""
        est = self._tick_est_ms
        if est <= 0.0:
            return self.multi_tick
        ticks = self.multi_tick
        now = None
        for i in active:
            req = self._slots[i]
            dl = req.params.deadline_ms
            if dl is None:
                continue
            if now is None:
                now = self._clock()
            left = float(dl) - (now - req.arrival_t) * 1e3
            ticks = min(ticks, int(left // est))
        return max(1, ticks)

    def _multi_bucket(self, k: int) -> int:
        """Largest bucket <= k: powers of two, plus ``multi_tick`` itself
        (a bounded set of captured graphs whatever the clamps do)."""
        best = 2
        b = 2
        while b * 2 <= k:
            b *= 2
            best = b
        if self.multi_tick <= k:
            best = max(best, self.multi_tick)
        return best

    def _dispatch_multi(self, snap, k: int) -> _PendingTick:
        """Queue one fused k-tick stretch. The buffers (last tokens,
        positions, live flags, eos ids, remaining budgets) stay on the
        device between fused dispatches and are uploaded again only after
        a host-side change."""
        if not self._multi_clean:
            eos = np.full((self.max_slots,), -1, np.int64)
            bud = np.zeros((self.max_slots,), np.int64)
            for i, req in snap:
                p = req.params
                if p.eos_token_id is not None:
                    eos[i] = int(p.eos_token_id)
                bud[i] = int(p.max_new_tokens) - len(req.generated)
            self._multi.load(self._last, self._pos, self._live, eos, bud)
            self._multi_clean = True
        toks, oks = self._multi.run(k)
        self._ticks += k
        self._mon.counter("serving.multi_tick.dispatches").increase()
        self._mon.counter("serving.multi_tick.ticks").increase(k)
        return _PendingTick(kind="multi", data=(toks, oks), active=snap,
                            t_dispatch=time.perf_counter(),
                            dev_mark=self._device_s, ticks=k, k=k)

    def _dispatch_spec(self, snap, variant: str) -> _PendingTick:
        """Queue one draft/verify tick: the draft proposes k tokens a
        slot, the target scores all k+1 positions in ONE [S, k+1] forward
        (paged gather path) and ``verify_token_arrays`` walks them. A
        sampled row draws k+1 noise rows from its generator, keeping the
        generator's state after each, so the harvest leaves it exactly
        accepted+1 draws on."""
        k, V = self._spec.k, self.vocab_size
        last, pos, live = (self._up(self._last), self._up(self._pos),
                           self._up(self._live))
        drafts = self._spec.draft(self._bt_dev, last, pos, live)
        if self._fault("spec.disagree"):
            # a draft/target divergence storm: exact-match verification
            # must reject the garbage with the emitted stream unchanged
            drafts = self._spec.sabotage(drafts)
        idx = torch.where(live > 0, pos, torch.full_like(pos, -1))
        logits = _model_forward(self.model,
                                torch.cat([last[:, None], drafts], dim=1),
                                self._inject_bt(self._bt_dev), idx)
        scored = self._poison(logits.float())
        self._unpoison()
        ok = torch.isfinite(scored).all(dim=2).all(dim=1)
        noise, states = None, {}
        if variant != "greedy":
            noise = torch.zeros((self.max_slots, k + 1, V),
                                dtype=torch.float32, device=self.device)
            for i, req in snap:
                if req.params.temperature > 0:
                    st = []
                    for j in range(k + 1):
                        noise[i, j] = gumbel_noise(V, req.generator,
                                                   self.device)
                        st.append(req.generator.get_state())
                    states[i] = st
        toks, acc = verify_token_arrays(
            scored, drafts, noise, self._up(self._temps),
            self._up(self._topks), self._up(self._topps),
            use_filters=variant == "filtered", greedy=variant == "greedy")
        self._ticks += 1
        return _PendingTick(kind="spec", data=(toks, acc, ok), active=snap,
                            t_dispatch=time.perf_counter(),
                            dev_mark=self._device_s, k=k, gen_states=states)

    def _decode_harvest(self, pend: Optional[_PendingTick]
                        ) -> List[Output]:
        """Fetch the queued dispatch's tokens and retire its rows."""
        if pend is None:
            return []
        host = self._sync_timed(pend.data, pend.t_dispatch, pend.dev_mark)
        if pend.kind == "multi":
            return self._harvest_multi(pend, *host)
        if pend.kind == "spec":
            return self._harvest_spec(pend, *host)
        return self._harvest_single(pend, *host)

    def _emit(self, req: Request, tok: int) -> Optional[str]:
        """Append one decoded token (the tick wrote the previous one)
        and return its finish reason, if any."""
        req.written += 1
        req.generated.append(tok)
        if req.first_token_t == 0.0:      # a restored request's first
            req.first_token_t = self._clock()
        self._mon.counter("serving.tokens").increase()
        return self._finish_reason(req, tok)

    def _harvest_single(self, pend, nxt, okv) -> List[Output]:
        self._multi_clean = False
        outs: List[Output] = []
        for i, req in pend.active:
            if self._slots[i] is not req or req.state != DECODE:
                continue
            if not bool(okv[i]):
                # NaN/inf logits on THIS slot only: retire it, every
                # other lane keeps decoding
                self._mon.counter("serving.nan_quarantines").increase()
                outs.append(self._fail(req, "nan_logits"))
                continue
            tok = int(nxt[i])
            reason = self._emit(req, tok)
            self._pos[i] = req.written
            self._last[i] = tok
            if reason:
                outs.append(self._finish(req, reason))
        return outs

    def _harvest_multi(self, pend, toks, oks) -> List[Output]:
        """Walk the fused stretch's [S, k] tokens and ok flags exactly as
        k single harvests would: append until the row's eos or length
        exit (the condition that froze it in the loop), fail the slot at
        its first not-ok tick keeping the tokens before it."""
        outs: List[Output] = []
        exited = False
        for i, req in pend.active:
            if self._slots[i] is not req or req.state != DECODE:
                continue
            done = False
            for j in range(pend.k):
                if not bool(oks[i, j]):
                    self._mon.counter("serving.nan_quarantines").increase()
                    self._mon.counter(
                        "serving.multi_tick.scan_exit.nan_logits").increase()
                    outs.append(self._fail(req, "nan_logits"))
                    done = True
                    break
                tok = int(toks[i, j])
                reason = self._emit(req, tok)
                self._pos[i] = req.written
                self._last[i] = tok
                if reason:
                    self._mon.counter(
                        "serving.multi_tick.scan_exit." + reason).increase()
                    outs.append(self._finish(req, reason))
                    done = True
                    break
            if done:
                exited = True
            else:
                # the open DECODE stint records its fused progress
                tracing.bump_open(req.spans, tracing.DECODE,
                                  multi_ticks=pend.k, multi_dispatches=1)
        if not exited:
            self._mon.counter(
                "serving.multi_tick.scan_exit.horizon").increase()
        return outs

    def _harvest_spec(self, pend, toks, acc, okv) -> List[Output]:
        self._multi_clean = False
        k = pend.k
        outs: List[Output] = []
        for i, req in pend.active:
            if self._slots[i] is not req or req.state != DECODE:
                continue
            if not bool(okv[i]):
                self._mon.counter("serving.nan_quarantines").increase()
                outs.append(self._fail(req, "nan_logits"))
                continue
            n_acc = int(acc[i])
            if i in pend.gen_states:
                req.generator.set_state(pend.gen_states[i][n_acc])
            self._spec_drafted += k
            self._spec_accepted += n_acc
            monitor.counter("serving.spec_drafted").increase(k)
            monitor.counter("serving.spec_accepted").increase(n_acc)
            for j in range(n_acc + 1):
                reason = self._emit(req, int(toks[i, j]))
                if reason:
                    # mid-chain eos or budget: the rest of the chain is
                    # dropped, as plain decoding never produced it
                    outs.append(self._finish(req, reason))
                    break
            else:
                self._pos[i] = req.written
                self._last[i] = req.generated[-1]
        return outs

    def _finish_reason(self, req: Request, tok: int) -> Optional[str]:
        p = req.params
        if p.eos_token_id is not None and tok == int(p.eos_token_id):
            return "eos"
        if len(req.generated) >= int(p.max_new_tokens):
            return "length"
        return None

    def _clear_slot(self, req: Request):
        i = req.slot
        if i is not None:
            self._bt[i] = 0
            self._pos[i] = 0
            self._last[i] = 0
            self._temps[i] = 0.0
            self._topks[i] = 0
            self._topps[i] = 0.0
            self._live[i] = 0
            self._slots[i] = None
            self._bt_dirty = True
            self._multi_clean = False
            req.slot = None
        if req.pages:
            # one reference each: private pages return to the free list,
            # shared prefix pages live on under the cache's reference
            self._alloc.free(req.pages)
            req.pages = []
        elif req.shared_pages:
            # prefix references taken at admission, never merged into
            # pages (preempted before its first slice)
            self._alloc.free(req.shared_pages)
        req.shared_pages = None
        req.prefix_len = 0
        req.written = 0

    def _finish(self, req: Request, reason: str) -> Output:
        self._mon.counter("serving.finished").increase()
        return self._retire(req, reason, FINISHED)

    def _fail(self, req: Request, reason: str) -> Output:
        """Terminal FAILED(reason): the request is retired now — slot
        cleared, pages freed, out of the queue — and surfaces as an
        Output with ``error`` set; every other request keeps serving."""
        self._mon.counter("serving.failed").increase()
        return self._retire(req, reason, FAILED)

    def _retire(self, req: Request, reason: str, state: str) -> Output:
        queued = req.state in (WAITING, PREEMPTED)
        req.finish_t = self._clock()
        req.state = state
        req.finish_reason = reason
        if queued:
            self._waiting.remove(req)     # failed while queued
        self._clear_slot(req)         # pages freed NOW, not end-of-call
        self.requests.pop(req.req_id, None)
        n = len(req.generated)
        got_first = req.first_token_t > 0.0
        ttft_ms = ((req.first_token_t - req.arrival_t) * 1e3
                   if got_first else 0.0)
        tpot_ms = ((req.finish_t - req.first_token_t) / (n - 1) * 1e3
                   if got_first and n > 1 else 0.0)
        if got_first:
            self._mon.gauge("serving.ttft_ms").set(ttft_ms)
            self._mon.histogram("serving.hist.ttft_ms").record(ttft_ms)
        if got_first and n > 1:
            self._mon.gauge("serving.tpot_ms").set(tpot_ms)
            self._mon.histogram("serving.hist.tpot_ms").record(tpot_ms)
        # the terminal span, sealed at finish_t; the Output carries its
        # own copy of the timeline
        tracing.seal(req.spans,
                     tracing.FINISHED if state == FINISHED
                     else tracing.FAILED,
                     req.finish_t * 1e3, self.label,
                     reason=None if state == FINISHED else reason)
        return Output(req_id=req.req_id, prompt_ids=list(req.prompt),
                      token_ids=list(req.generated), finish_reason=reason,
                      ttft_ms=ttft_ms, tpot_ms=tpot_ms,
                      preemptions=req.preemptions,
                      error=None if state == FINISHED else reason,
                      spans=tracing.copy_spans(req.spans))

    def _publish_gauges(self):
        mon = self._mon
        mon.gauge("serving.slots_active").set(self.num_active)
        mon.gauge("serving.pages_free").set(self._alloc.free_pages)
        mon.gauge("serving.queue_depth").set(len(self._waiting))
        mon.gauge("serving.prefill_tokens_per_step").set(
            self._pf_step_tokens)
        if self._prefix is not None:
            mon.gauge("serving.prefix_hit_rate").set(self._prefix.hit_rate)
            mon.gauge("serving.prefix_pages_shared").set(
                self._alloc.shared_pages)
        if self._spec is not None and self._spec_drafted:
            mon.gauge("serving.spec_accept_rate").set(self.spec_accept_rate)
