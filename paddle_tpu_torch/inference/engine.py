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

Left out of this slice, each raising NotImplementedError: fault
injection, deadlines / queue timeouts and cancel (and with them the
multi-tick deadline clamp), snapshot/restore, span tracing (labels) and
mesh/TP.

``monitor`` surface: counters ``serving.requests`` / ``serving.tokens``
/ ``serving.finished`` / ``serving.failed`` / ``serving.preemptions`` /
``serving.steps`` / ``serving.prefill_tokens`` /
``serving.prefill_slices`` / ``serving.prefix_{lookups,hits,
tokens_reused}`` / ``serving.spec_{drafted,accepted}`` /
``serving.multi_tick.{dispatches,ticks,warmup_ticks}`` /
``serving.multi_tick.clamp.{max_new,pages,spec}`` /
``serving.multi_tick.scan_exit.{eos,length,nan_logits,horizon}``;
gauges ``serving.slots_active`` / ``serving.pages_free`` /
``serving.queue_depth`` / ``serving.ttft_ms`` / ``serving.tpot_ms`` /
``serving.prefill_tokens_per_step`` / ``serving.prefix_hit_rate`` /
``serving.prefix_pages_shared`` / ``serving.spec_accept_rate`` /
``serving.multi_tick.ticks_per_dispatch`` /
``serving.{host,device}_ms_per_tick`` (a step's wall time, split at the
host's waits for device results; histograms ``serving.hist.*`` too).
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
from ..kernels.paged_attention import paged_kernel_requirements
from ..text.generation import (_model_forward, _resolve_cache_dtype,
                               gumbel_noise, sample_token_arrays,
                               verify_token_arrays)
from .allocator import PageAllocator
from .prefix_cache import PrefixCache

# request lifecycle states
WAITING = "WAITING"
PREFILL = "PREFILL"
DECODE = "DECODE"
FINISHED = "FINISHED"
PREEMPTED = "PREEMPTED"
FAILED = "FAILED"

_LATER = "a later serving slice of the port"


class PoolPressure(RuntimeError):
    """A prefill slice could not get pages (pool dry after eviction):
    the request goes back to the queue and retries; running sequences
    finishing or being preempted free the pages it waits for."""


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
    deadline_ms: Optional[float] = None
    max_queue_steps: Optional[int] = None

    def validate(self):
        if int(self.max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if float(self.temperature) < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.deadline_ms is not None or self.max_queue_steps is not None:
            raise NotImplementedError(
                f"deadline_ms / max_queue_steps come with {_LATER}")


@dataclass
class Output:
    """One retired request: the generated continuation (including the
    eos token when one was emitted) plus serving latencies. A FAILED
    request (NaN logits) surfaces here too, with ``error`` set."""

    req_id: int
    prompt_ids: List[int]
    token_ids: List[int]
    finish_reason: str            # "eos" | "length" | failure reason
    ttft_ms: float                # arrival -> first token
    tpot_ms: float                # mean inter-token latency after that
    preemptions: int = 0
    error: Optional[str] = None   # None iff the request FINISHED

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
    arrival_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    finish_reason: Optional[str] = None

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
    left DECODE in between), and what the harvest needs of its kind."""

    kind: str                 # "single" | "multi" | "spec"
    data: tuple
    active: list
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
                 label: Optional[str] = None):
        unsupported = [
            ("fault_injector", fault_injector not in (None, False)),
            ("clock (deadlines)", clock is not None),
            ("label (span tracing)", label is not None),
        ]
        for knob, on in unsupported:
            if on:
                raise NotImplementedError(f"Engine {knob} comes with {_LATER}")
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

    def _fetch(self, *ts):
        """Device -> host numpy copies, the wait charged to the step's
        device share (``serving.device_ms_per_tick``)."""
        t0 = time.perf_counter()
        out = [t.cpu().numpy() for t in ts]
        self._device_s += time.perf_counter() - t0
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
                      generator=gen, arrival_t=time.perf_counter())
        self._next_id += 1
        self._waiting.append(req)
        monitor.counter("serving.requests").increase()
        return rid

    def step(self) -> List[Output]:
        """One scheduler tick: queue the decode work for the slots the
        last step settled, admit and prefill new requests while the
        device works, harvest the tokens (retiring finished requests),
        then grow pages for the next dispatch. Returns the requests that
        finished or failed during this tick. Under ``multi_tick`` one
        step may cover up to k device ticks."""
        outputs: List[Output] = []
        wall0 = time.perf_counter()
        self._device_s = 0.0
        with torch.no_grad():
            pending = self._decode_dispatch()
            self._pf_step_tokens = 0
            self._admit()
            outputs.extend(self._run_prefills())
            outputs.extend(self._decode_harvest(pending))
            self._ensure_pages()
        if self._moe_layer is not None:
            self._republish_moe_paths()
        monitor.counter("serving.steps").increase()
        self._publish_gauges()
        wall_ms = (time.perf_counter() - wall0) * 1e3
        dev_ms = min(self._device_s * 1e3, wall_ms)
        for name, v in (("host", wall_ms - dev_ms), ("device", dev_ms)):
            monitor.gauge(f"serving.{name}_ms_per_tick").set(v)
            monitor.histogram(f"serving.hist.{name}_ms_per_tick").record(v)
        if pending is not None and self.multi_tick > 1:
            monitor.gauge("serving.multi_tick.ticks_per_dispatch").set(
                pending.ticks)
        self._steps += 1
        return outputs

    def run(self, requests: Sequence, max_steps: int = 100_000
            ) -> List[Output]:
        """Offline serving: queue every (ids, SamplingParams) pair — bare
        ids get default params — then step until all finish. Returns
        Outputs ordered by request id."""
        ids_list = []
        for item in requests:
            if isinstance(item, (tuple, list)) and len(item) == 2 and \
                    isinstance(item[1], (SamplingParams, dict)):
                ids_list.append(self.add_request(item[0], item[1]))
            else:
                ids_list.append(self.add_request(item))
        want = set(ids_list)
        outs: List[Output] = []
        for _ in range(max_steps):
            outs.extend(o for o in self.step() if o.req_id in want)
            if len(outs) == len(want):
                break
        else:
            raise RuntimeError(
                f"engine did not drain in {max_steps} steps "
                f"({len(outs)}/{len(want)} finished)")
        return sorted(outs, key=lambda o: o.req_id)

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
                monitor.counter("serving.prefix_lookups").increase()
                if req.prefix_len:
                    monitor.counter("serving.prefix_hits").increase()
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
            try:
                out = self._prefill(req, cap)
            except PoolPressure:
                # admission charged only the first slice: a dry pool
                # mid-prompt waits, back in the queue, for pages
                self._clear_slot(req)
                req.state = PREEMPTED if req.generated else WAITING
                self._waiting.appendleft(req)
                out = None
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
        bt_dev, prompt_dev = self._up(bt_row), self._up(prompt)
        start_dev = torch.tensor([start], dtype=torch.int64,
                                 device=self.device)
        logits = _model_forward(self.model, prompt_dev,
                                self._inject_bt(bt_dev), start_dev)
        if self._spec is not None:
            # the same chunk into the draft pools (same pages, positions)
            self._spec.prefill(bt_dev, prompt_dev, start_dev)
        cur = logits[:, T - 1].float()                       # [1, V]
        ok = torch.isfinite(cur).all(dim=-1)
        if fresh and final:
            p = req.params
            tok = sample_token_arrays(
                cur, self._noise([req]),
                torch.tensor([p.temperature], device=self.device),
                torch.tensor([p.top_k], device=self.device),
                torch.tensor([p.top_p], device=self.device))
            ok_h, tok_h = self._fetch(ok, tok)
        else:
            ok_h, = self._fetch(ok)
        monitor.counter("serving.prefill_tokens").increase(pb)
        monitor.counter("serving.prefill_slices").increase()
        self._pf_step_tokens += pb
        if start == req.prefix_len:
            monitor.counter("serving.prefix_tokens_reused").increase(start)
        if not bool(ok_h[0]):
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
            req.first_token_t = time.perf_counter()
            monitor.counter("serving.tokens").increase()
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

    def _preempt(self, req: Request):
        """Evict back to the front of the waiting queue: pages freed,
        tokens and generator kept — a resume prefill rebuilds the
        cache."""
        monitor.counter("serving.preemptions").increase()
        req.preemptions += 1
        self._clear_slot(req)
        req.state = PREEMPTED if req.generated else WAITING
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
        snap = [(i, self._slots[i]) for i in active]
        self._flush_bt()
        if self._spec is not None:
            if self.multi_tick > 1:
                # speculation owns the horizon: every dispatch of a
                # multi_tick config is counted as an exclusion
                monitor.counter("serving.multi_tick.clamp.spec").increase()
            return self._dispatch_spec(snap, variant)
        mk = self._multi_k(active, variant)
        if mk > 1:
            return self._dispatch_multi(snap, mk)
        idx = np.where(self._live > 0, self._pos, -1)
        logits = _model_forward(self.model, self._up(self._last)[:, None],
                                self._inject_bt(self._bt_dev),
                                self._up(idx))
        cur = logits[:, -1].float()
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
        return _PendingTick(kind="single", data=(nxt, ok), active=snap)

    def _multi_k(self, active: List[int], variant: str) -> int:
        """Eligibility ladder and clamp of the fused multi-tick decode:
        only when every live slot is in a greedy stretch with nothing
        pending host-side (greedy variant, nothing waiting, no slot
        mid-prefill, no draft model). k is clamped to the longest
        remaining budget (shorter rows freeze in the loop) and to the
        tightest allocated page coverage (no allocator inside the loop),
        then rounded DOWN to a bucket. (Deadlines, and with them the
        JAX engine's deadline clamp, come with a later slice.)"""
        K = self.multi_tick
        if (K <= 1 or self._spec is not None or variant != "greedy"
                or self._waiting or self.num_prefilling):
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
            monitor.counter("serving.multi_tick.clamp.max_new").increase()
        if cov is not None and cov < k:
            k = cov
            monitor.counter("serving.multi_tick.clamp.pages").increase()
        if k < 2:
            return 1
        return self._multi_bucket(k)

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
        monitor.counter("serving.multi_tick.dispatches").increase()
        monitor.counter("serving.multi_tick.ticks").increase(k)
        return _PendingTick(kind="multi", data=(toks, oks), active=snap,
                            ticks=k, k=k)

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
        idx = torch.where(live > 0, pos, torch.full_like(pos, -1))
        logits = _model_forward(self.model,
                                torch.cat([last[:, None], drafts], dim=1),
                                self._inject_bt(self._bt_dev), idx)
        scored = logits.float()
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
                            k=k, gen_states=states)

    def _decode_harvest(self, pend: Optional[_PendingTick]
                        ) -> List[Output]:
        """Fetch the queued dispatch's tokens and retire its rows."""
        if pend is None:
            return []
        host = self._fetch(*pend.data)
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
        monitor.counter("serving.tokens").increase()
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
            for j in range(pend.k):
                if not bool(oks[i, j]):
                    monitor.counter(
                        "serving.multi_tick.scan_exit.nan_logits").increase()
                    outs.append(self._fail(req, "nan_logits"))
                    exited = True
                    break
                tok = int(toks[i, j])
                reason = self._emit(req, tok)
                self._pos[i] = req.written
                self._last[i] = tok
                if reason:
                    monitor.counter(
                        "serving.multi_tick.scan_exit." + reason).increase()
                    outs.append(self._finish(req, reason))
                    exited = True
                    break
        if not exited:
            monitor.counter("serving.multi_tick.scan_exit.horizon").increase()
        return outs

    def _harvest_spec(self, pend, toks, acc, okv) -> List[Output]:
        self._multi_clean = False
        k = pend.k
        outs: List[Output] = []
        for i, req in pend.active:
            if self._slots[i] is not req or req.state != DECODE:
                continue
            if not bool(okv[i]):
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
        monitor.counter("serving.finished").increase()
        return self._retire(req, reason, FINISHED)

    def _fail(self, req: Request, reason: str) -> Output:
        monitor.counter("serving.failed").increase()
        return self._retire(req, reason, FAILED)

    def _retire(self, req: Request, reason: str, state: str) -> Output:
        req.finish_t = time.perf_counter()
        req.state = state
        req.finish_reason = reason
        self._clear_slot(req)         # pages freed NOW, not end-of-call
        n = len(req.generated)
        got_first = req.first_token_t > 0.0
        ttft_ms = ((req.first_token_t - req.arrival_t) * 1e3
                   if got_first else 0.0)
        tpot_ms = ((req.finish_t - req.first_token_t) / (n - 1) * 1e3
                   if got_first and n > 1 else 0.0)
        if got_first:
            monitor.gauge("serving.ttft_ms").set(ttft_ms)
        if got_first and n > 1:
            monitor.gauge("serving.tpot_ms").set(tpot_ms)
        return Output(req_id=req.req_id, prompt_ids=list(req.prompt),
                      token_ids=list(req.generated), finish_reason=reason,
                      ttft_ms=ttft_ms, tpot_ms=tpot_ms,
                      preemptions=req.preemptions,
                      error=None if state == FINISHED else reason)

    def _publish_gauges(self):
        monitor.gauge("serving.slots_active").set(self.num_active)
        monitor.gauge("serving.pages_free").set(self._alloc.free_pages)
        monitor.gauge("serving.queue_depth").set(len(self._waiting))
        monitor.gauge("serving.prefill_tokens_per_step").set(
            self._pf_step_tokens)
        if self._prefix is not None:
            monitor.gauge("serving.prefix_hit_rate").set(
                self._prefix.hit_rate)
            monitor.gauge("serving.prefix_pages_shared").set(
                self._alloc.shared_pages)
        if self._spec is not None and self._spec_drafted:
            monitor.gauge("serving.spec_accept_rate").set(
                self.spec_accept_rate)
