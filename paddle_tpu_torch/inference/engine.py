"""paddle_tpu_torch.inference.engine — in-process continuous batching.

Counterpart of ``paddle_tpu/inference/engine.py``, trimmed to the
serving main path:

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
* Monolithic bucketed prefill: the prompt padded to a ``prefill_bucket``
  multiple, written into the pools through the paged gather path, the
  first token sampled from its last real position.
* The fused ``[max_slots]`` decode tick: one single-token forward over
  every slot — the CUDA paged-decode kernel on the GPU — plus per-slot
  sampling in one of three variants (all-greedy argmax, no-filter,
  full-filter). Idle lanes ride at cache index -1 (context 0: dead slots
  for the kernel).
* Page growth before each tick, preempting the YOUNGEST sequence when
  the pool runs dry (``_ensure_pages``).

The step order is the JAX engine's: dispatch the decode tick for the
slots settled by the last step, then admit and prefill, then harvest
the tick's tokens, then grow pages for the next tick. PyTorch queues the
tick's kernels and returns, so admission and prefill host work overlap
the device's decode.

The pools are updated IN PLACE (the JAX engine donates them to its
executables). Sampling draws Gumbel noise from each request's own
``torch.Generator`` (seeded by ``SamplingParams.seed``), only for rows
with temperature > 0, so a request's sampled tokens do not depend on
its slot or on its batch-mates; greedy rows consume nothing.

MoE models (ERNIE-MoE) serve like dense ones: the model runs its MoE
blocks in decode mode under a cache (no capacity drops, idle lanes
masked), and the engine reports which dispatch they ran
(``moe_decode_path()``, ``serving.moe.decode_path.*``).

Left out of this slice, each knob raising NotImplementedError: prefix
cache, speculative decoding, chunked prefill, multi-tick decode, fault
injection, deadlines / queue timeouts and cancel, snapshot/restore, span
tracing (labels) and mesh/TP.

``monitor`` surface: counters ``serving.requests`` / ``serving.tokens``
/ ``serving.finished`` / ``serving.failed`` / ``serving.preemptions`` /
``serving.steps`` / ``serving.prefill_tokens`` /
``serving.prefill_slices``, gauges
``serving.slots_active`` / ``serving.pages_free`` /
``serving.queue_depth`` / ``serving.ttft_ms`` / ``serving.tpot_ms``.
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
                               gumbel_noise, sample_token_arrays)
from .allocator import PageAllocator

# request lifecycle states
WAITING = "WAITING"
PREFILL = "PREFILL"
DECODE = "DECODE"
FINISHED = "FINISHED"
PREEMPTED = "PREEMPTED"
FAILED = "FAILED"

_LATER = "a later serving slice of the port"


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
    head-major layout kernels/paged_attention.py expects."""
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    return [
        (z(rows, hkv, page_size, hd), z(rows, hkv, page_size, hd))
        + ((z(rows, hkv, page_size, dt=torch.float32),
            z(rows, hkv, page_size, dt=torch.float32)) if quant else ())
        for _ in range(layers)]


@dataclass
class _PendingTick:
    """One queued decode tick: the device outputs to fetch and the
    (slot, request) pairs it covered (harvest skips rows whose request
    left DECODE in between)."""

    data: tuple
    active: list


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
    model must live on that device. On ``cuda`` the constructor checks
    that the decode kernel takes the pool geometry and launches the
    kernel library's probe once.
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
                 max_prefill_tokens_per_step: Optional[int] = None,
                 multi_tick: int = 1,
                 fault_injector=None,
                 clock=None,
                 label: Optional[str] = None):
        unsupported = [
            ("prefix_cache", prefix_cache),
            ("draft_model (speculative decoding)", draft_model is not None),
            ("max_prefill_tokens_per_step (chunked prefill)",
             max_prefill_tokens_per_step is not None),
            ("multi_tick > 1", int(multi_tick) != 1),
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
        try:
            fsig = inspect.signature(model.forward)
        except (TypeError, ValueError):
            fsig = None
        if fsig is None or "kv_caches" not in fsig.parameters:
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
        self.max_context = int(max_context or spec["max_context"])
        self.max_blocks = _ceil_div(self._pbucket(self.max_context),
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
        self._bt_dev = self._up(self._bt)
        self._bt_dirty = False
        self._slots: List[Optional[Request]] = [None] * S
        self._waiting: "deque[Request]" = deque()
        self._next_id = 0
        self._admit_counter = 0
        self._steps = 0
        self._ticks = 0

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
        return {k[len(prefix):]: int(v) for k, v in monitor.snapshot().items()
                if k.startswith(prefix)}

    def _republish_moe_paths(self) -> None:
        """Mirror this step's ``kernels.moe.decode_path.*`` deltas (one per
        MoE layer per prefill chunk or decode tick) into
        ``serving.moe.decode_path.*`` and ``moe_decode_path()``."""
        now = self._moe_counters()
        for suffix, val in now.items():
            delta = val - self._moe_seen.get(suffix, 0)
            if delta > 0:
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

    def _pbucket(self, n: int) -> int:
        return _ceil_div(n, self.prefill_bucket) * self.prefill_bucket

    def _lifetime_pages(self, plen: int, max_new: int) -> int:
        """Peak page demand of a request over its whole lifetime (the
        can-it-ever-be-scheduled admission check): the bucketed whole
        need, as monolithic prefill pads it."""
        return _ceil_div(self._pbucket(plen + max_new), self.page_size)

    def _inject_bt(self, bt):
        """Pool tuples -> the model's per-layer paged cache tuples
        (k, v, bt[, ks, vs]): the block table is engine state shared by
        every layer."""
        return [(c[0], c[1], bt) + tuple(c[2:]) for c in self._pools]

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
        cap = self.max_blocks * self.page_size
        if self._pbucket(need) > cap:
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
        """One scheduler tick: queue the decode tick for the slots the
        last step settled, admit and prefill new requests while the
        device works, harvest the tick's tokens (retiring finished
        requests), then grow pages for the next tick. Returns the
        requests that finished or failed during this tick."""
        outputs: List[Output] = []
        with torch.no_grad():
            pending = self._decode_dispatch()
            self._admit()
            outputs.extend(self._run_prefills())
            outputs.extend(self._decode_harvest(pending))
            self._ensure_pages()
        if self._moe_layer is not None:
            self._republish_moe_paths()
        monitor.counter("serving.steps").increase()
        self._publish_gauges()
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
    def pages_free(self) -> int:
        return self._alloc.free_pages

    @property
    def decode_ticks(self) -> int:
        """Decode ticks run so far (each a [max_slots] forward)."""
        return self._ticks

    def leaked_pages(self) -> int:
        """Pages still allocated — 0 on a healthy drained engine."""
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
            need = _ceil_div(self._pbucket(len(req.resume_tokens())),
                             self.page_size)
            # the watermark reserves growth headroom for RUNNING
            # sequences; an otherwise-empty engine admits with the whole
            # pool
            busy = any(r is not None for r in self._slots)
            wm = self.watermark_pages if busy else 0
            if not self._alloc.can_alloc(need + reserved, wm):
                break
            reserved += need
            self._waiting.popleft()
            req.slot = slot
            req.state = PREFILL
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            self._slots[slot] = req

    def _run_prefills(self) -> List[Output]:
        """Prefill every PREFILL-state slot, in admission order, each
        writing its whole prefix in one bucketed chunk."""
        pending = sorted((r for r in self._slots
                          if r is not None and r.state == PREFILL),
                         key=lambda r: r.admit_seq)
        outs = (self._prefill(req) for req in pending)
        return [o for o in outs if o is not None]

    def _prefill(self, req: Request) -> Optional[Output]:
        """Write the request's prefix into the pools (one bucketed chunk,
        attended through the paged gather path). A fresh request samples
        its first token from the last real position; a resumed
        (preempted) one only rebuilds its cache and draws no noise, so
        its generator continues exactly where it stopped."""
        toks = req.resume_tokens()
        fresh = not req.generated
        T = len(toks)
        # bucket the chunk, never past the block table (add_request
        # guarantees the REAL tokens fit; clipping only drops padding)
        pb = min(self._pbucket(T), self.max_blocks * self.page_size)
        # pages for REAL tokens only: block-table entries beyond them
        # stay 0, so bucket-padding writes land in the scratch page.
        # _admit reserved at least these pages this step.
        need = _ceil_div(T, self.page_size) - len(req.pages)
        if need > 0:
            req.pages = req.pages + self._alloc.alloc(need, seq=req.req_id)
        bt_row = np.zeros((1, self.max_blocks), np.int32)
        bt_row[0, :len(req.pages)] = req.pages
        prompt = np.zeros((1, pb), np.int64)
        prompt[0, :T] = toks
        logits = _model_forward(self.model, self._up(prompt),
                                self._inject_bt(self._up(bt_row)),
                                torch.zeros((1,), dtype=torch.int64,
                                            device=self.device))
        cur = logits[:, T - 1].float()                       # [1, V]
        ok = torch.isfinite(cur).all(dim=-1)
        if fresh:
            p = req.params
            tok = sample_token_arrays(
                cur, self._noise([req]),
                torch.tensor([p.temperature], device=self.device),
                torch.tensor([p.top_k], device=self.device),
                torch.tensor([p.top_p], device=self.device))
            tok_h, ok_h = tok.cpu(), ok.cpu()
        else:
            tok_h, ok_h = None, ok.cpu()
        monitor.counter("serving.prefill_tokens").increase(pb)
        monitor.counter("serving.prefill_slices").increase()
        if not bool(ok_h[0]):
            return self._fail(req, "nan_logits")
        req.written = T
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
        req.state = DECODE

    def _ensure_pages(self):
        """Before the decode tick, every active slot must own the page
        its write lands in; allocate lazily, preempting the YOUNGEST
        sequence when the pool runs dry."""
        for i in range(self.max_slots):
            req = self._slots[i]
            if req is None or req.state != DECODE:
                continue
            need = _ceil_div(req.written + 1, self.page_size)
            while len(req.pages) < need:
                page = self._alloc_or_preempt(req)
                if page is None:      # req itself got preempted
                    break
                req.pages.extend(page)
                self._bt[i, :len(req.pages)] = req.pages
                self._bt_dirty = True

    def _alloc_or_preempt(self, req: Request):
        while True:
            try:
                return self._alloc.alloc(1, seq=req.req_id)
            except RuntimeError:
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
        """Queue this step's decode tick and return without waiting: one
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
        if self._bt_dirty:
            self._bt_dev = self._up(self._bt)
            self._bt_dirty = False
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
        return _PendingTick(data=(nxt, ok),
                            active=[(i, self._slots[i]) for i in active])

    def _decode_harvest(self, pend: Optional[_PendingTick]
                        ) -> List[Output]:
        """Fetch the queued tick's tokens and retire its rows."""
        if pend is None:
            return []
        nxt = pend.data[0].cpu().numpy()
        okv = pend.data[1].cpu().numpy()
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
            req.written += 1          # the tick wrote the last token
            self._pos[i] = req.written
            req.generated.append(tok)
            self._last[i] = tok
            monitor.counter("serving.tokens").increase()
            reason = self._finish_reason(req, tok)
            if reason:
                outs.append(self._finish(req, reason))
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
            req.slot = None
        if req.pages:
            self._alloc.free(req.pages)
            req.pages = []
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
