"""paddle_tpu_torch.inference.encoder — continuous-batching embedding
service (counterpart of ``paddle_tpu/inference/encoder.py``).

Encoder requests are one forward each (no KV cache, no pages), so the
service is batch packing:

* Requests queue per tenant. Every ``step()`` forms ONE batch of up to
  ``max_batch`` requests: the OLDEST waiting request first — its length
  sets the sequence bucket — then a round-robin walk over the tenants
  (FIFO within each) that takes requests fitting that bucket, so a
  flooding tenant slows, never starves, another (:399-433).
* The batch is pinned at ``max_batch`` rows and padded to a ``bucket``
  multiple: dead rows ride an all-zero attention mask, so every key of
  theirs is masked (the flash kernel gives them zeros) and they are
  dropped on the host. Pad positions are key-masked and left out of the
  mean, so a request's embedding does not depend on its batch-mates.
* Pooling is chosen per row: ``"mean"`` (the attention-mask-weighted
  mean of the final hidden states, in f32) or ``"cls"`` (the model's
  tanh-pooled [CLS] output).
* Deadlines and queue timeouts on an injectable clock, and ``cancel``.

The model follows the reference encoder contract, ``forward(input_ids,
attention_mask=...) -> (sequence [b, s, h], pooled [b, h])`` (the port's
``BertModel``), and runs without dropout and without autograd here. It
is used as it is (the JAX service snapshots its weights at
construction). On ``cuda`` with head dim 64 the constructor launches the
head-dim-64 flash probe once, as the ``Engine`` runs its kernels'
probes.

Compiles: the port compiles only kernel libraries, so
``steady_state_recompiles()`` counts the ``kernels._build`` libraries
built inside ``step()`` after the first step (0 in steady state).
``inspect_hotpath`` (the JAX service's hot-path lint) comes with the
analysis slice.

``monitor`` surface: counters ``serving.embed.requests`` / ``.finished``
/ ``.batches`` / ``.tokens`` / ``.pad_tokens`` / ``.timeouts`` /
``.cancelled`` / ``.steps``, gauges ``serving.embed.queue_depth`` /
``.batch_fill`` / ``.latency_ms`` / ``.host_ms_per_tick`` /
``.device_ms_per_tick``, histogram ``serving.hist.embed_latency_ms``.
The device share of a tick is the encode's time between two CUDA events
on the card (the forward's wall time on the CPU); the host share is the
rest of the tick.
"""
from __future__ import annotations

import inspect
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import monitor
from ..core.device import resolve_device
from ..kernels import _build
from .engine import _ceil_div, _normalize_prompt, serving_model_spec

POOLING_MODES = ("mean", "cls")


@dataclass
class EmbedParams:
    """Per-request embedding config: every field may differ per request
    inside one batch."""

    pooling: str = "mean"
    deadline_ms: Optional[float] = None
    max_queue_steps: Optional[int] = None

    def validate(self):
        if self.pooling not in POOLING_MODES:
            raise ValueError(
                f"pooling must be one of {POOLING_MODES}, got "
                f"{self.pooling!r}")
        if self.deadline_ms is not None and float(self.deadline_ms) <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {self.deadline_ms}")
        if self.max_queue_steps is not None \
                and int(self.max_queue_steps) < 1:
            raise ValueError(
                f"max_queue_steps must be >= 1, got {self.max_queue_steps}")


@dataclass
class EmbedOutput:
    """One retired request. ``embedding`` is the [hidden] f32 vector (None
    on failure); ``finish_reason`` is "done" or the failure
    ("deadline" / "queue_timeout" / "cancelled")."""

    req_id: int
    embedding: Optional[np.ndarray]
    tokens: int                   # real (unpadded) sequence length
    pooling: str
    finish_reason: str
    latency_ms: float             # arrival -> embedding on the host
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclass
class _EmbedRequest:
    req_id: int
    tokens: List[int]
    params: EmbedParams
    tenant: str
    arrival_t: float
    queued_step: int


class BatchEncoder:
    """Bucketed continuous-batching embedding service over an encoder.

        svc = BatchEncoder(bert_model, max_batch=16, bucket=32)
        rid = svc.add_request(ids, EmbedParams(pooling="mean"))
        for out in svc.step():
            ...                       # finished EmbedOutputs
        # or offline:
        outs = svc.run([ids_a, (ids_b, EmbedParams(pooling="cls"))])

    ``device=None`` serves on ``cuda`` (raising when no GPU is visible);
    ``device="cpu"`` runs the plain kernel versions. The model must live
    on that device."""

    def __init__(self, model, max_batch: int = 8, bucket: int = 32,
                 max_seq: Optional[int] = None, clock=None, device=None):
        spec = serving_model_spec(model)
        if spec.get("kind") == "decoder":
            raise ValueError(
                f"{type(model).__name__} is a DECODER — serve it through "
                f"the continuous-batching Engine; BatchEncoder embeds with "
                f"encoder models (BertModel)")
        try:
            fsig = inspect.signature(model.forward)
        except (TypeError, ValueError):
            fsig = None
        if fsig is None or "attention_mask" not in fsig.parameters:
            raise ValueError(
                f"BatchEncoder requires an encoder with an attention_mask "
                f"forward kwarg (padding-masked batching); "
                f"{type(model).__name__}.forward has none")
        if int(max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if int(bucket) < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        self.device = resolve_device(device)
        params = list(model.parameters())
        if params and params[0].device != self.device:
            raise ValueError(
                f"the model lives on {params[0].device} but the service "
                f"runs on {self.device}: build both on one device")
        if self.device.type == "cuda" and spec.get("head_dim") == 64:
            from ..kernels.flash_attention import minor64_supported
            minor64_supported(self.device)
        self.model = model
        self.serving_spec = spec
        self.max_batch = int(max_batch)
        self.bucket = int(bucket)
        self.max_seq = int(max_seq or spec["max_context"])
        self._clock = clock if clock is not None else time.perf_counter
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._rr = 0
        self.requests: Dict[int, _EmbedRequest] = {}
        self._next_id = 0
        self._steps = 0
        self._device_ms = 0.0
        self._steady_builds = 0

    # -- public API ----------------------------------------------------------

    def add_request(self, ids, params=None, tenant: str = "default") -> int:
        """Queue one sequence (1-D ids, or [1, s]) under ``params``;
        returns the request id."""
        p = params or EmbedParams()
        if isinstance(p, dict):
            p = EmbedParams(**p)
        p.validate()
        tokens = _normalize_prompt(ids)
        rid = self._next_id
        if len(tokens) > self.max_seq:
            raise ValueError(
                f"request {rid} has {len(tokens)} tokens, beyond the "
                f"service's max_seq {self.max_seq}")
        self._next_id += 1
        req = _EmbedRequest(req_id=rid, tokens=tokens, params=p,
                            tenant=str(tenant), arrival_t=self._clock(),
                            queued_step=self._steps)
        self.requests[rid] = req
        self._queues.setdefault(str(tenant), deque()).append(req)
        monitor.counter("serving.embed.requests").increase()
        return rid

    def cancel(self, req_id: int) -> Optional[EmbedOutput]:
        """Drop a queued request now; returns its failure output (None
        for an unknown or retired id)."""
        req = self.requests.get(int(req_id))
        if req is None:
            return None
        monitor.counter("serving.embed.cancelled").increase()
        return self._fail(req, "cancelled")

    def step(self) -> List[EmbedOutput]:
        """One tick: expire deadlines, form one batch, encode it, retire
        its requests."""
        wall0 = time.perf_counter()
        builds0 = _build.build.libraries_built
        self._device_ms = 0.0
        outs = self._expire()
        batch = self._form_batch()
        if batch:
            outs.extend(self._encode(batch))
        monitor.counter("serving.embed.steps").increase()
        monitor.gauge("serving.embed.queue_depth").set(self.num_waiting)
        wall_ms = (time.perf_counter() - wall0) * 1e3
        dev_ms = min(self._device_ms, wall_ms)
        monitor.gauge("serving.embed.host_ms_per_tick").set(wall_ms - dev_ms)
        monitor.gauge("serving.embed.device_ms_per_tick").set(dev_ms)
        if self._steps > 0:
            self._steady_builds += _build.build.libraries_built - builds0
        self._steps += 1
        return outs

    def run(self, requests: Sequence,
            max_steps: int = 100_000) -> List[EmbedOutput]:
        """Offline driver: queue every item — ``ids`` or ``(ids,
        EmbedParams)`` — then step until all retire. Returns the outputs
        ordered by request id."""
        want = set()
        for item in requests:
            if isinstance(item, (tuple, list)) and len(item) == 2 and \
                    isinstance(item[1], (EmbedParams, dict)):
                want.add(self.add_request(item[0], item[1]))
            else:
                want.add(self.add_request(item))
        outs: List[EmbedOutput] = []
        for _ in range(max_steps):
            outs.extend(o for o in self.step() if o.req_id in want)
            if len(outs) == len(want):
                break
        else:
            raise RuntimeError(
                f"encoder did not drain in {max_steps} steps "
                f"({len(outs)}/{len(want)} finished)")
        return sorted(outs, key=lambda o: o.req_id)

    def steady_state_recompiles(self) -> int:
        """Kernel libraries built inside ``step()`` after the first step:
        0 under any steady mix of lengths, tenants and pooling."""
        return self._steady_builds

    def inspect_hotpath(self):
        raise NotImplementedError(
            "the hot-path lint of the serving surfaces comes with the "
            "analysis slice of the port")

    def close(self):
        """Nothing to release (API parity with the JAX service)."""

    @property
    def num_waiting(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def idle(self) -> bool:
        return self.num_waiting == 0

    # -- scheduler internals -------------------------------------------------

    def _bucketed(self, n: int) -> int:
        return min(_ceil_div(n, self.bucket) * self.bucket, self.max_seq)

    def _expire(self) -> List[EmbedOutput]:
        outs: List[EmbedOutput] = []
        now = self._clock()
        for req in [r for q in self._queues.values() for r in q]:
            p = req.params
            if p.deadline_ms is not None and \
                    (now - req.arrival_t) * 1e3 > float(p.deadline_ms):
                monitor.counter("serving.embed.timeouts").increase()
                outs.append(self._fail(req, "deadline"))
            elif p.max_queue_steps is not None and \
                    self._steps - req.queued_step > int(p.max_queue_steps):
                monitor.counter("serving.embed.timeouts").increase()
                outs.append(self._fail(req, "queue_timeout"))
        return outs

    def _form_batch(self) -> List[_EmbedRequest]:
        """The oldest waiting request, then one request per tenant per
        lap from the round-robin cursor on, each the first of its
        tenant's queue that fits the oldest one's bucket."""
        tenants = [t for t, q in self._queues.items() if q]
        if not tenants:
            return []
        oldest = min((self._queues[t][0] for t in tenants),
                     key=lambda r: r.req_id)
        L = self._bucketed(len(oldest.tokens))
        batch = [oldest]
        self._queues[oldest.tenant].remove(oldest)
        names = list(self._queues.keys())
        start = self._rr % len(names)
        progressed = True
        while len(batch) < self.max_batch and progressed:
            progressed = False
            for i in range(len(names)):
                q = self._queues[names[(start + i) % len(names)]]
                take = next((r for r in q if len(r.tokens) <= L), None)
                if take is not None:
                    q.remove(take)
                    batch.append(take)
                    progressed = True
                    if len(batch) >= self.max_batch:
                        break
        self._rr += 1
        return batch

    def _embed(self, ids, amask, sel):
        """The padded batch forward and both poolings; ``sel`` picks CLS
        (1) or the masked mean (0) per row. -> [B, hidden] f32."""
        x, pooled = self.model(ids, attention_mask=amask)
        m = (amask > 0).float()
        denom = m.sum(dim=1, keepdim=True).clamp(min=1.0)
        mean = (x.float() * m[:, :, None]).sum(dim=1) / denom
        return torch.where(sel[:, None] > 0, pooled.float(), mean)

    def _encode(self, batch: List[_EmbedRequest]) -> List[EmbedOutput]:
        L = self._bucketed(max(len(r.tokens) for r in batch))
        B = self.max_batch
        ids = np.zeros((B, L), np.int64)
        amask = np.zeros((B, L), np.int64)
        sel = np.zeros((B,), np.int64)
        for i, r in enumerate(batch):
            n = len(r.tokens)
            ids[i, :n] = r.tokens
            amask[i, :n] = 1
            sel[i] = 1 if r.params.pooling == "cls" else 0
        dev = self.device
        ids_d, amask_d, sel_d = (torch.from_numpy(a).to(dev)
                                 for a in (ids, amask, sel))
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                if dev.type == "cuda":
                    ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                                for _ in range(2))
                    ev0.record()
                    emb_d = self._embed(ids_d, amask_d, sel_d)
                    ev1.record()
                    emb = emb_d.cpu().numpy()
                    self._device_ms += ev0.elapsed_time(ev1)
                else:
                    t0 = time.perf_counter()
                    emb = self._embed(ids_d, amask_d, sel_d).numpy()
                    self._device_ms += (time.perf_counter() - t0) * 1e3
        finally:
            self.model.train(was_training)
        now = self._clock()
        real = sum(len(r.tokens) for r in batch)
        monitor.counter("serving.embed.batches").increase()
        monitor.counter("serving.embed.tokens").increase(real)
        monitor.counter("serving.embed.pad_tokens").increase(B * L - real)
        monitor.gauge("serving.embed.batch_fill").set(len(batch) / float(B))
        outs = []
        for i, r in enumerate(batch):
            self.requests.pop(r.req_id, None)
            lat = (now - r.arrival_t) * 1e3
            monitor.gauge("serving.embed.latency_ms").set(lat)
            monitor.histogram("serving.hist.embed_latency_ms").record(lat)
            monitor.counter("serving.embed.finished").increase()
            outs.append(EmbedOutput(
                req_id=r.req_id, embedding=emb[i].copy(),
                tokens=len(r.tokens), pooling=r.params.pooling,
                finish_reason="done", latency_ms=lat))
        return outs

    def _fail(self, req: _EmbedRequest, reason: str) -> EmbedOutput:
        q = self._queues.get(req.tenant)
        if q is not None and req in q:
            q.remove(req)
        self.requests.pop(req.req_id, None)
        return EmbedOutput(
            req_id=req.req_id, embedding=None, tokens=len(req.tokens),
            pooling=req.params.pooling, finish_reason=reason,
            latency_ms=(self._clock() - req.arrival_t) * 1e3, error=reason)
