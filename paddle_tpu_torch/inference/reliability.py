"""Serving-engine reliability layer: fault injection + crash recovery.

Counterpart of ``paddle_tpu/inference/reliability.py``. The engine's
HOST-side bookkeeping (request lifecycles, the page allocator, the
prefix-cache index, per-request generators) is the single source of
truth of a serving process. This module holds the two mechanisms its
hardening is built and proven on.

* **Deterministic fault injection**: a seeded :class:`FaultInjector`
  with named fault points wired through the engine's allocator, prefix
  cache, prefill / decode / verify forwards and the draft loop. Faults
  are drawn from one ``numpy`` Generator in the order the engine queries
  the sites (or forced by a :class:`FaultPlan`), so a chaos run replays
  from its seed alone, and the same (seed, rate, sites, plan, trace)
  fires the same faults in the port and in the JAX engine.

      ============================  =========================================
      fault point                   what fires
      ============================  =========================================
      ``alloc.exhausted``           the next page allocation raises the
                                    pool-exhausted error although pages are
                                    free — prefills requeue, decode growth
                                    preempts
      ``alloc.refcount_skew``       a stray extra reference lands on a live
                                    page — the per-step invariant audit must
                                    detect and repair it
      ``prefix.hash_collision``     the next root-chunk digest collides with a
                                    constant — the exact-token compare must
                                    degrade the hit to a miss
      ``prefix.stale_entry``        one cached entry's token metadata is
                                    corrupted — it must never be hit again and
                                    must be reclaimed
      ``prefill.nan``               the prefill chunk's sampling logits turn
                                    NaN — the request is quarantined, pages
                                    freed
      ``decode.nan``                one live slot's decode logits turn NaN —
                                    that slot alone fails; the rest keep
                                    serving
      ``prefill.device_error`` /    the forward raises (simulated device
      ``decode.device_error``       loss) BEFORE it is launched, so host state
                                    stays coherent — prefills requeue, decode
                                    skips the tick and retries
      ``spec.disagree``             the drafted tokens are replaced with
                                    garbage — exact-match verification must
                                    reject them with output unchanged
      ``worker.die_prefill`` /      the DisaggEngine drops one live worker of
      ``worker.die_decode``         the kind wholesale; its requests re-admit
                                    from host truth (never the last one)
      ``replica.die``               the ServingFleet drops one live replica
                                    wholesale (never the last one)
      ============================  =========================================

* **Crash-exact snapshot/restore**: :func:`snapshot_engine` serializes
  the host-side source of truth (queued + live request tokens, sampling
  params, generator states, admission order, prefix-cache index
  metadata — NOT the KV pools, device state a crash loses anyway) as
  one JSON-able dict; :func:`restore_engine` re-admits every request on
  a fresh engine through the preemption / resume-prefill machinery, so
  the restarted engine emits the uninterrupted run's tokens.

The snapshot format is the JAX package's (``SNAPSHOT_VERSION`` 1) with
one addition. The JAX engine keeps a threefry ``key`` per request; the
port keeps a ``torch.Generator``. A sampled request's entry carries its
generator state as ``torch_rng`` (a list of byte values) with the
generator's device type in ``torch_rng_device``, and ``key`` is written
as ``[0, 0]``, so either framework loads the file. A sampled request
that already holds tokens restores only with a ``torch_rng`` of the
serving device's type; a greedy request needs no random state, so a
greedy snapshot the JAX engine wrote restores in the port.

Driven by flags (``FLAGS_serving_fault_seed=7`` arms every Engine built
without an explicit ``fault_injector``; ``fault_injector=False`` forces
one engine clean) or explicitly.

Counters: ``serving.fault_injected.<site>``, ``serving.invariant_repairs``,
``serving.snapshot_saves``, ``serving.snapshot_restores``,
``serving.stalls`` — beside the lifecycle counters of the engine's
hardening (``serving.timeouts`` / ``serving.cancelled`` /
``serving.failed`` / ``serving.nan_quarantines`` /
``serving.step_errors``).
"""
from __future__ import annotations

import json
import os
import warnings
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import monitor
from ..core.flags import define_flag, get_flag
from . import tracing

define_flag("serving_fault_seed", -1,
            "Seed for the serving engine's deterministic FaultInjector; "
            "-1 disables injection (production default)")
define_flag("serving_fault_rate", 0.02,
            "Per-query probability each armed fault point fires "
            "(FLAGS_serving_fault_seed >= 0 arms the injector)")
define_flag("serving_fault_sites", "",
            "Comma-separated fault-point filter for the injector; "
            "empty = every site armed")
define_flag("serving_debug_invariants", False,
            "Audit engine/allocator invariants after every step() and "
            "raise on the first finding (the chaos paths audit WITH "
            "repair instead)")

#: every named fault point the engines query, in the order a step visits
#: them (the JAX package's list)
FAULT_SITES = (
    "alloc.exhausted",
    "alloc.refcount_skew",
    "prefix.hash_collision",
    "prefix.stale_entry",
    "prefill.nan",
    "prefill.device_error",
    "decode.nan",
    "decode.device_error",
    "spec.disagree",
    # disaggregated serving (disagg.py): a whole worker dies, pools,
    # allocator and device state lost, and its requests re-admit
    # elsewhere token-exact. Queried by the DisaggEngine driver only,
    # never by an Engine; it never fires on the last worker of a kind
    # (recorded only when a kill landed).
    "worker.die_prefill",
    "worker.die_decode",
    # the serving fleet (fleet.py): one whole Engine replica dies, and
    # its requests re-admit on the survivors from host truth alone.
    # Queried by the ServingFleet driver only; never the last replica.
    "replica.die",
)

SNAPSHOT_VERSION = 1


class InjectedFault(RuntimeError):
    """An injected device error (never raised in production): the engine
    absorbs it by retrying (the prefill requeues, the decode tick is
    skipped). ``site`` names the fault point."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site}")
        self.site = site


@dataclass
class FaultPlan:
    """Explicit fault schedule: fire ``site`` the first time it is
    queried AT or AFTER engine step ``step`` (each entry fires once).
    Entries take precedence over the injector's rate draws. Parseable
    from a flag-friendly string::

        FaultPlan.parse("12:decode.nan,30:alloc.exhausted")
    """

    entries: List[Tuple[int, str]] = field(default_factory=list)

    def __post_init__(self):
        for step, site in self.entries:
            if site not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {site!r} in plan — known "
                    f"sites: {', '.join(FAULT_SITES)}")
        self._pending = sorted(
            ((int(s), site) for s, site in self.entries),
            key=lambda e: e[0])

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        entries = []
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            step, _, site = item.partition(":")
            entries.append((int(step), site.strip()))
        return cls(entries)

    def pop(self, site: str, step: int) -> bool:
        for i, (s, target) in enumerate(self._pending):
            if target == site and step >= s:
                del self._pending[i]
                return True
            if s > step:
                break
        return False

    @property
    def pending(self) -> List[Tuple[int, str]]:
        return list(self._pending)


class FaultInjector:
    """Seeded, replayable chaos source for the serving engine.

    The engine queries ``fire(site)`` at each named fault point; the
    injector answers from ONE ``numpy`` Generator consumed in query
    order, so the same (seed, rate, sites, plan, trace) always produces
    the same fault schedule. ``counts`` records what actually fired
    (also emitted as ``serving.fault_injected.<site>`` counters)."""

    def __init__(self, seed: int = 0, rate: float = 0.0,
                 sites: Optional[Sequence[str]] = None,
                 plan: Optional[FaultPlan] = None):
        unknown = set(sites or ()) - set(FAULT_SITES)
        if unknown:
            raise ValueError(
                f"unknown fault site(s) {sorted(unknown)} — known "
                f"sites: {', '.join(FAULT_SITES)}")
        self.seed = int(seed)
        self.rate = float(rate)
        self.sites = frozenset(sites) if sites else frozenset(FAULT_SITES)
        self.plan = plan
        self.rng = np.random.default_rng(self.seed)
        self.counts: Dict[str, int] = {}
        self.step = 0

    def enabled(self, site: str) -> bool:
        return site in self.sites

    def on_step(self, step: int) -> None:
        """Engine hook: the current scheduler step (plan entries key on
        it)."""
        self.step = int(step)

    def fire(self, site: str, record: bool = True) -> bool:
        """One fault-point query. Plan entries fire unconditionally;
        otherwise an armed site fires with probability ``rate``. The
        Generator is consumed for every armed rate query, fired or not,
        so the schedule is a pure function of the seed and the query
        order."""
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}")
        hit = False
        if self.plan is not None and self.plan.pop(site, self.step):
            hit = True
        elif site in self.sites and self.rate > 0.0:
            hit = bool(self.rng.random() < self.rate)
        if hit and record:
            self.record(site)
        return hit

    def record(self, site: str) -> None:
        """Count an APPLIED fault. Sites whose application can be a
        no-op (no live page to skew, an empty cache to corrupt) draw with
        ``fire(site, record=False)`` and call this once the fault
        landed."""
        self.counts[site] = self.counts.get(site, 0) + 1
        monitor.counter(f"serving.fault_injected.{site}").increase()

    @property
    def total_injected(self) -> int:
        return sum(self.counts.values())

    def __repr__(self):
        return (f"FaultInjector(seed={self.seed}, rate={self.rate}, "
                f"injected={self.total_injected})")


def injector_from_flags() -> Optional[FaultInjector]:
    """An injector from ``FLAGS_serving_fault_*``; None when injection
    is off (the default, seed -1)."""
    seed = int(get_flag("serving_fault_seed"))
    if seed < 0:
        return None
    sites_spec = str(get_flag("serving_fault_sites")).strip()
    sites = tuple(s.strip() for s in sites_spec.split(",")
                  if s.strip()) or None
    return FaultInjector(seed=seed,
                         rate=float(get_flag("serving_fault_rate")),
                         sites=sites)


# --------------------------------------------------------------------------
# crash-exact snapshot / restore
# --------------------------------------------------------------------------

def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a cache dtype (``float32``, ``bfloat16``,
    ``int8``): the JAX engine's fingerprint spells it so."""
    return str(dtype).replace("torch.", "")


def _fingerprint(eng) -> Dict[str, object]:
    """The compatibility signature a snapshot is only valid against.
    ``hard`` fields change the TOKENS a request would emit (model
    geometry, cache dtype, draft length) — restore refuses a mismatch;
    ``soft`` fields only change scheduling (pool geometry) — restore
    warns, because the preemption-exact engine emits the same tokens
    under any page or slot budget."""
    cfg = eng.model.config
    return {
        "hard": {
            "vocab_size": int(cfg.vocab_size),
            "num_hidden_layers": int(cfg.num_hidden_layers),
            "hidden_size": int(cfg.hidden_size),
            "num_attention_heads": int(cfg.num_attention_heads),
            "num_key_value_heads": int(cfg.num_key_value_heads),
            "cache_dtype": _dtype_name(eng.cache_dtype),
            "spec_k": int(eng._spec.k) if eng._spec is not None else 0,
        },
        "soft": {
            "max_slots": eng.max_slots,
            "page_size": eng.page_size,
            "pool_pages": eng.pool_pages,
            "max_context": eng.max_context,
            "prefill_bucket": eng.prefill_bucket,
            "prefix_cache": eng._prefix is not None,
            "max_prefill_tokens_per_step":
                eng.max_prefill_tokens_per_step,
            "multi_tick": eng.multi_tick,
        },
    }


def snapshot_engine(eng, sync: bool = True) -> Dict[str, object]:
    """Serialize the engine's host-side source of truth as one JSON-able
    dict: every live + queued request (prompt, generated tokens,
    sampling params, a sampled request's generator state, admission
    order, latency ages, span timeline) plus the prefix-cache index
    metadata. KV pools are NOT serialized: the resume-prefill machinery
    rebuilds them on restore.

    Called between ``step()`` calls, it is non-destructive: the engine
    keeps serving afterwards. ``sync`` is accepted for the API's sake
    and changes nothing here: the JAX engine's ``sync=False`` skips a
    device fetch of its live rng keys, while the port's generator state
    is host bookkeeping (``torch.Generator.get_state`` reads no device
    memory), exact either way."""
    from .engine import DECODE, PREEMPTED, WAITING
    del sync
    now = eng._clock()
    entries: List[Dict[str, object]] = []
    # queue order on restore = live requests first (they were running;
    # the resume machinery puts preempted work at the queue FRONT), in
    # admission order, then the waiting queue as-is
    live = sorted((r for r in eng._slots if r is not None),
                  key=lambda r: r.admit_seq)
    for req in list(live) + list(eng._waiting):
        rng_state = None
        if req.params.temperature > 0 and req.generator is not None:
            rng_state = [int(b) for b in req.generator.get_state().tolist()]
        entries.append({
            "req_id": int(req.req_id),
            "prompt": [int(t) for t in req.prompt],
            "generated": [int(t) for t in req.generated],
            "params": asdict(req.params),
            "key": [0, 0],
            "torch_rng": rng_state,
            "torch_rng_device": (req.generator.device.type
                                 if rng_state is not None else None),
            "live": req.state == DECODE,
            "preemptions": int(req.preemptions),
            "retries": int(req.retries),
            "elapsed_ms": (now - req.arrival_t) * 1e3,
            # a RUNNING request (decoding or mid chunked prefill) has no
            # queue age: it re-enters the restored queue with a fresh
            # max_queue_steps budget
            "waited_steps": (eng._steps - req.queued_step
                             if req.state in (WAITING, PREEMPTED)
                             and req.queued_step >= 0 else 0),
            "spans": tracing.copy_spans(req.spans),
        })
    prefix_index: List[Dict[str, object]] = []
    if eng._prefix is not None:
        for ent in eng._prefix._store.values():
            prefix_index.append({
                "key": ent.key.hex(),
                "parent": (ent.parent.hex()
                           if ent.parent is not None else None),
                "depth": int(ent.depth),
                "chunk": [int(t) for t in ent.chunk],
            })
    snap = {
        "version": SNAPSHOT_VERSION,
        "fingerprint": _fingerprint(eng),
        "next_id": int(eng._next_id),
        "admit_counter": int(eng._admit_counter),
        "steps": int(eng._steps),
        "requests": entries,
        # index METADATA only: restore starts with an empty cache that
        # re-fills from resume prefills (hit or miss never changes tokens)
        "prefix_index": prefix_index,
    }
    monitor.counter("serving.snapshot_saves").increase()
    return snap


def _restored_generator(eng, ent: Dict[str, object], params
                        ) -> torch.Generator:
    """The generator a restored request continues with: its saved state
    when it has one of the serving device's type, else a fresh one from
    its seed. A sampled request that already emitted tokens without a
    usable saved state cannot continue its stream exactly: ValueError."""
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(int(params.seed))
    state = ent.get("torch_rng")
    same_device = ent.get("torch_rng_device") == eng.device.type
    if state is not None and same_device:
        gen.set_state(torch.tensor(state, dtype=torch.uint8))
    elif float(params.temperature) > 0 and ent["generated"]:
        raise ValueError(
            f"snapshot request {ent['req_id']} samples (temperature "
            f"{params.temperature}) and has emitted tokens, but carries "
            f"no torch_rng of device type {eng.device.type!r} (it has "
            f"{ent.get('torch_rng_device')!r}) — its stream cannot "
            f"continue exactly")
    return gen


def restore_engine(eng, snap: Dict[str, object],
                   strict: bool = True) -> int:
    """Re-admit every snapshotted request into ``eng`` (normally a fresh
    engine over the same weights after a restart). Requests with
    generated tokens enter as PREEMPTED — the resume-prefill path
    rebuilds their KV from the kept tokens and the saved generator
    continues the stream — and untouched requests enter as WAITING, in
    the snapshot's queue order. Returns the number of requests
    re-admitted.

    ``strict=True`` raises on any fingerprint mismatch; strict or not, a
    HARD mismatch (model geometry / cache dtype / draft length) always
    raises, and so does a sampled request without a usable generator
    state (``_restored_generator``)."""
    from .engine import PREEMPTED, WAITING, Request, SamplingParams
    if snap.get("version") != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot version {snap.get('version')!r} does not match "
            f"this engine's {SNAPSHOT_VERSION}")
    if eng.requests or any(r is not None for r in eng._slots):
        raise RuntimeError(
            "restore onto a busy engine: "
            f"{len(eng.requests)} live/queued request(s) present — "
            "restore targets a fresh (or fully drained) engine")
    fp = _fingerprint(eng)
    saved = snap.get("fingerprint", {})
    hard_diff = {k: (saved.get("hard", {}).get(k), v)
                 for k, v in fp["hard"].items()
                 if saved.get("hard", {}).get(k) != v}
    if hard_diff:
        raise ValueError(
            f"snapshot is token-incompatible with this engine: "
            f"{hard_diff} (saved vs current) — same model geometry, "
            f"cache dtype and spec_k are required for an exact restore")
    soft_diff = {k: (saved.get("soft", {}).get(k), v)
                 for k, v in fp["soft"].items()
                 if saved.get("soft", {}).get(k) != v}
    if soft_diff:
        if strict:
            raise ValueError(
                f"snapshot scheduler geometry differs: {soft_diff} "
                f"(saved vs current) — pass strict=False to restore "
                f"anyway (tokens stay exact; only scheduling latencies "
                f"change)")
        warnings.warn(
            f"restoring across scheduler geometries: {soft_diff} "
            f"(saved vs current); outputs stay token-exact",
            RuntimeWarning, stacklevel=3)
    # every generator first: a refused entry leaves the engine untouched
    params = [SamplingParams(**ent["params"]) for ent in snap["requests"]]
    gens = [_restored_generator(eng, ent, p)
            for ent, p in zip(snap["requests"], params)]
    now = eng._clock()
    for ent, p, gen in zip(snap["requests"], params, gens):
        req = Request(
            req_id=int(ent["req_id"]),
            prompt=[int(t) for t in ent["prompt"]],
            params=p,
            generator=gen,
            state=PREEMPTED if ent["generated"] else WAITING,
            generated=[int(t) for t in ent["generated"]],
            preemptions=int(ent.get("preemptions", 0)),
            retries=int(ent.get("retries", 0)),
            arrival_t=now - float(ent.get("elapsed_ms", 0.0)) / 1e3,
        )
        req.spans = tracing.restore_spans(
            ent.get("spans"), req.arrival_t * 1e3, now * 1e3,
            eng.label, bool(req.generated))
        eng.readmit(req, waited_steps=int(ent.get("waited_steps", 0)))
    eng._next_id = max(eng._next_id, int(snap.get("next_id", 0)))
    eng._admit_counter = max(eng._admit_counter,
                             int(snap.get("admit_counter", 0)))
    monitor.counter("serving.snapshot_restores").increase()
    return len(snap["requests"])


def save_snapshot(snap: Dict[str, object], path: str) -> str:
    """Atomic write (temp file + rename): the stall and crash paths call
    this when the process may be killed mid-write — a truncated snapshot,
    or a good one clobbered by a partial rewrite, would destroy the
    recovery trail it exists to leave."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(snap, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return path


def load_snapshot(path: str) -> Dict[str, object]:
    with open(path) as fh:
        return json.load(fh)
