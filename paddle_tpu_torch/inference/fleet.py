"""The serving fleet: session-aware routing, live migration, heartbeat
failover and autoscaling over N Engine replicas.

Counterpart of ``paddle_tpu/inference/fleet.py``. The single-loop
Engine serves one card's worth of traffic and the disaggregated driver
(disagg.py) splits ONE request's prefill and decode across workers; the
fleet is the third axis: many whole Engine replicas behind one front
door. A request moves between replicas as HOST truth (its tokens and a
generator replayed from them), never as KV bytes.

* **Session-aware routing.** Requests that share a system prefix share a
  session key (the prefix cache's chained blake2b over the first
  page-aligned prompt chunk), and the router steers them to the replica
  whose prefix cache is warm for it: scored by that replica's own
  ``PrefixCache.lookup`` depth plus a session -> replica hint for
  prefixes still prefilling. Cold requests go to the least loaded
  replica, and one fleet-level round robin over tenant queues keeps
  tenants fair across replicas. ``router="round_robin"`` /
  ``"least_loaded"`` are the baselines the fleet-wide
  ``prefix_hit_rate`` is held against.
* **Live migration.** ``migrate_request(rid)`` moves an in-flight
  request between replicas without dropping a token: the source's
  ``Engine.extract_request`` removes it (slot cleared, pages freed), its
  generator is replayed from (seed, tokens emitted)
  (``disagg.replay_rng_key``), and it re-admits on the target through the
  resume-prefill path, so the continued stream is the never-migrated
  run's. Between the two it is PARKED on the fleet (``num_parked``), and
  ``snapshot()`` carries it. ``drain_replica(i)`` migrates every request
  off a replica and closes it to new work until ``undrain_replica(i)``.
* **Heartbeat failover.** ``heartbeat_timeout=T`` gives each replica a
  ``distributed.watchdog.Heartbeat`` ticked by its step; a replica whose
  loop stalls past T while the driver keeps stepping is killed and failed
  over at the next fleet step. ``kill_replica(i)`` (and the seeded
  ``replica.die`` fault site) drops a replica wholesale, its device
  memory released, and every request that lived there re-admits
  elsewhere from host truth and finishes token-exact. The last live
  replica is never killed.
* **Autoscaling.** ``autoscale=AutoscalePolicy(...)`` (or True) reads
  the queue depth and a TTFT percentile on the fleet's injectable clock
  every step: sustained pressure adds a replica, sustained low load
  drains the least loaded one by migration (a scale-down never drops a
  request). Events land in ``scale_log`` and
  ``serving.fleet.scale_events``.

Every replica serves on the fleet's device (``device=None`` is ``cuda``,
raising without a GPU; ``device="cpu"`` runs the kernels' plain
versions). ``steady_state_recompiles``, ``per_replica_recompiles`` and
``inspect_hotpath`` come with the analysis slice (ROADMAP section 1,
item 6) and raise until then.

Observability: counters ``serving.fleet.routed_warm`` /
``serving.fleet.routed_cold`` / ``serving.fleet.migrations`` /
``serving.fleet.replica_deaths`` / ``serving.fleet.readmitted`` /
``serving.fleet.scale_events``, gauges ``serving.fleet.queue_depth`` /
``serving.fleet.replicas`` / ``serving.fleet.parked`` and per replica
``serving.fleet.replica<i>.queue_depth`` /
``serving.fleet.replica<i>.prefix_hit_rate``.
"""
from __future__ import annotations

import time
import weakref
from collections import deque
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

from .. import monitor
from . import tracing
from .disagg import (_ITEM6, _replayed_generator, _ServingDriver,
                     driver_fingerprint, release_device_memory,
                     restore_check, restored_request)
from .engine import (FAILED, FINISHED, Engine, Output, Request,
                     SamplingParams)
from .prefix_cache import _chunk_hash

FLEET_SNAPSHOT_VERSION = 1

#: router policies: "session" steers shared-prefix traffic to the warm
#: replica; the other two are the baselines
ROUTERS = ("session", "least_loaded", "round_robin")

#: how many leading page chunks the router probes a replica's cache for
#: when scoring warmth (the signal saturates fast; an uncapped probe
#: would digest a whole long prompt a replica a dispatch attempt)
ROUTE_PROBE_CHUNKS = 8


@dataclass
class AutoscalePolicy:
    """Scale-up / scale-down knobs, read every fleet step on the
    injectable clock. Up after ``patience`` steps in a row of pressure
    (queue depth above ``scale_up_queue_depth``, or the recent p95 TTFT
    above ``scale_up_ttft_p95_ms`` when set); down after
    ``scale_down_patience`` steps in a row with the queue empty and the
    live load within HALF of one fewer replica's slots. ``cooldown``
    steps separate two scale events."""

    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_queue_depth: int = 8
    scale_up_ttft_p95_ms: Optional[float] = None
    patience: int = 3
    scale_down_patience: int = 50
    cooldown: int = 20
    ttft_window: int = 32

    def __post_init__(self):
        if int(self.min_replicas) < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if int(self.max_replicas) < int(self.min_replicas):
            raise ValueError(
                f"max_replicas {self.max_replicas} < min_replicas "
                f"{self.min_replicas}")


class ServingFleet(_ServingDriver):
    """Front door over N in-process Engine replicas.

        fleet = ServingFleet(model, replicas=2, max_slots=4,
                             page_size=8, pool_pages=64)
        rid = fleet.add_request(ids, SamplingParams(max_new_tokens=32),
                                tenant="team-a")
        for tok in fleet.stream(rid):
            ...
        outs = fleet.run([(ids_a, pa), (ids_b, pb)])   # or offline

    The geometry (page_size / prefill_bucket / max_context / cache_dtype
    / spec_k / pool_pages / max_slots) is every replica's: a request must
    be admissible wherever the router places it. ``prefix_cache`` is on
    by default (session routing exists to keep the caches warm).
    """

    def __init__(self, model, replicas: int = 2, max_slots: int = 8,
                 page_size: int = 16,
                 pool_pages: Optional[int] = None,
                 cache_dtype: str = "auto",
                 max_context: Optional[int] = None,
                 prefill_bucket: int = 32,
                 watermark_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 draft_model=None, spec_k: int = 4,
                 clock=None, fault_injector=None,
                 max_prefill_tokens_per_step: Optional[int] = None,
                 router: str = "session",
                 heartbeat_timeout: Optional[float] = None,
                 autoscale=None, multi_tick: int = 1, device=None):
        if int(replicas) < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        if router not in ROUTERS:
            raise ValueError(
                f"unknown router {router!r}: one of {ROUTERS}")
        super().__init__(model, "fleet", device, clock, fault_injector)
        self.router = router
        self._ctor = dict(
            max_slots=int(max_slots), page_size=int(page_size),
            pool_pages=pool_pages, cache_dtype=cache_dtype,
            max_context=max_context, prefill_bucket=int(prefill_bucket),
            watermark_pages=watermark_pages,
            prefix_cache=bool(prefix_cache),
            draft_model=draft_model, spec_k=int(spec_k),
            clock=self._clock, device=self.device,
            fault_injector=self._engine_injector,
            max_prefill_tokens_per_step=max_prefill_tokens_per_step,
            multi_tick=int(multi_tick))
        if autoscale is True:
            autoscale = AutoscalePolicy()
        self._policy: Optional[AutoscalePolicy] = autoscale
        self._heartbeat_timeout = heartbeat_timeout
        self._heartbeats: Dict[int, object] = {}
        self._stalled: set = set()
        self._last_step_t = time.monotonic()
        self._replicas: List[Optional[Engine]] = []
        self.replica_stats: Dict[int, Dict[str, int]] = {}
        for _ in range(int(replicas)):
            self._spawn_replica()
        w0 = self._replicas[0]
        self.max_slots = w0.max_slots
        self.page_size = w0.page_size
        self.max_blocks = w0.max_blocks
        self.max_context = w0.max_context
        self.prefill_bucket = w0.prefill_bucket
        self.cache_dtype = w0.cache_dtype
        self.pool_pages = w0.pool_pages
        self.vocab_size = w0.vocab_size
        self._lookahead = w0._lookahead
        # PARKED requests (mid-migration, failed over, restored with
        # progress) go before the tenant queues: they hold partial progress
        self._rr_pos = 0
        self._parked: "deque[Request]" = deque()
        self._migrate_dst: Dict[int, int] = {}
        self._home: Dict[int, int] = {}
        # session key (first-chunk digest) -> replica of its last
        # dispatch, so a same-session burst sticks to one replica before
        # its first prefill lands in the cache (bounded, oldest evicted)
        self._sessions: Dict[bytes, int] = {}
        # each request's session key, digested once at admission
        self._skey: Dict[int, Optional[bytes]] = {}
        self._draining: set = set()
        self.scale_log: List[Dict[str, object]] = []
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        # the autoscaler's TTFT signal: two rotating histograms (this
        # window and the last), p95 from their exact merge
        self._ttft_hist = monitor.Histogram("fleet.autoscale.ttft")
        self._ttft_hist_prev = monitor.Histogram(
            "fleet.autoscale.ttft.prev")
        self._ttft_sampled: set = set()
        # prefix hits / lookups of replicas that died or scaled away, so
        # the fleet-wide hit rate survives churn
        self._retired_hits = 0
        self._retired_lookups = 0

    @classmethod
    def from_plan(cls, model, plan, **overrides) -> "ServingFleet":
        """A fleet sized by a serving plan (``replicas``; a per-replica
        ``decode_mp`` is advisory, as in the JAX fleet)."""
        kw = dict(replicas=int(plan.get("replicas", 2)))
        kw.update(overrides)
        fleet = cls(model, **kw)
        fleet.plan = dict(plan)
        return fleet

    # -- replica lifecycle ---------------------------------------------------

    def _spawn_replica(self, index: Optional[int] = None) -> int:
        """One new Engine replica, at ``index`` (a dead replica's
        coordinate) or appended."""
        if index is None:
            index = len(self._replicas)
            self._replicas.append(None)
        self._replicas[index] = Engine(self.model, label=f"replica{index}",
                                       **self._ctor)
        # a reused coordinate is a NEW engine: fresh stats
        self.replica_stats[index] = {
            "steps": 0, "busy_steps": 0, "routed_warm": 0,
            "routed_cold": 0, "migrated_out": 0, "finished": 0}
        if self._heartbeat_timeout is not None:
            from ..distributed.watchdog import Heartbeat
            # the watcher thread holds the fleet weakly, so a fleet
            # dropped without close() is still collected (__del__)
            ref = weakref.ref(self)

            def on_stall(age, i=index):
                fleet = ref()
                if fleet is not None:
                    fleet._flag_stall(i)

            hb = Heartbeat(float(self._heartbeat_timeout), on_stall=on_stall,
                           name=f"fleet-replica{index}")
            hb.start()
            self._heartbeats[index] = hb
        return index

    def _flag_stall(self, index: int) -> None:
        """Heartbeat callback (the watcher thread): record the verdict;
        the next fleet step decides whether the replica wedged or the
        driver paused."""
        self._stalled.add(int(index))

    def _remove_replica(self, index: int) -> None:
        w = self._replicas[index]
        if w is None:
            return
        if w._prefix is not None:
            self._retired_hits += w._prefix.hits
            self._retired_lookups += w._prefix.lookups
        hb = self._heartbeats.pop(index, None)
        if hb is not None:
            hb.stop()
        w.close()
        self._replicas[index] = None
        del w
        release_device_memory()
        self._draining.discard(index)
        self._stalled.discard(index)
        # stale hints must not score a dead replica warm
        for k in [k for k, v in self._sessions.items() if v == index]:
            del self._sessions[k]

    def _alive(self) -> List[Tuple[int, Engine]]:
        return [(i, w) for i, w in enumerate(self._replicas)
                if w is not None]

    # -- front door ----------------------------------------------------------

    def add_request(self, ids, sampling_params=None,
                    tenant: str = "default") -> int:
        """Queue a prompt under ``tenant``'s share of the dispatch and
        return its id at once; the router places it at a later
        ``step()``, and tokens stream out of ``stream(rid)`` /
        ``astream(rid)``."""
        rid = super().add_request(ids, sampling_params, tenant)
        self._skey[rid] = self._session_key(self.requests[rid].prompt)
        return rid

    def _check_admissible(self, rid: int, prompt: List[int],
                          params: SamplingParams) -> None:
        # the admission arithmetic of a live replica (the geometry is
        # fleet-wide): a request must be admissible anywhere
        probe = self._alive()[0][1]
        need = len(prompt) + int(params.max_new_tokens)
        cap = self.max_blocks * self.page_size - (self._lookahead - 1)
        chunk_cap = (need
                     if probe.max_prefill_tokens_per_step is not None
                     else probe._pbucket(need))
        if chunk_cap > cap:
            raise ValueError(
                f"request {rid} needs {need} token slots, beyond the "
                f"fleet's max_context capacity {cap}")
        worst = probe._lifetime_pages(len(prompt),
                                      int(params.max_new_tokens))
        if worst > self.pool_pages:
            raise RuntimeError(
                f"request {rid} can never be scheduled: it needs up "
                f"to {worst} page(s) but each replica's pool has "
                f"{self.pool_pages}")

    def _cancel_live(self, req: Request) -> Optional[Output]:
        home = self._home.get(req.req_id)
        if home is not None and self._replicas[home] is not None:
            return self._replicas[home].cancel(req.req_id)
        return None

    # -- driver loop ---------------------------------------------------------

    def step(self) -> List[Output]:
        """One fleet step: chaos and the stall sweep, the deadline sweep
        over fleet-held requests, session-aware dispatch, one step of
        every live replica, the autoscaler. Returns every request that
        finished or failed in it."""
        outs: List[Output] = []
        now = time.monotonic()
        step_gap = now - self._last_step_t
        self._last_step_t = now
        self._maybe_chaos()
        self._sweep_stalled(step_gap)
        outs.extend(self._expire())
        self._dispatch()
        for i, w in self._alive():
            busy = not w.idle
            for out in w.step():
                self._retired(out, replica=i)
                outs.append(out)
            st = self.replica_stats[i]
            st["steps"] += 1
            st["busy_steps"] += int(busy)
            hb = self._heartbeats.get(i)
            if hb is not None:
                hb.tick()
        self._sample_ttft()
        self._autoscale()
        self._steps += 1
        self._publish_gauges()
        return outs

    # -- routing -------------------------------------------------------------

    def _session_key(self, prompt: List[int]) -> Optional[bytes]:
        """The request's session: the prefix cache's chained digest of
        the FIRST page-aligned prompt chunk (None below one page). The
        replicas' caches use the same hash and chunking, so a collision
        costs at worst a cold route, never a wrong token."""
        ps = self.page_size
        if len(prompt) < ps:
            return None
        return _chunk_hash(None, prompt[:ps])

    @staticmethod
    def _can_take_cold(w: Engine) -> bool:
        """A cold dispatch wants admission now: a free slot, an empty
        local queue."""
        return not w._waiting and any(r is None for r in w._slots)

    @staticmethod
    def _can_take_warm(w: Engine) -> bool:
        """A warm (session-affine) dispatch may queue behind the
        replica's work, within a bounded backlog."""
        return len(w._waiting) < w.max_slots

    def _route(self, req: Request) -> Tuple[Optional[int], bool]:
        """A replica for ``req``: (index, routed warm); None when no
        replica has room this step (the request stays queued)."""
        alive = [(i, w) for i, w in self._alive()
                 if i not in self._draining]
        if not alive:
            return None, False
        pinned = self._migrate_dst.get(req.req_id)
        if pinned is not None:
            if self._replicas[pinned] is not None \
                    and pinned not in self._draining:
                if self._can_take_warm(self._replicas[pinned]):
                    return pinned, False
                return None, False
            self._migrate_dst.pop(req.req_id, None)
        if self.router == "round_robin":
            pos = self._rr_pos
            for k in range(len(alive)):
                i, w = alive[(pos + k) % len(alive)]
                if self._can_take_cold(w):
                    self._rr_pos = (pos + k + 1) % len(alive)
                    return i, False
            return None, False
        if self.router == "session":
            if req.req_id not in self._skey:
                self._skey[req.req_id] = self._session_key(req.prompt)
            skey = self._skey[req.req_id]
            if skey is not None:
                hint = self._sessions.get(skey)
                best_i, best_score = None, 0
                probe = min((len(req.prompt) - 1) // self.page_size,
                            ROUTE_PROBE_CHUNKS)
                for i, w in alive:
                    depth = 0
                    if w._prefix is not None:
                        depth = w._prefix.lookup(req.prompt,
                                                 max_chunks=probe)
                    # the hint scores like one warm page
                    score = depth + (self.page_size if i == hint else 0)
                    if score > best_score:
                        best_i, best_score = i, score
                if best_i is not None \
                        and self._can_take_warm(self._replicas[best_i]):
                    return best_i, True
        # least loaded (and the "least_loaded" router): most free slots,
        # then most free pages
        free = [(i, w) for i, w in alive if self._can_take_cold(w)]
        if not free:
            return None, False
        i, _ = max(free, key=lambda e: (
            sum(1 for r in e[1]._slots if r is None),
            e[1]._alloc.free_pages, -e[0]))
        return i, False

    def _assign(self, req: Request, index: int, warm: bool,
                front: bool) -> None:
        w = self._replicas[index]
        req.queued_step = w._steps
        if front:
            w._waiting.appendleft(req)
        else:
            w._waiting.append(req)
        w.requests[req.req_id] = req
        self._home[req.req_id] = index
        self._migrate_dst.pop(req.req_id, None)
        if self.router == "session":
            skey = self._skey.get(req.req_id)
            if skey is not None:
                self._sessions[skey] = index
                while len(self._sessions) > 4096:
                    self._sessions.pop(next(iter(self._sessions)))
        st = self.replica_stats[index]
        st["routed_warm" if warm else "routed_cold"] += 1
        monitor.counter("serving.fleet.routed_warm" if warm
                        else "serving.fleet.routed_cold").increase()

    def _dispatch(self) -> None:
        """Hand fleet-held requests to replicas: parked ones first (to the
        target's queue front), then one a tenant a round-robin turn."""
        still: "deque[Request]" = deque()
        while self._parked:
            req = self._parked.popleft()
            if req.state in (FINISHED, FAILED):
                continue
            idx, warm = self._route(req)
            if idx is None:
                still.append(req)
                continue
            self._assign(req, idx, warm, front=True)
        self._parked = still
        stalls = 0
        while self._rr and stalls < len(self._rr):
            tenant = self._rr[0]
            self._rr.rotate(-1)
            q = self._queues.get(tenant)
            if not q:
                stalls += 1
                continue
            req = q[0]
            idx, warm = self._route(req)
            if idx is None:
                stalls += 1
                continue
            q.popleft()
            self._assign(req, idx, warm, front=False)
            stalls = 0

    # -- live migration ------------------------------------------------------

    def _take_out(self, w: Engine, rid: int) -> Optional[Request]:
        """``extract_request`` with the generator replaced by one replayed
        from host truth (the source's is never carried over)."""
        req = w.extract_request(rid, device_key=False)
        if req is not None:
            req.generator = _replayed_generator(req, self.vocab_size,
                                                self.device)
            req.preemptions += 1
            req.queued_step = self._steps
        return req

    def migrate_request(self, req_id: int,
                        dst: Optional[int] = None) -> bool:
        """Live-migrate one in-flight request off its replica: extracted
        from the source (slot cleared, pages freed now), its generator
        replayed from (seed, tokens emitted), and parked on the fleet
        for re-admission at ``dst`` (when given and alive) or wherever
        the router places it, through the resume-prefill path: the
        continued stream is the never-migrated run's. False for an
        unknown, retired or unplaced request."""
        rid = int(req_id)
        if dst is not None:
            dst = int(dst)
            if not 0 <= dst < len(self._replicas) \
                    or self._replicas[dst] is None:
                raise ValueError(
                    f"migrate_request dst {dst} is not a live replica")
        src = self._home.get(rid)
        if src is None or self._replicas[src] is None:
            return False
        req = self._take_out(self._replicas[src], rid)
        if req is None:
            return False
        # extract_request opened the MIGRATING span (origin: the source)
        if req.spans and req.spans[-1].get("phase") == tracing.MIGRATING:
            req.spans[-1].setdefault("detail", {})["kind"] = "live"
        self._home.pop(rid, None)
        if dst is not None:
            self._migrate_dst[rid] = dst
        self._parked.append(req)
        self.replica_stats[src]["migrated_out"] += 1
        monitor.counter("serving.fleet.migrations").increase()
        monitor.counter("serving.preemptions").increase()
        return True

    def drain_replica(self, index: int) -> int:
        """Migrate EVERY live request off replica ``index`` and close it
        to new dispatches (``undrain_replica`` re-opens it). No token is
        dropped. Returns the number migrated."""
        index = int(index)
        if not 0 <= index < len(self._replicas) \
                or self._replicas[index] is None:
            raise ValueError(f"drain_replica: no live replica {index}")
        self._draining.add(index)
        w = self._replicas[index]
        rids = sorted(
            (r.req_id for r in w.requests.values()
             if r.state not in (FINISHED, FAILED)),
            key=lambda rid: self._order.get(rid, 10**9))
        return sum(1 for rid in rids if self.migrate_request(rid))

    def undrain_replica(self, index: int) -> None:
        self._draining.discard(int(index))

    # -- failover ------------------------------------------------------------

    def _maybe_chaos(self) -> None:
        if self._injector is None:
            return
        self._injector.on_step(self._steps)
        if not self._injector.fire("replica.die", record=False):
            return
        alive = [i for i, _ in self._alive()]
        if len(alive) <= 1:
            return             # never the last replica
        self._injector.record("replica.die")
        victim = alive[int(self._injector.rng.integers(0, len(alive)))]
        self.kill_replica(victim)

    def _sweep_stalled(self, step_gap: float) -> None:
        """Heartbeat verdicts: a replica whose heartbeat stalled WHILE the
        driver kept stepping is wedged, so it is killed and failed over
        (unless it is the last one: the flag waits for the next step).
        When the DRIVER paused past the timeout, every heartbeat aged out
        through no fault of the replicas: the flags clear instead."""
        if not self._stalled:
            return
        if self._heartbeat_timeout is not None \
                and step_gap > float(self._heartbeat_timeout):
            self._stalled.clear()
            return
        for i in sorted(self._stalled):
            if self._replicas[i] is None:
                self._stalled.discard(i)
                continue
            if len(self._alive()) <= 1:
                continue
            self._stalled.discard(i)
            self.kill_replica(i)

    def kill_replica(self, index: int) -> int:
        """Drop a replica wholesale (pools, allocator, prefix cache, its
        device memory released) and re-admit every request that lived
        there from host truth alone: the prompt, the tokens so far and a
        replayed generator. Returns the number re-admitted. The last
        live replica cannot be killed."""
        index = int(index)
        if not 0 <= index < len(self._replicas):
            raise ValueError(
                f"kill_replica index {index} out of range for "
                f"{len(self._replicas)} replica slot(s)")
        w = self._replicas[index]
        if w is None:
            return 0
        if len(self._alive()) <= 1:
            raise RuntimeError(
                "cannot kill the last replica: the fleet must keep "
                "serving")
        monitor.counter("serving.fleet.replica_deaths").increase()
        doomed = sorted(
            (r.req_id for r in w.requests.values()
             if r.state not in (FINISHED, FAILED)),
            key=lambda rid: (self._order.get(rid, 10**9), rid))
        zero_progress: List[Request] = []
        n = 0
        for rid in doomed:
            # the extraction migration takes (page frees on the dying
            # allocator are harmless), so failover cannot drift from it
            req = self._take_out(w, rid)
            if req is None:
                continue
            if req.generated:
                if req.spans and \
                        req.spans[-1].get("phase") == tracing.MIGRATING:
                    req.spans[-1].setdefault(
                        "detail", {})["kind"] = "failover"
            else:
                tracing.open_span(req.spans, tracing.QUEUED,
                                  self._clock() * 1e3, self.label,
                                  kind="failover")
            self._home.pop(req.req_id, None)
            self._migrate_dst.pop(req.req_id, None)
            if req.generated:
                self._parked.append(req)   # partial progress goes first
            else:
                # an assigned, unstarted request rejoins its tenant's
                # queue front (it is the tenant's oldest)
                zero_progress.append(req)
            monitor.counter("serving.fleet.readmitted").increase()
            n += 1
        for req in reversed(zero_progress):
            self._enqueue(req, self._tenant.get(req.req_id, "default"),
                          front=True)
        del w
        self._remove_replica(index)
        return n

    # -- autoscaling ---------------------------------------------------------

    def _sample_ttft(self) -> None:
        """TTFT samples (fleet clock) as requests reach their first token:
        the autoscaler's latency signal does not wait for finishes."""
        if self._policy is None:
            return
        window = int(self._policy.ttft_window)
        for rid, req in self.requests.items():
            if req.first_token_t > 0.0 and rid not in self._ttft_sampled:
                self._ttft_sampled.add(rid)
                if self._ttft_hist.count >= window:
                    self._ttft_hist_prev = self._ttft_hist
                    self._ttft_hist = monitor.Histogram(
                        "fleet.autoscale.ttft")
                self._ttft_hist.record(
                    (req.first_token_t - req.arrival_t) * 1e3)

    def _autoscale(self) -> None:
        pol = self._policy
        if pol is None:
            return
        live = self._alive()
        qd = self.num_waiting
        pressure = qd > int(pol.scale_up_queue_depth)
        if not pressure and pol.scale_up_ttft_p95_ms is not None:
            merged = monitor.Histogram("fleet.autoscale.ttft.merged")
            merged.merge(self._ttft_hist).merge(self._ttft_hist_prev)
            if merged.count >= 4:
                pressure = merged.percentile(95) \
                    > float(pol.scale_up_ttft_p95_ms)
        self._up_streak = self._up_streak + 1 if pressure else 0
        load = sum(w.num_active + w.num_prefilling + len(w._waiting)
                   for _, w in live)
        fits = (len(live) > int(pol.min_replicas) and qd == 0
                and 2 * load <= (len(live) - 1) * self.max_slots)
        self._down_streak = self._down_streak + 1 if fits else 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        if self._up_streak >= int(pol.patience) \
                and len(live) < int(pol.max_replicas):
            idx = next((i for i, w in enumerate(self._replicas)
                        if w is None), None)
            idx = self._spawn_replica(idx)
            self.scale_log.append({
                "step": self._steps, "action": "up", "replica": idx,
                "queue_depth": qd, "replicas": len(self._alive())})
        elif self._down_streak >= int(pol.scale_down_patience):
            # drain by migration first: the victim's requests re-admit
            # elsewhere token-exact before the replica closes
            idx, _ = min(live, key=lambda e: (
                e[1].num_active + e[1].num_prefilling
                + len(e[1]._waiting), e[0]))
            del live, _      # the dropped replica's memory goes with it
            moved = self.drain_replica(idx)
            self._remove_replica(idx)
            self.scale_log.append({
                "step": self._steps, "action": "down", "replica": idx,
                "migrated": moved, "replicas": len(self._alive())})
        else:
            return
        monitor.counter("serving.fleet.scale_events").increase()
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = int(pol.cooldown)

    # -- reliability surfaces ------------------------------------------------

    def snapshot(self) -> dict:
        """Crash-exact host-state snapshot of the fleet: every queued,
        parked and live request's host truth. Generators are replayed on
        restore, never saved. The format is the JAX fleet's, with
        ``torch_rng_device`` as in the disaggregated driver's."""
        reqs: List[Request] = []
        for _, w in self._alive():
            reqs.extend(r for r in w.requests.values()
                        if r.state not in (FINISHED, FAILED))
        reqs.extend(self._parked)
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
                "parked": req in self._parked,
                "preemptions": int(req.preemptions),
                "elapsed_ms": (now - req.arrival_t) * 1e3,
                "spans": tracing.copy_spans(req.spans),
            })
        monitor.counter("serving.snapshot_saves").increase()
        return {
            "version": FLEET_SNAPSHOT_VERSION,
            "kind": "fleet",
            "topology": {"replicas": len(self._alive())},
            "fingerprint": self._fingerprint(),
            "next_id": int(self._next_id),
            "torch_rng_device": self.device.type,
            "requests": entries,
        }

    def restore(self, snap: dict) -> int:
        """Re-admit a snapshot's requests into this fresh fleet: those
        with tokens (parked ones included) resume through the parked lane
        with replayed generators, untouched ones queue under their
        tenant; the outputs are the uninterrupted run's. The replica
        count may differ."""
        restore_check(self, snap, "fleet", FLEET_SNAPSHOT_VERSION)
        n = 0
        for ent in snap["requests"]:
            req = restored_request(self, ent)
            tenant = str(ent.get("tenant", "default"))
            self.requests[req.req_id] = req
            self._tenant[req.req_id] = tenant
            self._order[req.req_id] = len(self._order)
            self._skey[req.req_id] = self._session_key(req.prompt)
            if req.generated:
                self._parked.append(req)
            else:
                self._enqueue(req, tenant)
            n += 1
        self._next_id = max(self._next_id, int(snap.get("next_id", 0)))
        monitor.counter("serving.snapshot_restores").increase()
        return n

    def _fingerprint(self) -> Dict[str, object]:
        return driver_fingerprint(self.model, self.cache_dtype,
                                  self._alive()[0][1])

    def leaked_pages(self) -> int:
        """Pages still held on the live replicas after their prefix
        caches are released (a dead replica's pool died with it)."""
        return sum(w.leaked_pages() for _, w in self._alive())

    def check_invariants(self, repair: bool = False) -> List[str]:
        findings: List[str] = []
        for i, w in self._alive():
            findings += [f"replica{i}: {f}"
                         for f in w.check_invariants(repair=repair)]
        return findings

    def steady_state_recompiles(self) -> int:
        raise NotImplementedError(
            f"steady_state_recompiles reads the compile tracker: it comes "
            f"with {_ITEM6}")

    def per_replica_recompiles(self) -> Dict[int, int]:
        raise NotImplementedError(
            f"per_replica_recompiles reads the compile tracker: it comes "
            f"with {_ITEM6}")

    def inspect_hotpath(self):
        raise NotImplementedError(
            f"inspect_hotpath runs analysis.hotpath_lint: it comes with "
            f"{_ITEM6}")

    def close(self):
        for hb in self._heartbeats.values():
            hb.stop()
        self._heartbeats.clear()
        for _, w in self._alive():
            w.close()

    def __del__(self):
        # a dropped fleet stops its watchers (they hold it only weakly);
        # stop() sets each one's event before it joins, so a join that
        # fails (interpreter teardown, or the last reference dropped on
        # a watcher thread) still ends that thread
        for hb in self.__dict__.get("_heartbeats", {}).values():
            try:
                hb.stop()
            except Exception:  # noqa: BLE001
                pass

    # -- bookkeeping ---------------------------------------------------------

    def _held(self) -> List[Request]:
        return list(self._parked)

    def _drop_from_queues(self, req: Request) -> None:
        super()._drop_from_queues(req)
        try:
            self._parked.remove(req)
        except ValueError:
            pass
        self._migrate_dst.pop(req.req_id, None)
        home = self._home.get(req.req_id)
        if home is not None and self._replicas[home] is not None:
            self._drop_from_engine(self._replicas[home], req)

    def _retired(self, out: Output,
                 replica: Optional[int] = None) -> None:
        self._home.pop(out.req_id, None)
        self._migrate_dst.pop(out.req_id, None)
        self._skey.pop(out.req_id, None)
        self._ttft_sampled.discard(out.req_id)
        if replica is not None:
            self.replica_stats[replica]["finished"] += 1
        super()._retired(out)

    def _publish_gauges(self):
        monitor.gauge("serving.fleet.queue_depth").set(self.num_waiting)
        monitor.gauge("serving.fleet.replicas").set(len(self._alive()))
        monitor.gauge("serving.fleet.parked").set(len(self._parked))
        for i, w in self._alive():
            monitor.gauge(f"serving.fleet.replica{i}.queue_depth").set(
                len(w._waiting))
            monitor.gauge(f"serving.fleet.replica{i}.prefix_hit_rate").set(
                w.prefix_hit_rate)

    # -- introspection -------------------------------------------------------

    @property
    def num_replicas(self) -> int:
        return len(self._alive())

    @property
    def num_waiting(self) -> int:
        return (sum(len(q) for q in self._queues.values())
                + len(self._parked))

    @property
    def num_parked(self) -> int:
        return len(self._parked)

    @property
    def num_active(self) -> int:
        return sum(w.num_active for _, w in self._alive())

    @property
    def num_prefilling(self) -> int:
        return sum(w.num_prefilling for _, w in self._alive())

    @property
    def idle(self) -> bool:
        return (self.num_waiting == 0
                and all(w.idle for _, w in self._alive()))

    @property
    def pages_free(self) -> Dict[str, int]:
        return {f"replica{i}": w._alloc.free_pages
                for i, w in self._alive()}

    @property
    def prefix_hit_rate(self) -> float:
        """FLEET-WIDE prefix reuse: hits over lookups across every replica
        that ever served (dead replicas' totals kept) — what session
        routing exists to raise."""
        hits = self._retired_hits
        lookups = self._retired_lookups
        for _, w in self._alive():
            if w._prefix is not None:
                hits += w._prefix.hits
                lookups += w._prefix.lookups
        return hits / lookups if lookups else 0.0

    @property
    def spec_accept_rate(self) -> float:
        drafted = sum(w._spec_drafted for _, w in self._alive())
        accepted = sum(w._spec_accepted for _, w in self._alive())
        return accepted / drafted if drafted else 0.0

    def utilization(self) -> Dict[str, Dict[str, object]]:
        """Per-replica utilization for the replay report: the busy-step
        share, warm / cold routes, migrations out, finishes, the live
        prefix hit rate and queue depth; a dead replica reports
        ``alive: False``."""
        out: Dict[str, Dict[str, object]] = {}
        for i in sorted(self.replica_stats):
            st = self.replica_stats[i]
            w = self._replicas[i] if i < len(self._replicas) else None
            out[f"replica{i}"] = {
                "alive": w is not None,
                "utilization": round(
                    st["busy_steps"] / max(st["steps"], 1), 4),
                "routed_warm": st["routed_warm"],
                "routed_cold": st["routed_cold"],
                "migrated_out": st["migrated_out"],
                "finished": st["finished"],
                "prefix_hit_rate": (round(w.prefix_hit_rate, 4)
                                    if w is not None else None),
                "queue_depth": (len(w._waiting)
                                if w is not None else None),
            }
        return out
