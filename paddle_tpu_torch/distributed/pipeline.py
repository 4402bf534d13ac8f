"""Pipeline schedules over the pp ranks (counterpart of
``paddle_tpu/distributed/pipeline.py``).

The JAX package compiles a schedule as one ``lax.scan`` over ticks inside
``shard_map`` over the 'pp' axis, an activation hop being one
``ppermute`` a tick, and lets ``jax.grad`` reverse it. The port follows
Paddle's own runtime instead: each pp rank is a process holding only its
stage's parameters, and it runs its stage's events in their local order,
moving boundary activations and their gradients with
``isend`` / ``irecv``. The order is not written here: it is the stage's
program of the schedule's ``mpmd_graph`` event graph, so the runtime, the
graph and ``analysis.mpmd_lint`` cannot drift apart.

``StageRunner`` executes one rank's program of a graph:

- a message is posted at the tick after the one its producer ran at (the
  lockstep ppermute's timing), by both ends at the same boundary and in
  the same order: every boundary's sends and receives go out as one
  ``batch_isend_irecv`` (under NCCL one group, so that no two ranks wait
  on each other's queued sends); a receive is waited for when its
  consumer runs;
- the first message on each route, phase and chunk is preceded by its
  shape and dtype (the boundary's meta, sent once a runner);
- an fwd event runs the chunk's forward on autograd, on its input as a
  leaf; its ``acts`` slot keeps (input, output) until the bwd event
  reads it, and a slot still unread is never overwritten;
- a bwd event runs ``torch.autograd.backward`` from the output with the
  received gradient (the last chunk: from what ``seed`` gives, the
  microbatch's loss), the weights' gradients accumulating in ``.grad``,
  and sends the input's gradient on; under the zero-bubble schedules it
  takes only the input's gradient and leaves the weights' to the w event
  (``zero_bubble``: each autograd node runs once).

``stage_forward``, ``stage_backward`` and ``stage_weights`` are these
events' semantics, shared with the one-process MPMD programs
(``mpmd_runtime.PipelinePrograms``).

``pipeline_apply``, ``pipeline_apply_vpp``, ``pipeline_apply_zb`` and
``pipeline_apply_zbvpp`` are the schedules as differentiable functions of
a stage block ``block_fn(params, x, m, chunk_idx)`` (m the microbatch,
chunk_idx the global chunk v*S + s): each rank passes its stage's
parameters and the pp group, and every rank gets what the JAX function
returns, the last stage's [M, micro_batch, ...] outputs (broadcast over
the group); their gradient runs the backward half of the schedule.
``schedule_info``, ``schedule_stats``, ``split_microbatches`` and
``merge_microbatches`` are the JAX package's.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .mpmd_graph import BWD, FWD, W
from .zero_bubble import backward_x

#: the dtypes a boundary meta message can name
_META_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
                torch.int64, torch.int32)
_META_LEN = 10


def schedule_info(n_stages: int, n_micro: int, vpp_degree: int = 1):
    """Tick counts + bubble fraction for the compiled schedules — the
    in-test measurable that VPP cuts bubble vs GPipe."""
    S, M, V = n_stages, n_micro, vpp_degree
    if V <= 1:
        ticks = M + S - 1
        work = M            # useful ticks per stage (full-stage units)
    else:
        ticks = V * M + S - 1
        work = V * M        # useful ticks per stage (1/V-stage units)
    return {
        "ticks": ticks,
        "useful_ticks": work,
        "bubble_fraction": (ticks - work) / ticks,
    }


def schedule_stats(schedule_mode: str, n_stages: int, n_micro: int,
                   vpp_degree: int = 1):
    """Tick/bubble accounting for ANY supported schedule mode — the one
    dispatch point `analysis.shard_lint` (and tooling) uses so its
    numbers can never drift from the compiled schedules' own
    schedule_info/zb_schedule_info formulas."""
    mode = (schedule_mode or "FThenB").upper()
    S, M, V = n_stages, n_micro, max(1, vpp_degree)
    if mode in ("", "FTHENB", "1F1B"):
        return schedule_info(S, M, 1)
    if mode == "VPP":
        return schedule_info(S, M, V)
    from .zero_bubble import zb_schedule_info, zbvpp_schedule_info
    if mode == "ZBH1":
        return zb_schedule_info(S, M)
    if mode == "ZBVPP":
        return zbvpp_schedule_info(S, M, V)
    raise ValueError(f"unknown schedule_mode {schedule_mode!r}")


def split_microbatches(x, n_micro: int):
    """[B, ...] -> [n_micro, B // n_micro, ...]."""
    b = x.shape[0]
    if b % n_micro != 0:
        raise ValueError(
            f"batch size {b} not divisible by accumulate_steps {n_micro}")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def merge_microbatches(ys):
    return ys.reshape((-1,) + tuple(ys.shape[2:]))


# ---------------------------------------------------------------------------
# the rank runtime
# ---------------------------------------------------------------------------

class StageOps:
    """What a ``StageRunner`` calls (subclass and override):

    - ``feed(m)``: microbatch m's input of the stage's first chunk on
      stage 0;
    - ``forward(v, m, x)``: chunk v's forward on x (autograd on);
    - ``seed(m, y)``: at the last chunk's bwd, ``(out, dy)`` to run the
      backward from (default: y is the microbatch's loss, dy None);
    - ``params(v)``: chunk v's trainable leaves (the w event's inputs);
    - ``collect_dx(m, dx)``: the gradient of stage 0's first input;
    - ``input_grad``: whether ``feed``'s input takes a gradient;
    - ``grad``: whether the forwards record autograd (False: a forward
      only run, as an evaluation's)."""

    input_grad = False
    grad = True

    def feed(self, m):
        raise NotImplementedError

    def forward(self, v, m, x):
        raise NotImplementedError

    def seed(self, m, y):
        return y, None

    def params(self, v) -> List[torch.Tensor]:
        return []

    def collect_dx(self, m, dx):
        pass


def _leaf(x, grad: bool):
    """A stage input as a leaf of the stage's graph (taking a gradient
    when ``grad`` and floating)."""
    if not isinstance(x, torch.Tensor):
        return x
    return x.detach().requires_grad_(grad and x.is_floating_point())


def stage_forward(ops: StageOps, v: int, m: int, x=None):
    """An fwd event: chunk v's forward of microbatch m on ``x``, the
    received activation (None on the first chunk: ``ops.feed(m)``), as a
    leaf of the chunk's graph. Returns (the leaf, the output); the bwd
    event reads both. ``StageRunner`` (the pp ranks) and
    ``mpmd_runtime.PipelinePrograms`` (one process) run every event
    through these three functions."""
    x = _leaf(x, True) if x is not None else \
        _leaf(ops.feed(m), ops.input_grad)
    with torch.set_grad_enabled(ops.grad):
        y = ops.forward(v, m, x)
    return x, y


def stage_backward(ops: StageOps, ev, x, y, dy, graph, zb: bool):
    """A bwd event: the backward of the chunk's graph (x, y) from ``dy``,
    the received gradient (None on the last chunk: ``ops.seed``).
    Returns (the input's gradient, the W half or None): under the
    zero-bubble schedules (``zb``) only the input's gradient is taken
    here and the weights' are left to the w event
    (``zero_bubble.backward_x``); otherwise the weights' gradients
    accumulate in ``.grad`` now."""
    if dy is None:
        if not (ev.stage == graph.n_stages - 1
                and ev.chunk == graph.vpp_degree - 1):
            raise RuntimeError(f"{graph.subject}: {ev.describe()} has no "
                               f"gradient source")
        out, dy = ops.seed(ev.micro, y)
    else:
        out = y
    half = None
    if zb:
        dx, half = backward_x(out, x, dy, ops.params(ev.chunk))
    else:
        torch.autograd.backward(out, dy)
        dx = x.grad if isinstance(x, torch.Tensor) and x.requires_grad \
            else None
    if ev.stage == 0 and ev.chunk == 0 and dx is not None:
        ops.collect_dx(ev.micro, dx)
    if ev.sends and dx is None:
        raise TypeError(f"{graph.subject}: {ev.describe()} must send its "
                        f"input's gradient, but the stage input is not a "
                        f"floating tensor")
    return dx, half


def stage_weights(half) -> None:
    """A w event: the weights' gradients the bwd event left
    (``zero_bubble.WeightHalf``)."""
    half.run()


def _encode_meta(t: torch.Tensor, device) -> torch.Tensor:
    if t.dim() > _META_LEN - 2 or t.dtype not in _META_DTYPES:
        raise TypeError(f"a stage boundary must be a tensor of at most "
                        f"{_META_LEN - 2} dims of {_META_DTYPES}, got "
                        f"{t.dtype}{list(t.shape)}")
    meta = [t.dim(), _META_DTYPES.index(t.dtype)] + list(t.shape)
    meta += [0] * (_META_LEN - len(meta))
    return torch.tensor(meta, dtype=torch.int64, device=device)


def _decode_meta(meta: torch.Tensor):
    vals = [int(v) for v in meta.cpu().tolist()]
    return tuple(vals[2:2 + vals[0]]), _META_DTYPES[vals[1]]


class StageRunner:
    """One pp rank's program of ``graph`` (stage ``stage``), its peers
    the global ``ranks`` of each stage, over ``group``; tensors on
    ``device``. ``run(ops, phases)`` executes the program's events of
    ``phases`` (all by default); ``stats`` counts what the runs did."""

    def __init__(self, graph, stage: int, ranks: Sequence[int], group=None,
                 device=None):
        self.graph, self.stage = graph, int(stage)
        self.ranks = [int(r) for r in ranks]
        self.group = group
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.zb = any(ev.phase == W for ev in graph.events())
        self._meta: Dict[tuple, tuple] = {}
        self.stats = collections.Counter()
        self._plans: Dict[frozenset, tuple] = {}

    # -- the message plan --------------------------------------------------
    def _plan(self, phases):
        """(ticks, events by tick, posts by boundary) for the events of
        ``phases``; a post is (kind, peer stage, tag, key, first) with
        key (src, dst, phase, chunk) naming the route's boundary meta."""
        cached = self._plans.get(phases)
        if cached is not None:
            return cached
        g, me = self.graph, self.stage
        evs = []
        for s in range(g.n_stages):
            for i, ev in enumerate(g.programs.get(s, ())):
                if ev.phase in phases:
                    evs.append((ev.tick, s, i, ev))
        evs.sort(key=lambda e: e[:3])
        mine: Dict[int, list] = collections.defaultdict(list)
        posts: Dict[int, list] = collections.defaultdict(list)
        seen = set()
        for tick, s, _, ev in evs:
            if s == me:
                mine[tick].append(ev)
            for msg in ev.sends:
                key = (s, msg.peer, ev.phase, ev.chunk)
                first = key not in seen
                seen.add(key)
                if s == me:
                    posts[tick + 1].append(("send", msg.peer, tuple(msg.tag),
                                            key, first, ev.key))
                if msg.peer == me and s != me:
                    posts[tick + 1].append(("recv", s, tuple(msg.tag), key,
                                            first, ev.key))
        ticks = sorted(set(mine) | set(posts))
        plan = (ticks, dict(mine), dict(posts))
        self._plans[phases] = plan
        return plan

    def _meta_device(self):
        from . import env
        return self.device if env.backend() == "nccl" else torch.device("cpu")

    def _post(self, posts, produced, inbox, pending_sends):
        """One boundary: the metas of first messages, then the payloads,
        each set as one batch."""
        from .communication import collectives as C
        me = self.stage
        mdev = self._meta_device()
        ops, metas = [], []
        for kind, peer, tag, key, first, _ in posts:
            if not first or key in self._meta or peer == me:
                continue
            if kind == "send":
                payload = produced[(tag, peer)]
                t = _encode_meta(payload, mdev)
                self._meta[key] = (tuple(payload.shape), payload.dtype)
                ops.append(C.P2POp(C.isend, t, self.ranks[peer], self.group))
                pending_sends.append(t)
            else:
                t = torch.zeros(_META_LEN, dtype=torch.int64, device=mdev)
                ops.append(C.P2POp(C.irecv, t, self.ranks[peer], self.group))
                metas.append((key, t))
        if ops:
            tasks = C.batch_isend_irecv(ops)
            for op, task in zip(ops, tasks):
                if op.op is C.irecv:
                    task.wait()
                else:
                    pending_sends.append(task)
            for key, t in metas:
                self._meta[key] = _decode_meta(t)
        ops, recvs = [], []
        for kind, peer, tag, key, _, _ in posts:
            if peer == me:              # a stage's message to itself
                if kind == "send":
                    inbox[(me, me)].append(
                        (tag, produced.pop((tag, peer)), None))
                continue
            if kind == "send":
                payload = produced.pop((tag, peer))
                ops.append(C.P2POp(C.isend, payload, self.ranks[peer],
                                   self.group))
                pending_sends.append(payload)
                self.stats["sends"] += 1
            else:
                shape, dtype = self._meta[key]
                buf = torch.empty(shape, dtype=dtype, device=self.device)
                ops.append(C.P2POp(C.irecv, buf, self.ranks[peer],
                                   self.group))
                recvs.append((peer, tag, buf))
                self.stats["recvs"] += 1
        if ops:
            recvs = iter(recvs)
            for op, task in zip(ops, C.batch_isend_irecv(ops)):
                if op.op is C.isend:
                    pending_sends.append(task)
                else:
                    peer, tag, buf = next(recvs)
                    inbox[(peer, me)].append((tag, buf, task))

    # -- execution ---------------------------------------------------------
    def run(self, ops: StageOps, phases=(FWD, BWD, W)):
        """Execute this stage's events of ``phases``; the slots the fwd
        events fill stay on the runner for a later ``run`` of the
        backward phases."""
        phases = frozenset(phases)
        ticks, mine, posts = self._plan(phases)
        g, me = self.graph, self.stage
        produced: Dict[tuple, torch.Tensor] = {}
        inbox: Dict[tuple, collections.deque] = \
            collections.defaultdict(collections.deque)
        pending_sends: list = []
        if FWD in phases:
            self._slots: Dict[tuple, Any] = {}
        slots = self._slots
        for t in ticks:
            if t in posts:
                self._post(posts[t], produced, inbox, pending_sends)
            for ev in mine.get(t, ()):
                self._event(ev, ops, inbox, produced, slots)
                self.stats[ev.phase] += 1
        for task in pending_sends:
            if hasattr(task, "wait"):
                task.wait()
        if produced:
            raise RuntimeError(f"{g.subject}: stage {me} produced messages "
                               f"no boundary posted: {sorted(produced)}")

    def _recv(self, ev, inbox):
        (msg,) = ev.recvs
        q = inbox[(msg.peer, ev.stage)]
        if not q:
            raise RuntimeError(f"{self.graph.subject}: {ev.describe()} "
                               f"expects {tuple(msg.tag)} from stage "
                               f"{msg.peer} but nothing was posted")
        tag, buf, task = q.popleft()
        if tag != tuple(msg.tag):
            raise RuntimeError(f"{self.graph.subject}: {ev.describe()} FIFO "
                               f"head from stage {msg.peer} is {tag}, "
                               f"expected {tuple(msg.tag)}")
        if task is not None:
            task.wait()
        return buf

    def _event(self, ev, ops, inbox, produced, slots):
        if ev.phase == FWD:
            x = self._recv(ev, inbox) if ev.recvs else None
            x, y = stage_forward(ops, ev.chunk, ev.micro, x)
            for (buf, slot) in ev.writes:
                if (buf, slot) in slots:
                    raise RuntimeError(
                        f"{self.graph.subject}: {ev.describe()} overwrites "
                        f"the live slot ({buf}, {slot})")
                slots[(buf, slot)] = (x, y)
            for msg in ev.sends:
                produced[(tuple(msg.tag), msg.peer)] = y.detach()
            return
        ((buf, slot),) = ev.reads
        if ev.phase == BWD:
            x, y = slots.pop((buf, slot))
            dy = self._recv(ev, inbox) if ev.recvs else None
            dx, half = stage_backward(ops, ev, x, y, dy, self.graph, self.zb)
            for w in ev.writes:
                slots[w] = half
            for msg in ev.sends:
                produced[(tuple(msg.tag), msg.peer)] = dx
            return
        stage_weights(slots.pop((buf, slot)))


# ---------------------------------------------------------------------------
# the schedules as differentiable functions of a stage block
# ---------------------------------------------------------------------------

def _pp_info(group):
    """(S, this stage, the stages' global ranks) of the pp ``group``
    (None: a world of one stage)."""
    if group is None:
        return 1, 0, [0]
    return group.nranks, group.rank, list(group.ranks)


class _BlockOps(StageOps):
    """The stage ops of a block schedule: chunk v of this stage is the
    global chunk v*S + s. The last chunk's outputs are kept (``ys``), or,
    with ``loss_of``, turned into microbatch losses (``losses``)."""

    def __init__(self, block_fn, params_of, xs, S, stage, V, remat,
                 loss_of=None):
        self.block_fn, self.params_of = block_fn, params_of
        self.xs, self.S, self.stage, self.remat = xs, S, stage, remat
        self.last_v = V - 1 if stage == S - 1 else -1
        self.loss_of = loss_of
        self.input_grad = loss_of is None
        self.ys: Dict[int, torch.Tensor] = {}
        self.dxs: Dict[int, torch.Tensor] = {}
        self.losses: List[torch.Tensor] = []
        self.d_ys = None

    def feed(self, m):
        return self.xs[m]

    def forward(self, v, m, x):
        params = self.params_of(v)
        ci = v * self.S + self.stage
        if self.remat:
            from .fleet.recompute import recompute
            y = recompute(self.block_fn, params, x, m, ci)
        else:
            y = self.block_fn(params, x, m, ci)
        if v == self.last_v:
            if self.loss_of is not None:
                y = self.loss_of(m, y)
                self.losses.append(y.detach())
            else:
                self.ys[m] = y
        return y

    def seed(self, m, y):
        if self.loss_of is not None:
            return y, None
        return y, self.d_ys[m]

    def params(self, v):
        return list(self.params_of(v).values())

    def collect_dx(self, m, dx):
        self.dxs[m] = dx


def _run_schedule(graph, block_fn, chunk_params, xs, group, remat):
    """The forward half of ``graph`` on this rank, its backward half as
    the gradient: every rank returns the last stage's outputs."""
    S, stage, ranks = _pp_info(group)
    V = graph.vpp_degree
    names = [sorted(p) for p in chunk_params]
    flat = [chunk_params[v][n] for v in range(V) for n in names[v]]

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, xs_, *flat_):
            leaves, k = [], 0
            for v in range(V):
                d = {}
                for n in names[v]:
                    d[n] = flat_[k].detach().requires_grad_(
                        flat_[k].requires_grad)
                    k += 1
                leaves.append(d)
            runner = StageRunner(graph, stage, ranks, group, xs_.device)
            ops = _BlockOps(block_fn, lambda v: leaves[v], xs_.detach(), S,
                            stage, V, remat)
            runner.run(ops, phases=(FWD,))
            # stage blocks map activations to activations of the same
            # shape (as the JAX schedules require): ys is shaped as xs
            ys = torch.stack([ops.ys[m].detach()
                              for m in range(graph.n_micro)]) \
                if stage == S - 1 else torch.empty_like(xs_)
            if group is not None and S > 1:
                from .communication import collectives as C
                C.broadcast(ys, src=ranks[-1], group=group)
            ctx.runner, ctx.ops, ctx.leaves = runner, ops, leaves
            return ys

        @staticmethod
        def backward(ctx, d_ys):
            runner, ops = ctx.runner, ctx.ops
            ops.d_ys = d_ys.contiguous()
            runner.run(ops, phases=(BWD, W))
            d_xs = None
            if stage == 0 and ops.dxs:
                d_xs = torch.stack([ops.dxs[m]
                                    for m in range(graph.n_micro)])
            grads = [ctx.leaves[v][n].grad for v in range(V)
                     for n in names[v]]
            return (d_xs, *grads)

    return _Fn.apply(xs, *flat)


def _check_stages(group, n_stages):
    S, _, _ = _pp_info(group)
    if n_stages is not None and int(n_stages) != S:
        raise ValueError(f"the schedule has {n_stages} stages but the pp "
                         f"group has {S} ranks")
    return S


def gpipe_local(block_fn: Callable, n_stages: int, n_micro: int,
                group=None, remat: bool = False):
    """The GPipe (FThenB) schedule's rank-local function:
    ``local_fn(stage_params, xs)`` -> the last stage's [M, mb, ...]
    outputs. ``stage_params``: this rank's {name: tensor}."""
    from .mpmd_graph import gpipe_graph
    S = _check_stages(group, n_stages)
    graph = gpipe_graph(S, int(n_micro))

    def local_fn(stage_params, xs):
        return _run_schedule(graph, block_fn, [stage_params], xs, group,
                             remat)

    return local_fn


def one_f_one_b_local(block_fn: Callable, n_stages: int, n_micro: int,
                      group=None, remat: bool = False):
    """The 1F1B schedule's rank-local function. One forward and one
    backward interleave, so the backward cannot wait for the caller's:
    ``local_fn(stage_params, xs, loss_of)`` runs the whole schedule,
    ``loss_of(m, y)`` giving microbatch m's loss on the last stage;
    the parameters' gradients accumulate in their ``.grad``. Returns the
    sum of the microbatch losses on the last stage (None elsewhere)."""
    from .mpmd_graph import one_f_one_b_graph
    S = _check_stages(group, n_stages)
    _, stage, ranks = _pp_info(group)
    graph = one_f_one_b_graph(S, int(n_micro))

    def local_fn(stage_params, xs, loss_of):
        ops = _BlockOps(block_fn, lambda v: stage_params, xs, S, stage, 1,
                        remat, loss_of)
        StageRunner(graph, stage, ranks, group, xs.device).run(ops)
        return torch.stack(ops.losses).sum() if ops.losses else None

    return local_fn


def vpp_local(block_fn: Callable, n_stages: int, n_micro: int,
              vpp_degree: int, group=None, remat: bool = False):
    """The interleaved (VPP) schedule's rank-local function:
    ``local_fn(chunk_params, xs)``, ``chunk_params`` this rank's V
    {name: tensor} dicts (chunk v of stage s is the global chunk
    v*S + s, the round-robin placement)."""
    from .mpmd_graph import vpp_graph
    S = _check_stages(group, n_stages)
    M, V = int(n_micro), int(vpp_degree)
    if M < S:
        raise ValueError(
            f"interleaved schedule needs accumulate_steps >= pp degree "
            f"({M} < {S})")
    graph = vpp_graph(S, M, V)

    def local_fn(chunk_params, xs):
        return _run_schedule(graph, block_fn, list(chunk_params), xs, group,
                             remat)

    return local_fn


def _n_micro(xs, n_micro):
    return int(n_micro if n_micro is not None else xs.shape[0])


def pipeline_apply(block_fn: Callable, stage_params: Dict[str, Any], xs,
                   group=None, n_micro: Optional[int] = None,
                   remat: bool = False):
    """Run the GPipe schedule. ``stage_params``: this rank's stage
    parameters; ``xs``: the [n_micro, micro_batch, ...] microbatch stack
    (read on stage 0); ``group``: the pp group. Differentiable in the
    stage parameters and xs; every rank gets the last stage's outputs."""
    S, _, _ = _pp_info(group)
    return gpipe_local(block_fn, S, _n_micro(xs, n_micro), group,
                       remat)(stage_params, xs)


def pipeline_apply_vpp(block_fn: Callable, chunk_params: Sequence[Dict],
                       xs, vpp_degree: int, group=None,
                       n_micro: Optional[int] = None, remat: bool = False):
    """Run the interleaved (VPP) schedule; ``chunk_params``: this rank's
    ``vpp_degree`` chunks (chunk v = the global chunk v*S + s)."""
    S, _, _ = _pp_info(group)
    if len(chunk_params) != int(vpp_degree):
        raise ValueError(f"{len(chunk_params)} chunks for vpp_degree "
                         f"{vpp_degree}")
    return vpp_local(block_fn, S, _n_micro(xs, n_micro), vpp_degree,
                     group, remat)(chunk_params, xs)


def pipeline_apply_zb(block_f: Callable, stage_params: Dict[str, Any], xs,
                      group=None, n_micro: Optional[int] = None):
    """Run the zero-bubble (ZBH1) schedule: its backward takes each
    microbatch's input gradient first and the weights' in the w events
    the graph places in the drain bubble (``zero_bubble.zb_local``)."""
    from .zero_bubble import zb_local
    S, _, _ = _pp_info(group)
    return zb_local(block_f, S, _n_micro(xs, n_micro), group)(
        stage_params, xs)


def pipeline_apply_zbvpp(block_f: Callable, chunk_params: Sequence[Dict],
                         xs, vpp_degree: int, group=None,
                         n_micro: Optional[int] = None):
    """Run the zero-bubble interleaved (ZBVPP) schedule."""
    from .zero_bubble import zbvpp_local
    S, _, _ = _pp_info(group)
    return zbvpp_local(block_f, S, _n_micro(xs, n_micro), vpp_degree,
                       group)(list(chunk_params), xs)
