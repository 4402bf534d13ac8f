"""Collective communication (counterpart of
``paddle_tpu/distributed/communication/collectives.py``).

The JAX package's collectives lower to XLA collectives over mesh axes
inside a trace (and are the identity on its single controller). The
port's are eager calls on the group's ``torch.distributed`` process
group, with Paddle's contracts (:170-434):

- the ops work in place: ``all_reduce``, ``broadcast``, ``reduce``,
  ``scatter``, ``reduce_scatter`` and ``alltoall_single`` write their
  output tensor and return it;
- a list output (``all_gather``, ``all_gather_object``, ``alltoall``) is
  filled: extended with one entry a rank when it is empty, else copied
  into, entry by entry (it must then hold one a rank);
- ``src`` / ``dst`` / ``peer`` are global ranks;
- a tensor may be a surface ``Tensor`` (its torch tensor is written) or
  a torch tensor; nothing here is differentiable (the tensor-parallel
  ops with gradients are ``fleet/layers/mpu/mp_ops.py``);
- ``sync_op=False`` runs the op all the same and returns a finished task
  (``isend`` / ``irecv`` return the pending one).

Under gloo a collective on CUDA tensors stages them: each is copied to
pinned host memory, the op runs there and the outputs are copied back,
for every op alike (PyTorch documents gloo's CUDA support for only a few
ops). The counters ``distributed.staged_bytes.<op>`` count the bytes
copied both ways, ``distributed.calls.<op>`` the calls and
``distributed.host_us.<op>`` the host time of the call, staging
included. Under NCCL nothing is staged. ``ReduceOp.AVG`` is a SUM
divided by the group size.
"""
from __future__ import annotations

import time
from typing import List

import torch
import torch.distributed as dist

from ... import monitor
from ...core.tensor import Tensor
from .. import env
from .group import Group, _Done, _resolve


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}


def _op(op):
    if op not in _TORCH_OPS:
        raise ValueError(f"unknown ReduceOp {op}")
    return _TORCH_OPS[op]


def _data(x):
    return x._data if isinstance(x, Tensor) else x


def _like(orig, t):
    return Tensor._from_data(t) if isinstance(orig, Tensor) else t


def staged_bytes() -> dict:
    """{op: bytes staged through host memory} since the last
    ``monitor.reset()``."""
    pre = "distributed.staged_bytes."
    return {k[len(pre):]: v for k, v in monitor.counters().items()
            if k.startswith(pre) and v}


class _Call:
    """One collective call: its staging (under gloo, for CUDA tensors)
    and its counters. ``host(t)`` is the tensor the op reads and writes
    in place of ``t``; ``done()`` copies the staged outputs back."""

    def __init__(self, name: str, tensors):
        self.name = name
        self.t0 = time.perf_counter()
        self.stage = env.backend() == "gloo" and any(
            t is not None and t.is_cuda for t in tensors)
        self.nbytes = 0
        self._back = []

    def host(self, t, write=False, read=True):
        if not self.stage or t is None or not t.is_cuda:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if read:
            h.copy_(t)
            self.nbytes += t.numel() * t.element_size()
        if write:
            self._back.append((t, h))
        return h

    def done(self):
        for dev_t, h in self._back:
            dev_t.copy_(h)
            self.nbytes += h.numel() * h.element_size()
        self._back = []
        monitor.counter(f"distributed.calls.{self.name}").increase()
        if self.nbytes:
            monitor.counter(
                f"distributed.staged_bytes.{self.name}").increase(self.nbytes)
        monitor.counter(f"distributed.host_us.{self.name}").increase(
            int((time.perf_counter() - self.t0) * 1e6))


def _trivial(g: Group) -> bool:
    """A group of one with no process group: every op is the identity."""
    return g.pg is None


def _avg(t, op, g):
    if op == ReduceOp.AVG:
        if t.is_floating_point():
            t.div_(g.nranks)
        else:
            t.floor_divide_(g.nranks)


@torch.no_grad()
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    g = _resolve(group)
    t = _data(tensor)
    if _trivial(g):
        return tensor
    c = _Call("all_reduce", [t])
    h = c.host(t, write=True)
    dist.all_reduce(h, op=_op(op), group=g.pg)
    _avg(h, op, g)
    c.done()
    return tensor


@torch.no_grad()
def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands on global rank ``dst``; the other ranks'
    tensors are left as the backend leaves them."""
    g = _resolve(group)
    t = _data(tensor)
    if _trivial(g):
        return tensor
    c = _Call("reduce", [t])
    h = c.host(t, write=True)
    dist.reduce(h, dst=int(dst), op=_op(op), group=g.pg)
    if env.get_rank() == int(dst):
        _avg(h, op, g)
    c.done()
    return tensor


def _fill(out_list, orig, results):
    """Paddle's list contract: extend an empty list, else copy into it."""
    if out_list is None:
        return results
    if len(out_list) == 0:
        out_list.extend(_like(orig, r) for r in results)
    else:
        if len(out_list) != len(results):
            raise ValueError(f"the output list has {len(out_list)} entries, "
                             f"the group {len(results)} ranks")
        with torch.no_grad():
            for o, r in zip(out_list, results):
                _data(o).copy_(r)
    return out_list


@torch.no_grad()
def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Gather every rank's ``tensor`` into ``tensor_list`` (rank order)."""
    g = _resolve(group)
    t = _data(tensor)
    if _trivial(g):
        return _fill(tensor_list, tensor, [t.clone()])
    c = _Call("all_gather", [t])
    outs = [torch.empty_like(t) for _ in range(g.nranks)]
    h_in = c.host(t)
    h_outs = [c.host(o, write=True, read=False) for o in outs]
    dist.all_gather(h_outs, h_in.contiguous(), group=g.pg)
    c.done()
    return _fill(tensor_list, tensor, outs)


def all_gather_object(object_list, obj, group=None):
    """Gather every rank's picklable ``obj`` into ``object_list``."""
    g = _resolve(group)
    if _trivial(g):
        objs = [obj]
    else:
        objs = [None] * g.nranks
        dist.all_gather_object(objs, obj, group=g.pg)
    object_list.extend(objs)
    return object_list


@torch.no_grad()
def broadcast(tensor, src=0, group=None, sync_op=True):
    g = _resolve(group)
    t = _data(tensor)
    if _trivial(g):
        return tensor
    c = _Call("broadcast", [t])
    h = c.host(t, write=True, read=env.get_rank() == int(src))
    dist.broadcast(h, src=int(src), group=g.pg)
    c.done()
    return tensor


def broadcast_object_list(object_list, src=0, group=None):
    g = _resolve(group)
    if not _trivial(g):
        dist.broadcast_object_list(object_list, src=int(src), group=g.pg)
    return object_list


@torch.no_grad()
def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``src``'s ``tensor_list[i]`` lands in group rank i's
    ``tensor``."""
    g = _resolve(group)
    t = _data(tensor)
    me_src = env.get_rank() == int(src)
    if _trivial(g):
        if tensor_list:
            t.copy_(_data(tensor_list[0]))
        return tensor
    if me_src and (tensor_list is None or len(tensor_list) != g.nranks):
        raise ValueError("scatter: the source rank needs one tensor a rank")
    srcs = [_data(x) for x in tensor_list] if me_src else []
    c = _Call("scatter", [t] + srcs)
    h = c.host(t, write=True, read=False)
    h_srcs = [c.host(s).contiguous() for s in srcs] if me_src else None
    dist.scatter(h, h_srcs, src=int(src), group=g.pg)
    c.done()
    return tensor


@torch.no_grad()
def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """Reduce the ranks' inputs and leave group rank i the i-th part: a
    list of one tensor a rank, or one tensor split on dim 0."""
    g = _resolve(group)
    t = _data(tensor)
    inp = tensor_or_tensor_list
    if isinstance(inp, (list, tuple)):
        parts = [_data(x) for x in inp]
    else:
        whole = _data(inp)
        if whole.shape[0] % g.nranks:
            raise ValueError(
                f"reduce_scatter: input dim 0 ({whole.shape[0]}) must be "
                f"divisible by the group size ({g.nranks})")
        parts = list(whole.chunk(g.nranks))
    if len(parts) != g.nranks:
        raise ValueError(f"reduce_scatter: {len(parts)} inputs for a group "
                         f"of {g.nranks}")
    if _trivial(g):
        t.copy_(parts[0])
        return tensor
    c = _Call("reduce_scatter", [t] + parts)
    h = c.host(t, write=True, read=False)
    h_parts = [c.host(p).contiguous() for p in parts]
    if c.stage or env.backend() == "gloo":
        dist.reduce_scatter(h, h_parts, op=_op(op), group=g.pg)
    else:
        dist.reduce_scatter_tensor(h, torch.cat(h_parts), op=_op(op),
                                   group=g.pg)
    _avg(h, op, g)
    c.done()
    return tensor


@torch.no_grad()
def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Group rank j's ``in_tensor_list[i]`` lands in group rank i's
    ``out_tensor_list[j]``. A single input tensor is split on dim 0 into
    one part a rank."""
    g = _resolve(group)
    if isinstance(in_tensor_list, (list, tuple)):
        ins = [_data(x) for x in in_tensor_list]
        orig = in_tensor_list[0] if in_tensor_list else None
    else:
        whole = _data(in_tensor_list)
        if whole.shape[0] != g.nranks:
            raise ValueError(
                f"all_to_all: single-tensor input dim 0 ({whole.shape[0]}) "
                f"must equal the group size ({g.nranks})")
        ins = list(whole.unbind(0))
        orig = in_tensor_list
    if len(ins) != g.nranks:
        raise ValueError(f"all_to_all: {len(ins)} inputs for a group of "
                         f"{g.nranks}")
    if _trivial(g):
        return _fill(out_tensor_list, orig, [x.clone() for x in ins])
    c = _Call("all_to_all", ins)
    outs = [torch.empty_like(x) for x in ins]
    h_outs = [c.host(o, write=True, read=False) for o in outs]
    h_ins = [c.host(x).contiguous() for x in ins]
    dist.all_to_all(h_outs, h_ins, group=g.pg)
    c.done()
    return _fill(out_tensor_list, orig, outs)


alltoall = all_to_all


@torch.no_grad()
def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """All-to-all on dim 0 of one tensor, evenly or by split sizes."""
    g = _resolve(group)
    out, inp = _data(out_tensor), _data(in_tensor)
    if _trivial(g):
        out.copy_(inp)
        return out_tensor
    c = _Call("alltoall_single", [out, inp])
    h_out = c.host(out, write=True, read=False)
    h_in = c.host(inp).contiguous()
    dist.all_to_all_single(
        h_out, h_in,
        output_split_sizes=list(out_split_sizes) if out_split_sizes else None,
        input_split_sizes=list(in_split_sizes) if in_split_sizes else None,
        group=g.pg)
    c.done()
    return out_tensor


class _P2PTask:
    """A pending isend / irecv: ``wait()`` waits for the transfer and
    copies a staged receive back to the card."""

    def __init__(self, work, call):
        self._work, self._call = work, call

    def wait(self, timeout=None):
        if self._work is not None:
            self._work.wait()
            self._work = None
            self._call.done()
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def isend(tensor, dst=0, group=None, sync_op=True):
    """Post a send and return its task (``wait()``); ``sync_op`` is the
    JAX package's flag, taken for its signature: the send is asynchronous
    either way."""
    g = _resolve(group)
    t = _data(tensor)
    c = _Call("send", [t])
    work = dist.isend(c.host(t).contiguous(), dst=int(dst), group=g.pg)
    return _P2PTask(work, c)


def irecv(tensor, src=0, group=None, sync_op=True):
    """Post a receive into ``tensor`` and return its task; ``sync_op`` as
    in ``isend``."""
    g = _resolve(group)
    t = _data(tensor)
    c = _Call("recv", [t])
    work = dist.irecv(c.host(t, write=True, read=False), src=int(src),
                      group=g.pg)
    return _P2PTask(work, c)


def send(tensor, dst=0, group=None, sync_op=True):
    isend(tensor, dst, group).wait()
    return _Done()


def recv(tensor, src=0, group=None, sync_op=True):
    irecv(tensor, src, group).wait()
    return _Done()


class P2POp:
    """One point-to-point op of ``batch_isend_irecv``: ``op`` is
    ``isend`` or ``irecv`` (of this module), ``peer`` a global rank."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv):
            raise ValueError("P2POp's op must be isend or irecv")
        self.op, self.tensor, self.peer, self.group = op, tensor, peer, group


def batch_isend_irecv(p2p_op_list) -> List[_P2PTask]:
    """Issue every op of the list together (torch's
    ``batch_isend_irecv``); returns one task an op."""
    calls, torch_ops = [], []
    for p in p2p_op_list:
        g = _resolve(p.group)
        t = _data(p.tensor)
        send_ = p.op is isend
        c = _Call("send" if send_ else "recv", [t])
        h = c.host(t).contiguous() if send_ else \
            c.host(t, write=True, read=False)
        torch_ops.append(dist.P2POp(dist.isend if send_ else dist.irecv, h,
                                    int(p.peer), group=g.pg))
        calls.append(c)
    works = dist.batch_isend_irecv(torch_ops) if torch_ops else []
    return [_P2PTask(w, c) for w, c in zip(works, calls)]
