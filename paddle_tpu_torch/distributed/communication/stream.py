"""``paddle.distributed.communication.stream.*`` (counterpart of
``paddle_tpu/distributed/communication/stream.py``).

Paddle's stream variants take ``use_calc_stream`` to run the NCCL call
on the compute stream. The port issues every collective on the current
stream (NCCL orders it after the work queued there; gloo's staging
copies synchronise), so the knob is accepted and changes nothing."""
from __future__ import annotations

from . import collectives as _c


def all_reduce(tensor, op=_c.ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_reduce(tensor, op=op, group=group, sync_op=sync_op)


def all_gather(tensor_or_tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_gather(tensor_or_tensor_list, tensor, group=group,
                         sync_op=sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True,
              use_calc_stream=False):
    return _c.broadcast(tensor, src=src, group=group, sync_op=sync_op)


def reduce(tensor, dst=0, op=_c.ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=False):
    return _c.reduce(tensor, dst=dst, op=op, group=group, sync_op=sync_op)


def reduce_scatter(tensor, tensor_or_tensor_list, op=_c.ReduceOp.SUM,
                   group=None, sync_op=True, use_calc_stream=False):
    return _c.reduce_scatter(tensor, tensor_or_tensor_list, op=op,
                             group=group, sync_op=sync_op)


def scatter(tensor, tensor_or_tensor_list=None, src=0, group=None,
            sync_op=True, use_calc_stream=False):
    return _c.scatter(tensor, tensor_or_tensor_list, src=src, group=group,
                      sync_op=sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             use_calc_stream=False):
    return _c.all_to_all(out_tensor_list, in_tensor_list, group=group,
                         sync_op=sync_op)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    return _c.alltoall_single(out_tensor, in_tensor, in_split_sizes,
                              out_split_sizes, group=group, sync_op=sync_op)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.send(tensor, dst=dst, group=group, sync_op=sync_op)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.recv(tensor, src=src, group=group, sync_op=sync_op)
