"""paddle.incubate (counterpart of ``paddle_tpu/incubate``): the fused
ops and layers (``nn``), ``LookAhead`` / ``ModelAverage`` and the
functional minimizers (``optimizer``), ``asp``, ``autograd``,
``autotune``, the MoE stack (``distributed``), ``identity_loss`` and the
softmax-mask fusions, the graph samplers (``graph``) and ``geometric``'s
segment ops and ``send_u_recv`` under their incubate names, and
``inference`` (resolved on first access: it pulls in the serving stack,
which imports this package)."""
from . import asp, autograd, autotune, distributed, graph, nn, optimizer
from ..geometric import (segment_max, segment_mean,  # noqa: F401
                         segment_min, segment_sum)
from ..geometric import send_u_recv as graph_send_recv  # noqa: F401
from .graph import (graph_khop_sampler, graph_reindex,  # noqa: F401
                    graph_sample_neighbors)
from ..nn.functional.common import (  # noqa: F401
    fused_softmax_mask as softmax_mask_fuse,
    fused_softmax_mask_upper_triangle as softmax_mask_fuse_upper_triangle)
from ..nn.functional.loss import identity_loss  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401

__all__ = ["asp", "autograd", "autotune", "distributed", "nn",
           "optimizer", "inference", "LookAhead", "ModelAverage",
           "identity_loss", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "graph", "graph_khop_sampler",
           "graph_reindex", "graph_sample_neighbors", "graph_send_recv",
           "segment_max", "segment_mean", "segment_min", "segment_sum"]


def __getattr__(name):
    if name == "inference":
        import importlib
        mod = importlib.import_module("paddle_tpu_torch.inference")
        globals()["inference"] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | {"inference"})
