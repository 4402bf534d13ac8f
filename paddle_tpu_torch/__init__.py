"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside the JAX one (``paddle_tpu/``, the reference it
is held to). It imports ``torch``, never ``jax``, and nothing of
``paddle_tpu``. Plain tensor code is PyTorch; every kernel the JAX
package wrote in Pallas for the TPU is a hand-written CUDA kernel for
Hopper (``csrc/*.cu``, built with ``nvcc`` at first use).

The eager dygraph surface is the paddle API over torch:

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    paddle.seed(0)
    layer = nn.TransformerEncoderLayer(768, 12, 3072)     # on the GPU
    x = paddle.randn([8, 128, 768])
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = layer(x).mean()
    loss.backward()

``Tensor`` wraps a ``torch.Tensor`` (it does not subclass it: paddle's
``shape``, ``size`` and ``dtype`` collide with torch's), every op body
is a torch function dispatched through ``core.dispatch.run_op`` (AMP
cast by op name, NaN check), and torch autograd is the tape. Tensors,
parameters and the creation ops land on the current place, ``cuda:0``
unless ``set_device("cpu")`` was called; without a GPU they raise.
``linalg`` is a real module, the ``*_`` in-place variants are top-level
names and ``Tensor`` methods, and ``nn`` holds conv, pooling, the resize
/ fold / shuffle / grid functionals and the recurrent layers. ``jit``,
``inference``, ``text``, ``incubate``, ``regularizer``, ``quantization``
``distributed``, ``io``, ``metric``, ``hapi``, ``callbacks``,
``reader``, ``profiler``, ``device``, ``utils``, ``sysconfig``,
``version``, ``vision``, ``tensor``, ``fft``, ``signal``, ``audio``,
``distribution``, ``sparse``, ``geometric``, ``hub``, ``static`` and
``onnx`` resolve as
attributes on first use, and so
do ``Model``, ``summary`` and ``flops`` of ``hapi`` and ``to_dlpack`` /
``from_dlpack`` of ``utils.dlpack`` (a module ``__getattr__``: importing
them here would pull the serving, model, data, vision and profiler stacks
into every ``import``; ``dir()`` lists them). The high-level paths:

    model = paddle.Model(net)                      # a Layer or a Module
    model.prepare(paddle.optimizer.AdamW(2e-5, parameters=net.parameters()),
                  nn.CrossEntropyLoss(), paddle.metric.Accuracy(),
                  amp_configs={"level": "O1"})     # a bf16 TrainStep
    model.fit(paddle.io.DataLoader(ds, batch_size=32, num_workers=2))
    paddle.jit.save(net, "out/net", input_spec=[paddle.jit.InputSpec(
        [32, 128], "int64")])                      # torch.export
    pred = paddle.inference.create_predictor(
        paddle.inference.Config("out/net.pdmodel"))

``paddle.jit.to_static`` compiles a function or a Layer with Dynamo and
Inductor (one entry an input signature; the flash kernels enter the
graph as custom ops); ``static`` keeps the graph-free names of
``paddle.static`` and its control flow, ``onnx.export`` writes an ONNX
file from a Layer walk. ``DataParallel`` (``distributed``'s, resolved
lazily) averages gradients over the data-parallel ranks. The names of
the JAX package's top level whose modules are not ported yet
(``analysis``, ``cost_model``) are absent.

The port's models and the serving ``Engine`` take raw torch tensors:

    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.inference import Engine, SamplingParams

    model = LlamaForCausalLM(LlamaConfig(num_hidden_layers=4))  # on cuda
    eng = Engine(model, max_slots=16, page_size=128)
    outs = eng.run([(prompt_ids, SamplingParams(max_new_tokens=128))])

Entry points run on ``cuda`` by default and raise when no GPU is
visible; ``device="cpu"`` (``set_device("cpu")`` for the surface) runs
the kernels' plain PyTorch versions.
"""
import numpy as _np
import torch as _torch

from . import monitor
from .core.device import resolve_device
from .core.dtype import (bfloat16, bool_, complex64, complex128, dtype,
                         finfo, float8_e4m3fn, float8_e5m2, float16, float32,
                         float64, get_default_dtype, iinfo, int8, int16,
                         int32, int64, promote_types, pstring, raw,
                         set_default_dtype, uint8)
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace,
                         Place, TPUPlace, XPUPlace, get_device,
                         is_compiled_with_cuda, is_compiled_with_tpu,
                         is_compiled_with_xpu, set_device)
from .core.tensor import Tensor, to_tensor
from .core.random import get_rng_state, seed, set_rng_state
from .core.flags import get_flags, set_flags
from .core import flags
from . import ops
from .ops.creation import *  # noqa: F401,F403
from .ops.math import *  # noqa: F401,F403
from .ops.manipulation import *  # noqa: F401,F403
from .ops.logic import *  # noqa: F401,F403
from .ops.search import *  # noqa: F401,F403
from .ops.stat import *  # noqa: F401,F403
from . import linalg  # real module: import paddle_tpu_torch.linalg works
from .ops.linalg import cdist, einsum, matrix_transpose, norm, pdist  # noqa: F401
from .ops.math import bmm, dot, matmul, mm, mv, pow  # noqa: F401
from .ops.inplace import *  # noqa: F401,F403
from . import autograd
from .autograd import grad
from . import amp
from .framework import ParamAttr, load, save
from . import framework
from .framework.misc import (batch, check_shape, create_parameter,
                             disable_signal_handler, get_cuda_rng_state,
                             set_cuda_rng_state, set_printoptions)
from . import nn
from .nn.initializer.lazy_init import LazyGuard
from . import optimizer

bool = bool_  # noqa: A001 (paddle.bool)
pi = float(_np.pi)
nan = float(_np.nan)
inf = float(_np.inf)
newaxis = None

no_grad = _torch.no_grad
enable_grad = _torch.enable_grad
is_grad_enabled = _torch.is_grad_enabled
set_grad_enabled = _torch.set_grad_enabled


def in_dynamic_mode():
    return True


def disable_static(place=None):
    """A no-op: dygraph is the only mode; the compiled path is
    ``jit.to_static``, not a Program / Executor world."""


def enable_static():
    raise NotImplementedError(
        "static graph mode is subsumed by paddle.jit.to_static in the port")


#: subpackages resolved on first attribute access (``paddle.jit``, ...)
_LAZY_SUBPACKAGES = ("jit", "inference", "text", "incubate", "regularizer",
                     "quantization", "distributed", "io", "metric", "hapi",
                     "callbacks", "reader", "profiler", "device", "utils",
                     "sysconfig", "version", "vision", "fft", "signal",
                     "audio", "distribution", "sparse", "geometric", "hub",
                     "tensor", "static", "onnx")
#: names of a subpackage resolved on first access (``paddle.Model``)
_LAZY_NAMES = {"Model": "hapi", "summary": "hapi", "flops": "hapi",
               "to_dlpack": "utils.dlpack", "from_dlpack": "utils.dlpack",
               "DataParallel":
                   "distributed.fleet.meta_parallel.parallel_wrappers"}


def __getattr__(name):
    import importlib
    if name in _LAZY_SUBPACKAGES:
        mod = importlib.import_module(__name__ + "." + name)
        globals()[name] = mod
        return mod
    if name in _LAZY_NAMES:
        value = getattr(importlib.import_module(
            __name__ + "." + _LAZY_NAMES[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


#: subpackages that exist for internal use and are not top-level names
#: yet (``analysis`` holds only the MPMD lint until its slice)
_UNLISTED = {"analysis"}


def __dir__():
    return sorted((set(globals()) - _UNLISTED) | set(_LAZY_SUBPACKAGES) |
                  set(_LAZY_NAMES))
