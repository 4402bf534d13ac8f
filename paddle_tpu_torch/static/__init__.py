"""paddle.static of the port (counterpart of ``paddle_tpu/static``).

There is no Program / Executor world here: ``paddle.jit.to_static``
(Dynamo + Inductor) takes its place. The graph-free names keep working
(``InputSpec``, the name and device guards, places, parameters and
global variables, metrics, ``Print``, ``ExponentialMovingAverage``,
``data`` -> ``InputSpec``, ``gradients``, the load / save helpers over
``paddle.load`` and ``jit.load``) and ``static.nn`` maps the static
layer builders onto the dygraph functionals, its control flow onto
``torch.cond`` / ``while_loop`` under a trace. The Program and Executor
names raise, as in the JAX package, with the port's alternative.
"""
from __future__ import annotations

import contextlib

import torch

from ..core.tensor import Tensor as Variable
from ..jit.api import InputSpec
from . import nn

__all__ = ["InputSpec", "name_scope", "device_guard", "Program",
           "default_main_program", "default_startup_program"]

_NO_PROGRAMS = ("the port has no static Programs; trace with "
                "paddle.jit.to_static instead")


@contextlib.contextmanager
def name_scope(prefix=None):
    """A no-op: op names exist only in Programs."""
    yield


@contextlib.contextmanager
def device_guard(device=None):
    """A no-op: placement follows the tensors (kept for source
    compatibility)."""
    yield


class Program:
    def __init__(self, *a, **kw):
        raise NotImplementedError(_NO_PROGRAMS)


def default_main_program():
    raise NotImplementedError(_NO_PROGRAMS)


def default_startup_program():
    raise NotImplementedError(_NO_PROGRAMS)


# -- graph-free statics kept runnable ----------------------------------------

def cpu_places(device_count=None):
    """``device_count`` CPU places (one by default)."""
    from ..core.place import CPUPlace
    return [CPUPlace() for _ in range(device_count or 1)]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """paddle.create_parameter (the same factory)."""
    from ..framework.misc import create_parameter as _cp
    return _cp(shape, dtype, name=name, attr=attr, is_bias=is_bias,
               default_initializer=default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A Tensor filled with ``value``, flagged ``persistable``."""
    from ..ops.creation import full
    t = full(shape, value, dtype)
    t.persistable = persistable
    t.name = name
    return t


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-k accuracy (paddle.metric.accuracy)."""
    from ..metric import accuracy as _acc
    return _acc(input, label, k=k)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1, ins_tag_weight=None):
    """(auc, batch_auc, states): the op library's AUC twice and no
    states, as the JAX package returns it."""
    from ..ops.stat import auc as _auc
    val = _auc(input, label, num_thresholds=num_thresholds)
    return val, val, []


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """Print the value (after ``message``) and return it."""
    if message:
        print(message, input)
    else:
        print(input)
    return input


class WeightNormParamAttr:
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "use paddle.nn.utils.weight_norm on the Layer instead")


class BuildStrategy:
    """A bag of fusion switches, kept for configuration compatibility:
    Inductor makes its own fusions."""

    def __init__(self):
        self.enable_addto = False
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.enable_auto_fusion = False


class ExponentialMovingAverage:
    """EMA of parameters (static.ExponentialMovingAverage): ``update``
    folds the parameters into f32 averages (``decay * ema + (1 - decay)
    * p``, the first update takes ``p``); ``apply`` swaps the averages
    into the parameters (a context manager, restoring on exit unless
    ``need_restore=False``); ``restore`` swaps the parameters back. The
    swaps copy in place, so each Parameter keeps the tensor an optimizer
    updates."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = float(decay)
        self._ema = {}
        self._backup = {}
        self._params = []

    def update(self, parameters=None):
        if parameters is not None:
            self._params = list(parameters)
        for p in self._params:
            cur = p._data.detach().float()
            prev = self._ema.get(id(p))
            self._ema[id(p)] = cur.clone() if prev is None else \
                self._decay * prev + (1 - self._decay) * cur

    def apply(self, executor=None, need_restore=True):
        outer = self

        class _Ctx:
            def __enter__(ctx):
                with torch.no_grad():
                    for p in outer._params:
                        if id(p) in outer._ema:
                            outer._backup[id(p)] = p._data.detach().clone()
                            p._data.copy_(outer._ema[id(p)])
                return ctx

            def __exit__(ctx, *exc):
                if need_restore:
                    outer.restore()
                return False
        return _Ctx()

    def restore(self, executor=None):
        with torch.no_grad():
            for p in self._params:
                if id(p) in self._backup:
                    p._data.copy_(self._backup.pop(id(p)))


class CompiledProgram:
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "the port has no Programs to compile; compile with "
            "paddle.jit.to_static")


class Executor:
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "the port has no Executor; call layers eagerly or compile "
            "with paddle.jit.to_static")


class IpuCompiledProgram:
    def __init__(self, *a, **kw):
        raise NotImplementedError("the port runs on CUDA GPUs, not IPUs")


class IpuStrategy(IpuCompiledProgram):
    pass


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    raise NotImplementedError(
        "the port has no static graphs to append to; call "
        "loss.backward() (eager) or let paddle.jit.TrainStep "
        "differentiate the whole step")


__all__ += ["cpu_places", "create_parameter", "create_global_var",
            "accuracy", "auc", "Print", "WeightNormParamAttr",
            "BuildStrategy", "ExponentialMovingAverage",
            "CompiledProgram", "Executor", "append_backward", "Variable"]


def cuda_places(device_ids=None):
    """The card's places: ``CUDAPlace(i)`` for each id (every visible
    GPU by default; none without one)."""
    from ..core.place import CUDAPlace
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in device_ids]


def data(name, shape, dtype=None, lod_level=0):
    """An input placeholder: the ``InputSpec`` (jit's placeholder)."""
    return InputSpec(shape=shape, dtype=dtype or "float32", name=name)


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """paddle.grad of ``targets`` with respect to ``inputs``."""
    from ..autograd import grad
    return grad(targets, inputs, grad_outputs=target_gradients)


def global_scope():
    """The module's scope, a dict (there is no Scope world)."""
    return _GLOBAL_SCOPE


class _Scope(dict):
    def var(self, name):
        return self.setdefault(name, None)

    def find_var(self, name):
        return self.get(name)


_GLOBAL_SCOPE = _Scope()


def ipu_shard_guard(index=-1, stage=-1):
    raise NotImplementedError("the port runs on CUDA GPUs, not IPUs")


def _pdparams(model_path):
    return model_path if model_path.endswith(".pdparams") \
        else model_path + ".pdparams"


def load(program, model_path, executor=None, var_list=None):
    """The state dict ``paddle.save`` wrote to ``model_path.pdparams``."""
    from ..framework.io import load as _load
    return _load(_pdparams(model_path))


def save(program, model_path):
    raise NotImplementedError(
        "the port has no Programs to save; paddle.save(state_dict) or "
        "paddle.jit.save")


def load_from_file(path):
    """The bytes of a file."""
    with open(path, "rb") as f:
        return f.read()


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_inference_model(path_prefix, executor=None, **kwargs):
    """A ``jit.save`` artifact as [layer, [], []]: the loaded
    ``TranslatedLayer`` plays the Program's role. ``kwargs`` go to
    ``jit.load`` (``device="cpu"`` off the card)."""
    from ..jit.serialization import load as _jit_load
    return [_jit_load(path_prefix, **kwargs), [], []]


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         **kwargs):
    raise NotImplementedError(
        "export with paddle.jit.save(layer, path) (a torch.export "
        "program)")


def load_program_state(model_path, var_list=None):
    """The saved state dict."""
    from ..framework.io import load as _load
    return _load(_pdparams(model_path))


def set_program_state(program, state_dict):
    """Load ``state_dict`` into the Layer standing for the program."""
    if hasattr(program, "set_state_dict"):
        program.set_state_dict(state_dict)
        return program
    raise TypeError("pass the nn.Layer to receive the state")


def serialize_program(*a, **kw):
    raise NotImplementedError("no Program serialization; paddle.jit.save")


def deserialize_program(*a, **kw):
    raise NotImplementedError("no Program serialization; paddle.jit.load")


def serialize_persistables(*a, **kw):
    raise NotImplementedError("paddle.save(state_dict) replaces this")


def deserialize_persistables(*a, **kw):
    raise NotImplementedError("paddle.load replaces this")


def normalize_program(*a, **kw):
    raise NotImplementedError(_NO_PROGRAMS)


def ctr_metric_bundle(*a, **kw):
    raise NotImplementedError("the PS / CTR serving stack is out of scope")


__all__ += ["cuda_places", "data", "gradients", "global_scope", "load",
            "save", "load_from_file", "save_to_file",
            "load_inference_model", "save_inference_model",
            "load_program_state", "set_program_state",
            "serialize_program", "deserialize_program",
            "serialize_persistables", "deserialize_persistables",
            "normalize_program", "ctr_metric_bundle", "ipu_shard_guard"]


@contextlib.contextmanager
def program_guard(main_program=None, startup_program=None):
    """A no-op scope: there are no Programs to guard."""
    yield


@contextlib.contextmanager
def scope_guard(scope):
    """A no-op scope: the module's scope stands in."""
    yield


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """An eager Python call (static.py_func)."""
    return func(x)


def set_ipu_shard(layer, index=-1, stage=-1):
    raise NotImplementedError("the port runs on CUDA GPUs, not IPUs")


def xpu_places(device_ids=None):
    raise NotImplementedError("the port runs on CUDA GPUs; accelerator "
                              "places are cuda_places()")


__all__ += ["program_guard", "scope_guard", "py_func", "set_ipu_shard",
            "xpu_places"]
