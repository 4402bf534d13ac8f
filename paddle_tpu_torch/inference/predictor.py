"""The paddle.inference predictor (counterpart of
``paddle_tpu/inference/__init__.py:18-268``).

``Config`` names a ``jit.save`` artifact, ``create_predictor`` loads it
(``jit.load``) and the predictor runs it through zero-copy-style handles
or a list of arrays, as paddle_infer's API does. The device is chosen
once, where the artifact is loaded: ``cuda`` unless the config asks for
the CPU (``disable_gpu()``); without a GPU the load raises. There is no
quiet fallback. ``enable_use_gpu(..., device_id)`` picks the card.
"""
from __future__ import annotations

import enum
import glob
import os

import numpy as np
import torch

from ..core.tensor import Tensor as _SurfaceTensor
from ..core.tensor import to_numpy


class Config:
    """paddle_infer.Config(model_file, params_file) or Config(model_dir)."""

    def __init__(self, prog_file=None, params_file=None, model_dir=None):
        if model_dir is not None and prog_file is None:
            models = sorted(glob.glob(os.path.join(model_dir, "*.pdmodel")))
            if not models:
                raise FileNotFoundError(
                    f"no .pdmodel artifact under {model_dir}")
            prog_file = models[0]
        # the jit.save prefix, or the explicit file path
        self.prefix = (prog_file[:-len(".pdmodel")]
                       if prog_file and prog_file.endswith(".pdmodel")
                       else prog_file)
        self._ir_optim = True
        self._memory_optim = True
        self._device = None          # cuda (resolved at load)

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def enable_memory_optim(self, flag=True):
        self._memory_optim = flag

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision_mode=None):
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self._device != "cpu"

    def set_cpu_math_library_num_threads(self, n):
        pass


class _Handle:
    """Zero-copy-style tensor handle (reference ZeroCopyTensor): host
    arrays in and out."""

    def __init__(self):
        self._value = None

    def copy_from_cpu(self, arr):
        self._value = np.ascontiguousarray(arr)

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(shape)

    def copy_to_cpu(self):
        return np.asarray(self._value)

    def shape(self):
        return list(np.asarray(self._value).shape)


def _host(o):
    if isinstance(o, _SurfaceTensor):
        return o.numpy()
    if isinstance(o, torch.Tensor):
        return to_numpy(o)
    return np.asarray(o)


class Predictor:
    def __init__(self, config: Config):
        from ..jit.serialization import load as jit_load
        self._layer = jit_load(config.prefix, device=config._device)
        n_in = getattr(self._layer, "num_inputs", 1)
        self._input_names = [f"input_{i}" for i in range(n_in)]
        self._inputs = {n: _Handle() for n in self._input_names}
        self._outputs = []

    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name) -> _Handle:
        return self._inputs[name]

    def run(self, inputs=None):
        """Positional arrays (their outputs returned, paddle_infer's list
        API) or the input handles' arrays (True returned; read the outputs
        through ``get_output_handle``)."""
        if inputs is not None:
            args = list(inputs)
        else:
            args = [self._inputs[n].copy_to_cpu() for n in self._input_names]
        out = self._layer(*args)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = [_host(o) for o in outs]
        if inputs is not None:
            return self._outputs
        return True

    def get_output_names(self):
        return [f"output_{i}" for i in range(len(self._outputs))]

    def get_output_handle(self, name) -> _Handle:
        h = _Handle()
        h.copy_from_cpu(self._outputs[int(name.split("_")[-1])])
        return h


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class DataType(enum.Enum):
    FLOAT32 = 0
    FLOAT16 = 1
    INT64 = 2
    INT32 = 3
    UINT8 = 4
    INT8 = 5
    BOOL = 6
    BFLOAT16 = 7


class PlaceType(enum.Enum):
    UNK = -1
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM = 3


class PrecisionType(enum.Enum):
    Float32 = 0
    Half = 1
    Int8 = 2
    Bfloat16 = 3


class XpuConfig:
    """Config bag (reference: inference.XpuConfig), carried for
    config-file compatibility; the port has no XPU backend."""

    def __init__(self):
        self.device_id = 0
        self.l3_size = 0


class Tensor:
    """Predictor IO tensor handle (reference: inference.Tensor): the
    copy_from_cpu / copy_to_cpu view over a torch tensor."""

    def __init__(self, data=None):
        self._data = data

    def copy_from_cpu(self, arr):
        self._data = torch.as_tensor(np.asarray(arr))

    def copy_to_cpu(self):
        return to_numpy(self._data)

    def shape(self):
        return list(self._data.shape) if self._data is not None else []

    def reshape(self, shape):
        self._data = self._data.reshape(shape)


class PredictorPool:
    """N independent predictors over one config."""

    def __init__(self, config, size=1):
        self._predictors = [create_predictor(config)
                            for _ in range(int(size))]

    def retrive(self, idx):  # the reference spells it 'retrive'
        return self._predictors[idx]

    retrieve = retrive


def get_version():
    return f"paddle_tpu_torch inference (torch {torch.__version__})"


def get_num_bytes_of_data_type(dtype):
    sizes = {DataType.FLOAT32: 4, DataType.FLOAT16: 2, DataType.INT64: 8,
             DataType.INT32: 4, DataType.UINT8: 1, DataType.INT8: 1,
             DataType.BOOL: 1, DataType.BFLOAT16: 2}
    return sizes[dtype]


def get_trt_compile_version():
    """No TensorRT is linked: (0, 0, 0), the reference's not-compiled
    answer."""
    return (0, 0, 0)


def get_trt_runtime_version():
    return (0, 0, 0)


def _get_phi_kernel_name(op_name):
    return op_name


__all__ = ["Config", "DataType", "PlaceType", "PrecisionType", "Predictor",
           "PredictorPool", "Tensor", "XpuConfig", "create_predictor",
           "get_num_bytes_of_data_type", "get_trt_compile_version",
           "get_trt_runtime_version", "get_version"]
