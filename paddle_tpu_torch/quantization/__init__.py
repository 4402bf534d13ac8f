"""paddle.quantization (counterpart of ``paddle_tpu/quantization``): the
fake-quant and linear quantize ops, the KV-cache and weight quantizers
(``functional``), the QAT / PTQ surface, the observers and quanters, and
the quantized execution layers (``WeightOnlyLinear``,
``quantize_for_inference``: the serving entry for int8 / int4 decode)."""
from .functional import (  # noqa: F401
    dequantize_linear, fake_channel_wise_quantize_dequantize_abs_max,
    fake_quantize_abs_max, fake_quantize_dequantize_abs_max,
    kv_dequantize_arrays, kv_quantize_arrays, quantize_linear)
from .qat import PTQ, QAT, QuantConfig  # noqa: F401
from .layers import (WeightOnlyLinear, WeightOnlyLinearModule,  # noqa: F401
                     quantize_for_inference)
from . import observers, quanters  # noqa: F401
from .observers import AbsmaxObserver, BaseObserver  # noqa: F401
from .quanters import BaseQuanter, FakeQuanterWithAbsMax, quanter  # noqa: F401

__all__ = ["fake_channel_wise_quantize_dequantize_abs_max",
           "fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
           "quantize_linear", "dequantize_linear", "kv_quantize_arrays",
           "kv_dequantize_arrays", "QAT", "PTQ", "QuantConfig",
           "WeightOnlyLinear", "WeightOnlyLinearModule",
           "quantize_for_inference", "observers", "quanters",
           "AbsmaxObserver", "BaseObserver", "BaseQuanter",
           "FakeQuanterWithAbsMax", "quanter"]
