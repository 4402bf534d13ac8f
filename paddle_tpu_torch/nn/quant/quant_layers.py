"""paddle.nn.quant.quant_layers (counterpart of
``paddle_tpu/nn/quant/quant_layers.py``): the QAT layer names."""
from ...quantization.qat import QuantedWrapper  # noqa: F401
from ...quantization.quanters import BaseQuanter as QuanterBase  # noqa: F401
from ...quantization.quanters import FakeQuanterWithAbsMax  # noqa: F401

FakeQuantAbsMax = FakeQuanterWithAbsMax

__all__ = ["QuantedWrapper", "QuanterBase", "FakeQuanterWithAbsMax",
           "FakeQuantAbsMax"]
