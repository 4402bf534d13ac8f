from . import tracing
from .allocator import PageAllocator
from .encoder import POOLING_MODES, BatchEncoder, EmbedOutput, EmbedParams
from .engine import Engine, Output, SamplingParams
from .predictor import (Config, DataType, PlaceType, PrecisionType,
                        Predictor, PredictorPool, Tensor, XpuConfig,
                        create_predictor, get_num_bytes_of_data_type,
                        get_trt_compile_version, get_trt_runtime_version,
                        get_version)
from .reliability import FaultInjector, FaultPlan, InjectedFault

__all__ = ["BatchEncoder", "Config", "DataType", "EmbedOutput",
           "EmbedParams", "Engine", "FaultInjector", "FaultPlan",
           "InjectedFault", "Output", "PageAllocator", "PlaceType",
           "POOLING_MODES", "PrecisionType", "Predictor", "PredictorPool",
           "SamplingParams", "Tensor", "XpuConfig", "create_predictor",
           "get_num_bytes_of_data_type", "get_trt_compile_version",
           "get_trt_runtime_version", "get_version", "tracing",
           "DisaggEngine", "ServingFleet", "AutoscalePolicy"]


def __getattr__(name):
    # the disaggregated driver and the fleet load on first use, as the
    # JAX package's do
    if name == "DisaggEngine":
        from .disagg import DisaggEngine
        return DisaggEngine
    if name in ("ServingFleet", "AutoscalePolicy"):
        from . import fleet as _fleet
        return getattr(_fleet, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
