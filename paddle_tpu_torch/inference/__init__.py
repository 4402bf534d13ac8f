from . import tracing
from .allocator import PageAllocator
from .encoder import POOLING_MODES, BatchEncoder, EmbedOutput, EmbedParams
from .engine import Engine, Output, SamplingParams
from .reliability import FaultInjector, FaultPlan, InjectedFault

__all__ = ["BatchEncoder", "EmbedOutput", "EmbedParams", "Engine",
           "FaultInjector", "FaultPlan", "InjectedFault", "Output",
           "PageAllocator", "POOLING_MODES", "SamplingParams", "tracing"]
