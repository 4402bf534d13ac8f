from .allocator import PageAllocator
from .engine import Engine, Output, SamplingParams

__all__ = ["Engine", "Output", "PageAllocator", "SamplingParams"]
