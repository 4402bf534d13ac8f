from .allocator import PageAllocator
from .encoder import POOLING_MODES, BatchEncoder, EmbedOutput, EmbedParams
from .engine import Engine, Output, SamplingParams

__all__ = ["BatchEncoder", "EmbedOutput", "EmbedParams", "Engine", "Output",
           "PageAllocator", "POOLING_MODES", "SamplingParams"]
