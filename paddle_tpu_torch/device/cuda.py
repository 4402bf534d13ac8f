"""paddle.device.cuda (counterpart of ``paddle_tpu/device/cuda.py``): the
CUDA streams, events and allocator statistics of ``device``, and the
card's properties (``torch.cuda``'s)."""
import torch

from . import Event, Stream, current_stream, stream_guard  # noqa: F401
from . import device_count, synchronize  # noqa: F401
from .monitor import (_cuda_index, max_memory_allocated,  # noqa: F401
                      max_memory_reserved, memory_allocated,
                      memory_reserved)


def is_available():
    return torch.cuda.is_available()


def empty_cache():
    """Release the allocator's cached, unused blocks to the card."""
    _cuda_index(None, "the CUDA allocator's cache")
    torch.cuda.empty_cache()


def get_device_properties(device=None):
    """name, total_memory, major, minor, multi_processor_count, ..."""
    return torch.cuda.get_device_properties(
        _cuda_index(device, "device properties"))


def get_device_name(device=None):
    return torch.cuda.get_device_name(_cuda_index(device, "a device name"))


def get_device_capability(device=None):
    return torch.cuda.get_device_capability(
        _cuda_index(device, "a device capability"))
