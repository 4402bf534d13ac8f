"""paddle.device.xpu: the same functions as device.cuda, as in the JAX
package (``paddle_tpu/device/xpu.py``), where both name the accelerator;
here the accelerator is the GPU."""
from .cuda import *  # noqa: F401,F403
from .cuda import device_count, empty_cache, synchronize  # noqa: F401
