"""paddle_tpu_torch.vision (counterpart of ``paddle_tpu/vision``; reference:
python/paddle/vision): the model zoo on the eager surface, host-side numpy
transforms and datasets, and the detection ops of ``ops`` (plain PyTorch on
the tensors' device; the host ops in numpy, their results back on the
input's device). Imports neither PIL nor cv2 until an image is decoded."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401
from .models import LeNet, ResNet, resnet18, resnet50  # noqa: F401
from .image import (  # noqa: F401
    get_image_backend, image_load, set_image_backend,
)
