"""Vision models (counterpart of ``paddle_tpu/vision/models``; reference:
python/paddle/vision/models), on the eager surface's layers: convolutions
and pooling run cuDNN on the card (``nn.Conv2D``, ``nn.MaxPool2D``, ...).
The attribute names are the JAX package's, so
``set_state_dict(bridge.layer_state_from_jax(jax_model))`` carries a JAX
model's weights across. ``pretrained=True`` raises (nothing can be
downloaded)."""
from .alexnet import AlexNet, alexnet  # noqa: F401
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264,
)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .mobilenet import MobileNetV2, mobilenet_v2  # noqa: F401
from .mobilenetv1 import MobileNetV1, mobilenet_v1  # noqa: F401
from .mobilenetv3 import (  # noqa: F401
    MobileNetV3Large, MobileNetV3Small, mobilenet_v3_large,
    mobilenet_v3_small,
)
from .resnet import (  # noqa: F401
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
    resnext50_32x4d, resnext50_64x4d, resnext101_32x4d, resnext101_64x4d,
    resnext152_32x4d, resnext152_64x4d, wide_resnet50_2, wide_resnet101_2,
)
from .shufflenetv2 import (  # noqa: F401
    ShuffleNetV2, shufflenet_v2_swish, shufflenet_v2_x0_25,
    shufflenet_v2_x0_33, shufflenet_v2_x0_5, shufflenet_v2_x1_0,
    shufflenet_v2_x1_5, shufflenet_v2_x2_0,
)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
