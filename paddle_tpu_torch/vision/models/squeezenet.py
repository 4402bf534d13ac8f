"""SqueezeNet (counterpart of ``paddle_tpu/vision/models/squeezenet.py``;
reference: python/paddle/vision/models/squeezenet.py)."""
from __future__ import annotations

from ... import concat, nn
from ._pretrained import no_pretrained


class _Fire(nn.Layer):
    def __init__(self, in_ch, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Conv2D(in_ch, squeeze, 1)
        self.relu = nn.ReLU()
        self.expand1 = nn.Conv2D(squeeze, e1, 1)
        self.expand3 = nn.Conv2D(squeeze, e3, 3, padding=1)

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return concat([self.relu(self.expand1(x)),
                       self.relu(self.expand3(x))], axis=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(512, 64, 256, 256),
            )
        elif version == "1.1":
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256),
            )
        else:
            raise ValueError("version must be '1.0' or '1.1'")
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1),
                nn.ReLU(),
            )
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.avgpool(x)
        return nn.Flatten()(x)


def squeezenet1_0(pretrained=False, **kwargs):
    no_pretrained(pretrained, "squeezenet1_0")
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    no_pretrained(pretrained, "squeezenet1_1")
    return SqueezeNet("1.1", **kwargs)
