"""MobileNetV1 (counterpart of ``paddle_tpu/vision/models/mobilenetv1.py``;
reference: python/paddle/vision/models/mobilenetv1.py)."""
from __future__ import annotations

from ... import nn
from ._pretrained import no_pretrained


class _ConvBNRelu(nn.Layer):
    def __init__(self, in_ch, out_ch, k, stride=1, padding=0, groups=1):
        super().__init__()
        self.conv = nn.Conv2D(in_ch, out_ch, k, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_ch)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _DepthwiseSeparable(nn.Layer):
    def __init__(self, in_ch, out1, out2, stride, scale):
        super().__init__()
        c1 = int(out1 * scale)
        self.dw = _ConvBNRelu(in_ch, c1, 3, stride=stride, padding=1,
                              groups=in_ch)
        self.pw = _ConvBNRelu(c1, int(out2 * scale), 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = scale
        self.conv1 = _ConvBNRelu(3, int(32 * s), 3, stride=2, padding=1)
        cfg = [
            (int(32 * s), 32, 64, 1), (int(64 * s), 64, 128, 2),
            (int(128 * s), 128, 128, 1), (int(128 * s), 128, 256, 2),
            (int(256 * s), 256, 256, 1), (int(256 * s), 256, 512, 2),
            (int(512 * s), 512, 512, 1), (int(512 * s), 512, 512, 1),
            (int(512 * s), 512, 512, 1), (int(512 * s), 512, 512, 1),
            (int(512 * s), 512, 512, 1), (int(512 * s), 512, 1024, 2),
            (int(1024 * s), 1024, 1024, 1),
        ]
        self.blocks = nn.Sequential(*[
            _DepthwiseSeparable(in_ch, o1, o2, st, s)
            for in_ch, o1, o2, st in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * s), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.fc(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained, "mobilenet_v1")
    return MobileNetV1(scale=scale, **kwargs)
