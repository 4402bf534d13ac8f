"""MobileNetV3 Large/Small (counterpart of
``paddle_tpu/vision/models/mobilenetv3.py``; reference:
python/paddle/vision/models/mobilenetv3.py)."""
from __future__ import annotations

from ... import nn
from ._pretrained import no_pretrained


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _SE(nn.Layer):
    def __init__(self, ch):
        super().__init__()
        squeeze = _make_divisible(ch // 4)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(ch, squeeze, 1)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(squeeze, ch, 1)
        self.hs = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hs(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _InvertedResidualV3(nn.Layer):
    def __init__(self, in_ch, exp, out_ch, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        act_layer = nn.Hardswish if act == "hardswish" else nn.ReLU
        layers = []
        if exp != in_ch:
            layers += [nn.Conv2D(in_ch, exp, 1, bias_attr=False),
                       nn.BatchNorm2D(exp), act_layer()]
        layers += [nn.Conv2D(exp, exp, k, stride=stride,
                             padding=k // 2, groups=exp, bias_attr=False),
                   nn.BatchNorm2D(exp)]
        if use_se:
            layers.append(_SE(exp))
        layers += [act_layer(),
                   nn.Conv2D(exp, out_ch, 1, bias_attr=False),
                   nn.BatchNorm2D(out_ch)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_LARGE = [
    # k, exp, out, se, act, stride
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_exp, last_ch, scale=1.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_ch = _make_divisible(16 * scale)
        self.conv = nn.Sequential(
            nn.Conv2D(3, in_ch, 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(in_ch), nn.Hardswish())
        blocks = []
        for k, exp, out, se, act, stride in cfg:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            blocks.append(_InvertedResidualV3(in_ch, exp_c, out_c, k,
                                              stride, se, act))
            in_ch = out_c
        self.blocks = nn.Sequential(*blocks)
        exp_c = _make_divisible(last_exp * scale)
        self.lastconv = nn.Sequential(
            nn.Conv2D(in_ch, exp_c, 1, bias_attr=False),
            nn.BatchNorm2D(exp_c), nn.Hardswish())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(exp_c, last_ch), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_ch, num_classes))

    def forward(self, x):
        x = self.lastconv(self.blocks(self.conv(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.classifier(x)
        return x


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_LARGE, 960, 1280, scale, num_classes, with_pool)


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_SMALL, 576, 1024, scale, num_classes, with_pool)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained, "mobilenet_v3_large")
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained, "mobilenet_v3_small")
    return MobileNetV3Small(scale=scale, **kwargs)
