"""MobileNetV2 (counterpart of ``paddle_tpu/vision/models/mobilenet.py``;
reference: python/paddle/vision/models/mobilenetv2.py)."""
from __future__ import annotations

from ... import nn
from ._pretrained import no_pretrained


class _InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers += [nn.Conv2D(inp, hidden, 1, bias_attr=False),
                       nn.BatchNorm2D(hidden), nn.ReLU6()]
        layers += [
            nn.Conv2D(hidden, hidden, 3, stride=stride, padding=1,
                      groups=hidden, bias_attr=False),
            nn.BatchNorm2D(hidden), nn.ReLU6(),
            nn.Conv2D(hidden, oup, 1, bias_attr=False),
            nn.BatchNorm2D(oup),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        cfg = [
            # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        inp = int(32 * scale)
        feats = [nn.Conv2D(3, inp, 3, stride=2, padding=1,
                           bias_attr=False),
                 nn.BatchNorm2D(inp), nn.ReLU6()]
        for t, c, n, s in cfg:
            oup = int(c * scale)
            for i in range(n):
                feats.append(_InvertedResidual(
                    inp, oup, s if i == 0 else 1, t))
                inp = oup
        last = int(1280 * max(1.0, scale))
        feats += [nn.Conv2D(inp, last, 1, bias_attr=False),
                  nn.BatchNorm2D(last), nn.ReLU6()]
        self.features = nn.Sequential(*feats)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained, "mobilenet_v2")
    return MobileNetV2(scale=scale, **kwargs)
