"""Inception v3 (counterpart of ``paddle_tpu/vision/models/inceptionv3.py``;
reference: python/paddle/vision/models/inceptionv3.py)."""
from __future__ import annotations

from ... import concat, nn
from ._pretrained import no_pretrained


class _BasicConv(nn.Layer):
    def __init__(self, in_ch, out_ch, k, **kw):
        super().__init__()
        self.conv = nn.Conv2D(in_ch, out_ch, k, bias_attr=False, **kw)
        self.bn = nn.BatchNorm2D(out_ch)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _InceptionA(nn.Layer):
    def __init__(self, in_ch, pool_feat):
        super().__init__()
        self.b1 = _BasicConv(in_ch, 64, 1)
        self.b5 = nn.Sequential(_BasicConv(in_ch, 48, 1),
                                _BasicConv(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_BasicConv(in_ch, 64, 1),
                                _BasicConv(64, 96, 3, padding=1),
                                _BasicConv(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _BasicConv(in_ch, pool_feat, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                      axis=1)


class _InceptionB(nn.Layer):
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = _BasicConv(in_ch, 384, 3, stride=2)
        self.b3d = nn.Sequential(_BasicConv(in_ch, 64, 1),
                                 _BasicConv(64, 96, 3, padding=1),
                                 _BasicConv(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class _InceptionC(nn.Layer):
    def __init__(self, in_ch, c7):
        super().__init__()
        self.b1 = _BasicConv(in_ch, 192, 1)
        self.b7 = nn.Sequential(
            _BasicConv(in_ch, c7, 1),
            _BasicConv(c7, c7, (1, 7), padding=(0, 3)),
            _BasicConv(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            _BasicConv(in_ch, c7, 1),
            _BasicConv(c7, c7, (7, 1), padding=(3, 0)),
            _BasicConv(c7, c7, (1, 7), padding=(0, 3)),
            _BasicConv(c7, c7, (7, 1), padding=(3, 0)),
            _BasicConv(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _BasicConv(in_ch, 192, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                      axis=1)


class _InceptionD(nn.Layer):
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = nn.Sequential(_BasicConv(in_ch, 192, 1),
                                _BasicConv(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _BasicConv(in_ch, 192, 1),
            _BasicConv(192, 192, (1, 7), padding=(0, 3)),
            _BasicConv(192, 192, (7, 1), padding=(3, 0)),
            _BasicConv(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class _InceptionE(nn.Layer):
    def __init__(self, in_ch):
        super().__init__()
        self.b1 = _BasicConv(in_ch, 320, 1)
        self.b3_1 = _BasicConv(in_ch, 384, 1)
        self.b3_2a = _BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.b3_2b = _BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.bd_1 = nn.Sequential(_BasicConv(in_ch, 448, 1),
                                  _BasicConv(448, 384, 3, padding=1))
        self.bd_2a = _BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.bd_2b = _BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _BasicConv(in_ch, 192, 1))

    def forward(self, x):
        b3 = self.b3_1(x)
        b3 = concat([self.b3_2a(b3), self.b3_2b(b3)], axis=1)
        bd = self.bd_1(x)
        bd = concat([self.bd_2a(bd), self.bd_2b(bd)], axis=1)
        return concat([self.b1(x), b3, bd, self.bp(x)], axis=1)


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _BasicConv(3, 32, 3, stride=2), _BasicConv(32, 32, 3),
            _BasicConv(32, 64, 3, padding=1), nn.MaxPool2D(3, stride=2),
            _BasicConv(64, 80, 1), _BasicConv(80, 192, 3),
            nn.MaxPool2D(3, stride=2))
        self.blocks = nn.Sequential(
            _InceptionA(192, 32), _InceptionA(256, 64),
            _InceptionA(288, 64), _InceptionB(288),
            _InceptionC(768, 128), _InceptionC(768, 160),
            _InceptionC(768, 160), _InceptionC(768, 192),
            _InceptionD(768), _InceptionE(1280), _InceptionE(2048))
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(nn.Flatten()(x)))
        return x


def inception_v3(pretrained=False, **kwargs):
    no_pretrained(pretrained, "inception_v3")
    return InceptionV3(**kwargs)
