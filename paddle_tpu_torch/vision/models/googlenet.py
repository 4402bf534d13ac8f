"""GoogLeNet / Inception v1 (counterpart of
``paddle_tpu/vision/models/googlenet.py``; reference:
python/paddle/vision/models/googlenet.py — returns (out, aux1, aux2) like
the reference's three classifier heads)."""
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


class _Inception(nn.Layer):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _BasicConv(in_ch, c1, 1)
        self.b2 = nn.Sequential(_BasicConv(in_ch, c3r, 1),
                                _BasicConv(c3r, c3, 3, padding=1))
        self.b3 = nn.Sequential(_BasicConv(in_ch, c5r, 1),
                                _BasicConv(c5r, c5, 5, padding=2))
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                _BasicConv(in_ch, proj, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                      axis=1)


class _AuxHead(nn.Layer):
    def __init__(self, in_ch, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D((4, 4))
        self.conv = _BasicConv(in_ch, 128, 1)
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x))
        x = self.relu(self.fc1(nn.Flatten()(x)))
        return self.fc2(self.dropout(x))


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _BasicConv(3, 64, 7, stride=2, padding=3),
            nn.MaxPool2D(3, stride=2, ceil_mode=True),
            _BasicConv(64, 64, 1), _BasicConv(64, 192, 3, padding=1),
            nn.MaxPool2D(3, stride=2, ceil_mode=True))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes)
            self.aux1 = _AuxHead(512, num_classes)
            self.aux2 = _AuxHead(528, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        aux1 = self.aux1(x) if self.num_classes > 0 and self.training \
            else None
        x = self.i4d(self.i4c(self.i4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 and self.training \
            else None
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(nn.Flatten()(x)))
        if self.training and self.num_classes > 0:
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    no_pretrained(pretrained, "googlenet")
    return GoogLeNet(**kwargs)
