"""DenseNet family (counterpart of ``paddle_tpu/vision/models/densenet.py``;
reference: python/paddle/vision/models/densenet.py)."""
from __future__ import annotations

from ... import concat, nn
from ._pretrained import no_pretrained

_CFG = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class _DenseLayer(nn.Layer):
    def __init__(self, in_ch, growth, bn_size, dropout):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(in_ch)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(in_ch, bn_size * growth, 1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth)
        self.conv2 = nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                               bias_attr=False)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return concat([x, out], axis=1)


class _Transition(nn.Layer):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.bn = nn.BatchNorm2D(in_ch)
        self.relu = nn.ReLU()
        self.conv = nn.Conv2D(in_ch, out_ch, 1, bias_attr=False)
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        if layers not in _CFG:
            raise ValueError(f"layers must be one of {sorted(_CFG)}")
        init_ch, growth, blocks = _CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        feats = [nn.Conv2D(3, init_ch, 7, stride=2, padding=3,
                           bias_attr=False),
                 nn.BatchNorm2D(init_ch), nn.ReLU(),
                 nn.MaxPool2D(3, stride=2, padding=1)]
        ch = init_ch
        for bi, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if bi != len(blocks) - 1:
                feats.append(_Transition(ch, ch // 2))
                ch //= 2
        feats += [nn.BatchNorm2D(ch), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.classifier(x)
        return x


def densenet121(pretrained=False, **kwargs):
    no_pretrained(pretrained, "densenet121")
    return DenseNet(121, **kwargs)


def densenet161(pretrained=False, **kwargs):
    no_pretrained(pretrained, "densenet161")
    return DenseNet(161, **kwargs)


def densenet169(pretrained=False, **kwargs):
    no_pretrained(pretrained, "densenet169")
    return DenseNet(169, **kwargs)


def densenet201(pretrained=False, **kwargs):
    no_pretrained(pretrained, "densenet201")
    return DenseNet(201, **kwargs)


def densenet264(pretrained=False, **kwargs):
    no_pretrained(pretrained, "densenet264")
    return DenseNet(264, **kwargs)
