"""ShuffleNetV2 (counterpart of ``paddle_tpu/vision/models/shufflenetv2.py``;
reference: python/paddle/vision/models/shufflenetv2.py)."""
from __future__ import annotations

from ... import concat, nn
from ...nn import functional as F
from ._pretrained import no_pretrained


def _shuffle(x, groups):
    return F.channel_shuffle(x, groups)


class _ShuffleUnit(nn.Layer):
    def __init__(self, in_ch, out_ch, stride, act="relu"):
        super().__init__()
        self.stride = stride
        branch = out_ch // 2
        act_layer = nn.Swish if act == "swish" else nn.ReLU
        if stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2D(in_ch, in_ch, 3, stride=stride, padding=1,
                          groups=in_ch, bias_attr=False),
                nn.BatchNorm2D(in_ch),
                nn.Conv2D(in_ch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), act_layer())
            b2_in = in_ch
        else:
            self.branch1 = None
            b2_in = in_ch // 2
        self.branch2 = nn.Sequential(
            nn.Conv2D(b2_in, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), act_layer(),
            nn.Conv2D(branch, branch, 3, stride=stride, padding=1,
                      groups=branch, bias_attr=False),
            nn.BatchNorm2D(branch),
            nn.Conv2D(branch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), act_layer())

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            x1, x2 = x[:, :half], x[:, half:]
            out = concat([x1, self.branch2(x2)], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return _shuffle(out, 2)


_STAGES = {  # scale -> stage output channels + final conv
    0.25: ([24, 48, 96], 512), 0.33: ([32, 64, 128], 512),
    0.5: ([48, 96, 192], 1024), 1.0: ([116, 232, 464], 1024),
    1.5: ([176, 352, 704], 1024), 2.0: ([244, 488, 976], 2048),
}


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        if scale not in _STAGES:
            raise ValueError(f"scale must be one of {sorted(_STAGES)}")
        stage_ch, final_ch = _STAGES[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, 24, 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(24), nn.ReLU())
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        blocks = []
        in_ch = 24
        for out_ch, repeat in zip(stage_ch, (4, 8, 4)):
            blocks.append(_ShuffleUnit(in_ch, out_ch, 2, act))
            for _ in range(repeat - 1):
                blocks.append(_ShuffleUnit(out_ch, out_ch, 1, act))
            in_ch = out_ch
        self.blocks = nn.Sequential(*blocks)
        self.conv_last = nn.Sequential(
            nn.Conv2D(in_ch, final_ch, 1, bias_attr=False),
            nn.BatchNorm2D(final_ch), nn.ReLU())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(final_ch, num_classes)

    def forward(self, x):
        x = self.conv_last(self.blocks(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.fc(x)
        return x


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    no_pretrained(pretrained, "shufflenet_v2_x0_25")
    return ShuffleNetV2(scale=0.25, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    no_pretrained(pretrained, "shufflenet_v2_x0_33")
    return ShuffleNetV2(scale=0.33, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    no_pretrained(pretrained, "shufflenet_v2_x0_5")
    return ShuffleNetV2(scale=0.5, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    no_pretrained(pretrained, "shufflenet_v2_x1_0")
    return ShuffleNetV2(scale=1.0, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    no_pretrained(pretrained, "shufflenet_v2_x1_5")
    return ShuffleNetV2(scale=1.5, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    no_pretrained(pretrained, "shufflenet_v2_x2_0")
    return ShuffleNetV2(scale=2.0, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    no_pretrained(pretrained, "shufflenet_v2_swish")
    return ShuffleNetV2(scale=1.0, act="swish", **kwargs)
