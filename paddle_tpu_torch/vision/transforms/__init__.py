"""Vision transforms (counterpart of ``paddle_tpu/vision/transforms``;
reference: python/paddle/vision/transforms).

Operate on numpy CHW float arrays on the host (the DataLoader's workers
run them); the port keeps its own copy of the JAX package's numpy code,
so under one ``np.random.seed`` both give the same arrays bit for bit.
The random transforms draw from the global ``np.random``. In DataLoader
workers torch seeds numpy per worker, so each worker draws its own
crops (the JAX package's forked pool does not reseed, and its workers
repeat each other's draws). ``Resize`` indexes the nearest pixel
whatever its ``interpolation``, as in the JAX package.
"""
from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class BaseTransform:
    def __call__(self, x):
        return self._apply_image(x)


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        a = np.asarray(img, np.float32)
        if a.max() > 1.5:
            a = a / 255.0
        if a.ndim == 2:
            a = a[None]
        elif a.ndim == 3 and a.shape[-1] in (1, 3) and \
                self.data_format == "CHW":
            a = a.transpose(2, 0, 1)
        return a


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def _apply_image(self, img):
        return (np.asarray(img, np.float32) - self.mean) / self.std


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        c, h, w = img.shape
        oh, ow = self.size
        yi = (np.arange(oh) * (h / oh)).astype(np.int64).clip(0, h - 1)
        xi = (np.arange(ow) * (w / ow)).astype(np.int64).clip(0, w - 1)
        return img[:, yi][:, :, xi]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return img[:, :, ::-1].copy()
        return img


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=0, keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        if self.padding:
            img = np.pad(img, [(0, 0), (self.padding, self.padding),
                               (self.padding, self.padding)])
        c, h, w = img.shape
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[:, i:i + th, j:j + tw]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        c, h, w = img.shape
        th, tw = self.size
        i = (h - th) // 2
        j = (w - tw) // 2
        return img[:, i:i + th, j:j + tw]


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return img[:, :, ::-1].copy()


from . import functional  # noqa: E402
from .functional import (  # noqa: F401,E402
    adjust_brightness, adjust_contrast, adjust_hue, adjust_saturation,
    affine, center_crop, crop, erase, pad, perspective, rotate,
    to_grayscale, vflip,
)


class RandomVerticalFlip(BaseTransform):
    """(reference: transforms.RandomVerticalFlip)"""

    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return vflip(img)
        return img


class Transpose(BaseTransform):
    """HWC->CHW by default (reference: transforms.Transpose)."""

    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = tuple(order)

    def _apply_image(self, img):
        a = np.asarray(img)
        if a.ndim == 2:
            a = a[..., None]
        return a.transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.padding, self.fill = padding, fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class BrightnessTransform(BaseTransform):
    """Random brightness in [max(0,1-v), 1+v] (reference:
    transforms.BrightnessTransform)."""

    def __init__(self, value, keys=None):
        if isinstance(value, (tuple, list)):
            self._range = (float(value[0]), float(value[1]))
        else:
            v = float(value)
            self._range = (max(0.0, 1.0 - v), 1.0 + v)

    def _factor(self):
        return np.random.uniform(*self._range)

    def _apply_image(self, img):
        return adjust_brightness(img, self._factor())


class ContrastTransform(BrightnessTransform):
    def _apply_image(self, img):
        return adjust_contrast(img, self._factor())


class SaturationTransform(BrightnessTransform):
    def _apply_image(self, img):
        return adjust_saturation(img, self._factor())


class HueTransform(BaseTransform):
    """Random hue shift in [-v, v], v <= 0.5 (reference: HueTransform)."""

    def __init__(self, value, keys=None):
        if isinstance(value, (tuple, list)):
            lo, hi = float(value[0]), float(value[1])
        else:
            if not 0 <= value <= 0.5:
                raise ValueError("hue value must be in [0, 0.5]")
            lo, hi = -float(value), float(value)
        if not -0.5 <= lo <= hi <= 0.5:
            raise ValueError("hue range must be within [-0.5, 0.5]")
        self._range = (lo, hi)

    def _apply_image(self, img):
        return adjust_hue(img, np.random.uniform(*self._range))


class ColorJitter(BaseTransform):
    """Random brightness/contrast/saturation/hue in random order
    (reference: transforms.ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self.transforms = []
        if brightness:
            self.transforms.append(BrightnessTransform(brightness))
        if contrast:
            self.transforms.append(ContrastTransform(contrast))
        if saturation:
            self.transforms.append(SaturationTransform(saturation))
        if hue:
            self.transforms.append(HueTransform(hue))

    def _apply_image(self, img):
        order = np.random.permutation(len(self.transforms))
        for i in order:
            img = self.transforms[i](img)
        return img


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = tuple(degrees)
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, self.interpolation, self.expand,
                      self.center, self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = tuple(degrees)
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        a = np.asarray(img)
        h, w = (a.shape[-2], a.shape[-1])
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate is not None:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) \
                * w
            ty = np.random.uniform(-self.translate[1], self.translate[1]) \
                * h
        sc = np.random.uniform(*self.scale) if self.scale else 1.0
        if self.shear is None:
            sh = (0.0, 0.0)
        elif isinstance(self.shear, (int, float)):
            sh = (np.random.uniform(-self.shear, self.shear), 0.0)
        elif len(self.shear) == 2:
            sh = (np.random.uniform(self.shear[0], self.shear[1]), 0.0)
        else:
            sh = (np.random.uniform(self.shear[0], self.shear[1]),
                  np.random.uniform(self.shear[2], self.shear[3]))
        return affine(img, angle, (tx, ty), sc, sh, self.interpolation,
                      self.fill, self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        a = np.asarray(img)
        h, w = a.shape[-2], a.shape[-1]
        d = self.distortion_scale
        half_h, half_w = int(h * d / 2), int(w * d / 2)
        def rnd(k):
            return int(np.random.randint(0, max(k, 1)))
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(rnd(half_w), rnd(half_h)),
               (w - 1 - rnd(half_w), rnd(half_h)),
               (w - 1 - rnd(half_w), h - 1 - rnd(half_h)),
               (rnd(half_w), h - 1 - rnd(half_h))]
        return perspective(img, start, end, self.interpolation, self.fill)


class RandomErasing(BaseTransform):
    """(reference: transforms.RandomErasing)"""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        a = np.asarray(img, np.float32)
        if a.ndim == 2:
            a = a[None]
        c, h, w = a.shape
        area = h * w
        for _ in range(10):
            target = np.random.uniform(*self.scale) * area
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w and eh > 0 and ew > 0:
                i = np.random.randint(0, h - eh + 1)
                j = np.random.randint(0, w - ew + 1)
                if isinstance(self.value, str):
                    if self.value != "random":
                        raise ValueError(
                            "value must be a number, a per-channel "
                            "sequence, or 'random'")
                    v = np.random.standard_normal((c, eh, ew)).astype(
                        np.float32)
                elif isinstance(self.value, (tuple, list, np.ndarray)):
                    v = np.asarray(self.value,
                                   np.float32).reshape(-1, 1, 1)
                else:
                    v = self.value
                return erase(a, i, j, eh, ew, v, self.inplace)
        return a


class RandomResizedCrop(BaseTransform):
    """Random area/aspect crop then resize (reference:
    transforms.RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        a = np.asarray(img, np.float32)
        if a.ndim == 2:
            a = a[None]
        c, h, w = a.shape
        area = h * w
        for _ in range(10):
            target = np.random.uniform(*self.scale) * area
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            ch_ = int(round(np.sqrt(target / ar)))
            cw = int(round(np.sqrt(target * ar)))
            if 0 < ch_ <= h and 0 < cw <= w:
                i = np.random.randint(0, h - ch_ + 1)
                j = np.random.randint(0, w - cw + 1)
                patch = a[:, i:i + ch_, j:j + cw]
                return Resize(self.size, self.interpolation)(patch)
        return Resize(self.size, self.interpolation)(
            CenterCrop(min(h, w))(a))
