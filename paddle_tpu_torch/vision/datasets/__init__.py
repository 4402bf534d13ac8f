"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets``;
reference: python/paddle/vision/datasets).

Nothing is downloaded (``download`` is accepted and ignored): MNIST loads
from local gzip files when given, and otherwise every dataset is a
deterministic synthetic stand-in with the reference's shapes and dtypes
(class-conditional patterns, learnable), equal bit for bit to the JAX
package's for the same arguments. ``DatasetFolder`` / ``ImageFolder`` read
``root/<class>/<file>`` with any ``loader``; the default loader imports
PIL when it is called.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io import Dataset


def _synthetic_images(n, num_classes, shape, seed):
    """Class-conditional blobs + noise — learnable but nontrivial."""
    rng = np.random.default_rng(seed)
    h, w = shape[-2], shape[-1]
    c = shape[0] if len(shape) == 3 else 1
    protos = rng.uniform(0, 1, size=(num_classes, c, h, w)).astype(
        np.float32)
    # low-frequency class prototypes
    for k in range(num_classes):
        yy, xx = np.mgrid[0:h, 0:w]
        fx, fy = 1 + k % 4, 1 + (k // 4) % 4
        wave = np.sin(2 * np.pi * fx * xx / w) * \
            np.cos(2 * np.pi * fy * yy / h)
        protos[k] = 0.5 + 0.5 * wave.astype(np.float32)
    labels = rng.integers(0, num_classes, n)
    noise = rng.normal(0, 0.35, size=(n, c, h, w)).astype(np.float32)
    images = np.clip(protos[labels] + noise, 0, 1)
    return images, labels.astype(np.int64)


class MNIST(Dataset):
    """Reference: vision/datasets/mnist.py. 28x28 grayscale, 10 classes."""

    NUM_CLASSES = 10

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        n = 60000 if mode == "train" else 10000
        loaded = False
        if image_path and label_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
                self.images = np.frombuffer(
                    f.read(), np.uint8).reshape(num, 1, rows, cols) \
                    .astype(np.float32) / 255.0
            with gzip.open(label_path, "rb") as f:
                f.read(8)
                self.labels = np.frombuffer(f.read(), np.uint8) \
                    .astype(np.int64)
            loaded = True
        if not loaded:
            n = min(n, 8192)  # synthetic fallback kept small
            self.images, self.labels = _synthetic_images(
                n, 10, (1, 28, 28), seed=0 if mode == "train" else 1)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img.astype(np.float32), int(self.labels[idx])

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        n = 2048 if mode == "train" else 512
        self.images, self.labels = _synthetic_images(
            n, self.NUM_CLASSES, (3, 32, 32), seed=2 if mode == "train"
            else 3)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img.astype(np.float32), int(self.labels[idx])

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm",
                  ".tif", ".tiff", ".webp")


class DatasetFolder(Dataset):
    """Generic folder-of-class-folders dataset (reference:
    vision/datasets/folder.py DatasetFolder): root/<class>/<file>."""

    def __init__(self, root, loader=None, extensions=None,
                 transform=None, is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        extensions = extensions or IMG_EXTENSIONS
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise RuntimeError(f"no class folders found in {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for base, _, files in sorted(os.walk(cdir)):
                for fname in sorted(files):
                    path = os.path.join(base, fname)
                    ok = is_valid_file(path) if is_valid_file else \
                        fname.lower().endswith(tuple(extensions))
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f"no valid files found under {root}")
        self.targets = [t for _, t in self.samples]

    @staticmethod
    def _default_loader(path):
        from PIL import Image
        with open(path, "rb") as f:
            return Image.open(f).convert("RGB")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target


class ImageFolder(Dataset):
    """Flat/recursive folder of images, no labels (reference:
    vision/datasets/folder.py ImageFolder)."""

    def __init__(self, root, loader=None, extensions=None,
                 transform=None, is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or DatasetFolder._default_loader
        extensions = extensions or IMG_EXTENSIONS
        self.samples = []
        for base, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                path = os.path.join(base, fname)
                ok = is_valid_file(path) if is_valid_file else \
                    fname.lower().endswith(tuple(extensions))
                if ok:
                    self.samples.append(path)
        if not self.samples:
            raise RuntimeError(f"no valid files found under {root}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        sample = self.loader(self.samples[idx])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]


class Flowers(Dataset):
    """Flowers-102 (reference: vision/datasets/flowers.py). Synthetic
    stand-in (no egress): 102 classes of class-conditional images."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True,
                 backend=None, num_samples=600):
        seed = {"train": 0, "valid": 1, "test": 2}.get(mode, 0)
        self._x, self._y = _synthetic_images(num_samples, 102,
                                             (3, 96, 96), seed + 400)
        self.transform = transform

    def __len__(self):
        return len(self._y)

    def __getitem__(self, i):
        img = self._x[i]
        if self.transform is not None:
            img = self.transform(img)
        return img, self._y[i]


class VOC2012(Dataset):
    """VOC2012 segmentation (reference: vision/datasets/voc2012.py):
    (image, label_mask) pairs, 21 classes. Synthetic stand-in: masks are
    thresholded class prototypes so mIoU training is meaningful."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None, num_samples=200):
        seed = {"train": 0, "valid": 1, "test": 2}.get(mode, 0)
        imgs, labels = _synthetic_images(num_samples, 21, (3, 64, 64),
                                         seed + 500)
        self._x = imgs
        # mask: the class's wave pattern thresholded into fg/bg
        self._masks = (imgs.mean(axis=1) > 0.5).astype(np.int64) * \
            (labels[:, None, None] + 0)
        self.transform = transform

    def __len__(self):
        return len(self._x)

    def __getitem__(self, i):
        img = self._x[i]
        if self.transform is not None:
            img = self.transform(img)
        return img, self._masks[i]
