"""Image backend selection + loading (counterpart of
``paddle_tpu/vision/image.py``; reference: python/paddle/vision/image.py
set_image_backend/get_image_backend/image_load). PIL or cv2 is imported
when ``image_load`` is called, so the module imports without either.
"""
from __future__ import annotations

_image_backend = "pil"


def get_image_backend():
    """Name of the package used to load images ('pil' or 'cv2')."""
    return _image_backend


def set_image_backend(backend):
    """Select the package used to load images (reference: set_image_backend;
    'tensor' decode is not offered — decoding happens on host either way)."""
    global _image_backend
    if backend not in ("pil", "cv2"):
        raise ValueError(
            f"Expected backend 'pil' or 'cv2', got {backend}")
    _image_backend = backend


def image_load(path, backend=None):
    """Load an image file via the selected backend (reference: image_load).

    Returns a PIL.Image under 'pil', an HWC BGR ndarray under 'cv2' —
    matching the reference's return types.
    """
    backend = backend or _image_backend
    if backend not in ("pil", "cv2"):
        raise ValueError(
            f"Expected backend 'pil' or 'cv2', got {backend}")
    if backend == "pil":
        from PIL import Image
        return Image.open(path)
    import cv2
    return cv2.imread(str(path))
