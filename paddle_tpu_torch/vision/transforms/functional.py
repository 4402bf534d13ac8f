"""Functional image transforms on CHW float numpy arrays (counterpart of
``paddle_tpu/vision/transforms/functional.py``; reference:
python/paddle/vision/transforms/functional.py + functional_cv2.py).

Host-side augmentation for the DataLoader path; geometry goes through
scipy.ndimage. Images are CHW (the module's convention, see __init__);
2-D inputs are treated as single-channel.
"""
from __future__ import annotations

import numpy as np


def _chw(img):
    a = np.asarray(img, np.float32)
    if a.ndim == 2:
        a = a[None]
    return a


def vflip(img):
    """Flip vertically (reference: transforms.vflip)."""
    return _chw(img)[:, ::-1, :].copy()


def hflip(img):
    return _chw(img)[:, :, ::-1].copy()


def crop(img, top, left, height, width):
    """Crop region (reference: transforms.crop)."""
    a = _chw(img)
    return a[:, top:top + height, left:left + width].copy()


def center_crop(img, output_size):
    a = _chw(img)
    th, tw = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    _, h, w = a.shape
    i, j = (h - th) // 2, (w - tw) // 2
    return a[:, i:i + th, j:j + tw].copy()


def pad(img, padding, fill=0, padding_mode="constant"):
    """Pad image borders (reference: transforms.pad). padding is int,
    (pad_x, pad_y), or (left, top, right, bottom)."""
    a = _chw(img)
    if isinstance(padding, int):
        l = t = r = b = padding
    elif len(padding) == 2:
        l, t = padding
        r, b = padding
    else:
        l, t, r, b = padding
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    return np.pad(a, [(0, 0), (t, b), (l, r)], mode=mode, **kw)


def erase(img, i, j, h, w, v, inplace=False):
    """Erase a region with value v (reference: transforms.erase)."""
    a = _chw(img) if inplace else _chw(img).copy()
    a[:, i:i + h, j:j + w] = v
    return a


def to_grayscale(img, num_output_channels=1):
    """ITU-R 601-2 luma transform (reference: to_grayscale)."""
    a = _chw(img)
    if a.shape[0] == 3:
        gray = (0.299 * a[0] + 0.587 * a[1] + 0.114 * a[2])[None]
    else:
        gray = a[:1]
    if num_output_channels == 3:
        gray = np.repeat(gray, 3, axis=0)
    return gray


def adjust_brightness(img, brightness_factor):
    """Blend with black (reference: adjust_brightness)."""
    return _chw(img) * float(brightness_factor)


def adjust_contrast(img, contrast_factor):
    """Blend with the grayscale mean (reference: adjust_contrast)."""
    a = _chw(img)
    mean = to_grayscale(a).mean()
    return mean + contrast_factor * (a - mean)


def adjust_saturation(img, saturation_factor):
    """Blend with the grayscale image (reference: adjust_saturation)."""
    a = _chw(img)
    gray = to_grayscale(a, num_output_channels=a.shape[0])
    return gray + saturation_factor * (a - gray)


def _rgb_to_hsv(a):
    r, g, b = a[0], a[1], a[2]
    maxc = np.max(a, axis=0)
    minc = np.min(a, axis=0)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return np.stack([h, s, v])


def _hsv_to_rgb(hsv):
    h, s, v = hsv[0], hsv[1], hsv[2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(np.int32) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b])


def adjust_hue(img, hue_factor):
    """Cycle hue by hue_factor in [-0.5, 0.5] (reference: adjust_hue)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    a = _chw(img)
    if a.shape[0] != 3:
        return a.copy()
    scale = a.max() if a.max() > 1.5 else 1.0
    hsv = _rgb_to_hsv(a / max(scale, 1e-12))
    hsv[0] = (hsv[0] + hue_factor) % 1.0
    return _hsv_to_rgb(hsv) * scale


def _affine_matrix(angle, translate, scale, shear, center):
    rot = np.deg2rad(angle)
    sx, sy = np.deg2rad(shear[0]), np.deg2rad(shear[1])
    cx, cy = center
    tx, ty = translate
    # RSS = rotation * shear * scale (torchvision/paddle convention)
    a = np.cos(rot - sy) / max(np.cos(sy), 1e-12)
    b = -np.cos(rot - sy) * np.tan(sx) / max(np.cos(sy), 1e-12) \
        - np.sin(rot)
    c = np.sin(rot - sy) / max(np.cos(sy), 1e-12)
    d = -np.sin(rot - sy) * np.tan(sx) / max(np.cos(sy), 1e-12) \
        + np.cos(rot)
    m = np.array([[a, b, 0.0], [c, d, 0.0], [0, 0, 1]]) * 1.0
    m[:2, :2] *= scale
    # translate to center, apply, translate back + user translation
    pre = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    post = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1]],
                    np.float64)
    return post @ m @ pre


def affine(img, angle, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="nearest", fill=0, center=None):
    """Affine transform (reference: transforms.affine). Maps output
    coordinates through the inverse matrix like the reference's cv2 path."""
    from scipy import ndimage
    a = _chw(img)
    _, h, w = a.shape
    if isinstance(shear, (int, float)):
        shear = (float(shear), 0.0)
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    m = _affine_matrix(angle, translate, scale, shear, center)
    minv = np.linalg.inv(m)
    order = {"nearest": 0, "bilinear": 1, "bicubic": 3}.get(
        interpolation, 0)
    # ndimage works in (row=y, col=x) index space
    mat = np.array([[minv[1, 1], minv[1, 0]], [minv[0, 1], minv[0, 0]]])
    off = np.array([minv[1, 2], minv[0, 2]])
    out = [ndimage.affine_transform(ch, mat, offset=off, order=order,
                                    mode="constant", cval=fill)
           for ch in a]
    return np.stack(out)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotate counter-clockwise by angle degrees (reference: rotate)."""
    from scipy import ndimage
    a = _chw(img)
    order = {"nearest": 0, "bilinear": 1, "bicubic": 3}.get(
        interpolation, 0)
    if center is None and not expand:
        out = [ndimage.rotate(ch, angle, reshape=expand, order=order,
                              mode="constant", cval=fill) for ch in a]
        return np.stack(out)
    if expand:
        out = [ndimage.rotate(ch, angle, reshape=True, order=order,
                              mode="constant", cval=fill) for ch in a]
        return np.stack(out)
    _, h, w = a.shape
    return affine(a, angle, (0, 0), 1.0, (0, 0), interpolation, fill,
                  center)


def _perspective_coeffs(startpoints, endpoints):
    # solve the 8-dof homography mapping endpoints -> startpoints
    A = []
    B = []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        A.append([ex, ey, 1, 0, 0, 0, -sx * ex, -sx * ey])
        A.append([0, 0, 0, ex, ey, 1, -sy * ex, -sy * ey])
        B.extend([sx, sy])
    coeffs = np.linalg.solve(np.asarray(A, np.float64),
                             np.asarray(B, np.float64))
    return coeffs


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """Perspective transform mapping startpoints->endpoints (reference:
    transforms.perspective)."""
    from scipy import ndimage
    a = _chw(img)
    _, h, w = a.shape
    c = _perspective_coeffs(startpoints, endpoints)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    denom = c[6] * xs + c[7] * ys + 1.0
    src_x = (c[0] * xs + c[1] * ys + c[2]) / denom
    src_y = (c[3] * xs + c[4] * ys + c[5]) / denom
    order = {"nearest": 0, "bilinear": 1, "bicubic": 3}.get(
        interpolation, 0)
    out = [ndimage.map_coordinates(ch, [src_y, src_x], order=order,
                                   mode="constant", cval=fill)
           for ch in a]
    return np.stack(out)
