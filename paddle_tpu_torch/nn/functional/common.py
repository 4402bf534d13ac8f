"""Common functionals: linear, dropout, embedding, ... (counterpart of
``paddle_tpu/nn/functional/common.py``).

Surface Tensors go through ``run_op``; raw torch tensors take the same
body and come out raw.

``interpolate`` computes what the JAX package's ``jax.image.resize``
computes, not what torch's ``F.interpolate`` does: every resized axis is
a matmul by the scale-and-translate weight matrix ``jax.image`` builds
(half-pixel centres; a triangle kernel for the linear modes and "area",
Keys cubic with a = -0.5 for "bicubic", both widened by the scale when
downsampling, i.e. antialiased), and "nearest" picks
floor((i + 0.5) in / out). ``align_corners`` and ``align_mode`` are
taken and ignored, as the JAX package ignores them. ``unfold`` / ``fold``
pad first (the JAX paddings may be asymmetric) and then run torch's
im2col / col2im; ``grid_sample`` is the JAX gather, corner by corner.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...core import random as random_mod
from ...core.dispatch import surface, unwrap, wrap
from ...core.tensor import Tensor
from ...ops.manipulation import pad  # noqa: F401  (re-export, paddle parity)


def _linear(a, w, b):
    out = a @ w
    return out if b is None else out + b


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with paddle's [in, out] weight layout."""
    return surface("linear", _linear, [x, weight, bias])


def _keep_mask(shape, p, axis, device, generator):
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32) < 1.0 - p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Dropout. ``upscale_in_train`` keeps each element with probability
    1 - p and scales it by 1/(1 - p) in training, identity in eval;
    ``downscale_in_infer`` keeps without scaling in training and scales
    by 1 - p in eval. p 0 is identity and p 1 zeros in training. The
    mask (over ``axis`` only, when given) is drawn as f32 uniforms from
    ``generator``; when None, a surface Tensor draws from the port's
    generator of its device (``core.random``), a raw tensor from torch's
    default one. The JAX package's threefry keys cannot be reproduced,
    so only the distribution matches."""
    if isinstance(p, (int, float)) and not 0 <= p <= 1:
        raise ValueError(f"dropout p must be in [0, 1], got {p}")
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be upscale_in_train or "
                         f"downscale_in_infer, got {mode!r}")
    if not training:
        if mode == "downscale_in_infer":
            return surface("dropout", lambda a: a * (1.0 - p), [x])
        return x
    if p == 0:
        return x
    if p == 1:
        return surface("dropout", torch.zeros_like, [x])
    a = unwrap(x)
    if generator is None and isinstance(x, Tensor):
        generator = random_mod.draw_generator(a.device)
    keep = _keep_mask(a.shape, p, axis, a.device, generator)

    def fn(v):
        kept = v / (1.0 - p) if mode == "upscale_in_train" else v
        return torch.where(keep, kept, torch.zeros((), dtype=v.dtype,
                                                   device=v.device))
    return surface("dropout", fn, [x])


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


_SELU_ALPHA_P = -1.6732632423543772 * 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout."""
    if not training or p == 0.0:
        return x
    a = unwrap(x)
    keep = _keep_mask(a.shape, p, None, a.device,
                      random_mod.draw_generator(a.device))
    a_coef = ((1 - p) * (1 + p * _SELU_ALPHA_P ** 2)) ** -0.5
    b_coef = -a_coef * p * _SELU_ALPHA_P
    return surface("alpha_dropout", lambda v: (a_coef * torch.where(
        keep, v, torch.full_like(v, _SELU_ALPHA_P)) + b_coef).to(v.dtype),
        [x])


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout over whole channels (dim 1)."""
    if not training or p == 0:
        return x
    a = unwrap(x)
    keep = _keep_mask(a.shape, p, [0, 1], a.device,
                      random_mod.draw_generator(a.device))
    A = (1 - p + p * _SELU_ALPHA_P ** 2 * (1 - p)) ** -0.5
    B = -A * p * _SELU_ALPHA_P
    return surface("feature_alpha_dropout", lambda v: A * torch.where(
        keep, v, torch.full_like(v, _SELU_ALPHA_P)) + B, [x])


def embedding(x, weight, padding_idx=None, sparse=False, name=None,
              max_norm=None, norm_type=2.0, scale_grad_by_freq=False):
    """Rows of ``weight`` ([num, dim]); ids equal to ``padding_idx`` give
    zeros (and no gradient)."""
    def fn(ids, w):
        out = torch.nn.functional.embedding(ids, w)
        if padding_idx is not None:
            pi = padding_idx if padding_idx >= 0 else w.shape[0] + padding_idx
            out = torch.where((ids == pi)[..., None],
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)
        return out
    return surface("embedding", fn, [x, weight])


def one_hot(x, num_classes, name=None):
    def fn(a):
        return torch.nn.functional.one_hot(a.long(), num_classes).float()
    if isinstance(x, Tensor):
        from ...core.dispatch import run_op_nodiff
        return run_op_nodiff("one_hot", fn, [x])
    return fn(x)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    def fn(lab, prior):
        if prior is not None:
            return (1 - epsilon) * lab + epsilon * prior
        return (1 - epsilon) * lab + epsilon / lab.shape[-1]
    return surface("label_smooth", fn, [label, prior_dist])


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def fn(a, b):
        num = torch.sum(a * b, dim=axis)
        den = torch.linalg.vector_norm(a, dim=axis) * \
            torch.linalg.vector_norm(b, dim=axis)
        return num / torch.clamp(den, min=eps)
    return surface("cosine_similarity", fn, [x1, x2])


def bilinear(x1, x2, weight, bias=None, name=None):
    """out[n, o] = x1[n, i] W[o, i, j] x2[n, j] (+ bias)."""
    def fn(a, b, w, bb):
        out = torch.einsum("ni,oij,nj->no", a, w, b)
        return out if bb is None else out + bb
    return surface("bilinear", fn, [x1, x2, weight, bias])


def pad3d(x, paddings, mode="constant", value=0.0, data_format="NCDHW",
          name=None):
    return pad(x, paddings, mode=mode, value=value, data_format=data_format)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero-pad the spatial dims; padding = [left, right, top, bottom]."""
    pads = [int(v) for v in (padding.tolist() if hasattr(padding, "tolist")
                             else padding)]
    return pad(x, pads, mode="constant", value=0.0, data_format=data_format)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    def fn(a):
        nt, c, h, w = a.shape
        v = a.reshape(nt // seg_num, seg_num, c, h, w)
        fold = int(c * shift_ratio)
        left = torch.cat([v[:, 1:, :fold],
                          torch.zeros_like(v[:, :1, :fold])], dim=1)
        right = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                           v[:, :-1, fold:2 * fold]], dim=1)
        return torch.cat([left, right, v[:, :, 2 * fold:]],
                         dim=2).reshape(nt, c, h, w)
    return surface("temporal_shift", fn, [x])


def fused_softmax_mask(x, mask, name=None):
    return surface("fused_softmax_mask",
                   lambda a, m: torch.softmax(a + m, dim=-1), [x, mask])


def fused_softmax_mask_upper_triangle(x, name=None):
    def fn(a):
        s = a.shape[-1]
        mask = torch.triu(torch.full((s, s), -1e9, dtype=a.dtype,
                                     device=a.device), diagonal=1)
        return torch.softmax(a + mask, dim=-1)
    return surface("fused_softmax_mask_upper_triangle", fn, [x])


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """||x - y + eps||_p along the last dim."""
    def fn(a, b):
        d = torch.abs(a - b + epsilon)
        if p == float("inf"):
            return torch.amax(d, dim=-1, keepdim=keepdim)
        if p == 0:
            return torch.sum((d != 0).to(a.dtype), dim=-1, keepdim=keepdim)
        return torch.sum(d ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)
    return surface("pairwise_distance", fn, [x, y])


def class_center_sample(label, num_classes, num_samples, group=None,
                        name=None):
    """Sample negative class centres beside the positives and remap the
    labels into the sampled set (on the host, numpy's global state)."""
    lab_t = unwrap(label)
    lab = lab_t.detach().cpu().numpy().astype(np.int64)
    pos = np.unique(lab)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        neg_pool = np.setdiff1d(np.arange(num_classes), pos,
                                assume_unique=True)
        extra = np.random.choice(neg_pool, num_samples - len(pos),
                                 replace=False)
        sampled = np.sort(np.concatenate([pos, extra]))
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    dev = lab_t.device
    return (wrap(torch.as_tensor(remap[lab], device=dev)),
            wrap(torch.as_tensor(sampled, device=dev)))


def gather_tree(ids, parents, name=None):
    from ...ops.search import gather_tree as _gt
    return _gt(ids, parents)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention sampled at a CSR pattern, as a dense masked softmax."""
    def fn(q, k, v, off, cols, kp, am):
        B, H, M, D = q.shape
        nnz = cols.shape[-1]
        j = torch.arange(nnz, device=q.device)
        rows = torch.sum(j[None, None, None, :] >= off[..., 1:, None],
                         dim=-2)
        mask = torch.zeros((B, H, M, M), dtype=torch.bool, device=q.device)
        b_i = torch.arange(B, device=q.device)[:, None, None]
        h_i = torch.arange(H, device=q.device)[None, :, None]
        mask[b_i, h_i, rows, cols.long()] = True
        scores = torch.einsum("bhmd,bhnd->bhmn", q, k) / D ** 0.5
        neg = torch.full_like(scores, -1e30)
        scores = torch.where(mask, scores, neg)
        if kp is not None:
            scores = torch.where(kp[:, None, None, :] > 0, scores, neg)
        if am is not None:
            scores = scores + am[:, None, :, :]
        attn = torch.where(mask, torch.softmax(scores, dim=-1),
                           torch.zeros_like(scores))
        return torch.einsum("bhmn,bhnd->bhmd", attn, v)
    return surface("sparse_attention", fn, [
        query, key, value, sparse_csr_offset, sparse_csr_columns,
        key_padding_mask, attn_mask])


# ---- resize / fold / shuffle / grid ----------------------------------------

def _interp_size(shape_sp, size, scale_factor):
    if size is not None:
        return [int(unwrap(s)) for s in size]
    if isinstance(scale_factor, (int, float)):
        scale_factor = [scale_factor] * len(shape_sp)
    return [int(np.floor(s * f)) for s, f in zip(shape_sp, scale_factor)]


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(in_size, out_size, kernel):
    """[in, out] resampling matrix of ``jax.image.resize`` along one axis
    (``compute_weight_mat`` with translation 0 and antialiasing), in f64."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size)[:, None]) \
        / kernel_scale
    w = kernel(x)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def _nearest_index(in_size, out_size):
    """``jax.image``'s nearest source rows: floor((i + 0.5) in / out) in
    f32."""
    off = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(in_size) / np.float32(out_size)
    return np.floor(off.astype(np.float32)).astype(np.int64)


_RESIZE_KERNELS = {"bilinear": _triangle, "area": _triangle,
                   "trilinear": _triangle, "linear": _triangle,
                   "bicubic": _keys_cubic}


def _resize(v, sp_axes, out_sp, mode):
    out = v if v.is_floating_point() or mode == "nearest" else v.float()
    for ax, n in zip(sp_axes, out_sp):
        m = out.shape[ax]
        if m == n:
            continue
        if mode == "nearest":
            idx = torch.as_tensor(_nearest_index(m, n), device=v.device)
            out = out.index_select(ax, idx)
            continue
        w = torch.as_tensor(_resize_weights(m, n, _RESIZE_KERNELS[mode]),
                            dtype=out.dtype, device=v.device)
        out = torch.movedim(torch.movedim(out, ax, -1) @ w, -1, ax)
    return out.to(v.dtype)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims as ``jax.image.resize`` does (modes
    nearest / linear / bilinear / trilinear / bicubic / area; see the
    module docstring). ``align_corners`` / ``align_mode`` are ignored."""
    if size is None and scale_factor is None:
        raise ValueError("one of size / scale_factor must be set")
    if mode not in _RESIZE_KERNELS and mode != "nearest":
        raise ValueError(f"unknown interpolate mode {mode!r}")
    shape = unwrap(x).shape
    channel_last = data_format in ("NHWC", "NDHWC", "NWC")
    nd = len(shape) - 2
    sp_axes = list(range(1, 1 + nd)) if channel_last \
        else list(range(2, 2 + nd))
    out_sp = _interp_size([shape[i] for i in sp_axes], size, scale_factor)
    return surface("interpolate",
                   lambda v: _resize(v, sp_axes, out_sp, mode), [x])


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def nearest_interp(x, size=None, scale_factor=None, data_format="NCHW",
                   **kw):
    return interpolate(x, size=size, scale_factor=scale_factor,
                       mode="nearest", data_format=data_format)


def bilinear_interp(x, size=None, scale_factor=None, data_format="NCHW",
                    align_corners=False, **kw):
    return interpolate(x, size=size, scale_factor=scale_factor,
                       mode="bilinear", align_corners=align_corners,
                       data_format=data_format)


def bicubic_interp(x, size=None, scale_factor=None, data_format="NCHW",
                   align_corners=False, **kw):
    return interpolate(x, size=size, scale_factor=scale_factor,
                       mode="bicubic", align_corners=align_corners,
                       data_format=data_format)


def linear_interp(x, size=None, scale_factor=None, data_format="NCW",
                  align_corners=False, **kw):
    return interpolate(x, size=size, scale_factor=scale_factor,
                       mode="linear", align_corners=align_corners,
                       data_format=data_format)


def trilinear_interp(x, size=None, scale_factor=None, data_format="NCDHW",
                     align_corners=False, **kw):
    return interpolate(x, size=size, scale_factor=scale_factor,
                       mode="trilinear", align_corners=align_corners,
                       data_format=data_format)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _fold_pads(p):
    """paddle's fold / unfold paddings -> (top, bottom, left, right)."""
    if isinstance(p, int):
        return p, p, p, p
    if len(p) == 2:
        return p[0], p[0], p[1], p[1]
    pt, pl, pb, pr = p
    return pt, pb, pl, pr


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: NCHW -> [N, C*kh*kw, L], channel-major rows."""
    k, s, d = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    pt, pb, pl, pr = _fold_pads(paddings)

    def fn(a):
        a = TF.pad(a, [pl, pr, pt, pb])
        return TF.unfold(a, k, dilation=d, padding=0, stride=s)
    return surface("unfold", fn, [x])


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of unfold: overlapping patches add."""
    (oh, ow), k = _pair(output_sizes), _pair(kernel_sizes)
    s, d = _pair(strides), _pair(dilations)
    pt, pb, pl, pr = _fold_pads(paddings)

    def fn(cols):
        hp, wp = oh + pt + pb, ow + pl + pr
        out = TF.fold(cols, (hp, wp), k, dilation=d, padding=0, stride=s)
        return out[:, :, pt:hp - pb, pl:wp - pr]
    return surface("fold", fn, [x])


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def fn(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, c // (r * r), r, r, h, w)
            return a.permute(0, 1, 4, 2, 5, 3).reshape(
                n, c // (r * r), h * r, w * r)
        n, h, w, c = a.shape
        a = a.reshape(n, h, w, r, r, c // (r * r))
        return a.permute(0, 1, 3, 2, 4, 5).reshape(
            n, h * r, w * r, c // (r * r))
    return surface("pixel_shuffle", fn, [x])


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor

    def fn(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, c, h // r, r, w // r, r)
            return a.permute(0, 1, 3, 5, 2, 4).reshape(
                n, c * r * r, h // r, w // r)
        n, h, w, c = a.shape
        a = a.reshape(n, h // r, r, w // r, r, c)
        return a.permute(0, 1, 3, 2, 4, 5).reshape(
            n, h // r, w // r, c * r * r)
    return surface("pixel_unshuffle", fn, [x])


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def fn(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, groups, c // groups, h, w)
            return a.transpose(1, 2).reshape(n, c, h, w)
        n, h, w, c = a.shape
        a = a.reshape(n, h, w, groups, c // groups)
        return a.transpose(3, 4).reshape(n, h, w, c)
    return surface("channel_shuffle", fn, [x])


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """2-D affine sampling grid [n, h, w, 2] (x, y) in [-1, 1]."""
    n, h, w = (int(unwrap(out_shape[0])), int(unwrap(out_shape[-2])),
               int(unwrap(out_shape[-1])))

    def fn(th):
        kw = dict(dtype=th.dtype, device=th.device)
        if align_corners:
            ys = torch.linspace(-1.0, 1.0, h, **kw)
            xs = torch.linspace(-1.0, 1.0, w, **kw)
        else:
            ys = (torch.arange(h, **kw) * 2 + 1) / h - 1
            xs = (torch.arange(w, **kw) * 2 + 1) / w - 1
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
        return torch.einsum("hwk,nck->nhwc", base, th)
    return surface("affine_grid", fn, [theta])


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """2-D grid sampling of an NCHW input at grid [n, ho, wo, 2] (x, y in
    [-1, 1]): the JAX package's four-corner gather (nearest rounds);
    "border" and "zeros" clamp the index, "zeros" then zeroes a corner
    outside the input, "reflection" reflects it."""
    def fn(a, g):
        n, c, h, w = a.shape
        gx, gy = g[..., 0], g[..., 1]
        if align_corners:
            fx = (gx + 1) * (w - 1) / 2
            fy = (gy + 1) * (h - 1) / 2
        else:
            fx = ((gx + 1) * w - 1) / 2
            fy = ((gy + 1) * h - 1) / 2
        bidx = torch.arange(n, device=a.device)[:, None, None]

        def reflect(i, size):
            period = 2 * max(size - 1, 1)
            i = torch.abs(i) % period
            return torch.where(i >= size, period - i, i)

        def gather(ix, iy):
            if padding_mode == "reflection":
                ixc, iyc = reflect(ix, w), reflect(iy, h)
            else:
                ixc, iyc = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
            vals = a[bidx, :, iyc, ixc]                 # [n, ho, wo, c]
            if padding_mode == "zeros":
                ok = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
                vals = vals * ok[..., None].to(vals.dtype)
            return vals

        if mode == "nearest":
            out = gather(torch.round(fx).to(torch.int64),
                         torch.round(fy).to(torch.int64))
        else:
            x0 = torch.floor(fx).to(torch.int64)
            y0 = torch.floor(fy).to(torch.int64)
            wx, wy = fx - x0, fy - y0
            out = (gather(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
                   + gather(x0 + 1, y0) * (wx * (1 - wy))[..., None]
                   + gather(x0, y0 + 1) * ((1 - wx) * wy)[..., None]
                   + gather(x0 + 1, y0 + 1) * (wx * wy)[..., None])
        return torch.movedim(out, -1, 1)
    return surface("grid_sample", fn, [x, grid])
