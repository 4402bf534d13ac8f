"""Common functionals: linear, dropout, embedding, ... (counterpart of
``paddle_tpu/nn/functional/common.py``).

Surface Tensors go through ``run_op``; raw torch tensors take the same
body and come out raw. The vision functionals of the JAX module
(interpolate / upsample, unfold / fold, pixel_shuffle, channel_shuffle,
affine_grid / grid_sample) come with a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

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
        generator = random_mod.generator(a.device)
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
                      random_mod.generator(a.device))
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
                      random_mod.generator(a.device))
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
