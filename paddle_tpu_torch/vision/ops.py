"""paddle.vision.ops (counterpart of ``paddle_tpu/vision/ops.py``; reference
python/paddle/vision/ops.py: nms, roi_align, roi_pool, box_coder,
prior_box, yolo_box, ...).

Two kinds of op, as in the JAX package:

- Device ops (``nms``, the RoI family, ``box_coder``, ``yolo_box``,
  ``yolo_loss``, ``deform_conv2d``, ``affine_channel``, ``box_clip``,
  ``correlation``, ``shuffle_channel``) are plain PyTorch on the input's
  device, dispatched through ``run_op`` under the JAX op names, with the
  JAX package's semantics, static output shapes and gradients.
- Host ops (``prior_box``, ``matrix_nms``, ``generate_proposals``,
  ``multiclass_nms3``, ``bipartite_match``, ``collect_fpn_proposals``,
  ``detection_map``, ...) run the JAX package's numpy on a host copy of
  their inputs and hand their results back as tensors on the input's
  device (a dynamic number of rows, like the reference's CPU kernels).

The RoI ops read ``boxes_num`` on the host once a call (the image of each
RoI), as the JAX package does.

Memory. A straight vectorisation of the RoI ops materialises a sample
grid per RoI and channel (``[R, C, oh*r, ow*r]``, 3.3 GB in f32 at Faster
R-CNN's 1,024 RoIs of a 1,024-channel map at 28 x 28 samples). Here:

- ``roi_align`` is separable: its bilinear weights and its border mask
  factor into a ``[oh, H]`` matrix and a ``[ow, W]`` matrix per RoI, so
  each RoI's output is ``Wy @ x[b] @ Wx^T``, two matrix products whose
  gradient in ``x`` is the JAX op's scatter-add summed in another order.
  RoIs go in chunks of one image whose product intermediate stays under
  ``CHUNK_BYTES``.
- ``roi_pool`` gathers each chunk's samples channels-last and takes the
  maximum; its backward recomputes a chunk's samples and scatter-adds
  the gradient to the maxima (ties share it evenly, as ``jnp.max``'s
  gradient does), so nothing of the forward's samples is kept.
- ``psroi_pool`` is a masked mean whose masks are separable: two
  contractions per chunk.

``nms`` builds the suppression matrix of the score-ordered boxes on the
device (IoU above the threshold, later rank only), packs it to bits, and
copies it to the host once: the greedy scan of the JAX op's ``lax.scan``
runs there over the packed rows, then the kept indices (padded with -1
to the input length, the JAX op's static shape) go back to the device.
A call is a fixed handful of launches and one device-to-host copy of
n^2 / 8 bytes, whatever n.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import place as place_mod
from ..core.dispatch import run_op, run_op_nodiff, unwrap, wrap
from ..core.tensor import _from_numpy, to_numpy

#: bytes a RoI op's chunk of per-RoI intermediates may take (the chunk
#: rule of roi_align, roi_pool and psroi_pool): rois per chunk =
#: max(1, CHUNK_BYTES // bytes of one RoI's intermediates)
CHUNK_BYTES = 256 << 20


def _device_of(*xs):
    """The device of the first tensor among ``xs``, else the current
    place's."""
    for x in xs:
        a = unwrap(x)
        if isinstance(a, torch.Tensor):
            return a.device
    return place_mod.current_device()


def _host(x):
    """A host numpy array of a Tensor, torch tensor or array-like."""
    a = unwrap(x)
    if isinstance(a, torch.Tensor):
        return to_numpy(a)
    return np.asarray(a)


def _out(arr, device):
    """A numpy result as a Tensor on ``device``."""
    return wrap(_from_numpy(np.asarray(arr)).to(device))


def _roi_batch_indices(boxes, boxes_num):
    """(per-RoI image index as a host int64 array, RoIs per image) from
    boxes_num (reference roi_align convention: the first boxes_num[0] rois
    belong to image 0, ...). Reading boxes_num is the call's one host
    sync when it lies on the card."""
    n_rois = int(unwrap(boxes).shape[0])
    if boxes_num is None:
        return np.zeros(n_rois, np.int64), np.asarray([n_rois], np.int64)
    counts = _host(boxes_num).astype(np.int64).reshape(-1)
    if int(counts.sum()) != n_rois:
        raise ValueError(f"boxes_num sums to {int(counts.sum())}, but there "
                         f"are {n_rois} boxes")
    return np.repeat(np.arange(len(counts)), counts), counts


def _chunks(counts, per_roi_bytes):
    """(image, first roi, end roi) spans: each image's RoIs in chunks of
    at most max(1, CHUNK_BYTES // per_roi_bytes)."""
    step = max(1, CHUNK_BYTES // max(int(per_roi_bytes), 1))
    start = 0
    for b, n in enumerate(counts.tolist()):
        for s in range(start, start + n, step):
            yield b, s, min(s + step, start + n)
        start += n


def _div(a, n):
    """a / n with IEEE division on every device: CUDA divides a tensor by
    a Python scalar through its reciprocal, an ulp off the CPU, and the
    RoI ops floor, ceil or truncate the quotients, so an ulp can move a
    sample or a bin edge by a pixel."""
    return a / torch.tensor(float(n), dtype=a.dtype, device=a.device)


def _iou_matrix(boxes):
    x1, y1, x2, y2 = [boxes[:, i] for i in range(4)]
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[:, None] + area[None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


#: bit weights of one packed byte, most significant first (np.packbits)
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _greedy_keep(suppress):
    """The greedy scan of a strictly upper-triangular [n, n] bool matrix
    (row i: the later ranks box i suppresses): rank i is kept unless a
    kept earlier rank suppresses it. The matrix is packed to bits where
    it lies and copied to the host once; returns a host bool array."""
    n = suppress.shape[0]
    nbytes = (n + 7) // 8
    pad = nbytes * 8 - n
    s = torch.nn.functional.pad(suppress, (0, pad)).view(n, nbytes, 8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=s.device)
    rows = (s.to(torch.int32) * w).sum(-1).to(torch.uint8).cpu().numpy()
    removed = np.zeros(nbytes, np.uint8)
    keep = np.zeros(n, bool)
    for i in range(n):
        if not (int(removed[i >> 3]) >> (7 - (i & 7))) & 1:
            keep[i] = True
            removed |= rows[i]
    return keep


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Hard NMS (reference vision/ops.py nms). Returns kept indices
    sorted by score, padded with -1 to the input length (static shape).
    ``category_idxs`` and ``categories`` are accepted and not used: every
    box competes with every other, as in the JAX op."""
    def fn(b, s):
        n = b.shape[0]
        order = torch.argsort(-s, stable=True)
        if n == 0:
            return order
        # the IoU of the sorted boxes: the JAX op's matrix, permuted
        iou = _iou_matrix(b[order])
        later = torch.ones(n, n, dtype=torch.bool, device=b.device).triu(1)
        keep = torch.from_numpy(_greedy_keep((iou > iou_threshold) & later))
        kept = order.cpu()[keep]
        out = torch.full((n,), -1, dtype=order.dtype)
        out[:kept.numel()] = kept
        out = out.to(b.device)
        if top_k is not None:
            out = out[:top_k]
        return out
    n_boxes = int(unwrap(boxes).shape[0])
    s = scores if scores is not None else torch.arange(
        n_boxes, 0, -1, dtype=torch.float32, device=_device_of(boxes))
    return run_op_nodiff("nms", fn, [boxes, s])


def _align_weights(lo, extent, n_out, ratio, size):
    """[R, n_out, size]: row o averages the bilinear weights of bin o's
    ``ratio`` sample points along one axis (roi_align's samples, border
    rule and clamps), so out = Wy @ x @ Wx^T."""
    k = torch.arange(n_out * ratio, dtype=lo.dtype, device=lo.device)
    p = lo[:, None] + _div((k + 0.5) * extent[:, None], n_out * ratio)
    # reference border semantics (roi_align kernel): points beyond
    # (-1, size) contribute 0; points in (-1, 0) clamp to the first pixel
    inside = (p > -1.0) & (p < size)
    p = torch.clamp(p, 0.0, size - 1)
    p0 = torch.floor(p)
    frac = p - p0
    i0 = p0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    w = torch.zeros(*p.shape, size, dtype=lo.dtype, device=lo.device)
    w = w.scatter_add(2, i0[..., None], (1 - frac)[..., None])
    w = w.scatter_add(2, i1[..., None], frac[..., None])
    w = w * inside[..., None]
    return w.view(-1, n_out, ratio, size).mean(2)


def _separable(feat_b, wy, wx):
    """[Rc, C, oh, ow] = wy @ feat_b @ wx^T per RoI, for one image's map
    [C, H, W] and weights wy [Rc, oh, H], wx [Rc, ow, W]: the x axis is
    contracted first in one matrix product, then y per RoI."""
    c, h, w = feat_b.shape
    rc, ow = wx.shape[0], wx.shape[1]
    t = feat_b.reshape(c * h, w) @ wx.reshape(rc * ow, w).t()
    t = t.reshape(c, h, rc, ow).permute(2, 1, 0, 3).reshape(rc, h, c * ow)
    out = torch.bmm(wy, t)                              # [Rc, oh, C*ow]
    return out.reshape(rc, -1, c, ow).permute(0, 2, 1, 3)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign (reference ops.yaml: roi_align), the JAX op's bilinear
    sampling: ``sampling_ratio`` <= 0 samples 2 x 2 points a bin (the
    JAX op's rule, not the reference's adaptive ceil). Computed as
    ``Wy @ x[b] @ Wx^T`` per RoI, in chunks of RoIs of one image."""
    out_h, out_w = (output_size if isinstance(output_size, (tuple, list))
                    else (output_size, output_size))
    _, counts = _roi_batch_indices(boxes, boxes_num)

    def fn(feat, rois):
        _, c, h, w = feat.shape
        off = 0.5 if aligned else 0.0
        ratio = sampling_ratio if sampling_ratio > 0 else 2
        r = rois * spatial_scale - off
        x1, y1, x2, y2 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
        rw = torch.clamp(x2 - x1, min=1e-6)
        rh = torch.clamp(y2 - y1, min=1e-6)
        wy = _align_weights(y1, rh, out_h, ratio, h)    # [R, oh, H]
        wx = _align_weights(x1, rw, out_w, ratio, w)    # [R, ow, W]
        transpose = h * out_w > out_h * w
        if transpose:            # contract the axis that leaves less
            feat = feat.transpose(2, 3)
            wy, wx = wx, wy
        per_roi = 2 * c * feat.shape[2] * wx.shape[1] * feat.element_size()
        outs = [_separable(feat[b], wy[s:e], wx[s:e])
                for b, s, e in _chunks(counts, per_roi)]
        out = torch.cat(outs) if outs else feat.new_zeros(
            0, c, wy.shape[1], wx.shape[1])
        return out.transpose(2, 3) if transpose else out
    return run_op("roi_align", fn, [x, boxes])


def _pool_samples(rois, spatial_scale, out_h, out_w, h, w):
    """roi_pool's sample indices: 4 x 4 points a bin at
    round(box * scale), as int64 [R, out_h*4] rows and [R, out_w*4]
    columns."""
    ratio = 4
    r = torch.round(rois * spatial_scale)
    x1, y1, x2, y2 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    ky = torch.arange(out_h * ratio, dtype=r.dtype, device=r.device)
    kx = torch.arange(out_w * ratio, dtype=r.dtype, device=r.device)
    ys = y1[:, None] + _div((ky + 0.5) * rh[:, None], out_h * ratio)
    xs = x1[:, None] + _div((kx + 0.5) * rw[:, None], out_w * ratio)
    yi = torch.clamp(ys.to(torch.int32), 0, h - 1).to(torch.int64)
    xi = torch.clamp(xs.to(torch.int32), 0, w - 1).to(torch.int64)
    return yi, xi


class _RoIPool(torch.autograd.Function):
    """Max over each bin's 4 x 4 samples, chunked over RoIs; the backward
    recomputes a chunk's samples and scatter-adds the output gradient to
    every sample equal to its bin's maximum, divided by their count."""

    @staticmethod
    def forward(ctx, feat, yi, xi, bidx, spans, out_h, out_w):
        cl = feat.permute(0, 2, 3, 1)                   # [N, H, W, C]
        outs = []
        for s, e in spans:
            patch = cl[bidx[s:e, None, None], yi[s:e, :, None],
                       xi[s:e, None, :]]                # [Rc, 4oh, 4ow, C]
            rc, c = patch.shape[0], patch.shape[-1]
            patch = patch.view(rc, out_h, 4, out_w, 4, c)
            outs.append(patch.amax(dim=(2, 4)))         # [Rc, oh, ow, C]
        out = torch.cat(outs) if outs else feat.new_zeros(
            0, out_h, out_w, feat.shape[1])
        ctx.save_for_backward(feat, yi, xi, bidx, out)
        ctx.spans, ctx.pool = spans, (out_h, out_w)
        return out.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        feat, yi, xi, bidx, out = ctx.saved_tensors
        out_h, out_w = ctx.pool
        cl = feat.permute(0, 2, 3, 1)
        g = g.permute(0, 2, 3, 1)                       # [R, oh, ow, C]
        dcl = torch.zeros_like(cl)
        for s, e in ctx.spans:
            b, ys, xs = bidx[s:e, None, None], yi[s:e, :, None], \
                xi[s:e, None, :]
            patch = cl[b, ys, xs]
            rc, c = patch.shape[0], patch.shape[-1]
            patch = patch.view(rc, out_h, 4, out_w, 4, c)
            hit = patch == out[s:e, :, None, :, None]
            share = g[s:e] / hit.sum(dim=(2, 4))
            contrib = hit * share[:, :, None, :, None]
            dcl.index_put_((b, ys, xs), contrib.view(rc, out_h * 4,
                                                     out_w * 4, c),
                           accumulate=True)
        return dcl.permute(0, 3, 1, 2), None, None, None, None, None, None


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """Max RoI pooling (reference ops.yaml: roi_pool) — the JAX op's
    dense-sampled max (4 x 4 samples a bin, static shapes)."""
    out_h, out_w = (output_size if isinstance(output_size, (tuple, list))
                    else (output_size, output_size))
    bidx_np, counts = _roi_batch_indices(boxes, boxes_num)

    def fn(feat, rois):
        _, c, h, w = feat.shape
        yi, xi = _pool_samples(rois.detach(), spatial_scale, out_h, out_w,
                               h, w)
        bidx = torch.from_numpy(bidx_np).to(feat.device)
        per_roi = 2 * c * out_h * out_w * 16 * feat.element_size()
        spans = [(s, e) for _, s, e in _chunks(counts, per_roi)]
        return _RoIPool.apply(feat, yi, xi, bidx, spans, out_h, out_w)
    return run_op("roi_pool", fn, [x, boxes])


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """reference ops.yaml: box_coder."""
    def fn(pb, pbv, tb):
        norm = 0.0 if box_normalized else 1.0
        pw = pb[:, 2] - pb[:, 0] + norm
        ph = pb[:, 3] - pb[:, 1] + norm
        pcx = pb[:, 0] + pw * 0.5
        pcy = pb[:, 1] + ph * 0.5
        if code_type == "encode_center_size":
            tw = tb[:, 2] - tb[:, 0] + norm
            th = tb[:, 3] - tb[:, 1] + norm
            tcx = tb[:, 0] + tw * 0.5
            tcy = tb[:, 1] + th * 0.5
            out = torch.stack([
                (tcx - pcx) / pw / pbv[:, 0],
                (tcy - pcy) / ph / pbv[:, 1],
                torch.log(tw / pw) / pbv[:, 2],
                torch.log(th / ph) / pbv[:, 3]], dim=1)
        else:  # decode_center_size
            dcx = pbv[:, 0] * tb[:, 0] * pw + pcx
            dcy = pbv[:, 1] * tb[:, 1] * ph + pcy
            dw = torch.exp(pbv[:, 2] * tb[:, 2]) * pw
            dh = torch.exp(pbv[:, 3] * tb[:, 3]) * ph
            out = torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                               dcx + dw * 0.5 - norm,
                               dcy + dh * 0.5 - norm], dim=1)
        return out
    return run_op("box_coder", fn, [prior_box, prior_box_var, target_box])


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior boxes (reference ops.yaml: prior_box), on the input's
    device."""
    h, w = tuple(unwrap(input).shape)[-2:]
    ih, iw = tuple(unwrap(image).shape)[-2:]
    step_h = steps[1] or ih / h
    step_w = steps[0] or iw / w
    ars = list(aspect_ratios)
    if flip:
        ars += [1.0 / r for r in aspect_ratios if r != 1.0]
    boxes = []
    for ms in min_sizes:
        for ar in ars:
            bw = ms * np.sqrt(ar) / 2
            bh = ms / np.sqrt(ar) / 2
            boxes.append((bw, bh))
        if max_sizes:
            for mx in max_sizes:
                s = np.sqrt(ms * mx) / 2
                boxes.append((s, s))
    cy = (np.arange(h) + offset) * step_h
    cx = (np.arange(w) + offset) * step_w
    gy, gx = np.meshgrid(cy, cx, indexing="ij")
    out = np.zeros((h, w, len(boxes), 4), np.float32)
    for i, (bw, bh) in enumerate(boxes):
        out[..., i, 0] = (gx - bw) / iw
        out[..., i, 1] = (gy - bh) / ih
        out[..., i, 2] = (gx + bw) / iw
        out[..., i, 3] = (gy + bh) / ih
    if clip:
        out = np.clip(out, 0, 1)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          out.shape).copy()
    dev = _device_of(input)
    return _out(out, dev), _out(var, dev)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, name=None):
    """YOLO detection decode (reference ops.yaml: yolo_box)."""
    na = len(anchors) // 2

    def fn(a, imgs):
        n, _, h, w = a.shape
        v = a.reshape(n, na, 5 + class_num, h, w)
        gx = torch.arange(w, device=a.device).reshape(1, 1, 1, w)
        gy = torch.arange(h, device=a.device).reshape(1, 1, h, 1)
        sx = torch.sigmoid(v[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
        sy = torch.sigmoid(v[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
        bx = (gx + sx) / w
        by = (gy + sy) / h
        aw = torch.tensor(anchors[0::2], dtype=a.dtype,
                          device=a.device).reshape(1, na, 1, 1)
        ah = torch.tensor(anchors[1::2], dtype=a.dtype,
                          device=a.device).reshape(1, na, 1, 1)
        bw = torch.exp(v[:, :, 2]) * aw / (w * downsample_ratio)
        bh = torch.exp(v[:, :, 3]) * ah / (h * downsample_ratio)
        conf = torch.sigmoid(v[:, :, 4])
        probs = torch.sigmoid(v[:, :, 5:]) * conf[:, :, None]
        imh = imgs[:, 0].reshape(n, 1, 1, 1).to(a.dtype)
        imw = imgs[:, 1].reshape(n, 1, 1, 1).to(a.dtype)
        x1 = (bx - bw / 2) * imw
        y1 = (by - bh / 2) * imh
        x2 = (bx + bw / 2) * imw
        y2 = (by + bh / 2) * imh
        if clip_bbox:
            zero = torch.zeros((), dtype=a.dtype, device=a.device)
            x1 = torch.minimum(torch.maximum(x1, zero), imw - 1)
            y1 = torch.minimum(torch.maximum(y1, zero), imh - 1)
            x2 = torch.minimum(torch.maximum(x2, zero), imw - 1)
            y2 = torch.minimum(torch.maximum(y2, zero), imh - 1)
        boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, -1, 4)
        scores = probs.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
        keep = (conf > conf_thresh).reshape(n, -1, 1)
        return boxes * keep, scores * keep
    return run_op("yolo_box", fn, [x, img_size])


def shuffle_channel(x, group, name=None):
    """reference ops.yaml: shuffle_channel."""
    def fn(a):
        n, c, h, w = a.shape
        return a.reshape(n, group, c // group, h, w).transpose(
            1, 2).reshape(n, c, h, w)
    return run_op("shuffle_channel", fn, [x])


def _deform_sample(a, py, px, msk):
    """[n, cin, K, ho, wo]: a [n, cin, h, w] sampled bilinearly at py / px
    [n, dg, K, ho, wo] (each deformable group's channels at its own
    points), times the modulation mask [n, dg, K, ho, wo] when given.
    Reference DmcnIm2colBilinear semantics: the whole sample is 0 outside
    (-1, size); inside, each out-of-range corner contributes 0 (no
    coordinate clamping), so border samples keep partial weights."""
    n, cin, h, w = a.shape
    dg = py.shape[1]
    cpg = cin // dg
    inside = (py > -1.0) & (py < h) & (px > -1.0) & (px < w)
    y0f, x0f = torch.floor(py), torch.floor(px)
    wy, wx = py - y0f, px - x0f
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    flat = a.reshape(n, dg, cpg, h * w)
    kshape = py.shape[2:]

    def corner(yc, xc):
        valid = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
        idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).reshape(
            n, dg, 1, -1).expand(n, dg, cpg, -1)
        g = torch.gather(flat, 3, idx).reshape(n, dg, cpg, *kshape)
        return g * valid[:, :, None]
    val = (corner(y0, x0) * ((1 - wy) * (1 - wx))[:, :, None]
           + corner(y0, x0 + 1) * ((1 - wy) * wx)[:, :, None]
           + corner(y0 + 1, x0) * (wy * (1 - wx))[:, :, None]
           + corner(y0 + 1, x0 + 1) * (wy * wx)[:, :, None])
    val = val * inside[:, :, None]
    if msk is not None:
        val = val * msk[:, :, None]
    return val.reshape(n, cin, *kshape)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1/v2 (reference ops.yaml: deformable_conv):
    a bilinear gather at the offset positions, then one contraction per
    group. mask=None is v1; with mask it is v2 (modulated). Images go in
    chunks whose sampled columns stay under ``CHUNK_BYTES``."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    dh, dw = (dilation, dilation) if isinstance(dilation, int) else dilation

    def fn(a, off, w, *rest):
        n, cin, h, wdt = a.shape
        cout, cin_g, kh, kw = w.shape
        hout = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
        wout = (wdt + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
        dg = deformable_groups
        kk = kh * kw
        off = off.reshape(n, dg, kk, 2, hout, wout)
        msk = None
        if mask is not None:
            msk = rest[0].reshape(n, dg, kk, hout, wout)
        # base sampling grid per kernel tap: tap (i, j) reads
        # (ho*sh - ph + i*dh, wo*sw - pw + j*dw)
        dev = a.device
        ho = torch.arange(hout, device=dev) * sh - ph
        wo = torch.arange(wout, device=dev) * sw - pw
        ki = torch.arange(kh, device=dev) * dh
        kj = torch.arange(kw, device=dev) * dw
        base_y = (ki[:, None, None, None] + ho[None, None, :, None]).expand(
            kh, kw, hout, wout).reshape(kk, hout, wout).to(off.dtype)
        base_x = (kj[None, :, None, None] + wo[None, None, None, :]).expand(
            kh, kw, hout, wout).reshape(kk, hout, wout).to(off.dtype)
        # offsets are (dy, dx) per tap
        py = base_y + off[:, :, :, 0]                   # [n, dg, K, ho, wo]
        px = base_x + off[:, :, :, 1]
        wf = w.reshape(cout, cin_g * kk)
        cpg_out = cout // groups
        per_image = 6 * cin * kk * hout * wout * a.element_size()
        step = max(1, CHUNK_BYTES // per_image)
        outs = []
        for s in range(0, n, step):
            e = min(s + step, n)
            cols = _deform_sample(a[s:e], py[s:e], px[s:e],
                                  None if msk is None else msk[s:e])
            cols = cols.reshape(e - s, groups, cin_g * kk, hout * wout)
            outs.append(torch.cat([
                torch.matmul(wf[g * cpg_out:(g + 1) * cpg_out], cols[:, g])
                for g in range(groups)], dim=1))
        out = torch.cat(outs).reshape(n, cout, hout, wout)
        if bias is not None:
            out = out + rest[-1].reshape(1, -1, 1, 1)
        return out
    args = [x, offset, weight]
    if mask is not None:
        args.append(mask)
    if bias is not None:
        args.append(bias)
    return run_op("deform_conv2d", fn, args)


from ..nn import Layer as _Layer  # noqa: E402


class DeformConv2D(_Layer):
    """Layer owning the deformable-conv weight/bias (reference:
    python/paddle/vision/ops.py:973 DeformConv2D(Layer)); params register
    on the module tree so optimizers/state_dict see them."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) \
            if isinstance(kernel_size, int) else kernel_size
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, kh, kw],
            attr=weight_attr)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True) \
            if bias_attr is not False else None
        self.stride, self.padding = stride, padding
        self.dilation = dilation
        self.deformable_groups = deformable_groups
        self.groups = groups

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             self.stride, self.padding, self.dilation,
                             self.deformable_groups, self.groups, mask)


def distribute_fpn_proposals(*a, **kw):
    raise NotImplementedError("FPN proposal distribution is dynamic-shape "
                              "host logic; run it outside jit")


def _cround(v):
    """C++ std::round: half away from zero (torch.round is half to even)."""
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


def _bin_masks(lo, bin_size, n_bins, size):
    """[R, n_bins, size] float: pixel p lies in bin i, i.e. in
    [floor(lo + i*bin), ceil(lo + (i+1)*bin)) clipped to [0, size]."""
    i = torch.arange(n_bins, dtype=lo.dtype, device=lo.device)
    start = torch.clamp(torch.floor(lo[:, None] + i * bin_size[:, None]),
                        0, size)
    end = torch.clamp(torch.ceil(lo[:, None] + (i + 1) * bin_size[:, None]),
                      0, size)
    p = torch.arange(size, dtype=lo.dtype, device=lo.device)
    return ((p >= start[..., None]) & (p < end[..., None])).to(lo.dtype)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling (reference ops.yaml: psroi_pool):
    input channels C = out_c * oh * ow; output bin (i, j) average-pools
    its own channel group over that bin's spatial region (reference
    psroi_pool_kernel.cc: start = round(box)*scale, end =
    (round(box)+1)*scale; each bin averages every pixel in
    [floor(start), ceil(end))). The bin masks are separable, so a chunk
    of RoIs is two contractions."""
    out_h, out_w = (output_size if isinstance(output_size, (tuple, list))
                    else (output_size, output_size))
    _, counts = _roi_batch_indices(boxes, boxes_num)

    def fn(feat, rois):
        _, c, h, w = feat.shape
        if c % (out_h * out_w) != 0:
            raise ValueError(
                f"psroi_pool needs channels divisible by {out_h * out_w}")
        out_c = c // (out_h * out_w)
        r = rois.detach()
        x1 = _cround(r[:, 0]) * spatial_scale
        y1 = _cround(r[:, 1]) * spatial_scale
        x2 = (_cround(r[:, 2]) + 1.0) * spatial_scale
        y2 = (_cround(r[:, 3]) + 1.0) * spatial_scale
        rw = torch.clamp(x2 - x1, min=0.1)
        rh = torch.clamp(y2 - y1, min=0.1)
        my = _bin_masks(y1, _div(rh, out_h), out_h, h).to(feat.dtype)
        mx = _bin_masks(x1, _div(rw, out_w), out_w, w).to(feat.dtype)
        cnt = torch.clamp(my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :],
                          min=1)                        # [R, oh, ow]
        per_roi = 2 * c * h * feat.element_size()
        outs = []
        for b, s, e in _chunks(counts, per_roi):
            f5 = feat[b].reshape(out_c, out_h, out_w, h, w)
            t = torch.einsum("cijyx,rjx->rcijy", f5, mx[s:e])
            outs.append(torch.einsum("rcijy,riy->rcij", t, my[s:e])
                        / cnt[s:e, None])
        return torch.cat(outs) if outs else feat.new_zeros(
            0, out_c, out_h, out_w)
    return run_op("psroi_pool", fn, [x, boxes])


class RoIAlign:
    """Layer wrapper (reference: vision.ops.RoIAlign)."""

    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale, aligned=aligned)


class RoIPool:
    """Layer wrapper (reference: vision.ops.RoIPool)."""

    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class PSRoIPool:
    """Layer wrapper (reference: vision.ops.PSRoIPool)."""

    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


def read_file(filename, name=None):
    """Read a file's bytes into a uint8 tensor on the current place
    (reference: read_file)."""
    with open(filename, "rb") as f:
        data = f.read()
    return _out(np.frombuffer(data, np.uint8), place_mod.current_device())


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode a uint8 JPEG byte tensor to CHW uint8 on its device
    (reference: decode_jpeg; PIL does the host-side decode and is
    imported here, on first use)."""
    import io as _io

    from PIL import Image
    data = bytes(_host(x).astype(np.uint8).tobytes())
    img = Image.open(_io.BytesIO(data))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return _out(arr, _device_of(x))


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2) — decay scores by overlap with higher-scored
    same-class candidates (reference ops.yaml: matrix_nms). Host-side
    like the reference CPU kernel (dynamic output count)."""
    dev = _device_of(bboxes)
    b_np = _host(bboxes)   # [N, M, 4]
    s_np = _host(scores)   # [N, C, M]
    outs, indices, counts = [], [], []
    for n in range(b_np.shape[0]):
        per_img = []
        for c in range(s_np.shape[1]):
            if c == background_label:
                continue
            sc = s_np[n, c]
            keep = np.where(sc > score_threshold)[0]
            if keep.size == 0:
                continue
            order = keep[np.argsort(-sc[keep])][:nms_top_k]
            boxes_c = b_np[n, order]
            sc_c = sc[order]
            # pairwise IoU of the sorted candidates
            x1 = np.maximum(boxes_c[:, None, 0], boxes_c[None, :, 0])
            y1 = np.maximum(boxes_c[:, None, 1], boxes_c[None, :, 1])
            x2 = np.minimum(boxes_c[:, None, 2], boxes_c[None, :, 2])
            y2 = np.minimum(boxes_c[:, None, 3], boxes_c[None, :, 3])
            off = 0.0 if normalized else 1.0
            inter = (np.clip(x2 - x1 + off, 0, None)
                     * np.clip(y2 - y1 + off, 0, None))
            area = ((boxes_c[:, 2] - boxes_c[:, 0] + off)
                    * (boxes_c[:, 3] - boxes_c[:, 1] + off))
            iou = inter / np.maximum(area[:, None] + area[None, :]
                                     - inter, 1e-10)
            iou = np.triu(iou, k=1)
            iou_cmax = iou.max(axis=0)     # per-candidate max w/ higher
            # decay_j = min_i f(iou_ij) / f(iou_cmax_i): denominator runs
            # over the HIGHER-ranked candidate i (rows)
            if use_gaussian:
                decay = np.exp((iou_cmax[:, None] ** 2 - iou ** 2)
                               * gaussian_sigma)
            else:
                decay = (1 - iou) / np.maximum(
                    1 - iou_cmax[:, None], 1e-10)
            decay = np.triu(decay, k=1) + np.tril(np.ones_like(decay))
            decay = decay.min(axis=0)
            dec_sc = sc_c * decay
            sel = np.where(dec_sc >= post_threshold)[0]
            for i in sel:
                per_img.append((c, dec_sc[i], *boxes_c[i], order[i]))
        per_img.sort(key=lambda r: -r[1])
        per_img = per_img[:keep_top_k]
        counts.append(len(per_img))
        for r in per_img:
            outs.append(r[:6])
            # global index into the flattened [N*M] box tensor
            # (reference matrix_nms_kernel.cc:235 pushes start + idx)
            indices.append(n * b_np.shape[1] + r[6])
    out = _out(np.asarray(outs, np.float32).reshape(-1, 6), dev)
    res = [out]
    if return_index:
        res.append(_out(np.asarray(indices, np.int64), dev))
    if return_rois_num:
        res.append(_out(np.asarray(counts, np.int32), dev))
    return tuple(res) if len(res) > 1 else out


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=True,
                       name=None):
    """RPN proposal generation: decode deltas at anchors, clip to image,
    filter small, NMS (reference ops.yaml: generate_proposals). Host-side
    (dynamic output count, like the reference CPU kernel)."""
    dev = _device_of(scores)
    sc = _host(scores)       # [N, A, H, W]
    bd = _host(bbox_deltas)  # [N, 4A, H, W]
    ims = _host(img_size)    # [N, 2]
    anc = _host(anchors).reshape(-1, 4)
    var = _host(variances).reshape(-1, 4)
    N = sc.shape[0]
    rois_out, num_out, score_out = [], [], []
    off = 1.0 if pixel_offset else 0.0
    for n in range(N):
        s = sc[n].transpose(1, 2, 0).reshape(-1)
        d = bd[n].reshape(-1, 4, sc.shape[2], sc.shape[3]) \
            .transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s_n, d_n, a_n, v_n = s[order], d[order], anc[order], var[order]
        aw = a_n[:, 2] - a_n[:, 0] + off
        ah = a_n[:, 3] - a_n[:, 1] + off
        acx = a_n[:, 0] + aw / 2
        acy = a_n[:, 1] + ah / 2
        cx = v_n[:, 0] * d_n[:, 0] * aw + acx
        cy = v_n[:, 1] * d_n[:, 1] * ah + acy
        wk = aw * np.exp(np.clip(v_n[:, 2] * d_n[:, 2], None, 10))
        hk = ah * np.exp(np.clip(v_n[:, 3] * d_n[:, 3], None, 10))
        props = np.stack([cx - wk / 2, cy - hk / 2,
                          cx + wk / 2 - off, cy + hk / 2 - off], axis=1)
        H_im, W_im = float(ims[n, 0]), float(ims[n, 1])
        props[:, 0::2] = np.clip(props[:, 0::2], 0, W_im - off)
        props[:, 1::2] = np.clip(props[:, 1::2], 0, H_im - off)
        ws = props[:, 2] - props[:, 0] + off
        hs = props[:, 3] - props[:, 1] + off
        keep = np.where((ws >= min_size) & (hs >= min_size))[0]
        props, s_n = props[keep], s_n[keep]
        # greedy NMS
        order2 = np.argsort(-s_n)
        selected = []
        while order2.size and len(selected) < post_nms_top_n:
            i = order2[0]
            selected.append(i)
            xx1 = np.maximum(props[i, 0], props[order2[1:], 0])
            yy1 = np.maximum(props[i, 1], props[order2[1:], 1])
            xx2 = np.minimum(props[i, 2], props[order2[1:], 2])
            yy2 = np.minimum(props[i, 3], props[order2[1:], 3])
            inter = (np.clip(xx2 - xx1 + off, 0, None)
                     * np.clip(yy2 - yy1 + off, 0, None))
            area_i = (props[i, 2] - props[i, 0] + off) \
                * (props[i, 3] - props[i, 1] + off)
            area_o = (props[order2[1:], 2] - props[order2[1:], 0] + off) \
                * (props[order2[1:], 3] - props[order2[1:], 1] + off)
            iou = inter / np.maximum(area_i + area_o - inter, 1e-10)
            order2 = order2[1:][iou <= nms_thresh]
        rois_out.append(props[selected])
        score_out.append(s_n[selected])
        num_out.append(len(selected))
    rois = _out(np.concatenate(rois_out).astype(np.float32)
                if rois_out else np.zeros((0, 4), np.float32), dev)
    scs = _out(np.concatenate(score_out).astype(np.float32), dev)
    if return_rois_num:
        return rois, scs, _out(np.asarray(num_out, np.int32), dev)
    return rois, scs


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 detection loss (reference ops.yaml: yolo_loss kernel).

    x: [N, mask*(5+cls), H, W]; gt_box: [N, B, 4] (xywh, image-relative
    0..1); gt_label: [N, B]. Anchor assignment (best wh-IoU over ALL
    anchors), coordinate SCE/L1 losses weighted by (2 - gw*gh),
    objectness BCE with ignore region, class BCE — the JAX op's
    decomposition, vectorised over images, cells and boxes.
    """
    anchors_np = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask_np = np.asarray(anchor_mask, np.int64)
    n_mask = len(mask_np)

    def fn(xx, gbox, glabel, *rest):
        N, C, H, W = xx.shape
        dev, dt = xx.device, xx.dtype
        xx = xx.reshape(N, n_mask, 5 + class_num, H, W)
        B = gbox.shape[1]
        an_w = torch.from_numpy(anchors_np[:, 0]).to(dev) / (
            downsample_ratio * W)
        an_h = torch.from_numpy(anchors_np[:, 1]).to(dev) / (
            downsample_ratio * H)
        mask_t = torch.from_numpy(mask_np).to(dev)

        tx, ty = xx[:, :, 0], xx[:, :, 1]
        tw, th = xx[:, :, 2], xx[:, :, 3]
        tobj = xx[:, :, 4]
        tcls = xx[:, :, 5:]

        # decoded prediction boxes (for the ignore mask)
        gx = (torch.sigmoid(tx) * scale_x_y - 0.5 * (scale_x_y - 1)
              + torch.arange(W, device=dev)[None, None, None, :]) / W
        gy = (torch.sigmoid(ty) * scale_x_y - 0.5 * (scale_x_y - 1)
              + torch.arange(H, device=dev)[None, None, :, None]) / H
        gw = torch.exp(tw) * an_w[mask_t][None, :, None, None]
        gh = torch.exp(th) * an_h[mask_t][None, :, None, None]

        # IoU of every predicted box with every gt box -> ignore mask
        with torch.no_grad():
            px1, px2 = gx - gw / 2, gx + gw / 2
            py1, py2 = gy - gh / 2, gy + gh / 2
            bx1 = (gbox[:, :, 0] - gbox[:, :, 2] / 2)[:, None, :]
            bx2 = (gbox[:, :, 0] + gbox[:, :, 2] / 2)[:, None, :]
            by1 = (gbox[:, :, 1] - gbox[:, :, 3] / 2)[:, None, :]
            by2 = (gbox[:, :, 1] + gbox[:, :, 3] / 2)[:, None, :]
            ix1 = torch.maximum(px1[:, :, None], bx1[..., None, None])
            ix2 = torch.minimum(px2[:, :, None], bx2[..., None, None])
            iy1 = torch.maximum(py1[:, :, None], by1[..., None, None])
            iy2 = torch.minimum(py2[:, :, None], by2[..., None, None])
            inter = torch.clamp(ix2 - ix1, min=0) * \
                torch.clamp(iy2 - iy1, min=0)
            area_p = (gw * gh)[:, :, None]
            area_g = (gbox[:, :, 2] * gbox[:, :, 3])[:, None, :, None, None]
            valid_gt = (gbox[:, :, 2] > 0)[:, None, :, None, None]
            iou = inter / torch.clamp(area_p + area_g - inter, min=1e-10)
            iou = torch.where(valid_gt, iou, 0.0)
            best_iou = torch.amax(iou, dim=2)           # [N, m, H, W]
            ignore = best_iou > ignore_thresh

            # anchor assignment per gt: best wh-IoU over ALL anchors
            bw = gbox[:, :, 2][..., None]               # [N, B, 1]
            bh = gbox[:, :, 3][..., None]
            inter_a = torch.minimum(bw, an_w) * torch.minimum(bh, an_h)
            iou_a = inter_a / torch.clamp(bw * bh + an_w * an_h - inter_a,
                                          min=1e-10)
            best_anchor = torch.argmax(iou_a, dim=-1)   # [N, B]
            # position of each gt in the grid
            gi = torch.clamp((gbox[:, :, 0] * W).to(torch.int32), 0,
                             W - 1).to(torch.int64)
            gj = torch.clamp((gbox[:, :, 1] * H).to(torch.int32), 0,
                             H - 1).to(torch.int64)
        score = rest[0] if rest else torch.ones(N, B, dtype=dt, device=dev)

        loss = torch.zeros(N, dtype=dt, device=dev)
        flat = N * n_mask * H * W
        obj_target = torch.zeros(flat, dtype=dt, device=dev)
        obj_weight = torch.zeros(flat, dtype=dt, device=dev)
        smooth_pos = 1.0 - 1.0 / class_num if use_label_smooth and \
            class_num > 1 else 1.0
        smooth_neg = 1.0 / class_num if use_label_smooth and \
            class_num > 1 else 0.0
        ni = torch.arange(N, device=dev)[:, None]
        onehot = (glabel[..., None] == torch.arange(
            class_num, device=dev)).to(dt)              # [N, B, cls]
        cls_tgt = onehot * smooth_pos + (1 - onehot) * smooth_neg
        zero = torch.zeros((), dtype=dt, device=dev)

        def bce(logit, target):
            return torch.maximum(logit, zero) - logit * target \
                + torch.log1p(torch.exp(-torch.abs(logit)))
        for k, a_idx in enumerate(mask_np.tolist()):
            resp = (best_anchor == a_idx) & (gbox[:, :, 2] > 0)  # [N, B]
            wgt = (2.0 - gbox[:, :, 2] * gbox[:, :, 3]) * score
            # targets at (gj, gi)
            tgt_x = gbox[:, :, 0] * W - gi
            tgt_y = gbox[:, :, 1] * H - gj
            tgt_w = torch.log(torch.clamp(gbox[:, :, 2] / an_w[a_idx],
                                          min=1e-9))
            tgt_h = torch.log(torch.clamp(gbox[:, :, 3] / an_h[a_idx],
                                          min=1e-9))
            px = tx[:, k][ni, gj, gi]
            py_ = ty[:, k][ni, gj, gi]
            pw = tw[:, k][ni, gj, gi]
            ph = th[:, k][ni, gj, gi]
            coord = (bce(px, tgt_x) + bce(py_, tgt_y)
                     + torch.abs(pw - tgt_w) + torch.abs(ph - tgt_h)) * wgt
            loss = loss + torch.sum(torch.where(resp, coord, zero), dim=1)
            # class loss at responsible cells
            pcls = tcls[:, k][ni, :, gj, gi]            # [N, B, cls]
            cls_l = torch.sum(bce(pcls, cls_tgt), dim=-1) * score
            loss = loss + torch.sum(torch.where(resp, cls_l, zero), dim=1)
            # objectness target map: a scatter-max at (n, k, gj, gi)
            cell = ((ni * n_mask + k) * H + gj) * W + gi
            obj_target = obj_target.scatter_reduce(
                0, cell.reshape(-1), torch.where(resp, 1.0, 0.0).to(
                    dt).reshape(-1), "amax")
            obj_weight = obj_weight.scatter_reduce(
                0, cell.reshape(-1), torch.where(resp, score, zero)
                .reshape(-1), "amax")
        obj_target = obj_target.reshape(N, n_mask, H, W)
        obj_weight = obj_weight.reshape(N, n_mask, H, W)
        # objectness: positives weighted by score; negatives (not ignored)
        pos = obj_target > 0
        neg_ok = (~pos) & (~ignore)
        obj_bce = torch.maximum(tobj, zero) - tobj * obj_target \
            + torch.log1p(torch.exp(-torch.abs(tobj)))
        obj_l = torch.where(pos, obj_bce * obj_weight,
                            torch.where(neg_ok, obj_bce, zero))
        loss = loss + torch.sum(obj_l, dim=(1, 2, 3))
        return loss
    args = [x, gt_box, gt_label] + ([gt_score] if gt_score is not None
                                    else [])
    return run_op("yolo_loss", fn, args)


def affine_channel(x, scale, bias, data_format="NCHW", name=None):
    """Per-channel affine y = scale*x + bias (reference ops.yaml:
    affine_channel)."""
    def fn(a, s, b):
        if data_format == "NCHW":
            shape = (1, -1) + (1,) * (a.dim() - 2)
        else:
            shape = (1,) * (a.dim() - 1) + (-1,)
        return a * s.reshape(shape) + b.reshape(shape)
    return run_op("affine_channel", fn, [x, scale, bias])


def box_clip(input, im_info, name=None):
    """Clip boxes to image bounds (reference ops.yaml: box_clip;
    im_info rows are [H, W, scale])."""
    def fn(b, info):
        info2 = info.reshape(-1, info.shape[-1])
        h = info2[:, 0] / info2[:, 2] - 1.0
        w = info2[:, 1] / info2[:, 2] - 1.0
        if b.dim() == 3:
            # batched [N, M, 4]: one limit per image
            h = h[:, None]
            w = w[:, None]
        else:
            # flat [M, 4]: single image -> scalar limits
            h = h[0]
            w = w[0]
        zero = torch.zeros((), dtype=b.dtype, device=b.device)
        x1 = torch.maximum(b[..., 0], zero)
        y1 = torch.maximum(b[..., 1], zero)
        x2 = b[..., 2]
        y2 = b[..., 3]
        return torch.stack([torch.minimum(x1, w), torch.minimum(y1, h),
                            torch.maximum(torch.minimum(x2, w), zero),
                            torch.maximum(torch.minimum(y2, h), zero)],
                           dim=-1)
    return run_op("box_clip", fn, [input, im_info])


def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=0.5,
                    name=None):
    """Greedy bipartite matching of a [M, N] distance matrix (reference
    ops.yaml: bipartite_match kernel's greedy algorithm). Returns
    (match_indices [1, N], match_distances [1, N]); per_prediction mode
    additionally matches leftover columns above the threshold."""
    dev = _device_of(dist_matrix)
    d = np.array(_host(dist_matrix), np.float64)
    m, n_ = d.shape
    idx = np.full(n_, -1, np.int64)
    dist = np.zeros(n_, np.float64)
    work = d.copy()
    # greedy global-max assignment, one row to one column
    for _ in range(min(m, n_)):
        r, c = np.unravel_index(np.argmax(work), work.shape)
        if work[r, c] <= 0:
            break
        idx[c] = r
        dist[c] = d[r, c]
        work[r, :] = -1
        work[:, c] = -1
    if match_type == "per_prediction":
        for c in range(n_):
            if idx[c] == -1:
                r = int(np.argmax(d[:, c]))
                if d[r, c] >= dist_threshold:
                    idx[c] = r
                    dist[c] = d[r, c]
    return (_out(idx.reshape(1, -1), dev),
            _out(dist.astype(np.float32).reshape(1, -1), dev))


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, rois_num_per_level=None,
                          name=None):
    """Merge per-FPN-level proposals, keep top-N by score PER IMAGE
    (reference ops.yaml: collect_fpn_proposals). Host-side (dynamic
    count). rois_num_per_level: per-level [batch] counts; without it the
    whole input is one image."""
    dev = _device_of(*multi_rois)
    rois_l = [_host(r) for r in multi_rois]
    scores_l = [_host(s).reshape(-1) for s in multi_scores]
    if rois_num_per_level is None:
        rois = np.concatenate(rois_l)
        scores = np.concatenate(scores_l)
        order = np.argsort(-scores)[:post_nms_top_n]
        return _out(rois[order].astype(np.float32), dev)
    counts_l = [_host(c).astype(np.int64).reshape(-1)
                for c in rois_num_per_level]
    batch = len(counts_l[0])
    out_rois, out_counts = [], []
    for b in range(batch):
        rs, ss = [], []
        for rois, scores, counts in zip(rois_l, scores_l, counts_l):
            beg = int(counts[:b].sum())
            end = beg + int(counts[b])
            rs.append(rois[beg:end])
            ss.append(scores[beg:end])
        rs = np.concatenate(rs)
        ss = np.concatenate(ss)
        order = np.argsort(-ss)[:post_nms_top_n]
        out_rois.append(rs[order])
        out_counts.append(len(order))
    return (_out(np.concatenate(out_rois).astype(np.float32), dev),
            _out(np.asarray(out_counts, np.int32), dev))


def _multiclass_nms3(b_np, s_np, score_threshold, nms_top_k, keep_top_k,
                     nms_threshold, normalized, nms_eta, background_label):
    """multiclass_nms3 on host arrays: (rows [label, score, x1, y1, x2,
    y2], global box indices, rows per image). The JAX op's greedy loop
    with the candidates as an index array (the same kept set, the same
    order)."""
    off = 0.0 if normalized else 1.0
    outs, indices, counts = [], [], []
    for n in range(b_np.shape[0]):
        per_img = []
        for c in range(s_np.shape[1]):
            if c == background_label:
                continue
            sc = s_np[n, c]
            keep = np.where(sc > score_threshold)[0]
            order = keep[np.argsort(-sc[keep])][:nms_top_k]
            boxes_c = b_np[n, order]
            kept = []
            thr = nms_threshold
            cand = np.arange(len(order))
            while cand.size:
                i = int(cand[0])
                kept.append(i)
                cand = cand[1:]
                if not cand.size:
                    break
                bi = boxes_c[i]
                rest = boxes_c[cand]
                xx1 = np.maximum(bi[0], rest[:, 0])
                yy1 = np.maximum(bi[1], rest[:, 1])
                xx2 = np.minimum(bi[2], rest[:, 2])
                yy2 = np.minimum(bi[3], rest[:, 3])
                inter = (np.clip(xx2 - xx1 + off, 0, None)
                         * np.clip(yy2 - yy1 + off, 0, None))
                ai = (bi[2] - bi[0] + off) * (bi[3] - bi[1] + off)
                ar = ((rest[:, 2] - rest[:, 0] + off)
                      * (rest[:, 3] - rest[:, 1] + off))
                iou = inter / np.maximum(ai + ar - inter, 1e-10)
                cand = cand[iou <= thr]
                if nms_eta < 1.0 and thr > 0.5:
                    thr *= nms_eta
            for i in kept:
                per_img.append((c, sc[order[i]], *boxes_c[i],
                                n * b_np.shape[1] + order[i]))
        per_img.sort(key=lambda r: -r[1])
        per_img = per_img[:keep_top_k]
        counts.append(len(per_img))
        for r in per_img:
            outs.append(r[:6])
            indices.append(r[6])
    return (np.asarray(outs, np.float32).reshape(-1, 6),
            np.asarray(indices, np.int64), np.asarray(counts, np.int32))


def multiclass_nms3(bboxes, scores, rois_num=None, score_threshold=0.05,
                    nms_top_k=1000, keep_top_k=100, nms_threshold=0.3,
                    normalized=True, nms_eta=1.0, background_label=-1,
                    return_index=False, name=None):
    """Per-class hard NMS over [N, M, 4] boxes / [N, C, M] scores
    (reference ops.yaml: multiclass_nms3). Output rows are
    [label, score, x1, y1, x2, y2] like the kernel."""
    dev = _device_of(bboxes)
    out, idx, counts = _multiclass_nms3(
        _host(bboxes), _host(scores), score_threshold, nms_top_k,
        keep_top_k, nms_threshold, normalized, nms_eta, background_label)
    res = [_out(out, dev)]
    if return_index:
        res.append(_out(idx, dev))
    res.append(_out(counts, dev))
    return tuple(res)


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  ap_version="integral", name=None):
    """Mean average precision over detection results (reference ops.yaml:
    detection_map). detect_res rows: [label, score, x1, y1, x2, y2];
    label rows: [label, x1, y1, x2, y2(, difficult)]. Single-image host
    evaluation like the reference CPU kernel's core loop."""
    dev = _device_of(detect_res)
    det = np.asarray(_host(detect_res), np.float64).reshape(-1, 6)
    gt = np.asarray(_host(label), np.float64)
    has_difficult = gt.shape[1] >= 6
    difficult = gt[:, 5].astype(bool) if has_difficult \
        else np.zeros(len(gt), bool)
    if not evaluate_difficult:
        gt = gt[~difficult]
    aps = []
    for c in range(class_num):
        if c == background_label:
            continue
        d_c = det[det[:, 0] == c]
        g_c = gt[gt[:, 0] == c]
        if len(g_c) == 0:
            continue
        order = np.argsort(-d_c[:, 1])
        d_c = d_c[order]
        matched = np.zeros(len(g_c), bool)
        tp = np.zeros(len(d_c))
        fp = np.zeros(len(d_c))
        for i, row in enumerate(d_c):
            best_iou, best_j = 0.0, -1
            for j, g in enumerate(g_c):
                xx1 = max(row[2], g[1])
                yy1 = max(row[3], g[2])
                xx2 = min(row[4], g[3])
                yy2 = min(row[5], g[4])
                inter = max(xx2 - xx1, 0) * max(yy2 - yy1, 0)
                a1 = (row[4] - row[2]) * (row[5] - row[3])
                a2 = (g[3] - g[1]) * (g[4] - g[2])
                iou = inter / max(a1 + a2 - inter, 1e-10)
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_iou >= overlap_threshold and not matched[best_j]:
                tp[i] = 1
                matched[best_j] = True
            else:
                fp[i] = 1
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        rec = ctp / len(g_c)
        prec = ctp / np.maximum(ctp + cfp, 1e-10)
        if ap_version == "11point":
            ap = np.mean([prec[rec >= t].max() if (rec >= t).any() else 0
                          for t in np.linspace(0, 1, 11)])
        else:  # integral
            ap = 0.0
            prev_r = 0.0
            for r, p2 in zip(rec, prec):
                ap += (r - prev_r) * p2
                prev_r = r
        aps.append(ap)
    m = float(np.mean(aps)) if aps else 0.0
    return _out(np.asarray(m, np.float32), dev)


def yolo_box_head(x, anchors, class_num, name=None):
    """YOLO head passthrough (reference ops.yaml: yolo_box_head — the
    fused CUDA graph just forwards activations to yolo_box_post)."""
    return x


def yolo_box_post(boxes0, boxes1, boxes2, image_shape, image_scale,
                  anchors0, anchors1, anchors2, class_num, conf_thresh,
                  downsample_ratio0, downsample_ratio1, downsample_ratio2,
                  clip_bbox=True, scale_x_y=1.0, nms_threshold=0.45,
                  name=None):
    """Decode 3 YOLO feature maps + NMS (reference ops.yaml:
    yolo_box_post): yolo_box per level on the device, then the boxes
    rescaled and per-class NMS on the host."""
    dev = _device_of(boxes0)
    levels = [(boxes0, anchors0, downsample_ratio0),
              (boxes1, anchors1, downsample_ratio1),
              (boxes2, anchors2, downsample_ratio2)]
    all_boxes, all_scores = [], []
    for feat, anc, ds in levels:
        b, s = yolo_box(feat, image_shape, list(anc), class_num,
                        conf_thresh, ds, clip_bbox, scale_x_y=scale_x_y)
        all_boxes.append(_host(b))
        all_scores.append(_host(s))
    boxes = np.concatenate(all_boxes, axis=1)    # [N, sumM, 4]
    scores = np.concatenate(all_scores, axis=1)  # [N, sumM, C]
    # rescale to original-image coordinates (reference divides by scale)
    scale = np.asarray(_host(image_scale), np.float32).reshape(-1)
    boxes_np = boxes / scale[:, None, None]
    out, _, counts = _multiclass_nms3(
        boxes_np, scores.transpose(0, 2, 1), conf_thresh, 1000, 100,
        nms_threshold, True, 1.0, -1)
    return _out(out, dev), _out(counts, dev)


def correlation(x, y, pad_size, kernel_size, max_displacement, stride1,
                stride2, corr_type_multiply=1, name=None):
    """FlowNet correlation layer (reference ops.yaml: correlation): for
    each displacement, the channel-patch inner product between x and the
    displaced y, averaged over channels * kernel_size^2; shifts slice a
    zero-padded copy (reference zero-padding semantics, no wraparound)."""
    def fn(a, b):
        n, c, h, w = a.shape
        d = max_displacement // stride2
        k = kernel_size
        # pad a by pad_size; pad b by pad_size + max displacement so any
        # shifted window reads zeros, never wrapped pixels
        pad = torch.nn.functional.pad
        ap = pad(a, (pad_size,) * 4)
        m = max_displacement
        bp = pad(b, (pad_size + m,) * 4)
        h2, w2 = ap.shape[2], ap.shape[3]
        outs = []
        for dy in range(-d, d + 1):
            for dx in range(-d, d + 1):
                oy, ox = dy * stride2, dx * stride2
                b_shift = bp[:, :, m + oy:m + oy + h2, m + ox:m + ox + w2]
                prod = torch.mean(ap * b_shift, dim=1)  # [n, h2, w2]
                if k > 1:
                    # patch mean over the k x k window (SAME padding)
                    lo, hi = (k - 1) // 2, k // 2
                    prod = torch.nn.functional.avg_pool2d(
                        pad(prod[:, None], (lo, hi, lo, hi)), k,
                        stride=1)[:, 0]
                outs.append(prod[:, pad_size:pad_size + h,
                                 pad_size:pad_size + w])
        out = torch.stack(outs, dim=1)                  # [n, D*D, h, w]
        if stride1 > 1:
            out = out[:, :, ::stride1, ::stride1]
        return out
    return run_op("correlation", fn, [x, y])
