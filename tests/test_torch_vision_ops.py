"""``paddle_tpu_torch.vision.ops`` against ``paddle_tpu.vision.ops`` on the
CPU, the same seeded numpy inputs through both:

- every device op (``nms``, ``roi_align``, ``roi_pool``, ``psroi_pool``,
  ``box_coder``, ``yolo_box``, ``shuffle_channel``, ``deform_conv2d`` v1 /
  v2 and ``DeformConv2D``, ``yolo_loss``, ``affine_channel``, ``box_clip``,
  ``correlation``): values, and the gradients of every float input where
  the JAX op has them, within chip_smoke's f32 gate (atol 1e-4 x
  max(1, max |ref|)); ``nms``'s kept indices equal (ties, the -1 padding,
  ``top_k``, ignored categories);
- the RoI ops and ``deform_conv2d`` again with ``CHUNK_BYTES`` cut so
  that every RoI (every image) is a chunk of its own;
- every host op (``prior_box``, ``matrix_nms``, ``generate_proposals``,
  ``multiclass_nms3``, ``bipartite_match``, ``collect_fpn_proposals``,
  ``detection_map``, ``read_file`` / ``decode_jpeg``) bit-equal;
  ``yolo_box_post`` (a device decode, then host NMS) within the gate.
"""
import io

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.vision import ops as tops
from test_torch_parity_util import (assert_f32_gate, cpu_place,  # noqa: F401
                                    run_both)

J, T = jp.vision.ops, tops


@pytest.fixture(autouse=True, scope="module")
def _cpu(cpu_place):  # noqa: F811
    yield


def _rng(seed):
    return np.random.default_rng(seed)


def _boxes(rng, n, size, min_wh=1.0, max_wh=None):
    max_wh = max_wh or size / 2
    xy = rng.uniform(-2, size, (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _eq(t_out, j_out):
    np.testing.assert_array_equal(np.asarray(t_out.numpy()),
                                  np.asarray(j_out.numpy()))


# -- nms -------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "ties", "top_k", "no_scores",
                                  "categories", "all_kept", "strict"])
def test_nms_matches_jax(case):
    rng = _rng(1)
    n = 48
    boxes = _boxes(rng, n, 40.0, 4.0, 20.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    kw = dict(iou_threshold=0.4)
    if case == "ties":             # equal scores: the lower index first
        scores = np.round(scores * 4) / 4
        boxes[5] = boxes[3]        # identical boxes too
    if case == "top_k":
        kw["top_k"] = 10
    if case == "categories":       # accepted and not used, as in JAX
        kw["category_idxs"] = rng.integers(0, 3, n).astype(np.int64)
        kw["categories"] = [0, 1, 2]
    if case == "all_kept":
        kw["iou_threshold"] = 1.0
    if case == "strict":
        kw["iou_threshold"] = 0.0
    s = None if case == "no_scores" else scores

    def call(P, ops):
        extra = dict(kw)
        if "category_idxs" in extra:
            extra["category_idxs"] = P.to_tensor(extra["category_idxs"])
        return ops.nms(P.to_tensor(boxes), scores=None if s is None
                       else P.to_tensor(s), **extra)
    got, want = call(tp, T), call(jp, J)
    _eq(got, want)
    g = got.numpy()
    kept = int((g >= 0).sum())
    assert g.shape == ((kw.get("top_k") or n),)
    assert (g[kept:] == -1).all() and (g[:kept] >= 0).all()
    if case == "all_kept":
        assert kept == n
    if case == "strict":
        assert 1 <= kept < n


def test_nms_empty_and_one():
    for n in (0, 1):
        b = _boxes(_rng(2), n, 10.0)
        s = np.ones(n, np.float32)
        got = T.nms(tp.to_tensor(b), 0.5, tp.to_tensor(s)).numpy()
        assert got.tolist() == list(range(n))


# -- the RoI family ----------------------------------------------------------

def _roi_inputs(seed, c=3, h=12, w=16, counts=(3, 2), scale=0.5):
    rng = _rng(seed)
    x = rng.standard_normal((len(counts), c, h, w)).astype(np.float32)
    boxes = _boxes(rng, sum(counts), w / scale, 2.0, 12.0)
    return x, boxes, np.asarray(counts, np.int32)


@pytest.mark.parametrize("out,ratio,aligned,hw", [
    (4, -1, True, (12, 16)), ((3, 5), 3, False, (12, 16)),
    (2, 1, True, (16, 8)), ((5, 2), -1, False, (7, 9))])
def test_roi_align_matches_jax(out, ratio, aligned, hw):
    x, boxes, num = _roi_inputs(3, h=hw[0], w=hw[1])

    def f(ops):
        return lambda a, b, n: ops.roi_align(a, b, n, out, 0.5, ratio,
                                             aligned)
    run_both(f(J), f(T), [x, boxes, num], int_args=(2,), gate=True)


def test_roi_align_border_and_degenerate_boxes():
    x, _, _ = _roi_inputs(4)
    boxes = np.array([[-9, -9, -3, -3], [-3, -3, 5, 4], [20, 14, 40, 30],
                      [6, 6, 6, 6], [30, 20, 28, 18]], np.float32)

    def f(ops):
        return lambda a, b, n: ops.roi_align(a, b, n, 3, 0.5)
    run_both(f(J), f(T), [x, boxes, np.array([3, 2], np.int32)],
             int_args=(2,), gate=True)


def test_roi_pool_matches_jax():
    x, boxes, num = _roi_inputs(5)
    boxes[1] = [4, 4, 5, 5]       # a small box: repeated samples tie

    def f(ops):
        return lambda a, b, n: ops.roi_pool(a, b, n, (3, 4), 0.5)
    run_both(f(J), f(T), [x, boxes, num], int_args=(2,), gate=True)


def test_roi_pool_ties_share_the_gradient():
    x = np.zeros((1, 2, 6, 6), np.float32)       # every sample ties
    x[0, 1, 2, 3] = 1.0
    boxes = np.array([[0, 0, 5, 5], [1, 1, 4, 4]], np.float32)

    def f(ops):
        return lambda a, b: ops.roi_pool(a, b, None, 2)
    run_both(f(J), f(T), [x, boxes], gate=True)


def test_psroi_pool_matches_jax():
    rng = _rng(6)
    x = rng.standard_normal((2, 2 * 3 * 2, 10, 12)).astype(np.float32)
    boxes = _boxes(rng, 5, 24.0, 2.0, 16.0)
    num = np.array([2, 3], np.int32)

    def f(ops):
        return lambda a, b, n: ops.psroi_pool(a, b, n, (3, 2), 0.5)
    run_both(f(J), f(T), [x, boxes, num], int_args=(2,), gate=True)


def test_roi_layers_match_jax():
    x, boxes, num = _roi_inputs(7, c=8)
    for name, size in (("RoIAlign", 2), ("RoIPool", 2), ("PSRoIPool", 2)):
        got = getattr(T, name)(size, 0.5)(tp.to_tensor(x),
                                          tp.to_tensor(boxes),
                                          tp.to_tensor(num))
        want = getattr(J, name)(size, 0.5)(jp.to_tensor(x),
                                           jp.to_tensor(boxes),
                                           jp.to_tensor(num))
        assert_f32_gate(got.numpy(), want.numpy(), name)


@pytest.mark.parametrize("op", ["roi_align", "roi_pool", "psroi_pool",
                                "deform_conv2d"])
def test_chunked_equals_unchunked(op, monkeypatch):
    """One RoI (one image) a chunk gives the one-chunk result."""
    rng = _rng(8)
    if op == "deform_conv2d":
        x = rng.standard_normal((3, 4, 7, 7)).astype(np.float32)
        args = [x, rng.normal(0, 1.5, (3, 18, 7, 7)).astype(np.float32),
                rng.standard_normal((5, 4, 3, 3)).astype(np.float32)]

        def call(a, o, w):
            return T.deform_conv2d(a, o, w, padding=1)
    else:
        x, boxes, num = _roi_inputs(8, c=4)
        args = [x, boxes, num]

        def call(a, b, n):
            return getattr(T, op)(a, b, n, 2, 0.5)
    outs = []
    for chunk in (tops.CHUNK_BYTES, 1):
        monkeypatch.setattr(tops, "CHUNK_BYTES", chunk)
        ts = [tp.to_tensor(a, stop_gradient=a.dtype != np.float32)
              for a in args]
        out = call(*ts)
        (out * out).sum().backward()
        outs.append((out.numpy(), ts[0].grad.numpy()))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-6, atol=1e-6)


# -- box and YOLO ops --------------------------------------------------------

@pytest.mark.parametrize("code_type,normalized", [
    ("encode_center_size", True), ("encode_center_size", False),
    ("decode_center_size", True), ("decode_center_size", False)])
def test_box_coder_matches_jax(code_type, normalized):
    rng = _rng(9)
    prior = _boxes(rng, 6, 1.0 if normalized else 30.0, 0.1, 0.5) \
        if normalized else _boxes(rng, 6, 30.0, 2.0, 10.0)
    var = rng.uniform(0.1, 0.3, (6, 4)).astype(np.float32)
    target = (_boxes(rng, 6, 30.0, 2.0, 10.0) if code_type.startswith(
        "encode") else rng.normal(0, 0.5, (6, 4)).astype(np.float32))

    def f(ops):
        return lambda p, v, t: ops.box_coder(p, v, t, code_type, normalized)
    run_both(f(J), f(T), [prior, var, target], gate=True)


YOLO_ANCHORS = [10, 13, 16, 30, 33, 23]


@pytest.mark.parametrize("clip,scale", [(True, 1.0), (False, 1.05)])
def test_yolo_box_matches_jax(clip, scale):
    rng = _rng(10)
    x = rng.standard_normal((2, 3 * (5 + 4), 5, 6)).astype(np.float32)
    img = np.array([[160, 192], [150, 170]], np.int32)

    def f(ops):
        return lambda a, i: ops.yolo_box(a, i, YOLO_ANCHORS, 4, 0.3, 32,
                                         clip, scale)
    run_both(f(J), f(T), [x, img], gate=True)


def test_shuffle_channel_matches_jax():
    x = _rng(11).standard_normal((2, 6, 3, 4)).astype(np.float32)
    run_both(lambda a: J.shuffle_channel(a, 3),
             lambda a: T.shuffle_channel(a, 3), [x], gate=True)


def _yolo_gt(rng, n, b, live):
    gt = np.zeros((n, b, 4), np.float32)
    gt[:, :live, :2] = rng.uniform(0.05, 0.95, (n, live, 2))
    gt[:, :live, 2:] = rng.uniform(0.02, 0.6, (n, live, 2))
    return gt


@pytest.mark.parametrize("with_score,smooth", [(False, True),
                                               (True, False)])
def test_yolo_loss_matches_jax(with_score, smooth):
    rng = _rng(12)
    cls = 5
    x = rng.standard_normal((2, 3 * (5 + cls), 8, 8)).astype(np.float32)
    gt = _yolo_gt(rng, 2, 6, 4)
    gt[1, 1] = gt[1, 0]            # two boxes in one cell
    label = rng.integers(0, cls, (2, 6)).astype(np.int64)
    arrays = [x, gt, label]
    if with_score:
        arrays.append(rng.uniform(0.3, 1.0, (2, 6)).astype(np.float32))

    def f(ops):
        def call(a, g, lab, *score):
            return ops.yolo_loss(a, g, lab, YOLO_ANCHORS, [0, 1, 2], cls,
                                 0.5, 32, gt_score=score[0] if score
                                 else None, use_label_smooth=smooth)
        return call
    run_both(f(J), f(T), arrays, int_args=(2,), gate=True)


def test_affine_channel_and_box_clip_match_jax():
    rng = _rng(13)
    for fmt, shape in (("NCHW", (2, 3, 4, 5)), ("NHWC", (2, 4, 5, 3))):
        x = rng.standard_normal(shape).astype(np.float32)
        s = rng.standard_normal(3).astype(np.float32)
        b = rng.standard_normal(3).astype(np.float32)
        run_both(lambda *a: J.affine_channel(*a, data_format=fmt),
                 lambda *a: T.affine_channel(*a, data_format=fmt),
                 [x, s, b], gate=True)
    flat = _boxes(rng, 7, 60.0, 2.0, 40.0)
    run_both(J.box_clip, T.box_clip,
             [flat, np.array([[50., 60., 1.]], np.float32)], gate=True)
    batched = np.stack([flat, flat * 1.5])
    run_both(J.box_clip, T.box_clip,
             [batched, np.array([[50., 60., 1.], [70., 40., 2.]],
                                np.float32)], gate=True)


@pytest.mark.parametrize("pad,k,md,s1,s2", [(2, 3, 2, 1, 1),
                                            (1, 1, 2, 2, 2),
                                            (3, 4, 2, 1, 1)])
def test_correlation_matches_jax(pad, k, md, s1, s2):
    rng = _rng(14)
    a = rng.standard_normal((2, 3, 7, 8)).astype(np.float32)
    b = rng.standard_normal((2, 3, 7, 8)).astype(np.float32)

    def f(ops):
        return lambda x, y: ops.correlation(x, y, pad, k, md, s1, s2)
    run_both(f(J), f(T), [a, b], gate=True)


# -- deformable convolution --------------------------------------------------

@pytest.mark.parametrize("v2,groups,dg,stride,dil", [
    (False, 1, 1, 1, 1), (True, 1, 1, 1, 1), (True, 2, 2, 2, 1),
    (False, 1, 2, 1, 2)])
def test_deform_conv2d_matches_jax(v2, groups, dg, stride, dil):
    rng = _rng(15)
    cin, cout, k, h = 4, 6, 3, 7
    ho = (h + 2 - (dil * (k - 1) + 1)) // stride + 1
    x = rng.standard_normal((2, cin, h, h)).astype(np.float32)
    off = rng.normal(0, 1.5, (2, dg * 2 * k * k, ho, ho)).astype(np.float32)
    w = rng.standard_normal((cout, cin // groups, k, k)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    arrays = [x, off, w, bias]
    if v2:
        arrays.append(rng.uniform(0, 1, (2, dg * k * k, ho, ho)).astype(
            np.float32))

    def f(ops):
        def call(a, o, wt, bi, *m):
            return ops.deform_conv2d(a, o, wt, bi, stride, 1, dil, dg,
                                     groups, m[0] if m else None)
        return call
    run_both(f(J), f(T), arrays, gate=True)


def test_deform_conv2d_layer_takes_jax_weights():
    from paddle_tpu_torch.bridge import layer_state_from_jax
    rng = _rng(16)
    jl = J.DeformConv2D(4, 5, 3, padding=1)
    tl = T.DeformConv2D(4, 5, 3, padding=1)
    missing, unexpected = tl.set_state_dict(layer_state_from_jax(jl))
    assert missing == [] and unexpected == []
    x = rng.standard_normal((1, 4, 6, 6)).astype(np.float32)
    off = rng.normal(0, 1, (1, 18, 6, 6)).astype(np.float32)
    m = rng.uniform(0, 1, (1, 9, 6, 6)).astype(np.float32)
    got = tl(tp.to_tensor(x), tp.to_tensor(off), tp.to_tensor(m))
    want = jl(jp.to_tensor(x), jp.to_tensor(off), jp.to_tensor(m))
    assert_f32_gate(got.numpy(), want.numpy())
    assert [n for n, _ in tl.named_parameters()] == ["weight", "bias"]


# -- host ops: bit-equal ------------------------------------------------------

def _both(name, arrays, **kw):
    """The host op ``name`` through both packages on Tensors of
    ``arrays``: every output leaf equal bit for bit."""
    def leaves(o):
        return [x for v in o for x in leaves(v)] if isinstance(
            o, (tuple, list)) else [o]
    got = leaves(getattr(T, name)(*[tp.to_tensor(a) for a in arrays], **kw))
    want = leaves(getattr(J, name)(*[jp.to_tensor(a) for a in arrays],
                                   **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gv, wv = np.asarray(g.numpy()), np.asarray(w.numpy())
        assert gv.dtype == wv.dtype and gv.shape == wv.shape
        np.testing.assert_array_equal(gv, wv)
    return got


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[8.0], aspect_ratios=(1.0, 2.0), flip=True),
    dict(min_sizes=[6.0, 10.0], max_sizes=[12.0, 20.0], clip=True,
         steps=(4.0, 4.0), offset=0.25)])
def test_prior_box_bit_equal(kw):
    feat = np.zeros((1, 2, 5, 6), np.float32)
    img = np.zeros((1, 3, 40, 48), np.float32)
    _both("prior_box", [feat, img], **kw)


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms_bit_equal(gaussian):
    rng = _rng(17)
    b = np.stack([_boxes(rng, 12, 1.0, 0.05, 0.5) for _ in range(2)])
    s = rng.uniform(0, 1, (2, 3, 12)).astype(np.float32)
    _both("matrix_nms", [b, s], score_threshold=0.2, post_threshold=0.1,
          nms_top_k=8, keep_top_k=10, use_gaussian=gaussian,
          return_index=True)


@pytest.mark.parametrize("pixel_offset", [False, True])
def test_generate_proposals_bit_equal(pixel_offset):
    rng = _rng(18)
    a, h, w = 3, 5, 6
    scores = rng.random((2, a, h, w)).astype(np.float32)
    deltas = rng.normal(0, 0.3, (2, 4 * a, h, w)).astype(np.float32)
    anchors = (rng.random((h, w, a, 4)) * 20).astype(np.float32)
    anchors[..., 2:] += anchors[..., :2] + 4
    var = rng.uniform(0.5, 1.0, (h, w, a, 4)).astype(np.float32)
    img = np.array([[40.0, 48.0], [36.0, 30.0]], np.float32)
    _both("generate_proposals", [scores, deltas, img, anchors, var],
          pre_nms_top_n=50, post_nms_top_n=12, nms_thresh=0.5,
          min_size=1.0, pixel_offset=pixel_offset)


@pytest.mark.parametrize("eta,bg,normalized", [(1.0, -1, True),
                                               (0.8, 0, False)])
def test_multiclass_nms3_bit_equal(eta, bg, normalized):
    rng = _rng(19)
    b = np.stack([_boxes(rng, 30, 50.0, 4.0, 20.0) for _ in range(2)])
    s = rng.uniform(0, 1, (2, 4, 30)).astype(np.float32)
    _both("multiclass_nms3", [b, s], score_threshold=0.2, nms_top_k=20,
          keep_top_k=25, nms_threshold=0.6, normalized=normalized,
          nms_eta=eta, background_label=bg, return_index=True)


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match_bit_equal(match_type):
    d = _rng(20).uniform(0, 1, (5, 8)).astype(np.float32)
    _both("bipartite_match", [d], match_type=match_type,
          dist_threshold=0.4)


def test_collect_fpn_proposals_bit_equal():
    rng = _rng(21)
    rois = [rng.random((6, 4)).astype(np.float32),
            rng.random((5, 4)).astype(np.float32)]
    scores = [rng.random(6).astype(np.float32),
              rng.random(5).astype(np.float32)]
    counts = [np.array([4, 2], np.int64), np.array([1, 4], np.int64)]
    for per_level in (None, counts):
        got = T.collect_fpn_proposals(
            [tp.to_tensor(r) for r in rois],
            [tp.to_tensor(s) for s in scores], 2, 3, 4,
            rois_num_per_level=None if per_level is None else
            [tp.to_tensor(c) for c in per_level])
        want = J.collect_fpn_proposals(
            [jp.to_tensor(r) for r in rois],
            [jp.to_tensor(s) for s in scores], 2, 3, 4,
            rois_num_per_level=None if per_level is None else
            [jp.to_tensor(c) for c in per_level])
        for g, w in zip(*(o if isinstance(o, tuple) else (o,)
                          for o in (got, want))):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("ap_version,difficult", [("integral", True),
                                                  ("11point", False)])
def test_detection_map_bit_equal(ap_version, difficult):
    rng = _rng(22)
    gt = np.concatenate([rng.integers(1, 3, (6, 1)),
                         _boxes(rng, 6, 20.0, 3.0, 8.0),
                         rng.integers(0, 2, (6, 1))], 1).astype(np.float32)
    det = np.concatenate([rng.integers(1, 3, (10, 1)),
                          rng.random((10, 1)),
                          _boxes(rng, 10, 20.0, 3.0, 8.0)],
                         1).astype(np.float32)
    det[:4, 2:] = gt[:4, 1:5] + 0.5
    det[:4, 0] = gt[:4, 0]
    _both("detection_map", [det, gt], class_num=3,
          evaluate_difficult=difficult, ap_version=ap_version)


def test_yolo_box_post_matches_jax():
    rng = _rng(23)
    cls = 3
    heads = [rng.normal(0, 1.5, (2, 3 * (5 + cls), s, s)).astype(
        np.float32) for s in (2, 4, 8)]
    shape = np.array([[64, 64], [64, 48]], np.int32)
    scale = np.array([1.0, 0.5], np.float32)
    anchors = [[116, 90, 156, 198, 373, 326], [30, 61, 62, 45, 59, 119],
               [10, 13, 16, 30, 33, 23]]

    def call(P, ops):
        return ops.yolo_box_post(
            *[P.to_tensor(h) for h in heads], P.to_tensor(shape),
            P.to_tensor(scale), *anchors, cls, 0.3, 32, 16, 8)
    (go, gn), (wo, wn) = call(tp, T), call(jp, J)
    np.testing.assert_array_equal(gn.numpy(), wn.numpy())
    assert_f32_gate(go.numpy(), wo.numpy())
    x = tp.to_tensor(heads[0])
    assert T.yolo_box_head(x, anchors[0], cls) is x


def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray((_rng(24).random((10, 12, 3)) * 255).astype(
        np.uint8)).save(buf, format="JPEG")
    f = tmp_path / "t.jpg"
    f.write_bytes(buf.getvalue())
    raw_t, raw_j = T.read_file(str(f)), J.read_file(str(f))
    _eq(raw_t, raw_j)
    for mode in ("unchanged", "gray", "rgb"):
        got, want = T.decode_jpeg(raw_t, mode), J.decode_jpeg(raw_j, mode)
        assert str(got.dtype).endswith("uint8")
        _eq(got, want)


def test_distribute_fpn_proposals_raises_as_jax():
    for ops in (J, T):
        with pytest.raises(NotImplementedError):
            ops.distribute_fpn_proposals(None)
