"""The resize / fold / shuffle / grid functionals of the eager surface
(paddle_tpu_torch.nn.functional.common) and their layers against the JAX
package on the same inputs: values and input gradients.

``interpolate`` is held to ``jax.image.resize`` (what the JAX package
computes): half-pixel centres, antialiased linear / cubic downsampling,
Keys cubic a = -0.5, "nearest" by floor((i + 0.5) in / out), "area" as
linear, and ``align_corners=True`` ignored — torch's ``F.interpolate``
differs on each, and a test below shows it does.

Tolerance: float32 within rtol 1e-5, atol 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as tF

from test_torch_parity_util import arr, cpu_place, run_both  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _cpu(cpu_place):
    yield


def both(name, arrays, **kw):
    return run_both(lambda *a: getattr(jF, name)(*a, **kw),
                    lambda *a: getattr(tF, name)(*a, **kw), arrays, tol=TOL)


INTERP = {
    "nearest_up": ((2, 3, 5, 6), dict(size=[9, 13], mode="nearest")),
    "nearest_down": ((1, 2, 11, 9), dict(size=[4, 5], mode="nearest")),
    "nearest_scale": ((1, 2, 5, 4), dict(scale_factor=2.5,
                                         mode="nearest")),
    "bilinear_up": ((2, 3, 5, 6), dict(size=[9, 13], mode="bilinear")),
    "bilinear_down_antialias": ((1, 2, 16, 13),
                                dict(size=[5, 4], mode="bilinear")),
    "bilinear_align_corners": ((1, 2, 5, 6),
                               dict(size=[8, 9], mode="bilinear",
                                    align_corners=True, align_mode=1)),
    "bicubic_up": ((1, 2, 5, 6), dict(size=[11, 8], mode="bicubic")),
    "bicubic_down": ((1, 2, 14, 12), dict(size=[5, 7], mode="bicubic")),
    "area_down": ((1, 3, 12, 10), dict(size=[4, 5], mode="area")),
    "linear_1d": ((2, 3, 7), dict(size=[12], mode="linear",
                                  data_format="NCW")),
    "linear_1d_nwc_down": ((2, 13, 3), dict(size=[5], mode="linear",
                                            data_format="NWC")),
    "trilinear": ((1, 2, 4, 5, 3), dict(size=[6, 3, 5], mode="trilinear",
                                        data_format="NCDHW")),
    "bilinear_nhwc": ((2, 5, 6, 3), dict(scale_factor=[1.5, 0.5],
                                         mode="bilinear",
                                         data_format="NHWC")),
    "one_axis_only": ((1, 2, 5, 6), dict(size=[5, 10], mode="bicubic")),
}


@pytest.mark.parametrize("case", sorted(INTERP))
def test_interpolate_matches_jax_image_resize(case):
    shape, kw = INTERP[case]
    both("interpolate", [arr(*shape, seed=1)], **kw)


def test_upsample_and_interp_ops():
    x = arr(1, 2, 5, 6, seed=2)
    both("upsample", [x], size=[8, 8], mode="bilinear")
    both("nearest_interp", [x], size=[7, 9])
    both("bilinear_interp", [x], size=[3, 4], align_corners=True)
    both("bicubic_interp", [x], scale_factor=2)
    both("linear_interp", [arr(2, 3, 6, seed=3)], size=[10])
    both("trilinear_interp", [arr(1, 1, 3, 4, 5, seed=4)], size=[5, 5, 5])


def test_differs_from_torch_interpolate():
    """The cases where torch's own resize would be a wrong port."""
    x = arr(1, 1, 16, 16, seed=5)
    got = tF.interpolate(tp.to_tensor(x), size=[4, 4],
                         mode="bilinear").numpy()
    plain = torch.nn.functional.interpolate(torch.from_numpy(x), size=[4, 4],
                                            mode="bilinear",
                                            align_corners=False).numpy()
    assert np.abs(got - plain).max() > 1e-3          # antialiasing
    up = tF.interpolate(tp.to_tensor(x), size=[24, 24],
                        mode="bicubic").numpy()
    tcub = torch.nn.functional.interpolate(torch.from_numpy(x),
                                           size=[24, 24], mode="bicubic",
                                           align_corners=False).numpy()
    assert np.abs(up - tcub).max() > 1e-4            # a = -0.5 vs -0.75


def test_integer_input_resizes_as_float_and_casts_back():
    x = np.arange(2 * 3 * 4 * 5).reshape(2, 3, 4, 5).astype(np.int32)
    want = jF.interpolate(jp.to_tensor(x), size=[7, 3],
                          mode="bilinear").numpy()
    got = tF.interpolate(tp.to_tensor(x), size=[7, 3],
                         mode="bilinear").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(kernel_sizes=3),
    dict(kernel_sizes=[2, 3], strides=2, paddings=1),
    dict(kernel_sizes=2, strides=[1, 2], paddings=[1, 0, 2, 1],
         dilations=2),
    dict(kernel_sizes=3, paddings=[1, 2]),
], ids=["plain", "stride_pad", "asym_dil", "pad2"])
def test_unfold_matches_jax(kw):
    both("unfold", [arr(2, 3, 8, 7, seed=6)], **kw)


@pytest.mark.parametrize("kw,out", [
    (dict(kernel_sizes=3), [6, 7]),
    (dict(kernel_sizes=[2, 3], strides=2, paddings=1), [7, 8]),
    (dict(kernel_sizes=2, strides=[1, 2], paddings=[1, 0, 2, 1],
          dilations=2), [6, 7]),
], ids=["plain", "stride_pad", "asym_dil"])
def test_fold_matches_jax(kw, out):
    # the column count fold needs: unfold's of an output-sized image
    cols = jF.unfold(jp.to_tensor(arr(2, 3, *out)), **kw).numpy()
    both("fold", [arr(*cols.shape, seed=7)], output_sizes=out, **kw)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_shuffles_match_jax(fmt):
    x = arr(2, 8, 6, 4, seed=8) if fmt == "NCHW" else arr(2, 6, 4, 8, seed=8)
    both("pixel_shuffle", [x], upscale_factor=2, data_format=fmt)
    both("pixel_unshuffle", [x], downscale_factor=2, data_format=fmt)
    both("channel_shuffle", [x], groups=4, data_format=fmt)


@pytest.mark.parametrize("align", [True, False])
def test_affine_grid_matches_jax(align):
    theta = arr(2, 2, 3, seed=9)
    both("affine_grid", [theta], out_shape=[2, 3, 5, 7],
         align_corners=align)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("pad", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align", [True, False])
def test_grid_sample_matches_jax(mode, pad, align):
    x = arr(2, 3, 6, 7, seed=10)
    grid = arr(2, 4, 5, 2, seed=11, lo=-1.3, hi=1.3)   # some outside
    run_both(lambda a, g: jF.grid_sample(a, g, mode, pad, align),
             lambda a, g: tF.grid_sample(a, g, mode, pad, align),
             [x, grid], tol=TOL)


LAYERS = {
    "Upsample": (lambda nn: nn.Upsample(size=[7, 9], mode="bicubic"),
                 (1, 2, 4, 5)),
    "UpsamplingNearest2D": (lambda nn: nn.UpsamplingNearest2D(
        scale_factor=2), (1, 2, 4, 5)),
    "UpsamplingBilinear2D": (lambda nn: nn.UpsamplingBilinear2D(
        size=[3, 3]), (1, 2, 8, 9)),
    "PixelShuffle": (lambda nn: nn.PixelShuffle(2), (1, 8, 3, 4)),
    "PixelUnshuffle": (lambda nn: nn.PixelUnshuffle(2), (1, 2, 6, 4)),
    "ChannelShuffle": (lambda nn: nn.ChannelShuffle(3), (1, 6, 3, 4)),
    "Unfold": (lambda nn: nn.Unfold([2, 3], strides=2, paddings=1),
               (2, 3, 7, 6)),
    "Fold": (lambda nn: nn.Fold([5, 6], 2), (2, 12, 20)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_jax(case):
    build, shape = LAYERS[case]
    run_both(build(jnn), build(tnn), [arr(*shape, seed=12)], tol=TOL)
