"""Convolution and pooling of the eager surface (paddle_tpu_torch.nn.
functional.conv / pooling and the Conv* / *Pool* layers) against the JAX
package on the same inputs: values and input / weight gradients.

Tolerance: float32 within rtol 1e-4, atol 1e-4 of the JAX values and
gradients (lax's and torch's convolutions sum in different orders); the
pooling masks and integer outputs exactly.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
import paddle_tpu.nn.functional.conv as jconv
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as tF
from paddle_tpu_torch.bridge import layer_state_from_jax

from test_torch_parity_util import arr, cpu_place, run_both  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _cpu(cpu_place):
    yield


def both(name, arrays, grad=True, jmod=jF, tmod=tF, **kw):
    return run_both(lambda *a: getattr(jmod, name)(*a, **kw),
                    lambda *a: getattr(tmod, name)(*a, **kw), arrays,
                    grad=grad, tol=TOL)


CONV_CASES = {
    "1d": ("conv1d", (2, 4, 11), (6, 4, 3), dict(stride=2, padding=1)),
    "1d_nlc_same": ("conv1d", (2, 11, 4), (6, 4, 3),
                    dict(padding="SAME", stride=2, data_format="NLC")),
    "2d_groups_dil": ("conv2d", (2, 4, 9, 8), (6, 2, 3, 3),
                      dict(groups=2, dilation=2, padding=[1, 2])),
    "2d_asym_pairs": ("conv2d", (1, 3, 8, 7), (4, 3, 3, 2),
                      dict(padding=[[1, 2], [0, 1]],
                           stride=[2, 1])),
    "2d_flat_asym": ("conv2d", (1, 3, 8, 7), (4, 3, 3, 3),
                     dict(padding=[2, 0, 1, 1])),
    "2d_same_stride": ("conv2d", (2, 3, 9, 10), (5, 3, 4, 3),
                       dict(padding="SAME", stride=2)),
    "2d_valid": ("conv2d", (1, 3, 7, 7), (2, 3, 3, 3),
                 dict(padding="VALID")),
    "2d_nhwc": ("conv2d", (2, 7, 6, 4), (5, 4, 3, 3),
                dict(padding=1, data_format="NHWC")),
    "3d": ("conv3d", (1, 2, 5, 6, 5), (3, 2, 3, 2, 3),
           dict(stride=[1, 2, 1], padding=1)),
    "3d_ndhwc": ("conv3d", (1, 5, 4, 6, 2), (3, 2, 2, 2, 2),
                 dict(padding="SAME", data_format="NDHWC")),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_conv_matches_jax(case, bias):
    name, xs, ws, kw = CONV_CASES[case]
    arrays = [arr(*xs, seed=1), arr(*ws, seed=2)]
    if bias:
        arrays.append(arr(ws[0], seed=3))
    both(name, arrays, **kw)


CONVT_CASES = {
    "1d": ("conv1d_transpose", (2, 4, 7), (4, 3, 3),
           dict(stride=2, padding=1, output_padding=1)),
    "2d": ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3),
           dict(stride=2, padding=1)),
    "2d_groups_dil_opad": ("conv2d_transpose", (1, 4, 5, 5), (4, 2, 3, 2),
                           dict(stride=[2, 3], groups=2, dilation=2,
                                output_padding=[1, 2], padding=[1, 0])),
    "2d_asym": ("conv2d_transpose", (1, 2, 4, 5), (2, 3, 3, 3),
                dict(stride=2, padding=[1, 0, 2, 1])),
    "2d_nhwc": ("conv2d_transpose", (1, 5, 4, 3), (3, 2, 2, 2),
                dict(stride=2, data_format="NHWC")),
    "2d_same_str": ("conv2d_transpose", (1, 2, 4, 4), (2, 3, 3, 3),
                    dict(stride=2, padding="SAME")),
    "3d": ("conv3d_transpose", (1, 2, 3, 4, 3), (2, 2, 2, 3, 2),
           dict(stride=[2, 1, 2], padding=[0, 1, 0])),
}


@pytest.mark.parametrize("case", sorted(CONVT_CASES))
def test_conv_transpose_matches_jax(case):
    name, xs, ws, kw = CONVT_CASES[case]
    groups = kw.get("groups", 1)
    arrays = [arr(*xs, seed=4), arr(*ws, seed=5),
              arr(ws[1] * groups, seed=6)]
    both(name, arrays, **kw)


def test_conv_transpose_output_size_checked():
    x, w = arr(1, 2, 4, 4), arr(2, 3, 3, 3)
    out = tF.conv2d_transpose(tp.to_tensor(x), tp.to_tensor(w), stride=2,
                              output_padding=1, output_size=[10, 10])
    assert out.shape == [1, 3, 10, 10]
    with pytest.raises(ValueError, match="output_size"):
        tF.conv2d_transpose(tp.to_tensor(x), tp.to_tensor(w), stride=2,
                            output_size=[12, 12])


def test_depthwise_and_transpose_bias():
    # the JAX package keeps these two in its conv module only
    mods = dict(jmod=jconv, tmod=tF)
    both("depthwise_conv2d", [arr(2, 4, 6, 6), arr(4, 1, 3, 3, seed=1)],
         padding=1, **mods)
    both("conv2d_transpose_bias", [arr(1, 2, 4, 4), arr(2, 3, 3, 3, seed=1),
                                   arr(3, seed=2)], stride=2, **mods)
    both("depthwise_conv2d_transpose", [arr(1, 3, 4, 4),
                                        arr(3, 1, 3, 3, seed=1)], stride=2)


POOL_CASES = {
    "max1d": ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                             padding=1)),
    "max1d_ceil_nlc": ("max_pool1d", (2, 10, 3),
                       dict(kernel_size=3, stride=2, ceil_mode=True,
                            data_format="NLC")),
    "max2d": ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2,
                                               padding=1)),
    "max2d_ceil": ("max_pool2d", (1, 2, 8, 9),
                   dict(kernel_size=[3, 2], stride=[2, 3], ceil_mode=True)),
    "max2d_same": ("max_pool2d", (1, 2, 7, 8),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "max2d_nhwc": ("max_pool2d", (2, 7, 6, 3),
                   dict(kernel_size=2, data_format="NHWC")),
    "max3d": ("max_pool3d", (1, 2, 5, 6, 5),
              dict(kernel_size=2, stride=2, padding=[1, 0, 1],
                   ceil_mode=True)),
    "avg1d": ("avg_pool1d", (2, 3, 10), dict(kernel_size=3, stride=2,
                                             padding=1)),
    "avg1d_incl": ("avg_pool1d", (2, 3, 10),
                   dict(kernel_size=3, padding=1, exclusive=False)),
    "avg2d_excl_ceil": ("avg_pool2d", (2, 3, 9, 8),
                        dict(kernel_size=3, stride=2, padding=1,
                             ceil_mode=True)),
    "avg2d_incl_ceil": ("avg_pool2d", (2, 3, 9, 8),
                        dict(kernel_size=3, stride=2, padding=1,
                             ceil_mode=True, exclusive=False)),
    "avg2d_same": ("avg_pool2d", (1, 2, 7, 7),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "avg2d_divisor": ("avg_pool2d", (1, 2, 6, 6),
                      dict(kernel_size=2, divisor_override=3)),
    "avg2d_nhwc_asym": ("avg_pool2d", (1, 6, 7, 2),
                        dict(kernel_size=3, padding=[1, 0, 2, 1],
                             data_format="NHWC")),
    "avg3d": ("avg_pool3d", (1, 2, 5, 4, 6),
              dict(kernel_size=[2, 2, 3], stride=2, padding=1)),
    "lp1d": ("lp_pool1d", (2, 3, 9), dict(norm_type=2, kernel_size=3,
                                          stride=2)),
    "lp2d": ("lp_pool2d", (1, 2, 7, 6), dict(norm_type=3, kernel_size=2,
                                             stride=2, ceil_mode=True)),
    "aavg1d": ("adaptive_avg_pool1d", (2, 3, 10), dict(output_size=4)),
    "aavg2d": ("adaptive_avg_pool2d", (2, 3, 9, 7),
               dict(output_size=[4, 3])),
    "aavg2d_nhwc": ("adaptive_avg_pool2d", (2, 9, 7, 3),
                    dict(output_size=3, data_format="NHWC")),
    "aavg3d": ("adaptive_avg_pool3d", (1, 2, 5, 7, 6),
               dict(output_size=[2, 3, 4])),
    "amax1d": ("adaptive_max_pool1d", (2, 3, 10), dict(output_size=3)),
    "amax2d": ("adaptive_max_pool2d", (2, 3, 9, 7),
               dict(output_size=[4, 3])),
    "amax3d": ("adaptive_max_pool3d", (1, 2, 5, 7, 6),
               dict(output_size=2)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_jax(case):
    name, xs, kw = POOL_CASES[case]
    if name.startswith("lp"):
        kw = dict(kw)
        p = kw.pop("norm_type")
        run_both(lambda a: getattr(jF, name)(a, p, **kw),
                 lambda a: getattr(tF, name)(a, p, **kw),
                 [arr(*xs, seed=7, lo=0.1, hi=2.0)], tol=TOL)
        return
    both(name, [arr(*xs, seed=7)], **kw)


@pytest.mark.parametrize("name,xs,kw", [
    ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (1, 2, 8, 8), dict(kernel_size=2, stride=2,
                                      padding=[1, 0, 0, 1])),
    ("max_pool2d", (2, 6, 5, 3), dict(kernel_size=2,
                                      data_format="NHWC")),
    ("max_pool3d", (1, 2, 4, 6, 4), dict(kernel_size=2, stride=2)),
    ("adaptive_max_pool2d", (1, 2, 6, 6), dict(output_size=3)),
], ids=["1d", "2d", "2d_asym", "2d_nhwc", "3d", "adaptive"])
def test_return_mask_matches_jax(name, xs, kw):
    both(name, [arr(*xs, seed=8)], return_mask=True, **kw)


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_max_unpool_inverts_the_pool(nd):
    shape = {1: (2, 3, 8), 2: (2, 3, 6, 8), 3: (1, 2, 4, 6, 4)}[nd]
    x = arr(*shape, seed=9)
    jo, jm = getattr(jF, f"max_pool{nd}d")(jp.to_tensor(x), 2,
                                           return_mask=True)
    vals, mask = jo.numpy(), jm.numpy()
    out = run_both(
        lambda v, m: getattr(jF, f"max_unpool{nd}d")(v, m, 2),
        lambda v, m: getattr(tF, f"max_unpool{nd}d")(v, m, 2),
        [vals, mask], tol=TOL, int_args=(1,))
    got = out[0].numpy()
    assert got.shape == x.shape
    # every max lands back where it came from, zeros elsewhere
    np.testing.assert_array_equal(got[got != 0], x[got != 0])


def test_max_unpool_output_size_and_nhwc():
    x = arr(1, 6, 6, 2, seed=10)
    jo, jm = jF.max_pool2d(jp.to_tensor(x), 2, data_format="NHWC",
                           return_mask=True)
    run_both(lambda v, m: jF.max_unpool2d(v, m, 2, data_format="NHWC",
                                          output_size=[7, 7]),
             lambda v, m: tF.max_unpool2d(v, m, 2, data_format="NHWC",
                                          output_size=[7, 7]),
             [jo.numpy(), jm.numpy()], tol=TOL, int_args=(1,))


@pytest.mark.parametrize("nd,shape,out,ks", [
    (2, (2, 3, 9, 11), [4, 5], None),
    (2, (1, 2, 10, 10), [3, 4], [3, 3]),
    (3, (1, 2, 7, 6, 8), [3, 2, 4], None),
], ids=["2d_disjoint", "2d_kernel", "3d"])
@pytest.mark.parametrize("u", [0.3, 0.77])
def test_fractional_max_pool_matches_jax(nd, shape, out, ks, u):
    name = f"fractional_max_pool{nd}d"
    both(name, [arr(*shape, seed=11)], output_size=out, kernel_size=ks,
         random_u=u, return_mask=True)


def test_fractional_random_u_from_numpy_seed():
    """random_u=None draws from numpy's global generator, which paddle.seed
    seeds in both packages: the same windows."""
    x = arr(1, 2, 9, 9, seed=12)
    jp.seed(5)
    want = jF.fractional_max_pool2d(jp.to_tensor(x), [4, 4]).numpy()
    tp.seed(5)
    got = tF.fractional_max_pool2d(tp.to_tensor(x), [4, 4]).numpy()
    np.testing.assert_array_equal(got, want)


def _layer_pair(build):
    jl, tl = build(jnn), build(tnn)
    missing, unexpected = tl.set_state_dict(layer_state_from_jax(jl))
    assert not missing and not unexpected
    return jl, tl


LAYER_CASES = {
    "Conv1D": (lambda nn: nn.Conv1D(3, 4, 3, padding=1), (2, 3, 9)),
    "Conv2D": (lambda nn: nn.Conv2D(3, 4, 3, stride=2, padding=1,
                                    groups=1), (2, 3, 8, 8)),
    "Conv2D_groups": (lambda nn: nn.Conv2D(4, 6, [3, 2], groups=2,
                                           dilation=2), (1, 4, 9, 8)),
    "Conv3D": (lambda nn: nn.Conv3D(2, 3, 2), (1, 2, 4, 5, 4)),
    "Conv1DTranspose": (lambda nn: nn.Conv1DTranspose(3, 2, 3, stride=2),
                        (2, 3, 5)),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(
        4, 6, 3, stride=2, padding=1, output_padding=1, groups=2),
        (1, 4, 4, 5)),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(2, 2, 2, stride=2),
                        (1, 2, 3, 3, 3)),
    "MaxPool1D": (lambda nn: nn.MaxPool1D(3, 2, 1), (2, 3, 9)),
    "MaxPool2D": (lambda nn: nn.MaxPool2D(3, 2, 1, ceil_mode=True),
                  (2, 3, 9, 8)),
    "MaxPool3D": (lambda nn: nn.MaxPool3D(2), (1, 2, 4, 4, 4)),
    "AvgPool1D": (lambda nn: nn.AvgPool1D(3, 2, 1), (2, 3, 9)),
    "AvgPool2D": (lambda nn: nn.AvgPool2D(3, 2, 1, exclusive=False),
                  (2, 3, 9, 8)),
    "AvgPool3D": (lambda nn: nn.AvgPool3D(2, 2), (1, 2, 4, 4, 4)),
    "LPPool1D": (lambda nn: nn.LPPool1D(2, 3, 2), (2, 3, 9)),
    "LPPool2D": (lambda nn: nn.LPPool2D(2, 2), (1, 2, 6, 6)),
    "AdaptiveAvgPool1D": (lambda nn: nn.AdaptiveAvgPool1D(4), (2, 3, 9)),
    "AdaptiveAvgPool2D": (lambda nn: nn.AdaptiveAvgPool2D([3, 2]),
                          (2, 3, 7, 5)),
    "AdaptiveAvgPool3D": (lambda nn: nn.AdaptiveAvgPool3D(2),
                          (1, 2, 5, 4, 5)),
    "AdaptiveMaxPool1D": (lambda nn: nn.AdaptiveMaxPool1D(4), (2, 3, 9)),
    "AdaptiveMaxPool2D": (lambda nn: nn.AdaptiveMaxPool2D(3),
                          (2, 3, 7, 5)),
    "AdaptiveMaxPool3D": (lambda nn: nn.AdaptiveMaxPool3D(2),
                          (1, 2, 5, 4, 5)),
    "FractionalMaxPool2D": (lambda nn: nn.FractionalMaxPool2D(
        [3, 4], random_u=0.4), (1, 2, 8, 9)),
    "FractionalMaxPool3D": (lambda nn: nn.FractionalMaxPool3D(
        [2, 3, 2], random_u=0.6), (1, 2, 5, 7, 5)),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(case):
    build, xs = LAYER_CASES[case]
    jl, tl = _layer_pair(build)
    assert list(tl.state_dict()) == list(jl.state_dict())
    lo = 0.1 if "LP" in case else -1.0
    run_both(jl, tl, [arr(*xs, seed=13, lo=lo, hi=1.0)], tol=TOL)
    for (n, jpar), (_, tpar) in zip(jl.named_parameters(),
                                    tl.named_parameters()):
        np.testing.assert_allclose(tpar.grad.numpy(), jpar.grad.numpy(),
                                   **TOL, err_msg=n)


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_max_unpool_layers(nd):
    shape = {1: (1, 2, 8), 2: (1, 2, 6, 6), 3: (1, 1, 4, 4, 4)}[nd]
    x = tp.to_tensor(arr(*shape, seed=14))
    pool = getattr(tF, f"max_pool{nd}d")
    vals, mask = pool(x, 2, return_mask=True)
    layer = getattr(tnn, f"MaxUnPool{nd}D")(2)
    back = layer(vals, mask)
    np.testing.assert_array_equal(pool(back, 2).numpy(), vals.numpy())


def test_conv_layer_initializers_follow_jax():
    """Weights N(0, 2 / fan_in), biases zero, as the JAX layers draw
    them (the distributions, not the bits)."""
    tp.seed(0)
    conv = tnn.Conv2D(16, 64, 3)
    w = conv.weight.numpy()
    assert w.shape == (64, 16, 3, 3)
    std = (2.0 / (16 * 9)) ** 0.5
    assert abs(w.std() / std - 1.0) < 0.05 and abs(w.mean()) < 0.01
    assert not conv.bias.numpy().any()
    t = tnn.Conv2DTranspose(8, 6, 3, groups=2)
    assert t.weight.shape == [8, 3, 3, 3]
