"""The in-place variants of the eager surface (paddle_tpu_torch.ops.inplace
and the ``*_`` Tensor methods) against the JAX package's: every variant
of the JAX module, on the same inputs. The object keeps its identity and
its dtype (a comparison on a float tensor writes 0 / 1 in float); the
values equal the JAX ones; the gradient link follows the JAX rebind (an
in-graph variant keeps it, a cast rebind cuts it); an in-place write on
a tensor autograd saved works inside a graph; a leaf outside any graph
is written in place, so a view of its storage sees the write.

Tolerance: float32 values and gradients within rtol 1e-5, atol 1e-6;
integer and bool results exactly.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.ops.inplace as jinplace
import paddle_tpu_torch as tp
import paddle_tpu_torch.ops.inplace as tinplace

from test_torch_parity_util import cpu_place  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _cpu(cpu_place):
    yield


def f(lo, hi, shape=(3, 4), seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def ints(shape=(3, 4), lo=1, hi=9, seed=0):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int64)


X = f(-0.9, 0.9)
POS = f(0.2, 3.0)
Y = f(0.5, 2.0, seed=1)
ANY = f(-2.0, 2.0, seed=2)

#: variant -> (x, extra positional args (arrays become tensors), kwargs)
CASES = {
    "abs_": (ANY, [], {}), "acos_": (X, [], {}), "acosh_": (POS + 1.0, [], {}),
    "addmm_": (f(-1, 1, (3, 3)), [f(-1, 1, (3, 4), 1), f(-1, 1, (4, 3), 2)],
               {}),
    "asin_": (X, [], {}), "asinh_": (ANY, [], {}), "atan_": (ANY, [], {}),
    "atanh_": (X, [], {}), "copysign_": (ANY, [f(-1, 1, seed=5)], {}),
    "cos_": (ANY, [], {}), "cosh_": (ANY, [], {}),
    "cumprod_": (X, [], dict(dim=1)), "cumsum_": (ANY, [], dict(axis=0)),
    "digamma_": (POS, [], {}), "divide_": (ANY, [Y], {}), "erf_": (ANY, [], {}),
    "erfinv_": (X, [], {}), "expm1_": (ANY, [], {}),
    "floor_divide_": (ANY * 3, [Y], {}), "floor_mod_": (ANY * 3, [Y], {}),
    "frac_": (ANY * 3, [], {}), "gammainc_": (POS, [Y], {}),
    "gammaincc_": (POS, [Y], {}), "gammaln_": (POS, [], {}),
    "gcd_": (ints(), [ints(seed=1)], {}), "hypot_": (ANY, [Y], {}),
    "i0_": (ANY, [], {}), "lcm_": (ints(), [ints(seed=1)], {}),
    "ldexp_": (ANY, [ints(lo=-2, hi=3, seed=3)], {}), "lgamma_": (POS, [], {}),
    "log_": (POS, [], {}), "log10_": (POS, [], {}), "log1p_": (POS, [], {}),
    "log2_": (POS, [], {}), "logit_": (f(0.1, 0.9), [], {}),
    "mod_": (ANY * 3, [Y], {}), "multigammaln_": (POS + 2.0, [3], {}),
    "multiply_": (ANY, [Y], {}), "nan_to_num_": (ANY, [], {}),
    "neg_": (ANY, [], {}), "polygamma_": (POS, [1], {}),
    "renorm_": (ANY, [2.0, 0, 1.0], {}), "sin_": (ANY, [], {}),
    "sinc_": (ANY, [], {}), "sinh_": (ANY, [], {}), "square_": (ANY, [], {}),
    "tan_": (X, [], {}), "tanh_": (ANY, [], {}), "trunc_": (ANY * 3, [], {}),
    "remainder_": (ANY * 3, [Y], {}),
    "equal_": (np.round(ANY), [np.round(Y)], {}),
    "greater_equal_": (ANY, [Y], {}), "greater_than_": (ANY, [Y], {}),
    "less_": (ANY, [Y], {}), "less_equal_": (ANY, [Y], {}),
    "less_than_": (ANY, [Y], {}), "not_equal_": (np.round(ANY),
                                                  [np.round(Y)], {}),
    "bitwise_and_": (ints(), [ints(seed=1)], {}),
    "bitwise_invert_": (ints(), [], {}),
    "bitwise_left_shift_": (ints(), [ints(lo=0, hi=3, seed=1)], {}),
    "bitwise_not_": (ints(), [], {}), "bitwise_or_": (ints(),
                                                      [ints(seed=1)], {}),
    "bitwise_right_shift_": (ints(hi=64), [ints(lo=0, hi=3, seed=1)], {}),
    "bitwise_xor_": (ints(), [ints(seed=1)], {}),
    "logical_and_": (np.round(ANY), [np.round(Y)], {}),
    "logical_not_": (np.round(ANY), [], {}),
    "logical_or_": (np.round(ANY) * 0, [np.round(Y)], {}),
    "logical_xor_": (np.round(ANY), [np.round(Y)], {}),
    "masked_scatter_": (ANY, [ANY > 0, f(-5, 5, (12,), 7)], {}),
    "t_": (ANY, [], {}), "transpose_": (ANY, [[1, 0]], {}),
    "tril_": (ANY, [], dict(diagonal=1)), "triu_": (ANY, [], {}),
}


def test_every_jax_variant_is_ported():
    assert sorted(tinplace.__all__) == sorted(jinplace.__all__)
    assert set(CASES) | {"cast_", "bernoulli_", "cauchy_", "geometric_",
                         "log_normal_"} == set(jinplace.__all__)
    for name in jinplace.__all__:
        assert getattr(tp, name) is getattr(tinplace, name), name
        assert callable(getattr(tp.Tensor, name)), name


def _args(pkg, extra):
    return [pkg.to_tensor(a) if isinstance(a, np.ndarray) else a
            for a in extra]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("as_method", [False, True],
                         ids=["function", "method"])
def test_variant_matches_jax(name, as_method):
    x, extra, kw = CASES[name]
    jx, tx = jp.to_tensor(x), tp.to_tensor(x)
    if as_method:
        jr = getattr(jx, name)(*_args(jp, extra), **kw)
        tr = getattr(tx, name)(*_args(tp, extra), **kw)
    else:
        jr = getattr(jinplace, name)(jx, *_args(jp, extra), **kw)
        tr = getattr(tinplace, name)(tx, *_args(tp, extra), **kw)
    assert tr is tx and jr is jx
    assert str(tx.dtype).split(".")[-1] == str(jx.dtype).split(".")[-1]
    want, got = jx.numpy(), tx.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


def test_cast_changes_the_dtype():
    for pkg in (jp, tp):
        x = pkg.to_tensor(ANY)
        assert x.cast_("int32") is x
        assert str(x.dtype).endswith("int32")
        np.testing.assert_array_equal(x.numpy(), ANY.astype(np.int32))


@pytest.mark.parametrize("name,args", [
    ("sin_", []), ("multiply_", [Y]), ("cumsum_", []), ("tanh_", []),
    ("t_", []), ("square_", [])])
def test_in_graph_variant_keeps_the_gradient_link(name, args):
    grads = []
    for pkg in (jp, tp):
        x = pkg.to_tensor(ANY, stop_gradient=False)
        y = x * 2.0
        getattr(y, name)(*_args(pkg, args))
        assert not y.stop_gradient
        (y * y).sum().backward()
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(grads[1], grads[0], **TOL)


def test_cast_rebind_cuts_the_gradient_link():
    for pkg in (jp, tp):
        x = pkg.to_tensor(ANY, stop_gradient=False)
        y = x * 2.0
        y.less_than_(pkg.to_tensor(Y))
        assert str(y.dtype).endswith("float32") and y.stop_gradient
        np.testing.assert_array_equal(y.numpy(), (2 * ANY < Y).astype(
            np.float32))


def test_write_on_a_saved_tensor_inside_a_graph():
    """y is saved by y * y, then written in place: torch alone would
    raise a version-counter error; the variant rebinds, as JAX does."""
    grads = []
    for pkg in (jp, tp):
        x = pkg.to_tensor(ANY, stop_gradient=False)
        y = x * 3.0
        z = y * y
        y.exp_()
        (z.sum() + y.sum()).backward()
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(grads[1], grads[0], **TOL)


def test_leaf_outside_a_graph_is_written_in_place():
    x = tp.to_tensor(POS)
    view = x._data.view(-1)
    x.log_()
    np.testing.assert_allclose(view.numpy().reshape(POS.shape),
                               np.log(POS), **TOL)
    x.equal_(x)                              # float stays float
    assert str(x.dtype).endswith("float32") and x.numpy().all()


@pytest.mark.parametrize("name,args,check", [
    ("bernoulli_", [0.3], lambda v: set(np.unique(v)) <= {0.0, 1.0}
     and abs(v.mean() - 0.3) < 0.03),
    ("cauchy_", [1.0, 2.0], lambda v: abs(np.median(v) - 1.0) < 0.15),
    ("geometric_", [0.25], lambda v: v.min() >= 1 and abs(v.mean() - 4.0)
     < 0.3),
    ("log_normal_", [0.5, 0.25], lambda v: abs(np.log(v).mean() - 0.5)
     < 0.02 and abs(np.log(v).std() - 0.25) < 0.02),
])
def test_random_fills_keep_identity_dtype_and_distribution(name, args,
                                                           check):
    tp.seed(3)
    for pkg in (jp, tp):
        x = pkg.zeros([100, 100], dtype="float32")
        assert getattr(x, name)(*args) is x
        assert str(x.dtype).endswith("float32")
        assert check(x.numpy()), (pkg.__name__, name)
