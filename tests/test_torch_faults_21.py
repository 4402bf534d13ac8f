"""Five faults of the port's eager surface against the JAX package, each
held to the JAX op's values, dtype and gradient: ``assign`` returns a
copy with no graph, ``Tensor.numpy()`` is a snapshot on the CPU too, bool
operands of ``-`` / ``//`` / ``%`` / ``**`` promote as ``jnp`` promotes
them, a Python float on the left of ``-`` / ``/`` / ``**`` beside an
integer tensor is float64, and ``heaviside``, ``floor_divide``, ``imag``,
``gammainc`` / ``gammaincc`` and ``clip`` with no bounds differentiate as
``jax.grad`` does."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

from test_torch_parity_util import (  # noqa: F401
    arr, assert_f32_gate, cpu_place, run_both)

pytestmark = pytest.mark.usefixtures("cpu_place")


# ---- assign ----------------------------------------------------------------

@pytest.mark.parametrize("write", ["add_", "setitem", "scale_"])
def test_assign_returns_a_copy(write):
    for pkg in (jp, tp):
        x = pkg.to_tensor(np.array([1.0, 2.0, 3.0], np.float32))
        if write == "scale_":
            y = pkg.zeros([3])
            pkg.assign(x, y)
            y.scale_(2.0)
        else:
            y = pkg.assign(x)
            if write == "add_":
                y.add_(pkg.ones([3]))
            else:
                y[0] = 10.0
        assert x.numpy().tolist() == [1.0, 2.0, 3.0], pkg.__name__


def test_assign_has_no_graph_back_to_its_input():
    for pkg in (jp, tp):
        x = pkg.to_tensor(np.array([1.0, 2.0], np.float32),
                          stop_gradient=False)
        y = pkg.assign(x * 2.0)
        assert y.stop_gradient, pkg.__name__
        o = pkg.zeros([2])
        pkg.assign(x * 3.0, o)
        assert o.stop_gradient, pkg.__name__
    np.testing.assert_array_equal(y.numpy(), [2.0, 4.0])
    np.testing.assert_array_equal(o.numpy(), [3.0, 6.0])


# ---- numpy() ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int64", "bool"])
def test_numpy_is_a_snapshot_on_the_cpu(dtype):
    for pkg in (jp, tp):
        t = pkg.to_tensor(np.array([1, 0], dtype))
        a = t.numpy()
        if dtype == "bool":
            t[0] = False
        else:
            t.add_(pkg.ones([2], dtype=dtype))
        assert a.tolist() == np.array([1, 0], dtype).tolist(), pkg.__name__


# ---- bool operands and scalars on the left ---------------------------------

MASK = np.array([True, False, True])
MASK2 = np.array([True, True, False])

_BOOL_CASES = {
    "1 - mask": lambda p, m, n: 1 - m,
    "1.0 - mask": lambda p, m, n: 1.0 - m,
    "mask - 1": lambda p, m, n: m - 1,
    "mask - 1.5": lambda p, m, n: m - 1.5,
    "subtract(int64 ones, mask)": lambda p, m, n: p.subtract(
        p.to_tensor(np.ones(3, np.int64)), m),
    "subtract(mask, int32)": lambda p, m, n: p.subtract(
        m, p.to_tensor(np.array([1, 2, 3], np.int32))),
    "subtract(float32, mask)": lambda p, m, n: p.subtract(
        p.to_tensor(np.array([0.5, 1.5, 2.5], np.float32)), m),
    "floor_divide(mask, mask)": lambda p, m, n: p.floor_divide(m, m),
    "floor_divide(mask, mask2)": lambda p, m, n: p.floor_divide(m, n),
    "remainder(mask, mask2)": lambda p, m, n: p.remainder(m, n),
    "pow(mask, mask2)": lambda p, m, n: p.pow(m, n),
    "mask ** 2": lambda p, m, n: m ** 2,
    "mask ** 2.0": lambda p, m, n: m ** 2.0,
    "2 ** mask": lambda p, m, n: 2 ** m,
    "2.5 - mask": lambda p, m, n: 2.5 - m,
    "int32 // mask": lambda p, m, n: p.to_tensor(
        np.array([1, 2, 3], np.int32)) // m,
    "int32 % mask": lambda p, m, n: p.to_tensor(
        np.array([1, -2, 3], np.int32)) % m,
}


@pytest.mark.parametrize("case", sorted(_BOOL_CASES))
def test_bool_operands_promote_as_jax(case):
    fn = _BOOL_CASES[case]
    j = fn(jp, jp.to_tensor(MASK), jp.to_tensor(MASK2))
    t = fn(tp, tp.to_tensor(MASK), tp.to_tensor(MASK2))
    assert t.dtype.name == j.dtype.name, (case, t.dtype, j.dtype)
    np.testing.assert_array_equal(t.numpy(), j.numpy())


_LEFT_SCALAR = {
    "2.5 - x": lambda x: 2.5 - x, "2.5 / x": lambda x: 2.5 / x,
    "2.5 ** x": lambda x: 2.5 ** x, "2.5 + x": lambda x: 2.5 + x,
    "2.5 * x": lambda x: 2.5 * x, "x + 2.5": lambda x: x + 2.5,
    "2 - x": lambda x: 2 - x, "2 / x": lambda x: 2 / x,
    "2 ** x": lambda x: 2 ** x}


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32"])
@pytest.mark.parametrize("case", sorted(_LEFT_SCALAR))
def test_python_scalar_on_the_left_keeps_jax_dtype(case, dtype):
    a = np.array([1, 2, 3], dtype)
    j = _LEFT_SCALAR[case](jp.to_tensor(a))
    t = _LEFT_SCALAR[case](tp.to_tensor(a))
    assert t.dtype.name == j.dtype.name, (case, t.dtype, j.dtype)
    np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-6)


def test_left_scalar_float_carries_the_gradient():
    x = arr(4, seed=3, lo=0.5, hi=2.0)
    run_both(lambda a: 2.5 - a, lambda a: 2.5 - a, [x])
    run_both(lambda a: 2.5 / a, lambda a: 2.5 / a, [x])
    run_both(lambda a: 2.5 ** a, lambda a: 2.5 ** a, [x])


# ---- backward ----------------------------------------------------------------

def test_heaviside_gradient_in_both_arguments():
    x = np.array([[-1.0, 0.0, 2.0], [0.0, 3.0, -4.0]], np.float32)
    y = np.array([0.5, 0.25, 0.75], np.float32)
    run_both(jp.heaviside, tp.heaviside, [x, y])
    # the gradient in x alone (y a constant) is zero, and reachable
    for pkg in (jp, tp):
        xt = pkg.to_tensor(x, stop_gradient=False)
        pkg.heaviside(xt, pkg.to_tensor(y)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.zeros_like(x))


def test_floor_divide_gradient_is_zero():
    x = arr(3, 4, seed=1, lo=-3.0, hi=3.0)
    y = arr(3, 4, seed=2, lo=0.5, hi=2.0)
    run_both(jp.floor_divide, tp.floor_divide, [x, y])
    for pkg in (jp, tp):
        xt = pkg.to_tensor(x, stop_gradient=False)
        pkg.floor_divide(xt, pkg.to_tensor(y)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.zeros_like(x))


def test_imag_of_a_real_tensor_has_a_zero_gradient():
    x = arr(5, seed=4)
    run_both(lambda a: jp.imag(a) + a, lambda a: tp.imag(a) + a, [x])
    for pkg in (jp, tp):
        xt = pkg.to_tensor(x, stop_gradient=False)
        pkg.imag(xt).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.zeros_like(x))


def _igamma_both(op, a, x):
    """``op``'s values and gradients in both arguments, JAX package and
    port, on tensors of the arrays' own dtype (``run_both`` would make
    f64 arrays f32), held to the f32 gate."""
    w = np.random.default_rng(123).standard_normal(a.shape)
    out = {}
    for pkg in (jp, tp):
        ta, tx = (pkg.to_tensor(v, dtype=str(v.dtype), stop_gradient=False)
                  for v in (a, x))
        y = getattr(pkg, op)(ta, tx)
        (y * pkg.to_tensor(w, dtype=str(a.dtype))).sum().backward()
        assert y.dtype.name == str(a.dtype), (pkg.__name__, y.dtype)
        out[pkg] = [y.numpy(), ta.grad.numpy(), tx.grad.numpy()]
    for name, got, ref in zip(("value", "d/da", "d/dx"), out[tp], out[jp]):
        assert_f32_gate(got, ref, err_msg=f"{op} {name}")


@pytest.mark.parametrize("op", ["gammainc", "gammaincc"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gammainc_gradient_in_the_first_argument(op, dtype):
    rng = np.random.default_rng(7)
    a = rng.uniform(0.2, 12.0, (4, 6)).astype(dtype)
    x = rng.uniform(0.01, 25.0, (4, 6)).astype(dtype)
    x[0, :3] = [0.3, 40.0, 120.0]
    run_both(getattr(jp, op), getattr(tp, op), [a, x], gate=True)
    _igamma_both(op, a, x)


@pytest.mark.parametrize("op", ["gammainc", "gammaincc"])
def test_gammainc_gradient_at_large_a_and_x(op):
    # x - a > 2,000 (the continued fraction, where a fixed-length series
    # stops short) and x near a in the thousands (a long series); in f64,
    # since JAX's own f32 series is 9e-4 off in P(3000, 3000)
    a = np.array([2900.0, 100.0, 3000.0, 3000.0, 1500.0, 2.5])
    x = np.array([5000.0, 2500.0, 3000.0, 3060.0, 1480.0, 2600.0])
    _igamma_both(op, a, x)


def test_gammainc_gradient_broadcasts():
    a = np.array([[0.5], [3.0]], np.float32)
    x = np.array([0.2, 1.0, 4.0, 9.0], np.float32)
    run_both(jp.gammainc, tp.gammainc, [a, x], gate=True)


def test_clip_with_no_bound_returns_x():
    x = arr(3, 4, seed=5)
    out = run_both(lambda a: jp.clip(a), lambda a: tp.clip(a), [x])
    xt = tp.to_tensor(x)
    y = tp.clip(xt)
    y.add_(tp.ones([3, 4]))
    np.testing.assert_array_equal(xt.numpy(), x)
    np.testing.assert_array_equal(out[0].numpy(), x)
