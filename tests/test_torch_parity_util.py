"""Shared helpers of the port's parity tests: one function run through the
JAX package and the port on the same numpy inputs, outputs and input
gradients compared.

The other ``test_torch_*`` files import ``run_both``; the one test here
checks that it fails on a real disagreement.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as place_mod


@pytest.fixture(scope="module")
def cpu_place():
    """The port's surface on the CPU for a module, the place restored
    after (a test module uses it as ``autouse``)."""
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


def arr(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return [out]


def _np(t):
    return np.asarray(t.numpy())


def assert_f32_gate(got, ref, err_msg=""):
    """chip_smoke's ``closeness`` gate for f32: |got - ref| <= 1e-4 *
    max(1, max |ref|), element by element."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape, err_msg)
    atol = 1e-4 * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=err_msg)


def run_both(jfn, tfn, arrays, grad=True, tol=None, grad_tol=None,
             int_args=(), gate=False):
    """Call ``jfn`` / ``tfn`` on the arrays as JAX-package / port Tensors
    (float arrays differentiable when ``grad``), compare every output
    leaf, then the gradients of sum(out_i * w_i) (fixed random weights
    w_i) with respect to every float input. Returns the port's outputs.
    ``gate`` compares floating outputs and gradients by
    ``assert_f32_gate`` instead of ``tol``."""
    tol = tol or dict(rtol=1e-5, atol=1e-5)
    grad_tol = grad_tol or tol

    def wrap(pkg, a, i):
        floating = np.asarray(a).dtype.kind == "f" and i not in int_args
        return pkg.to_tensor(a, stop_gradient=not (grad and floating))
    jin = [wrap(jp, a, i) for i, a in enumerate(arrays)]
    tin = [wrap(tp, a, i) for i, a in enumerate(arrays)]
    jout, tout = _leaves(jfn(*jin)), _leaves(tfn(*tin))
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        jv, tv = _np(j), _np(t)
        assert jv.shape == tv.shape, (jv.shape, tv.shape)
        if jv.dtype.kind in "iub":
            np.testing.assert_array_equal(tv, jv)
        elif gate:
            assert_f32_gate(tv, jv)
        else:
            np.testing.assert_allclose(tv.astype(np.float64),
                                       jv.astype(np.float64), **tol)
    if not grad:
        return tout
    diff = [i for i, (j, t) in enumerate(zip(jout, tout))
            if _np(j).dtype.kind == "f" and not t.stop_gradient]
    if not diff:
        return tout
    rng = np.random.default_rng(123)
    ws = {i: rng.standard_normal(_np(jout[i]).shape).astype(np.float32)
          for i in diff}
    jl = sum((jout[i] * jp.to_tensor(ws[i])).sum() for i in diff)
    tl = sum((tout[i] * tp.to_tensor(ws[i])).sum() for i in diff)
    jl.backward()
    tl.backward()
    for k, (j, t) in enumerate(zip(jin, tin)):
        if t.stop_gradient:
            continue
        if j.grad is None or t.grad is None:   # no path: zero gradient
            for g in (j.grad, t.grad):
                assert g is None or not np.any(_np(g)), k
            continue
        if gate:
            assert_f32_gate(_np(t.grad), _np(j.grad), f"grad of input {k}")
        else:
            np.testing.assert_allclose(_np(t.grad), _np(j.grad), **grad_tol,
                                       err_msg=f"grad of input {k}")
    return tout


def test_run_both_catches_a_mismatch(cpu_place):
    x = arr(3, 4)
    run_both(lambda a: a * 2.0, lambda a: a * 2.0, [x])
    with pytest.raises(AssertionError):
        run_both(lambda a: a * 2.0, lambda a: a * 2.001, [x])
    with pytest.raises(AssertionError):      # equal values, wrong grads
        run_both(lambda a: a * 2.0,
                 lambda a: a * 2.0 + (a * 0.0).detach() + a - a.detach(),
                 [x])
    run_both(lambda a: a * 2.0, lambda a: a * 2.0 + 5e-5, [x], gate=True)
    with pytest.raises(AssertionError):      # over the f32 gate
        run_both(lambda a: a * 2.0, lambda a: a * 2.0 + 2e-4, [x],
                 gate=True)
