"""Autograd of the eager surface (torch autograd underneath) against the
JAX package's tape: the 16 cases of test_autograd.py, each run through
both packages on the same inputs (results within rtol 1e-5), and the
semantics the two differ on by construction, each held to the JAX one:
a non-leaf set to stop_gradient, integer tensors, set_value on a leaf,
__setitem__'s gradient, PyLayer, create_graph double backward, .grad
identity and accumulation.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as place_mod


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


def a(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def leaf(P, arr):
    return P.to_tensor(arr, stop_gradient=False)


# -- the cases of test_autograd.py, as functions of the package ------------

def simple_chain(P):
    x = leaf(P, a(3, 4))
    (x * 2 + 1).sum().backward()
    return [x.grad.numpy()]


def broadcast_grad_reduces(P):
    x, b = leaf(P, a(3, 4)), leaf(P, a(4, seed=1))
    (x + b).sum().backward()
    return [x.grad.numpy(), b.grad.numpy()]


def grad_accumulation_and_clear(P):
    x = leaf(P, a(2, 2))
    (x * 3).sum().backward()
    (x * 3).sum().backward()
    g = x.grad.numpy().copy()
    x.clear_grad()
    return [g, np.asarray(x.grad is None)]


def stop_gradient_blocks(P):
    x, y = leaf(P, a(2, 2)), P.to_tensor(a(2, 2, seed=1))
    (x * y).sum().backward()
    return [x.grad.numpy(), np.asarray(y.grad is None)]


def no_grad_context(P):
    x = leaf(P, a(2, 2))
    with P.no_grad():
        y = x * 2
    return [np.asarray(y.stop_gradient)]


def double_backward_raises_without_retain(P):
    x = leaf(P, a(2, 2))
    loss = (x * x).sum()
    loss.backward()
    with pytest.raises(RuntimeError):
        loss.backward()
    return [x.grad.numpy()]


def retain_graph(P):
    x = leaf(P, a(2, 2))
    loss = (x * 2).sum()
    loss.backward(retain_graph=True)
    loss.backward()
    return [x.grad.numpy()]


def register_hook(P):
    x = leaf(P, a(2, 2))
    seen = []

    def hook(g):
        seen.append(g.numpy().copy())
        return g * 2

    h = x.register_hook(hook)
    (x * 1.0).sum().backward()
    h.remove()
    (x * 1.0).sum().backward()
    return [x.grad.numpy(), np.asarray(len(seen))]


def diamond_graph(P):
    x = leaf(P, a(3))
    y = x * 2
    (y + y * y).sum().backward()
    return [x.grad.numpy()]


def functional_grad(P):
    x = leaf(P, a(3))
    (gx,) = P.autograd.functional.grad([(x ** 2).sum()], [x]) \
        if P is jp else P.autograd.grad([(x ** 2).sum()], [x])
    return [gx.numpy(), np.asarray(x.grad is None)]


def pylayer(P):
    class Double(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * 2 + x * 0

    x = leaf(P, a(3))
    y = Double.apply(x)
    (y * y).sum().backward()
    return [y.numpy(), x.grad.numpy()]


def matmul_chain_grad(P):
    w, x = leaf(P, a(4, 5, seed=3)), P.to_tensor(a(2, 4, seed=4))
    P.tanh(P.matmul(x, w)).sum().backward()
    return [w.grad.numpy()]


def double_backward_create_graph(P):
    x = leaf(P, np.array(2.0, np.float32))
    (g,) = P.grad(x * x * x, [x], create_graph=True)
    sg = g.stop_gradient
    g.backward()
    return [g.numpy(), np.asarray(sg), x.grad.numpy()]


def grad_does_not_pollute_other_leaves(P):
    w, x = leaf(P, np.array(3.0, np.float32)), leaf(P, np.array(
        1.5, np.float32))
    (gx,) = P.grad(w * x * x, [x], create_graph=True)
    untouched = w.grad is None and x.grad is None
    ((gx - 1.0) * (gx - 1.0)).backward()
    return [np.asarray(untouched), w.grad.numpy()]


def grad_wrt_intermediate_tensor(P):
    x = leaf(P, np.array(2.0, np.float32))
    h = x * x
    y = h * h * h
    (gh,) = P.grad(y, [h])
    (gh2,) = P.grad(y, [h], create_graph=True)
    return [gh.numpy(), gh2.numpy()]


def grad_of_root_wrt_itself(P):
    x = leaf(P, np.array(3.0, np.float32))
    y = x * x
    (gy,) = P.grad(y, [y])
    (gy2,) = P.grad(y, [y], create_graph=True)
    return [gy.numpy(), gy2.numpy()]


CASES = [simple_chain, broadcast_grad_reduces, grad_accumulation_and_clear,
         stop_gradient_blocks, no_grad_context,
         double_backward_raises_without_retain, retain_graph, register_hook,
         diamond_graph, functional_grad, pylayer, matmul_chain_grad,
         double_backward_create_graph, grad_does_not_pollute_other_leaves,
         grad_wrt_intermediate_tensor, grad_of_root_wrt_itself]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_autograd_case_matches_jax(case):
    want, got = case(jp), case(tp)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=1e-5,
                                   atol=1e-6)


# -- where torch autograd and the JAX tape differ --------------------------

def nonleaf_stop_gradient(P):
    x = leaf(P, a(3))
    h = x * 3
    h.stop_gradient = True
    (h * x).sum().backward()
    return [x.grad.numpy(), np.asarray(h.stop_gradient)]


def int_tensors_never_differentiate(P):
    i = P.to_tensor(np.array([1, 2, 3]), stop_gradient=False)
    x = leaf(P, a(3))
    y = x * i.astype("float32")
    y.sum().backward()
    am = P.argmax(x)
    return [np.asarray(i.stop_gradient), x.grad.numpy(),
            np.asarray(am.stop_gradient), np.asarray(
                (i + 1).stop_gradient)]


def outputs_differentiable_iff_float(P):
    x = leaf(P, a(4))
    return [np.asarray((x * 2).stop_gradient),
            np.asarray((x > 0).stop_gradient),
            np.asarray(P.to_tensor(a(2)).exp().stop_gradient)]


def set_value_on_leaf(P):
    x = leaf(P, a(3))
    x.set_value(np.ones(3, np.float32))
    (x * x).sum().backward()
    x.fill_(2.0)
    v = x.numpy().copy()
    x.zero_()
    return [x.grad.numpy(), v, x.numpy(), np.asarray(x.stop_gradient)]


def setitem_keeps_written_gradient(P):
    x = leaf(P, a(4))
    v = leaf(P, a(2, seed=1))
    y = x * 1.0
    y[1:3] = v * 3
    (y * y).sum().backward()
    return [y.numpy(), x.grad.numpy(), v.grad.numpy()]


def pylayer_two_inputs(P):
    class Mul(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, y):
            ctx.save_for_backward(x, y)
            return x * y, x + y

        @staticmethod
        def backward(ctx, g1, g2):
            x, y = ctx.saved_tensor()
            return g1 * y + g2, g1 * x + g2

    x, y = leaf(P, a(3)), leaf(P, a(3, seed=2))
    p, s = Mul.apply(x, y)
    (p * 2 + s).sum().backward()
    return [p.numpy(), s.numpy(), x.grad.numpy(), y.grad.numpy()]


def hessian_via_double_backward(P):
    x = leaf(P, a(3))
    (g,) = P.grad((x * x * x).sum(), [x], create_graph=True)
    (h,) = P.grad(g.sum(), [x])
    return [g.numpy(), h.numpy()]


SEMANTICS = [nonleaf_stop_gradient, int_tensors_never_differentiate,
             outputs_differentiable_iff_float, set_value_on_leaf,
             setitem_keeps_written_gradient, pylayer_two_inputs,
             hessian_via_double_backward]


@pytest.mark.parametrize("case", SEMANTICS, ids=lambda f: f.__name__)
def test_semantics_match_jax(case):
    want, got = case(jp), case(tp)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=1e-5,
                                   atol=1e-6)


def test_grad_wrapper_identity_and_accumulation():
    x = leaf(tp, a(3))
    (x * 2).sum().backward()
    g = x.grad
    assert x.grad is g
    (x * 3).sum().backward()
    assert x.grad is g
    np.testing.assert_allclose(g.numpy(), np.full(3, 5.0))
    x.clear_grad()
    assert x.grad is None


def test_set_value_writes_the_leaf_in_place():
    """An optimizer holding the leaf sees set_value / fill_ / zero_."""
    p = tp.nn.Linear(2, 2).weight
    leaf_t = p._data
    p.set_value(np.eye(2, dtype=np.float32))
    assert p._data is leaf_t and not p.stop_gradient
    np.testing.assert_array_equal(leaf_t.detach().numpy(), np.eye(2))


def test_functional_jacobian_hessian_vjp_jvp():
    def f(x):
        return (x * x * x).sum()

    x = a(3)
    for P in (jp, tp):
        h = P.autograd.hessian(f, P.to_tensor(x))
        np.testing.assert_allclose(np.asarray(h[:].numpy()),
                                   np.diag(6 * x), rtol=1e-5, atol=1e-5)
    jj = jp.autograd.jacobian(lambda v: v * v, jp.to_tensor(x))
    tj = tp.autograd.jacobian(lambda v: v * v, tp.to_tensor(x))
    np.testing.assert_allclose(tj[:].numpy(), np.asarray(jj[:].numpy()),
                               rtol=1e-6)
    jo, jg = jp.autograd.vjp(lambda v: v * 2, jp.to_tensor(x))
    to, tg = tp.autograd.vjp(lambda v: v * 2, tp.to_tensor(x))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg.numpy()))
    _, jv = jp.autograd.jvp(lambda v: v * v, jp.to_tensor(x))
    _, tv = tp.autograd.jvp(lambda v: v * v, tp.to_tensor(x))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv.numpy()),
                               rtol=1e-6)


def test_saved_tensors_hooks_pack_and_unpack():
    log = []

    class Sq(tp.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * 2 * x

    x = leaf(tp, a(3))
    with tp.autograd.saved_tensors_hooks(
            lambda t: log.append("pack") or t.numpy(),
            lambda n: log.append("unpack") or tp.to_tensor(n)):
        y = Sq.apply(x)
    y.sum().backward()
    assert log == ["pack", "unpack"]
    np.testing.assert_allclose(x.grad.numpy(), 2 * a(3), rtol=1e-6)
    assert isinstance(x._data.grad, torch.Tensor)


def test_inplace_update_of_a_leaf_under_no_grad_stays_trainable():
    """Divergence by design: the JAX package rebinds an in-place op's
    result, so a parameter updated under no_grad turns stop_gradient;
    the port writes the leaf in place (an optimizer holds it) and it
    stays trainable."""
    w = tp.nn.Linear(2, 2).weight
    leaf_t = w._data
    with tp.no_grad():
        w.subtract_(tp.ones_like(w) * 0.5)
    assert w._data is leaf_t and not w.stop_gradient
    jw = jp.nn.Linear(2, 2).weight
    with jp.no_grad():
        jw.subtract_(jp.ones_like(jw) * 0.5)
    assert jw.stop_gradient


@pytest.mark.parametrize("batch", [1, 3])
def test_check_nan_inf_flags_match_jax(batch):
    """FLAGS_check_nan_inf raises at the offending op (batch 1) or when a
    batch of queued flags is flushed, in both packages."""
    for P in (jp, tp):
        P.set_flags({"FLAGS_check_nan_inf": True,
                     "FLAGS_check_nan_inf_batch": batch})
        try:
            x = P.to_tensor(np.array([1.0, -1.0], np.float32))
            with pytest.raises(FloatingPointError, match="log"):
                P.log(x)
                P.exp(x)
                P.sqrt(x * x)
        finally:
            P.set_flags({"FLAGS_check_nan_inf": False,
                         "FLAGS_check_nan_inf_batch": 1})


def test_tensor_methods_match_jax():
    x = a(2, 3)
    got = {}
    for P in (jp, tp):
        t = P.to_tensor(x)
        got[P] = dict(
            shape=t.shape, size=t.size, ndim=t.ndim, dtype=t.dtype.name,
            item=t[0, 1].item(), tolist=t.tolist(), array=np.asarray(t),
            astype=t.astype("float64").dtype.name, T=t.T.shape,
            detached=t.detach().stop_gradient, clone=P.clone(t).numpy(),
            numel=int(t.numel()), cpu=t.cpu().numpy())
    for k in got[jp]:
        np.testing.assert_equal(got[tp][k], got[jp][k], err_msg=k)
    t = tp.to_tensor(x, stop_gradient=False)
    c = t.clone()          # the JAX Tensor.clone names a missing function
    (c * 2).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.full((2, 3), 2.0))
    assert t.place == tp.CPUPlace() and t.to("cpu").place == tp.CPUPlace()
    np.testing.assert_array_equal(torch.from_dlpack(t).numpy(), x)
