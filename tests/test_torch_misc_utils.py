"""The port's small top-level modules against the JAX package's, on the
CPU: ``nn.utils`` (weight and spectral norm, parameters <-> vector, the
gradient clips), ``LazyGuard``, ``create_parameter``, ``batch``,
``check_shape``, ``set_printoptions``, the CUDA rng-state pair and the
``reader`` decorators. Weights cross with ``bridge.layer_state_from_jax``;
outputs and gradients agree within rtol 1e-5 / atol 1e-6 (f32, the same
math in another summation order)."""
import random

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.bridge import layer_state_from_jax
from paddle_tpu_torch.core import place as place_mod

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(make):
    jm, tm = make(jp), make(tp)
    tm.set_state_dict(layer_state_from_jax(jm))
    return jm, tm


def _np(t):
    return np.asarray(t.numpy())


@pytest.mark.parametrize("dim", [0, 1])
def test_weight_norm_and_its_removal_match_jax(dim):
    jm, tm = _pair(lambda P: P.nn.Linear(5, 4))
    x = _x((3, 5))
    for P, m in ((jp, jm), (tp, tm)):
        P.nn.utils.weight_norm(m, dim=dim)
    assert sorted(n for n, _ in jm.named_parameters()) == \
        sorted(n for n, _ in tm.named_parameters())
    for n in ("weight_g", "weight_v"):
        np.testing.assert_allclose(_np(getattr(jm, n)), _np(getattr(tm, n)),
                                   **TOL)
    np.testing.assert_allclose(_np(jm(jp.to_tensor(x))),
                               _np(tm(tp.to_tensor(x))), **TOL)
    # the port's hook is differentiable in g and v
    tm(tp.to_tensor(x)).sum().backward()
    assert tm.weight_g.grad is not None and tm.weight_v.grad is not None
    for P, m in ((jp, jm), (tp, tm)):
        P.nn.utils.remove_weight_norm(m)
    assert [n for n, _ in jm.named_parameters()] == \
        [n for n, _ in tm.named_parameters()]
    np.testing.assert_allclose(_np(jm(jp.to_tensor(x))),
                               _np(tm(tp.to_tensor(x))), **TOL)


@pytest.mark.parametrize("dim,iters", [(0, 1), (1, 3)])
def test_spectral_norm_matches_jax(dim, iters):
    jm, tm = _pair(lambda P: P.nn.Linear(6, 5))
    x = _x((2, 6), seed=1)
    for P, m in ((jp, jm), (tp, tm)):
        P.nn.utils.spectral_norm(m, n_power_iterations=iters, dim=dim)
    np.testing.assert_allclose(_np(jm(jp.to_tensor(x))),
                               _np(tm(tp.to_tensor(x))), **TOL)
    # the port keeps running (the power iteration carries on) and the
    # original weight gets the gradient
    out = tm(tp.to_tensor(x))
    out.sum().backward()
    assert tm.weight_orig.grad is not None
    assert np.isfinite(_np(tm(tp.to_tensor(x)))).all()


def test_parameters_to_vector_and_back_match_jax():
    jm, tm = _pair(lambda P: P.nn.Sequential(P.nn.Linear(3, 4),
                                              P.nn.Linear(4, 2)))
    vj = jp.nn.utils.parameters_to_vector(jm.parameters())
    vt = tp.nn.utils.parameters_to_vector(tm.parameters())
    np.testing.assert_array_equal(_np(vj), _np(vt))
    new = _x(tuple(vt.shape), seed=2)
    leaves = [p._data for p in tm.parameters()]
    jp.nn.utils.vector_to_parameters(jp.to_tensor(new), jm.parameters())
    tp.nn.utils.vector_to_parameters(tp.to_tensor(new), tm.parameters())
    for (n, a), (_, b) in zip(jm.state_dict().items(),
                              tm.state_dict().items()):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=n)
    assert all(p._data is leaf for p, leaf in zip(tm.parameters(), leaves))


def _grads(P, m, x):
    m.clear_gradients()
    (m(P.to_tensor(x)) ** 2).sum().backward()


@pytest.mark.parametrize("clip", [0.05, 1.0])
def test_clip_grad_value_matches_jax(clip):
    jm, tm = _pair(lambda P: P.nn.Linear(4, 3))
    x = _x((5, 4), seed=3)
    for P, m in ((jp, jm), (tp, tm)):
        _grads(P, m, x)
        P.nn.utils.clip_grad_value_(m.parameters(), clip)
    for a, b in zip(jm.parameters(), tm.parameters()):
        np.testing.assert_allclose(_np(a.grad), _np(b.grad), **TOL)
        assert np.abs(_np(b.grad)).max() <= clip


@pytest.mark.parametrize("max_norm,norm_type", [(0.1, 2.0), (100.0, 2.0),
                                                (0.5, float("inf"))])
def test_clip_grad_norm_matches_jax(max_norm, norm_type):
    jm, tm = _pair(lambda P: P.nn.Linear(4, 3))
    x = _x((5, 4), seed=4)
    totals = []
    for P, m in ((jp, jm), (tp, tm)):
        _grads(P, m, x)
        totals.append(_np(P.nn.utils.clip_grad_norm_(
            m.parameters(), max_norm, norm_type=norm_type)))
    np.testing.assert_allclose(totals[0], totals[1], **TOL)
    for a, b in zip(jm.parameters(), tm.parameters()):
        np.testing.assert_allclose(_np(a.grad), _np(b.grad), **TOL)


def test_lazy_guard_defers_initializers():
    from paddle_tpu_torch.nn.initializer.lazy_init import in_lazy_mode
    with tp.LazyGuard():
        assert in_lazy_mode()
        lin = tp.nn.Linear(8, 6)
    assert not in_lazy_mode()
    assert not _np(lin.weight).any()          # zeros until initialize()
    leaf = lin.weight._data
    lin.weight.initialize()
    assert _np(lin.weight).any() and lin.weight._data is leaf
    lin.weight.initialize()                   # a second call is a no-op
    with jp.LazyGuard():
        jl = jp.nn.Linear(8, 6)
    assert not _np(jl.weight).any()


@pytest.mark.parametrize("kw", [dict(shape=[3, 4], dtype="float32"),
                                dict(shape=[5], dtype="float32",
                                     is_bias=True),
                                dict(shape=[2, 2], dtype="float64",
                                     name="w0")])
def test_create_parameter_matches_jax(kw):
    init = dict(default_initializer=None) if kw.get("is_bias") else dict(
        default_initializer=jp.nn.initializer.Constant(0.5))
    a = jp.create_parameter(**kw, **init)
    init = dict(default_initializer=None) if kw.get("is_bias") else dict(
        default_initializer=tp.nn.initializer.Constant(0.5))
    b = tp.create_parameter(**kw, **init)
    np.testing.assert_array_equal(_np(a), _np(b))
    # divergence: the JAX Parameter casts a float64 parameter to float32
    # (its Tensor's default-dtype rule); the port keeps the dtype asked for
    assert b.dtype.name == kw["dtype"] and b.name == kw.get("name")
    assert a.dtype.name == "float32"
    assert not b.stop_gradient


def test_batch_matches_jax():
    def items():
        yield from range(7)
    for drop in (False, True):
        assert list(jp.batch(items, 3, drop)()) == \
            list(tp.batch(items, 3, drop)())
    with pytest.raises(ValueError):
        tp.batch(items, 0)


def test_check_shape_and_printoptions():
    tp.check_shape([2, 3])
    tp.check_shape(tp.to_tensor(np.array([2, 3])))
    for bad, err in (([2, 1.5], TypeError), ([2, -1], ValueError),
                     (tp.to_tensor(np.array([1.0])), TypeError)):
        with pytest.raises(err):
            tp.check_shape(bad)
    before = np.get_printoptions()
    try:
        tp.set_printoptions(precision=2, linewidth=60)
        assert np.get_printoptions()["precision"] == 2
        assert "0.33" in repr(tp.to_tensor(np.array([1 / 3], np.float32)))
    finally:
        np.set_printoptions(**before)
    tp.disable_signal_handler()


def test_cuda_rng_state_round_trip():
    st = tp.get_cuda_rng_state()
    assert isinstance(st, list) and len(st) == torch.cuda.device_count()
    tp.set_cuda_rng_state(st)
    with pytest.raises(ValueError):
        tp.set_cuda_rng_state(st + [torch.ByteTensor(8)])


def _reader(n=10):
    def r():
        yield from range(n)
    return r


def _same_reader(make):
    random.seed(11)
    a = list(make(jp.reader)())
    random.seed(11)
    b = list(make(tp.reader)())
    assert a == b
    return b


@pytest.mark.parametrize("case", [
    "cache", "map", "shuffle", "chain", "compose", "buffered", "firstn",
    "xmap_ordered", "multiprocess"])
def test_reader_decorators_match_jax(case):
    makers = {
        "cache": lambda R: R.cache(_reader()),
        "map": lambda R: R.map_readers(lambda a, b: a * b, _reader(),
                                       _reader(5)),
        "shuffle": lambda R: R.shuffle(_reader(23), 7),
        "chain": lambda R: R.chain(_reader(3), _reader(4)),
        "compose": lambda R: R.compose(_reader(4), _reader(4)),
        "buffered": lambda R: R.buffered(_reader(9), 2),
        "firstn": lambda R: R.firstn(_reader(), 4),
        "xmap_ordered": lambda R: R.xmap_readers(lambda v: v * v,
                                                 _reader(12), 3, 4,
                                                 order=True),
        "multiprocess": lambda R: R.multiprocess_reader([_reader(3),
                                                         _reader(5)]),
    }
    got = _same_reader(makers[case])
    assert got
    if case == "shuffle":
        assert sorted(got) == list(range(23))


def test_compose_refuses_misaligned_readers():
    with pytest.raises(tp.reader.ComposeNotAligned):
        list(tp.reader.compose(_reader(3), _reader(4))())
