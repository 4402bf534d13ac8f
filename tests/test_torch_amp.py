"""Eager AMP of the surface (paddle_tpu_torch.amp.auto_cast / decorate)
against the JAX package's: under every level, low dtype and custom list,
the dtype of every output of one chain of ops equals the JAX one, op by
op; the values agree within 2e-2 relative (bf16 / fp16 inputs). decorate
O2 casts the layers and keeps the norms float32.
"""
import numpy as np
import pytest

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


def chain(P):
    """(op name, output) of every step of a chain through white, black
    and unlisted ops, surface functionals and methods."""
    F = P.nn.functional
    x = P.to_tensor(a(4, 8), stop_gradient=False)
    w = P.to_tensor(a(8, 8, seed=1), stop_gradient=False)
    b = P.to_tensor(a(8, seed=2))
    lab = P.to_tensor(np.array([1, 0, 3, 2]))
    out = []
    h = P.matmul(x, w)
    out.append(("matmul", h))
    h = F.linear(h, w, b)
    out.append(("linear", h))
    g = F.gelu(h)
    out.append(("gelu", g))
    s = g + x
    out.append(("add", s))
    e = P.exp(s * 0.1)
    out.append(("exp", e))
    ln = F.layer_norm(e, 8, P.to_tensor(np.ones(8, np.float32)),
                      P.to_tensor(np.zeros(8, np.float32)))
    out.append(("layer_norm", ln))
    r = P.reshape(F.relu(g), [8, 4])
    out.append(("reshape", r))
    sm = F.softmax(g)
    out.append(("softmax", sm))
    c = P.concat([g, h], axis=1)
    out.append(("concat", c))
    m = P.mean(c)
    out.append(("mean", m))
    ce = F.cross_entropy(h, lab)
    out.append(("cross_entropy", ce))
    mm = P.mm(g, w)
    out.append(("mm", mm))
    t = P.tanh(mm)
    out.append(("tanh", t))
    sq = P.sum(t * t)
    out.append(("sum", sq))
    return out


CONFIGS = [
    dict(level="O1", dtype="bfloat16"),
    dict(level="O1", dtype="float16"),
    dict(level="O2", dtype="bfloat16"),
    dict(level="O2", dtype="float16"),
    dict(level="OD", dtype="bfloat16"),
    dict(level="O1", dtype="bfloat16", custom_white_list=["gelu", "tanh"],
         custom_black_list=["mm"]),
    dict(level="O2", dtype="bfloat16", custom_white_list=["layer_norm"],
         custom_black_list=["add", "gelu"]),
    dict(level="O0", dtype="bfloat16"),
    dict(enable=False, level="O2", dtype="float16"),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(
    str(v) if not isinstance(v, list) else "+".join(v) for v in c.values()))
def test_dtypes_op_by_op_match_jax(cfg):
    results = {}
    for P in (jp, tp):
        with P.amp.auto_cast(**cfg):
            results[P] = chain(P)
    for (jn, jt), (tn, tt) in zip(results[jp], results[tp]):
        assert jn == tn
        assert tt.dtype.name == jt.dtype.name, (tn, tt.dtype, jt.dtype)
        assert tt.shape == jt.shape
        np.testing.assert_allclose(
            np.asarray(tt.astype("float32").numpy()),
            np.asarray(jt.astype("float32").numpy()), rtol=2e-2, atol=2e-2,
            err_msg=tn)


def test_auto_cast_restores_state_and_gradients_flow():
    x = tp.to_tensor(a(4, 8), stop_gradient=False)
    w = tp.to_tensor(a(8, 8, seed=1), stop_gradient=False)
    with tp.amp.auto_cast(level="O1", dtype="bfloat16"):
        y = tp.matmul(x, w)
        assert y.dtype == tp.bfloat16
        with tp.amp.auto_cast(enable=False):
            assert tp.matmul(x, w).dtype == tp.float32
        assert tp.matmul(x, w).dtype == tp.bfloat16
    assert tp.matmul(x, w).dtype == tp.float32
    y.astype("float32").sum().backward()
    assert x.grad.dtype == tp.float32 and w.grad.dtype == tp.float32
    with pytest.raises(ValueError):
        with tp.amp.auto_cast(level="O3"):
            pass


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_decorate_o2_keeps_norms_f32(dtype):
    got = {}
    for P in (jp, tp):
        nn = P.nn
        model = nn.Sequential(nn.Linear(4, 4), nn.LayerNorm(4),
                              nn.BatchNorm1D(4), nn.Linear(4, 2))
        opt = P.optimizer.AdamW(learning_rate=1e-3,
                                parameters=model.parameters())
        model, opt = P.amp.decorate(model, opt, level="O2", dtype=dtype)
        got[P] = ({k: v.dtype.name for k, v in model.state_dict().items()},
                  opt._multi_precision)
    assert got[tp] == got[jp]
    assert got[tp][0]["0.weight"] == dtype
    assert got[tp][0]["1.weight"] == "float32"


def test_decorate_o2_optimizer_keeps_training_the_cast_leaves():
    model = tp.nn.Linear(4, 2)
    opt = tp.optimizer.AdamW(learning_rate=1e-1,
                             parameters=model.parameters())
    leaf = model.weight._data
    model = tp.amp.decorate(model, level="O2", dtype="bfloat16")
    assert model.weight._data is leaf and leaf.dtype.is_floating_point
    before = model.weight.numpy().astype(np.float32).copy()
    with tp.amp.auto_cast(level="O2", dtype="bfloat16"):
        loss = model(tp.to_tensor(a(3, 4))).astype("float32").sum()
    loss.backward()
    opt._multi_precision = True
    opt.step()
    assert not np.array_equal(model.weight.numpy().astype(np.float32),
                              before)
