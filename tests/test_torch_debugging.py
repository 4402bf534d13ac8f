"""The port's amp.debugging against the JAX package's on the CPU:
check_numerics' counts and its raise, the tensor checker aborting at the
same op, the operator-stats table (op, output dtype) -> count of a small
eager program in f32 and O1 bf16 (a 1-layer TransformerEncoder whose
weights cross by bridge.layer_state_from_jax), and dumps that each
package's compare_accuracy reads from the other. Counts and op names are
compared exactly; dump statistics of the same f32 program within 1e-5
(absmax relative, mean absolute: a normalised output's mean is ~0)."""
import csv

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.bridge import layer_state_from_jax
from paddle_tpu_torch.core import dispatch
from paddle_tpu_torch.core import place as place_mod


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


def _model(P):
    nn = P.nn
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        32, 4, 64, dropout=0.0, activation="gelu"), 1)
    return nn.Sequential(nn.Embedding(50, 32), enc, nn.Linear(32, 2))


@pytest.fixture()
def models():
    jm, tm = _model(jp), _model(tp)
    tm.set_state_dict(layer_state_from_jax(jm))
    return jm, tm


def _step(P, model, amp):
    rng = np.random.default_rng(0)
    ids = P.to_tensor(rng.integers(0, 50, (2, 8)))
    keep = P.to_tensor(np.ones((2, 1, 1, 8), bool))
    labels = P.to_tensor(rng.integers(0, 2, (2,)))
    with P.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
        h = model[1](model[0](ids), src_mask=keep)
        loss = P.nn.functional.cross_entropy(model[2](h[:, 0]), labels)
    loss.backward()
    return loss


def _sample():
    x = np.arange(24, dtype=np.float32).reshape(4, 6) - 5
    x[0, 1], x[2, 3], x[3, 0] = np.nan, np.inf, -np.inf
    return x


def test_check_numerics_counts_equal_jax(capsys):
    x = _sample()
    mode_j, mode_t = jdbg.DebugMode.CHECK_NAN_INF, tdbg.DebugMode.CHECK_NAN_INF
    jc = jdbg.check_numerics(jp.to_tensor(x), "op", "x", debug_mode=mode_j)
    tc = tdbg.check_numerics(tp.to_tensor(x), "op", "x", debug_mode=mode_t)
    assert [int(c) for c in tc] == [int(c) for c in jc] == [1, 2, 1]
    assert [c.dtype.name for c in tc] == ["int64"] * 3
    out = capsys.readouterr().out
    assert out.count("[check_numerics] op=op var=x: 1 nan, 2 inf") == 2
    for mod, P in ((jdbg, jp), (tdbg, tp)):
        with pytest.raises(FloatingPointError, match="1 nan, 2 inf"):
            mod.check_numerics(P.to_tensor(x))
    clean = np.ones((3, 3), np.float32)
    assert [int(c) for c in tdbg.check_numerics(tp.to_tensor(clean))] == \
        [int(c) for c in jdbg.check_numerics(jp.to_tensor(clean))] == [0, 0, 0]


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "o1_bf16"])
def test_tensor_checker_aborts_at_the_same_op_as_jax(models, amp):
    jm, tm = models
    w = np.asarray(jm[1].layers[0].self_attn.q_proj.weight.numpy()).copy()
    w[0, 0] = np.inf
    jm[1].layers[0].self_attn.q_proj.weight.set_value(w)
    tm.set_state_dict(layer_state_from_jax(jm))
    msgs = {}
    for name, P, mod in (("jax", jp, jdbg), ("port", tp, tdbg)):
        mod.enable_tensor_checker(mod.TensorCheckerConfig(
            enable=True,
            debug_mode=mod.DebugMode.CHECK_NAN_INF_AND_ABORT))
        try:
            with pytest.raises(FloatingPointError) as e:
                _step(P, jm if P is jp else tm, amp)
            msgs[name] = str(e.value)
        finally:
            mod.disable_tensor_checker()
    dispatch._nan_pending.clear()
    assert msgs["port"] == msgs["jax"]
    assert msgs["port"] == ("Op cast output contains NaN/Inf" if amp else
                            "Op linear output contains NaN/Inf")


def test_tensor_checker_passes_a_clean_step(models):
    _, tm = models
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig())
    try:
        assert np.isfinite(float(_step(tp, tm, True)))
    finally:
        tdbg.disable_tensor_checker()
    assert not tp.get_flags(["check_nan_inf"])["check_nan_inf"]


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "o1_bf16"])
def test_operator_stats_equal_jax(models, amp, capsys):
    jm, tm = models
    capsys.readouterr()
    with jdbg.collect_operator_stats():
        _step(jp, jm, amp)
    jout = capsys.readouterr().out
    with tdbg.collect_operator_stats():
        _step(tp, tm, amp)
    tout = capsys.readouterr().out
    assert tdbg.operator_stats() == jdbg._op_stats
    assert tout == jout and "op list" in tout
    assert ("dtype: bfloat16" in tout) == amp
    assert not dispatch.OP_OBSERVERS


def test_operator_stats_function_style(capsys):
    x = tp.to_tensor(np.ones((2, 2), np.float32))
    tdbg.enable_operator_stats_collection()
    _ = x * x
    tdbg.disable_operator_stats_collection()
    assert "multiply: 1" in capsys.readouterr().out
    assert tdbg.operator_stats() == {("multiply", "float32"): 1}


def test_dumps_are_read_by_both_compare_accuracy(models, tmp_path):
    """The same f32 step dumped by each package; each package's
    compare_accuracy reads both orders and gives the same rows, with the
    two runs within 1e-5 of each other; an O1 dump of the port against
    the JAX f32 dump shows the bf16 rounding."""
    jm, tm = models
    paths = {k: str(tmp_path / f"{k}.jsonl")
             for k in ("jax", "port", "port_o1")}
    with jdbg.dump_tensor_stats(paths["jax"]):
        _step(jp, jm, False)
    with tdbg.dump_tensor_stats(paths["port"]):
        _step(tp, tm, False)
    with tdbg.dump_tensor_stats(paths["port_o1"]):
        _step(tp, tm, True)
    jlines = open(paths["jax"]).read().splitlines()
    tlines = open(paths["port"]).read().splitlines()
    assert len(tlines) == len(jlines) > 5
    rows = {}
    for name, mod in (("jax", jdbg), ("port", tdbg)):
        for a, b in (("jax", "port"), ("port", "jax")):
            out = str(tmp_path / f"{name}_{a}_{b}.csv")
            rows[name, a, b] = mod.compare_accuracy(paths[a], paths[b], out)
            with open(out) as f:
                assert len(list(csv.DictReader(f))) == len(rows[name, a, b])
    for a, b in (("jax", "port"), ("port", "jax")):
        assert rows["port", a, b] == rows["jax", a, b]
        assert len(rows["port", a, b]) == len(jlines)
        # means of normalised outputs sit near 0: held to the scale
        assert all(abs(r["mean_a"] - r["mean_b"]) < 1e-5
                   for r in rows["port", a, b])
        assert max(r["absmax_rel_diff"] for r in rows["port", a, b]) < 1e-5
    mixed = jdbg.compare_accuracy(paths["jax"], paths["port_o1"],
                                  str(tmp_path / "o1.csv"))
    assert mixed == tdbg.compare_accuracy(paths["jax"], paths["port_o1"],
                                          str(tmp_path / "o1b.csv"))
    assert {r["dtype_b"] for r in mixed} >= {"bfloat16"}
    assert max(r["absmax_rel_diff"] for r in mixed) > 1e-4


def test_check_layer_numerics():
    class Net(tp.nn.Layer):
        @tdbg.check_layer_numerics
        def forward(self, x):
            return x * 2

    net = Net()
    assert float(net(tp.to_tensor(np.ones(3, np.float32))).sum()) == 6.0
    with pytest.raises(RuntimeError, match="input 0 of Net"):
        net(tp.to_tensor(np.array([1.0, np.nan], np.float32)))
