"""``paddle.static`` of the port (``paddle_tpu_torch.static``) against the
JAX package's, on the CPU: the same ``__all__``; each Program / Executor
shim raising where JAX raises; ``static.nn``'s ``cond`` / ``case`` /
``switch_case`` / ``while_loop`` eagerly and under ``to_static``;
``ExponentialMovingAverage``'s update / apply / restore values; ``data``,
``gradients``, ``load_inference_model`` of a port ``jit.save`` artifact,
the graph-free helpers, and the top level's ``enable_static`` /
``disable_static``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.bridge import layer_state_from_jax
from test_torch_parity_util import cpu_place  # noqa: F401  (fixture)

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _port_on_cpu(cpu_place):  # noqa: F811
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def _np(t):
    return np.asarray(t.numpy())


def test_all_names_match_jax():
    assert tp.static.__all__ == jp.static.__all__
    for name in jp.static.__all__:
        assert hasattr(tp.static, name), name
    public = {n for n in dir(jp.static.nn) if not n.startswith("_")}
    assert public - {"annotations"} <= set(dir(tp.static.nn))


#: (name, args) of every shim that raises NotImplementedError in JAX
RAISING = [("Program", ()), ("default_main_program", ()),
           ("default_startup_program", ()), ("WeightNormParamAttr", ()),
           ("CompiledProgram", ()), ("Executor", ()),
           ("IpuCompiledProgram", ()), ("IpuStrategy", ()),
           ("append_backward", (None,)), ("save", (None, "x")),
           ("save_inference_model", ("x", [], [])),
           ("serialize_program", ()), ("deserialize_program", ()),
           ("serialize_persistables", ()), ("deserialize_persistables", ()),
           ("normalize_program", ()), ("ctr_metric_bundle", ()),
           ("ipu_shard_guard", ()), ("set_ipu_shard", (None,)),
           ("xpu_places", ())]
NN_RAISING = ["data_norm", "nce", "sparse_embedding", "sequence_conv",
              "sequence_expand", "sequence_first_step", "sequence_last_step",
              "sequence_pool", "sequence_softmax"]


@pytest.mark.parametrize("name,args", RAISING)
def test_program_shims_raise_where_jax_raises(name, args):
    for P in (jp, tp):
        with pytest.raises(NotImplementedError) as e:
            getattr(P.static, name)(*args)
    assert "TPU" not in str(e.value)


@pytest.mark.parametrize("name", NN_RAISING + ["fc", "embedding",
                                               "deform_conv2d", "row_conv"])
def test_nn_builders_raise_where_jax_raises(name):
    args = {"fc": (None, 4), "embedding": (None, (4, 4)),
            "deform_conv2d": (None, None, None, 4, 3),
            "row_conv": (None, 2)}.get(name, ())
    for P in (jp, tp):
        with pytest.raises(NotImplementedError):
            getattr(P.static.nn, name)(*args)


def test_enable_and_disable_static():
    for P in (jp, tp):
        assert P.disable_static() is None
        with pytest.raises(NotImplementedError, match="to_static"):
            P.enable_static()


# -- control flow ------------------------------------------------------------

def _flow(P, x, k):
    """cond, case and switch_case over x and the branch index k."""
    n = P.static.nn
    a = n.cond(x.sum() > 0, lambda: x * 2, lambda: x - 1)
    b = n.case([(x.mean() > 1, lambda: x + 10), (x.mean() > -1,
                                                 lambda: x + 20)],
               default=lambda: x + 30)
    c = n.switch_case(k, {0: lambda: x * 3, 1: lambda: x * 4},
                      default=lambda: x * 5)
    return a, b, c


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("k", [0, 1, 7])
def test_eager_control_flow_matches_jax(sign, k):
    x = sign * np.linspace(0.5, 2.0, 6, dtype=np.float32)
    got = _flow(tp, tp.to_tensor(x), tp.to_tensor(k))
    want = _flow(jp, jp.to_tensor(x), jp.to_tensor(k))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_cond_runs_only_the_taken_branch_eagerly():
    for P in (jp, tp):
        ran = []
        P.static.nn.cond(P.to_tensor(True), lambda: ran.append("t"),
                         lambda: ran.append("f"))
        assert ran == ["t"]
        assert P.static.nn.cond(P.to_tensor(False), lambda: 1) is None


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_compiled_cond_matches_jax(sign):
    graphs = []

    def backend(gm, example_inputs):
        graphs.append(gm)
        return gm.forward
    x = sign * np.arange(1, 7, dtype=np.float32).reshape(2, 3)
    res = []
    for P, kw in ((jp, {}), (tp, dict(backend=backend))):
        @P.jit.to_static(**kw)
        def f(x):
            return P.static.nn.cond(x.sum() > 0,
                                    lambda: (x * 2, x.sum()),
                                    lambda: (x - 1, x.mean()))
        res.append([_np(t) for t in f(P.to_tensor(x))])
        assert not f._eager_sigs
    for g, w in zip(*reversed(res)):
        np.testing.assert_allclose(g, w, **TOL)
    assert len(graphs) == 1


def test_while_loop_eager_and_compiled_match_jax():
    def run(P, compiled, backend=None):
        def f(x, n):
            def cond(i, acc):
                return i < n

            def body(i, acc):
                return i + 1, acc * 1.5 + i.astype("float32")
            i, acc = P.static.nn.while_loop(cond, body,
                                            [P.to_tensor(0), x])
            return i, acc
        if compiled:
            f = P.jit.to_static(f, **({} if backend is None
                                      else dict(backend=backend)))
        return [_np(t) for t in f(P.to_tensor(np.ones((3,), np.float32)),
                                  P.to_tensor(4))]
    graphs = []

    def backend(gm, example_inputs):
        graphs.append(gm)
        return gm.forward
    want = run(jp, False)
    np.testing.assert_array_equal(want[0], 4)
    for got in (run(tp, False), run(tp, True, backend), run(jp, True)):
        np.testing.assert_allclose(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], **TOL)
    assert len(graphs) == 1


def test_eager_while_loop_calls_cond_once_per_step():
    for P in (jp, tp):
        calls = []

        def cond(i):
            calls.append(1)
            return i < 3
        out = P.static.nn.while_loop(cond, lambda i: i + 1,
                                     [P.to_tensor(0)])
        assert int(out[0]) == 3 and len(calls) == 4


# -- the graph-free helpers --------------------------------------------------

def _lin(P, seed=0):
    P.seed(seed)
    return P.nn.Linear(4, 3)


def test_exponential_moving_average_matches_jax():
    jl = _lin(jp)
    tl = _lin(tp)
    tl.set_state_dict(layer_state_from_jax(jl))
    emas = [jp.static.ExponentialMovingAverage(0.9),
            tp.static.ExponentialMovingAverage(0.9)]
    rng = np.random.default_rng(0)
    for step in range(3):
        for (P, lyr), ema in zip(((jp, jl), (tp, tl)), emas):
            ema.update(lyr.parameters() if step == 0 else None)
        new = {k: v + rng.standard_normal(v.shape).astype(np.float32)
               for k, v in layer_state_from_jax(jl).items()}
        jl.set_state_dict(new)
        tl.set_state_dict(new)
    live = {k: _np(v) for k, v in tl.state_dict().items()}
    leaves = {k: p._data for k, p in tl.named_parameters()}
    with emas[0].apply():
        with emas[1].apply():
            for k, v in tl.state_dict().items():
                want = _np(jl.state_dict()[k])
                np.testing.assert_allclose(_np(v), want, rtol=1e-6,
                                           atol=1e-6, err_msg=k)
                assert not np.allclose(want, live[k])
    for k, v in tl.state_dict().items():           # restored
        np.testing.assert_array_equal(_np(v), live[k])
        np.testing.assert_array_equal(_np(v), _np(jl.state_dict()[k]))
    # the swaps copied in place: each Parameter kept its leaf
    assert all(p._data is leaves[k] for k, p in tl.named_parameters())
    with emas[1].apply(need_restore=False):
        pass
    emas[1].restore()
    for k, v in tl.state_dict().items():
        np.testing.assert_array_equal(_np(v), live[k])


def test_data_gradients_and_places():
    for P in (jp, tp):
        spec = P.static.data("x", [None, 4], "float32")
        assert isinstance(spec, P.jit.InputSpec)
        assert spec.shape == [None, 4] and spec.name == "x"
        assert len(P.static.cpu_places(2)) == 2
        assert P.static.Variable is P.Tensor
    grads = []
    for P in (jp, tp):
        x = P.to_tensor(np.array([1.0, 2.0, 3.0], np.float32),
                        stop_gradient=False)
        (g,) = P.static.gradients([(x * x).sum()], [x])
        grads.append(_np(g))
    np.testing.assert_allclose(grads[1], grads[0])
    assert tp.static.cuda_places() == [
        tp.CUDAPlace(i) for i in range(torch.cuda.device_count())]


def test_graph_free_helpers_match_jax(capsys):
    out = []
    for P in (jp, tp):
        v = P.static.create_global_var([2, 2], 1.5, "float32",
                                       persistable=True, name="g")
        assert v.persistable and v.name == "g"
        p = P.static.create_parameter([3], "float32")
        assert list(p.shape) == [3] and not p.stop_gradient
        pred = P.to_tensor(np.array([[0.1, 0.9], [0.8, 0.2]], np.float32))
        lab = P.to_tensor(np.array([[1], [1]]))
        acc = P.static.accuracy(pred, lab)
        assert P.static.Print(v, message="v") is v
        scope = P.static.global_scope()
        scope.var("w")
        assert scope.find_var("w") is None and "w" in scope
        with P.static.name_scope("a"), P.static.device_guard("cpu"), \
                P.static.program_guard(None), P.static.scope_guard(None):
            pass
        assert P.static.py_func(lambda x: x + 1, 1, None) == 2
        out.append((_np(v), float(acc)))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1] == out[0][1] == 0.5
    assert "v" in capsys.readouterr().out


def test_load_helpers_and_the_inference_model(tmp_path):
    tl = _lin(tp, 3)
    tl.eval()
    path = str(tmp_path / "lin")
    tp.save(tl.state_dict(), path + ".pdparams")
    for fn in (tp.static.load, lambda _, p: tp.static.load_program_state(p)):
        state = fn(None, path)
        for k, v in tl.state_dict().items():
            np.testing.assert_array_equal(np.asarray(state[k]), _np(v))
    other = _lin(tp, 4)
    assert tp.static.set_program_state(other, tl.state_dict()) is other
    with pytest.raises(TypeError):
        tp.static.set_program_state(object(), {})
    tp.static.save_to_file(str(tmp_path / "b"), b"\x00\x01")
    assert tp.static.load_from_file(str(tmp_path / "b")) == b"\x00\x01"
    tp.jit.save(tl, str(tmp_path / "inf"),
                input_spec=[tp.jit.InputSpec([2, 4], "float32")])
    layer, feeds, fetches = tp.static.load_inference_model(
        str(tmp_path / "inf"), device="cpu")
    assert feeds == [] and fetches == []
    x = tp.to_tensor(np.random.default_rng(0).standard_normal(
        (2, 4)).astype(np.float32))
    np.testing.assert_allclose(_np(layer(x)), _np(tl(x)), rtol=1e-6)
