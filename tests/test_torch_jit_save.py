"""The port's jit (``InputSpec``, the Layer functionalization, ``TrainStep``
on a surface Layer, ``save`` / ``load``) and the paddle.inference
predictor against the JAX package's, on the CPU:

- a surface MLP (and a Layer with a buffer and a frozen parameter) and a
  2-layer ``BertModel`` saved and loaded by both packages from the same
  weights (``bridge``): the loaded artifacts agree within rtol 1e-5 /
  atol 1e-6 (f32; BERT's attention within rtol 1e-4 / atol 1e-5, the
  kernels' plain versions against XLA), and the ``.pdiparams`` carry the
  JAX keys (``params``, ``frozen``, ``buffers``, ``n_inputs``) and values
  (exact, up to the bridge's Linear transpose);
- the exported BERT graph holds the flash custom op
  ``paddle_tpu_torch::flash_fwd``, whose CPU implementation is the plain
  version (its counter, and equal to ``flash_plain`` bit for bit);
- the predictor round trip of ``tests/test_elastic_tuner_inference.py``,
  a perturbed artifact rejected, and the device chosen once at load
  (no GPU here: the default raises, ``disable_gpu()`` runs the CPU).
"""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.jit.functional import get_params as jax_get_params
from paddle_tpu.text.models import BertConfig as JaxBertConfig
from paddle_tpu.text.models import BertModel as JaxBertModel
import paddle_tpu_torch as tp
from paddle_tpu_torch import monitor
from paddle_tpu_torch.bridge import (bert_state_from_numpy,
                                     bert_state_to_numpy,
                                     layer_state_from_jax)
from paddle_tpu_torch.core import place as place_mod
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.text.models import BertConfig, BertModel

TOL = dict(rtol=1e-5, atol=1e-6)
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
NO_GPU = not torch.cuda.is_available()


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                           P.nn.Linear(16, 4))


def _normed(P):
    """A Layer with a buffer (BatchNorm1D's running stats) and a frozen
    parameter."""
    net = P.nn.Sequential(P.nn.Linear(8, 6), P.nn.BatchNorm1D(6),
                          P.nn.Linear(6, 3))
    net[2].bias.stop_gradient = True
    return net


def _pair(make, seed=0):
    jp.seed(seed)
    jm = make(jp)
    tm = make(tp)
    tm.set_state_dict(layer_state_from_jax(jm))
    for m in (jm, tm):
        m.eval()
    return jm, tm


@pytest.mark.parametrize("shape,dtype", [
    ([4, 8], "float32"), ([3, 8], "float32"), ([4, 8, 1], "float32"),
    ([4, 8], "int64"), ([4, 8], "float16")])
@pytest.mark.parametrize("spec", [([None, 8], "float32"),
                                  ([-1, 8], "float32"), ([4, 8], "float32"),
                                  ([4, 8], "int64"), ([4, 8], "floaat32")])
def test_input_spec_matches_like_jax(spec, shape, dtype):
    a = jp.jit.InputSpec(*spec).matches(shape, np.dtype(dtype))
    b = tp.jit.InputSpec(*spec).matches(shape, np.dtype(dtype))
    assert (a is None) == (b is None)
    assert repr(tp.jit.InputSpec(*spec)) == repr(jp.jit.InputSpec(*spec))


def test_functional_helpers_name_the_jax_state():
    jm, tm = _pair(_normed)
    for name in ("get_params", "get_buffers"):
        a = getattr(jp.jit, name)(jm)
        b = getattr(tp.jit, name)(tm)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          b[k].detach().numpy())
    x = _x((5, 8))
    params = {k: v * 2 for k, v in tp.jit.get_params(tm).items()}
    out, bufs = tp.jit.functional_call(tm, params, tp.jit.get_buffers(tm),
                                       [torch.from_numpy(x)],
                                       training=False)
    jparams = {k: v * 2 for k, v in jp.jit.get_params(jm).items()}
    jout, _ = jp.jit.functional_call(jm, jparams, jp.jit.get_buffers(jm),
                                     [jp.to_tensor(x)._data],
                                     training=False)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    assert sorted(bufs) == sorted(tp.jit.get_buffers(tm))
    # the layer's own tensors are back after the call
    assert tm[0].weight._data is tp.jit.get_params(tm)["0.weight"]


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_trainstep_takes_a_surface_layer_like_jax(amp):
    jm, tm = _pair(_mlp)
    x, y = _x((12, 8), 1), np.random.default_rng(2).integers(0, 4, 12)
    losses = []
    leaves = [p._data for p in tm.parameters()]
    for P, m in ((jp, jm), (tp, tm)):
        opt = P.optimizer.AdamW(1e-3, parameters=m.parameters())
        step = P.jit.TrainStep(m, P.nn.CrossEntropyLoss(), opt,
                               amp_dtype=amp)
        losses.append([float(step(P.to_tensor(x), P.to_tensor(y)))
                       for _ in range(3)])
        step.sync_to_model()
    np.testing.assert_allclose(losses[1], losses[0],
                               **(TOL if amp is None else dict(rtol=2e-2)))
    # updated in place, f32 masters
    assert all(p._data is leaf and p.dtype.name == "float32"
               for p, leaf in zip(tm.parameters(), leaves))
    if amp is None:
        for (n, a), (_, b) in zip(jm.state_dict().items(),
                                  tm.state_dict().items()):
            np.testing.assert_allclose(b.numpy(), np.asarray(a.numpy()),
                                       rtol=1e-4, atol=1e-6, err_msg=n)


def _pickle(path):
    with open(path + ".pdiparams", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("make,spec", [(_mlp, ([4, 8], "float32")),
                                       (_normed, ([-1, 8], "float32"))],
                         ids=["mlp", "buffers_frozen"])
def test_save_load_matches_jax(tmp_path, make, spec):
    jm, tm = _pair(make)
    for P, m, d in ((jp, jm, "jax"), (tp, tm, "port")):
        P.jit.save(m, str(tmp_path / d / "net"),
                   input_spec=[P.jit.InputSpec(*spec)])
    x = _x((4 if spec[0][0] == 4 else 1, 8), 3)
    a = jp.jit.load(str(tmp_path / "jax" / "net"))(jp.to_tensor(x))
    loaded = tp.jit.load(str(tmp_path / "port" / "net"), device="cpu")
    b = loaded(tp.to_tensor(x))
    np.testing.assert_allclose(b.numpy(), np.asarray(a.numpy()), **TOL)
    np.testing.assert_allclose(b.numpy(), tm(tp.to_tensor(x)).numpy(), **TOL)
    pa, pb = (_pickle(str(tmp_path / d / "net")) for d in ("jax", "port"))
    assert sorted(pa) == sorted(pb) == ["buffers", "frozen", "n_inputs",
                                        "params"]
    assert pa["n_inputs"] == pb["n_inputs"] == 1
    for part in ("params", "frozen", "buffers"):
        assert sorted(pa[part]) == sorted(pb[part])
        for k in pa[part]:
            np.testing.assert_array_equal(pb[part][k], pa[part][k])
    assert loaded.eval() is loaded
    with pytest.raises(RuntimeError, match="cannot be trained"):
        loaded.train()
    with pytest.raises(ValueError, match="input_spec"):
        tp.jit.save(tm, str(tmp_path / "x"))


def _bert_pair(seed=1):
    jp.seed(seed)
    jc = JaxBertConfig.tiny(vocab=64, hidden=32, layers=2, heads=2)
    jnet = JaxBertModel(jc)
    params = {k: np.asarray(v, np.float32)
              for k, v in jax_get_params(jnet).items()}
    tnet = BertModel(BertConfig(**vars(jc)), device="cpu")
    tnet.load_state_dict(bert_state_from_numpy(params))
    jnet.eval()
    tnet.eval()
    return jnet, tnet, params


def test_bert_artifact_matches_jax_and_holds_the_flash_op(tmp_path):
    jnet, tnet, params = _bert_pair()
    ids = np.random.default_rng(4).integers(0, 64, (2, 16)).astype(np.int64)
    jp.jit.save(jnet, str(tmp_path / "jax" / "bert"),
                input_spec=[jp.jit.InputSpec([2, 16], "int64")])
    tp.jit.save(tnet, str(tmp_path / "port" / "bert"),
                input_spec=[tp.jit.InputSpec([2, 16], "int64")])
    want = jp.jit.load(str(tmp_path / "jax" / "bert"))(jp.to_tensor(ids))
    loaded = tp.jit.load(str(tmp_path / "port" / "bert"), device="cpu")
    monitor.reset()
    got = loaded(torch.from_numpy(ids))
    # the op's CPU implementation ran the plain version, once a layer
    assert monitor.snapshot().get("kernels.flash.fwd_plain") == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   **ATTN_TOL)
    with torch.no_grad():
        eager = tnet(torch.from_numpy(ids))
    for g, e in zip(got, eager):
        np.testing.assert_allclose(g.numpy(), e.numpy(), **TOL)
    # the .pdiparams: the JAX keys, the JAX values through the bridge
    pa, pb = (_pickle(str(tmp_path / d / "bert")) for d in ("jax", "port"))
    assert sorted(pa["params"]) == sorted(pb["params"])
    port_in_jax_layout = bert_state_to_numpy(
        {k: torch.from_numpy(v) for k, v in pb["params"].items()})
    for k, v in pa["params"].items():
        np.testing.assert_array_equal(port_in_jax_layout[k], v, err_msg=k)
    assert pb["n_inputs"] == pa["n_inputs"] == 1
    # the exported graph holds the custom op (and no ctypes launch)
    with open(str(tmp_path / "port" / "bert.pdmodel"), "rb") as f:
        import io
        ep = torch.export.load(io.BytesIO(f.read()))
    ops = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.paddle_tpu_torch.flash_fwd.default) == 2
    # the weights live in the .pdiparams only: the program keeps neither a
    # state dict nor the example inputs, and no constant but scalars
    assert ep.example_inputs is None and not ep.state_dict
    assert all(c.numel() <= 1 for c in ep.constants.values())


@pytest.mark.parametrize("causal,window,heads_kv", [(False, None, 4),
                                                    (True, None, 2),
                                                    (True, 3, 4)])
def test_flash_custom_op_cpu_is_the_plain_version(causal, window, heads_kv):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 9, 4, 16, generator=g)
    k = torch.randn(2, 9, heads_kv, 16, generator=g)
    v = torch.randn(2, 9, heads_kv, 16, generator=g)
    got = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, None, causal, 0.25,
                                               window)
    want = fa.flash_plain(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal, 0.25,
                          window).transpose(1, 2)
    assert torch.equal(got, want) and got.is_contiguous()
    fake = fa._flash_fwd_fake(q, k, v, None, causal, 0.25, window)
    assert fake.shape == got.shape and fake.dtype == got.dtype
    # traced (torch.export), the no-grad entry goes through the op
    class Attn(torch.nn.Module):
        def forward(self, q, k, v):
            return fa.flash_attention_arrays(q, k, v, causal=causal,
                                             window=window, scale=0.25)
    with torch.no_grad():
        ep = torch.export.export(Attn(), (q, k, v), strict=False)
    assert torch.equal(ep.module()(q, k, v), want)


def test_predictor_round_trip_matches_jax(tmp_path):
    """tests/test_elastic_tuner_inference.py:12 on both packages."""
    jm, tm = _pair(_mlp)
    x = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
    outs = []
    for P, m, d in ((jp, jm, "jax"), (tp, tm, "port")):
        prefix = str(tmp_path / d / "model")
        P.jit.save(m, prefix, input_spec=[P.jit.InputSpec([2, 8],
                                                           "float32")])
        cfg = P.inference.Config(prefix + ".pdmodel")
        if P is tp:
            cfg.disable_gpu()
            assert not cfg.use_gpu()
        pred = P.inference.create_predictor(cfg)
        name = pred.get_input_names()[0]
        pred.get_input_handle(name).copy_from_cpu(x)
        assert pred.run() is True
        outs.append(pred.get_output_handle(
            pred.get_output_names()[0]).copy_to_cpu())
        listed = pred.run([x])
        np.testing.assert_array_equal(listed[0], outs[-1])
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    np.testing.assert_allclose(outs[1], tm(tp.to_tensor(x)).numpy(), **TOL)
    # the device is chosen once, at load: without a GPU the default raises
    if NO_GPU:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.inference.create_predictor(tp.inference.Config(
                str(tmp_path / "port" / "model.pdmodel")))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.jit.load(str(tmp_path / "port" / "model"))
    cfg = tp.inference.Config(model_dir=str(tmp_path / "port"))
    cfg.disable_gpu()
    pool = tp.inference.PredictorPool(cfg, size=2)
    assert pool.retrive(1).run([x])[0].shape == (2, 4)


def test_a_perturbed_artifact_is_rejected(tmp_path):
    jnet, tnet, _ = _bert_pair()
    prefix = str(tmp_path / "bert")
    tp.jit.save(tnet, prefix, input_spec=[tp.jit.InputSpec([2, 16],
                                                           "int64")])
    st = _pickle(prefix)
    st["params"]["encoder.0.attention.qkv.weight"][0, 0] += 0.5
    with open(prefix + "_bad.pdiparams", "wb") as f:
        pickle.dump(st, f)
    import shutil
    shutil.copy(prefix + ".pdmodel", prefix + "_bad.pdmodel")
    ids = np.random.default_rng(5).integers(0, 64, (2, 16))
    with torch.no_grad():
        want = tnet(torch.from_numpy(ids))[0].numpy()
    for path, ok in ((prefix, True), (prefix + "_bad", False)):
        cfg = tp.inference.Config(path + ".pdmodel")
        cfg.disable_gpu()
        got = tp.inference.create_predictor(cfg).run([ids])[0]
        close = np.allclose(got, want, **TOL)
        assert close == ok, path


def test_inference_enums_and_versions():
    I = tp.inference
    assert I.get_num_bytes_of_data_type(I.DataType.BFLOAT16) == 2
    assert I.get_num_bytes_of_data_type(I.DataType.INT64) == 8
    assert I.get_trt_compile_version() == I.get_trt_runtime_version() == \
        (0, 0, 0)
    assert "paddle_tpu_torch" in I.get_version()
    assert [m.name for m in I.PrecisionType] == \
        [m.name for m in jp.inference.PrecisionType]
    assert [m.name for m in I.PlaceType] == \
        [m.name for m in jp.inference.PlaceType]
    t = I.Tensor()
    t.copy_from_cpu(np.arange(6, dtype=np.float32))
    t.reshape([2, 3])
    assert t.shape() == [2, 3] and t.copy_to_cpu().sum() == 15
    with pytest.raises(FileNotFoundError):
        I.Config(model_dir="/nonexistent-dir-for-the-test")
    tp.jit.ignore_module([np])
    tp.jit.set_verbosity(1)
    tp.jit.set_code_level(50)
