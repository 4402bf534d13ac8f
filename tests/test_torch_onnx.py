"""``paddle.onnx.export`` of the port (``paddle_tpu_torch.onnx``) against
the JAX package's, on the CPU: the models of ``tests/test_onnx_export.py``
(an MLP, a LeNet-style conv stack, BatchNorm + Dropout, a dynamic batch,
a partial Flatten as Reshape, a rank-3 Linear as MatMul + Add, two BERT
encoder layers and an embedding Gather) built in both packages with the
same weights. Both files parse to the same nodes and attributes, their
initializers are bit-equal, and the graph, run by the JAX test's numpy
evaluator (and the BERT stacks also by ``chip_smoke.run_onnx``, the
evaluator of phase 27 (e)), gives the port's forward. The BERT layers are the port's ``text.models.bert`` modules
(``torch.nn.Module``s holding torch's [out, in] linears), so their
weights cross layouts on the way in and on the way out. An unsupported
layer raises in both.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.jit.functional import get_params
from paddle_tpu.onnx import _proto as JP
from paddle_tpu.text.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.models.bert import BertEncoderLayer as JaxBertLayer
import paddle_tpu_torch as tp
from paddle_tpu_torch.bridge import bert_state_from_numpy, \
    layer_state_from_jax
from paddle_tpu_torch.onnx import _proto as TP
from paddle_tpu_torch.text.models.bert import BertConfig, BertEncoderLayer
from test_onnx_export import _run_onnx
from test_torch_parity_util import cpu_place  # noqa: F401  (fixture)


def _chip_smoke_run_onnx():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_onnx


run_onnx = _chip_smoke_run_onnx()


@pytest.fixture(autouse=True)
def _port_on_cpu(cpu_place):  # noqa: F811
    yield


def _mlp(P):
    nn = P.nn
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4),
                         nn.Softmax())


def _lenet(P):
    nn = P.nn
    return nn.Sequential(
        nn.Conv2D(1, 4, 3, stride=1, padding=1), nn.ReLU(),
        nn.MaxPool2D(2, 2), nn.Conv2D(4, 8, 5, stride=1, padding=0),
        nn.ReLU(), nn.MaxPool2D(2, 2), nn.Flatten(), nn.Linear(200, 10))


def _bn(P):
    nn = P.nn
    return nn.Sequential(nn.Conv2D(3, 6, 1), nn.BatchNorm2D(6),
                         nn.Dropout(0.5), nn.AvgPool2D(2, 2))


#: name -> (builder, input spec shape, dtype, input shape, op types)
SURFACE = {
    "mlp": (_mlp, [2, 8], "float32", (2, 8),
            ["Gemm", "Relu", "Gemm", "Softmax"]),
    "lenet": (_lenet, [2, 1, 28, 28], "float32", (2, 1, 28, 28),
              ["Conv", "Relu", "MaxPool", "Conv", "Relu", "MaxPool",
               "Flatten", "Gemm"]),
    "batchnorm_dropout": (_bn, [1, 3, 8, 8], "float32", (1, 3, 8, 8),
                          ["Conv", "BatchNormalization", "AveragePool"]),
    "dynamic_batch": (lambda P: P.nn.Sequential(P.nn.Linear(8, 4)),
                      [None, 8], "float32", (32, 8), ["Gemm"]),
    "partial_flatten": (lambda P: P.nn.Sequential(P.nn.Flatten(1, 2),
                                                  P.nn.Flatten()),
                        [2, 3, 4, 5], "float32", (2, 3, 4, 5),
                        ["Reshape", "Flatten"]),
    "rank3_linear": (lambda P: P.nn.Sequential(
        P.nn.Linear(8, 4), P.nn.ReLU(), P.nn.Linear(4, 2)),
        [2, 3, 8], "float32", (2, 3, 8),
        ["MatMul", "Add", "Relu", "MatMul", "Add"]),
    "embedding_gather": (lambda P: P.nn.Sequential(P.nn.Embedding(50, 16),
                                                   P.nn.Linear(16, 4)),
                         [2, 7], "int64", (2, 7), None),
}


def _input(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int64":
        return rng.integers(0, 50, shape)
    return rng.standard_normal(shape).astype(np.float32)


def _export(P, net, path, spec, dtype):
    fname = P.onnx.export(net, str(path),
                          input_spec=[P.jit.InputSpec(spec, dtype)])
    assert fname.endswith(".onnx")
    return fname


def _same_graph(jfile, tfile):
    """Both files: the same nodes (op, inputs, outputs, attributes), graph
    inputs / outputs and opset; bit-equal initializers. Returns the port's
    parsed model."""
    jm = JP.parse_model(open(jfile, "rb").read())
    tm = TP.parse_model(open(tfile, "rb").read())
    assert tm["opset"] == jm["opset"]
    jg, tg = jm["graph"], tm["graph"]
    assert len(tg["nodes"]) == len(jg["nodes"])
    for tn, jn in zip(tg["nodes"], jg["nodes"]):
        for key in ("op_type", "inputs", "outputs"):
            assert tn[key] == jn[key], (key, tn, jn)
        assert tn["attrs"].keys() == jn["attrs"].keys()
        for k, v in jn["attrs"].items():
            np.testing.assert_array_equal(np.asarray(tn["attrs"][k]),
                                          np.asarray(v), err_msg=k)
    assert tg["outputs"] == jg["outputs"]
    assert tg["initializers"].keys() == jg["initializers"].keys()
    for k, v in jg["initializers"].items():
        got = tg["initializers"][k]
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    return tm


@pytest.mark.parametrize("name", sorted(SURFACE))
def test_surface_models_export_as_jax_does(name, tmp_path):
    build, spec, dtype, shape, ops = SURFACE[name]
    jp.seed(5)
    jnet = build(jp)
    jnet.eval()
    tp.seed(5)
    tnet = build(tp)
    missing, unexpected = tnet.set_state_dict(layer_state_from_jax(jnet))
    assert not missing and not unexpected
    tnet.eval()
    jfile = _export(jp, jnet, tmp_path / "jax", spec, dtype)
    tfile = _export(tp, tnet, tmp_path / "port", spec, dtype)
    model = _same_graph(jfile, tfile)
    kinds = [n["op_type"] for n in model["graph"]["nodes"]]
    if ops is not None:
        assert kinds == ops
    else:
        assert kinds[0] == "Gather"
    x = _input(dtype, shape, seed=len(name))
    want = np.asarray(tnet(tp.to_tensor(x)).numpy())
    got = _run_onnx(model, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bert_encoder_layers_export_as_jax_does(tmp_path):
    """Two BERT encoder layers: the JAX package's (surface Linears,
    [in, out]) and the port's ``text.models.bert`` modules (torch's
    [out, in], loaded through ``bridge.bert_state_from_numpy``). The port
    transposes each torch linear back, the fused qkv before slicing it:
    the files agree bit for bit, where a missing transpose of the square
    q / k / v / out weights would raise no shape error."""
    jp.seed(4)
    jc = JaxBertConfig.tiny(vocab=64, hidden=32, layers=2, heads=4)
    jnet = jp.nn.Sequential(JaxBertLayer(jc), JaxBertLayer(jc))
    jnet.eval()
    params = {k: np.asarray(v, np.float32)
              for k, v in get_params(jnet).items()}
    cfg = BertConfig(**dataclasses.asdict(jc))
    tnet = torch.nn.Sequential(BertEncoderLayer(cfg, device="cpu"),
                               BertEncoderLayer(cfg, device="cpu"))
    tnet.load_state_dict(bert_state_from_numpy(params))
    tnet.eval()
    b, s = 2, 10
    spec = [b, s, jc.hidden_size]
    jfile = _export(jp, jnet, tmp_path / "jax", spec, "float32")
    tfile = _export(tp, tnet, tmp_path / "port", spec, "float32")
    model = _same_graph(jfile, tfile)
    ops = [n["op_type"] for n in model["graph"]["nodes"]]
    assert {"Softmax", "LayerNormalization", "Gelu", "Transpose"} <= \
        set(ops)
    x = np.random.default_rng(4).standard_normal(spec).astype(np.float32)
    with torch.no_grad():
        want = tnet(torch.from_numpy(x)).numpy()
    for run in (run_onnx, _run_onnx):
        np.testing.assert_allclose(run(model, x), want, rtol=2e-4,
                                   atol=2e-5)
    # the transposes matter: the qkv weight read untransposed (as a JAX
    # [h, 3h] weight would be read) gives another graph
    w = model["graph"]["initializers"]
    qkv = tnet[0].attention.qkv.weight.detach().numpy()
    first = next(k for k in w if k.startswith("wq"))
    np.testing.assert_array_equal(w[first], qkv[:jc.hidden_size].T)
    assert not np.array_equal(w[first], qkv.T[:, :jc.hidden_size].T)


def test_a_bert_stack_exports_with_a_symbolic_batch(tmp_path):
    cfg = BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                     num_attention_heads=4, intermediate_size=64)
    torch.manual_seed(0)
    tnet = torch.nn.ModuleList([BertEncoderLayer(cfg, device="cpu")])
    for p in tnet.parameters():
        torch.nn.init.normal_(p, std=0.2)
    tnet.eval()
    fname = _export(tp, tnet, tmp_path / "stack", [None, 6, 32], "float32")
    model = TP.parse_model(open(fname, "rb").read())
    x = np.random.default_rng(1).standard_normal((3, 6, 32)).astype(
        np.float32)
    with torch.no_grad():
        want = tnet[0](torch.from_numpy(x)).numpy()
    for run in (run_onnx, _run_onnx):
        np.testing.assert_allclose(run(model, x), want, rtol=2e-4,
                                   atol=2e-5)


def test_unsupported_layers_raise_in_both(tmp_path):
    for P in (jp, tp):
        net = P.nn.Sequential(P.nn.LSTM(4, 4))
        with pytest.raises(NotImplementedError, match="jit.save"):
            P.onnx.export(net, str(tmp_path / "x"),
                          input_spec=[P.jit.InputSpec([1, 4, 4],
                                                      "float32")])
        with pytest.raises(ValueError, match="input_spec"):
            P.onnx.export(P.nn.Sequential(P.nn.Linear(2, 2)),
                          str(tmp_path / "y"))
    with pytest.raises(NotImplementedError, match="op set"):
        run_onnx({"graph": {"initializers": {}, "outputs": ["y"],
                             "nodes": [{"op_type": "Cos", "inputs": [],
                                        "outputs": ["y"], "attrs": {}}]}},
                  np.zeros(1))


def test_softmax_axis_is_the_layers(tmp_path):
    """Divergence by design: the port's exporter writes a Softmax layer's
    own axis (``_axis``); the JAX exporter reads an ``axis`` attribute the
    layer does not have and always writes -1."""
    files = {}
    for P in (jp, tp):
        P.seed(0)
        net = P.nn.Sequential(P.nn.Linear(4, 3), P.nn.Softmax(axis=0))
        files[P] = (net, _export(P, net, tmp_path / P.__name__, [5, 4],
                                 "float32"))
    axis = {P: TP.parse_model(open(f, "rb").read())["graph"]["nodes"][-1][
        "attrs"]["axis"] for P, (_, f) in files.items()}
    assert axis == {jp: -1, tp: 0}
    net, f = files[tp]
    x = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        _run_onnx(TP.parse_model(open(f, "rb").read()), x),
        np.asarray(net(tp.to_tensor(x)).numpy()), rtol=1e-5, atol=1e-6)
