"""The port's quantization surface (``paddle_tpu_torch.quantization``,
``paddle_tpu_torch.nn.quant``) held to the JAX package on the same seeded
numpy inputs, and weight-only int8 / int4 serving of the port's LLaMA held
to the JAX converted model.

Tolerances:

- ``weight_quantize``: exact on f32 weights (int8 values and scales
  equal), and on bf16 int8 weights; bf16 int4's per-group choice of
  scale sums squared errors in bf16, whose order may differ, so at most
  2% of the (group, column) choices may differ and the dequantized
  weight stays within one int4 step of the JAX one (it was 0% on the
  seeds here);
- the fake-quant ops, ``quantize_linear`` / ``dequantize_linear`` and
  ``weight_dequantize``: exact values (the same elementwise f32 ops),
  gradients within rtol 1e-5;
- the linears: rtol 1e-5, atol 1e-5 (f32 products summed in another
  order; ``llm_int8_linear``'s int32 product is exact in both);
- converted models: buffers exact, outputs rtol 1e-4, atol 1e-5, greedy
  tokens equal.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.engine import SamplingParams as JaxParams
from paddle_tpu.nn import quant as jquant
from paddle_tpu import quantization as jq
from paddle_tpu.quantization import functional as jqf
from paddle_tpu.text.generation import generate as jax_generate
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.bridge import (layer_state_from_jax,
                                     llama_state_from_numpy,
                                     llama_state_to_numpy)
from paddle_tpu_torch.inference import Engine, SamplingParams
from paddle_tpu_torch.nn import quant as tquant
from paddle_tpu_torch.quantization import functional as tqf
from paddle_tpu_torch.text import generate
from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

from test_torch_engine import _drive, torch_one_thread  # noqa: F401
from test_torch_llama import make_pair
from test_torch_parity_util import arr, cpu_place, run_both  # noqa: F401

EXACT = dict(rtol=0, atol=0)
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _cpu(cpu_place, torch_one_thread):
    yield


def _np(t):
    return np.asarray(t.numpy())


def _weight(k, n, seed=0, scale=0.05):
    return (np.random.default_rng(seed).standard_normal((k, n)) * scale
            ).astype(np.float32)


# -- functional -----------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quantize_ops_match_jax(bits):
    x = arr(6, 10, seed=1, lo=-3, hi=3)
    run_both(lambda a: jqf.fake_quantize_abs_max(a, bits),
             lambda a: tqf.fake_quantize_abs_max(a, bits), [x], tol=EXACT,
             grad_tol=TOL)
    run_both(lambda a: jqf.fake_quantize_dequantize_abs_max(a, bits),
             lambda a: tqf.fake_quantize_dequantize_abs_max(a, bits), [x],
             tol=EXACT, grad_tol=TOL)
    for axis in (0, 1):
        run_both(lambda a: jqf.fake_channel_wise_quantize_dequantize_abs_max(
            a, bits, quant_axis=axis),
            lambda a: tqf.fake_channel_wise_quantize_dequantize_abs_max(
                a, bits, quant_axis=axis), [x], tol=EXACT, grad_tol=TOL)


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_and_dequantize_linear_match_jax(per_channel):
    x = arr(4, 6, seed=2, lo=-2, hi=2)
    s = arr(6, seed=3, lo=0.01, hi=0.05) if per_channel else \
        np.float32(0.02)
    run_both(lambda a, b: jqf.quantize_linear(a, b, bit_length=8),
             lambda a, b: tqf.quantize_linear(a, b, bit_length=8),
             [x, s], grad=False, tol=EXACT)
    q = np.round(x * 40).astype(np.float32)
    run_both(lambda a, b: jqf.dequantize_linear(a, b, zero_point=1.0),
             lambda a, b: tqf.dequantize_linear(a, b, zero_point=1.0),
             [q, s], tol=EXACT, grad_tol=TOL)


WEIGHT_CASES = [("weight_only_int8", -1), ("weight_only_int8", 16),
                ("llm.int8", -1), ("weight_only_int4", -1),
                ("weight_only_int4", 0), ("weight_only_int4", 32)]


@pytest.mark.parametrize("algo,group_size", WEIGHT_CASES)
def test_weight_quantize_matches_jax_on_f32(algo, group_size):
    w = _weight(64, 48, seed=4)
    jqq, js = jqf.weight_quantize(jp.to_tensor(w), algo=algo,
                                  group_size=group_size)
    tqq, ts = tqf.weight_quantize(tp.to_tensor(w), algo=algo,
                                  group_size=group_size)
    assert str(tqq.dtype) == "paddle_tpu_torch.int8" or \
        tqq._data.dtype == torch.int8
    np.testing.assert_array_equal(_np(tqq), _np(jqq))
    np.testing.assert_array_equal(_np(ts), _np(js))
    bound = 7 if algo == "weight_only_int4" else 127
    assert np.abs(_np(tqq)).max() <= bound + (algo == "weight_only_int4")
    # the round trip: exact against JAX, and within half a step of w
    back = _np(tqf.weight_dequantize(tqq, ts))
    np.testing.assert_array_equal(back, _np(jqf.weight_dequantize(jqq, js)))
    step = np.repeat(_np(ts).reshape(-1, 48),
                     64 // _np(ts).reshape(-1, 48).shape[0], axis=0)
    assert (np.abs(back - w) <= 0.5 * step * (1 + 1e-6) + 1e-12).all() or \
        algo == "weight_only_int4"


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_weight_quantize_bf16_in_the_weight_dtype(algo):
    w = _weight(256, 96, seed=5, scale=0.02)
    jw = jp.to_tensor(w).astype("bfloat16")
    tw = torch.from_numpy(w).to(torch.bfloat16)
    jqq, js = jqf.weight_quantize(jw, algo=algo)
    tqq, ts = tqf.weight_quantize(tw, algo=algo)
    assert ts.dtype == torch.bfloat16          # not upcast
    js_f = _np(js.astype("float32"))
    if algo == "weight_only_int8":
        np.testing.assert_array_equal(tqq.numpy(), _np(jqq))
        np.testing.assert_array_equal(ts.float().numpy(), js_f)
        return
    differ = (ts.float().numpy() != js_f).mean()
    assert differ <= 0.02, differ
    back = tqf.weight_dequantize(tqq, ts).numpy()
    jback = _np(jqf.weight_dequantize(jqq, js))
    step = np.repeat(np.maximum(ts.float().numpy(), js_f), 16, axis=0)
    assert (np.abs(back - jback) <= step).all()


def test_weight_quantize_refuses_an_unknown_algo():
    with pytest.raises(ValueError):
        tqf.weight_quantize(torch.zeros(4, 4), algo="int3")
    with pytest.raises(ValueError):
        tqf.weight_quantize(torch.zeros(12, 4), group_size=8)


def test_kv_quantizers_keep_their_raw_contract():
    x = torch.from_numpy(arr(3, 2, 8, seed=6))
    q, s = tq.kv_quantize_arrays(x)
    assert q.dtype == torch.int8 and s.shape == (3, 2)
    back = tq.kv_dequantize_arrays(q, s)
    assert float((back - x).abs().max()) <= float(s.max()) * 0.5 + 1e-7


# -- nn.quant ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["per_column", "per_group_int8", "int4",
                                  "no_scale"])
def test_weight_only_linear_matches_jax(case):
    w = _weight(64, 32, seed=7)
    x = arr(2, 5, 64, seed=8)
    b = arr(32, seed=9)
    algo, gs = {"per_column": ("weight_only_int8", -1),
                "per_group_int8": ("weight_only_int8", 16),
                "int4": ("weight_only_int4", -1),
                "no_scale": ("weight_only_int8", -1)}[case]
    q, s = (np.asarray(v.numpy()) for v in jqf.weight_quantize(
        jp.to_tensor(w), algo=algo, group_size=gs))
    wd = "int4" if "int4" in algo else "int8"
    if case == "no_scale":
        run_both(lambda a, ww, bb: jquant.weight_only_linear(a, ww, bb),
                 lambda a, ww, bb: tquant.weight_only_linear(a, ww, bb),
                 [x, w, b], tol=TOL)
        return
    out = run_both(
        lambda a, qq, ss, bb: jquant.weight_only_linear(
            a, qq, bb, ss, weight_dtype=wd),
        lambda a, qq, ss, bb: tquant.weight_only_linear(
            a, qq, bb, ss, weight_dtype=wd),
        [x, q, s, b], tol=TOL)
    # and within quantization error of the float linear
    ref = x @ w + b
    rel = np.abs(_np(out[0]) - ref).max() / np.abs(ref).max()
    assert rel < (0.12 if wd == "int4" else 0.02), rel


@pytest.mark.parametrize("threshold", [6.0, 0.0])
def test_llm_int8_linear_matches_jax(threshold):
    w = _weight(64, 40, seed=10)
    x = arr(3, 4, 64, seed=11, lo=-2, hi=2)
    x[..., 7] *= 30.0                      # an outlier feature column
    b = arr(40, seed=12)
    q, s = (np.asarray(v.numpy()) for v in jqf.weight_quantize(
        jp.to_tensor(w), algo="llm.int8"))
    run_both(lambda a, qq, ss, bb: jquant.llm_int8_linear(
        a, qq, bb, ss, threshold=threshold),
        lambda a, qq, ss, bb: tquant.llm_int8_linear(
            a, qq, bb, ss, threshold=threshold),
        [x, q, s, b], tol=TOL, int_args=(1,))
    with pytest.raises(ValueError):
        tquant.llm_int8_linear(tp.to_tensor(x), tp.to_tensor(w))


def test_int8_matmul_cpu_route_is_exact():
    rng = np.random.default_rng(13)
    a = rng.integers(-127, 128, (5, 24)).astype(np.int8)
    b = rng.integers(-127, 128, (24, 9)).astype(np.int8)
    got = tquant.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def test_stub_and_quant_layer_names():
    x = tp.to_tensor(arr(2, 3, seed=14))
    assert tquant.Stub()(x) is x
    ql = tquant.quant_layers
    for name in ("QuantedWrapper", "QuanterBase", "FakeQuanterWithAbsMax",
                 "FakeQuantAbsMax"):
        assert hasattr(ql, name) and hasattr(jquant.quant_layers, name)
    assert ql.FakeQuantAbsMax is tq.FakeQuanterWithAbsMax


# -- layers, QAT, PTQ -------------------------------------------------------

def _mlp_pair(seed=7, conv=False):
    jp.seed(seed)

    def build(nn):
        return nn.Sequential(nn.Linear(32, 64), nn.ReLU(), nn.Linear(64, 8))
    jnet = build(jnn)
    tnet = build(tnn)
    tnet.set_state_dict(layer_state_from_jax(jnet))
    return jnet, tnet


def test_quanter_and_observer_match_jax():
    x = arr(4, 6, seed=15, lo=-3, hi=3)
    run_both(lambda a: jq.FakeQuanterWithAbsMax(4)(a),
             lambda a: tq.FakeQuanterWithAbsMax(4)(a), [x], tol=EXACT,
             grad_tol=TOL)
    jo, to = jq.AbsmaxObserver(8), tq.AbsmaxObserver(8)
    for i in range(3):
        a = arr(5, seed=20 + i, lo=-4, hi=2)
        jo(jp.to_tensor(a))
        to(tp.to_tensor(a))
    assert to.scales() == jo.scales() and to.zero_points() == 0
    assert tq.BaseObserver().scales() == 1.0
    assert tq.quanter("mine")(tq.FakeQuanterWithAbsMax) is \
        tq.FakeQuanterWithAbsMax


def test_ptq_convert_matches_jax():
    jnet, tnet = _mlp_pair()
    x = arr(4, 32, seed=16)
    jptq = jq.PTQ(jq.QuantConfig(activation=None, weight=None))
    tptq = tq.PTQ(tq.QuantConfig(activation=None, weight=None))
    jm, tm = jptq.quantize(jnet), tptq.quantize(tnet)
    assert tm is not tnet                         # inplace=False copies
    np.testing.assert_allclose(_np(tm(tp.to_tensor(x))),
                               _np(jm(jp.to_tensor(x))), **MODEL_TOL)
    jc, tc = jptq.convert(jm), tptq.convert(tm)
    wols = [s for _, s in tc.named_sublayers()
            if isinstance(s, tq.WeightOnlyLinear)]
    assert len(wols) == 2 and wols[0].weight._data.dtype == torch.int8
    jsd, tsd = jc.state_dict(), tc.state_dict()
    assert sorted(jsd) == sorted(tsd)
    for k in jsd:
        np.testing.assert_array_equal(_np(tsd[k]), _np(jsd[k]), err_msg=k)
    np.testing.assert_allclose(_np(tc(tp.to_tensor(x))),
                               _np(jc(jp.to_tensor(x))), **MODEL_TOL)
    # the caller's float model is untouched
    assert isinstance(tnet[0], tnn.Linear)


def test_ptq_convert_int4_and_inplace():
    jnet, tnet = _mlp_pair(seed=3)
    cfg = dict(activation=None, weight=None, bit_length=4)
    jc = jq.PTQ(jq.QuantConfig(**cfg)).convert(
        jq.PTQ(jq.QuantConfig(**cfg)).quantize(jnet))
    tptq = tq.PTQ(tq.QuantConfig(**cfg))
    wrapped = tptq.quantize(tnet, inplace=True)
    assert wrapped is tnet
    tc = tptq.convert(wrapped, inplace=True)
    assert tc is tnet and tc[0].weight_dtype == "int4"
    for k, v in jc.state_dict().items():
        np.testing.assert_array_equal(_np(tc.state_dict()[k]), _np(v),
                                      err_msg=k)


def test_qat_forward_and_gradients_match_jax():
    """Input fake quant: zero gradient through the rounding in both
    packages (the absmax scale's kept); weight fake quant: the
    straight-through gradient, as the JAX wrapper runs the inner layer on
    the weight parameter holding the fake-quantized array."""
    jnet, tnet = _mlp_pair(seed=11)
    cfg = dict(activation=None, weight=None, bit_length=8)
    jm = jq.QAT(jq.QuantConfig(**cfg)).quantize(jnet)
    tm = tq.QAT(tq.QuantConfig(**cfg)).quantize(tnet)
    x = arr(4, 32, seed=17, lo=-2, hi=2)
    jx = jp.to_tensor(x, stop_gradient=False)
    tx = tp.to_tensor(x, stop_gradient=False)
    jout, tout = jm(jx), tm(tx)
    np.testing.assert_allclose(_np(tout), _np(jout), **MODEL_TOL)
    w = np.random.default_rng(18).standard_normal((4, 8)).astype(np.float32)
    (jout * jp.to_tensor(w)).sum().backward()
    (tout * tp.to_tensor(w)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), **MODEL_TOL)
    jps = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(jps[name].grad),
                                   **MODEL_TOL, err_msg=name)
    # the float weights themselves are kept (the fake quant is per call)
    np.testing.assert_array_equal(_np(tm[0].inner.weight),
                                  _np(jm[0].inner.weight))


def test_weight_only_linear_layer_and_surface_quantize_for_inference():
    jnet, tnet = _mlp_pair(seed=5)
    x = arr(3, 32, seed=19)
    jq.quantize_for_inference(jnet, weight_dtype="int4")
    tq.quantize_for_inference(tnet, weight_dtype="int4")
    assert isinstance(tnet[2], tq.WeightOnlyLinear)
    assert not tnet.parameters()            # buffers only
    for k, v in jnet.state_dict().items():
        np.testing.assert_array_equal(_np(tnet.state_dict()[k]), _np(v),
                                      err_msg=k)
    np.testing.assert_allclose(_np(tnet(tp.to_tensor(x))),
                               _np(jnet(jp.to_tensor(x))), **MODEL_TOL)
    lyr = tq.WeightOnlyLinear(8, 4, has_bias=False)
    assert lyr.bias is None and lyr.weight._data.dtype == torch.int8
    with pytest.raises(ValueError):
        tq.WeightOnlyLinear(8, 4, weight_dtype="int2")


# -- the serving path: a converted LLaMA ------------------------------------

@pytest.fixture(scope="module")
def converted_pair():
    jnet, tnet, _ = make_pair(seed=2)
    jq.quantize_for_inference(jnet)
    tq.quantize_for_inference(tnet)
    return jnet, tnet


def test_quantize_for_inference_llama_buffers_match_jax(converted_pair):
    jnet, tnet = converted_pair
    n = sum(isinstance(m, tq.WeightOnlyLinear) for m in tnet.modules())
    assert n == 4 * 2 + 3 * 2 + 1 == sum(
        isinstance(s, jq.WeightOnlyLinear) for _, s in jnet.named_sublayers())
    assert not any(isinstance(m, torch.nn.Linear) for m in tnet.modules())
    head = tnet.lm_head
    assert isinstance(head, tq.WeightOnlyLinearModule)
    assert head.weight.dtype == torch.int8 and tuple(head.weight.shape) == (
        64, 64) and head.bias is None
    jsd = {k: _np(v) for k, v in jnet.state_dict().items()}
    tsd = tnet.state_dict()
    assert sorted(jsd) == sorted(tsd)
    for k, v in jsd.items():
        np.testing.assert_array_equal(tsd[k].numpy(), v, err_msg=k)


def test_quantized_llama_generate_matches_jax(converted_pair):
    jnet, tnet = converted_pair
    ids = np.random.default_rng(0).integers(0, 64, (3, 7)).astype(np.int64)
    want = _np(jax_generate(jnet, jp.to_tensor(ids), 10))
    for impl in ("dense", "paged"):
        got = generate(tnet, ids, 10, cache_impl=impl, page_size=4,
                       cache_dtype="float32")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=impl)


def test_quantized_llama_engine_matches_jax(converted_pair):
    jnet, tnet = converted_pair
    rng = np.random.default_rng(3)
    p = [rng.integers(0, 64, (n,)).astype(np.int32) for n in (6, 9)]
    schedule = {0: [(p[0], 8)], 2: [(p[1], 6)]}
    kw = dict(max_slots=2, page_size=4, pool_pages=32, max_context=32)
    jeng = JaxEngine(jnet, **kw)
    jdone, _ = _drive(jeng, JaxParams, schedule)
    tdone, _ = _drive(Engine(tnet, device="cpu", **kw), SamplingParams,
                      schedule)
    assert tdone == jdone
    jeng.close()


def test_quantized_llama_int4_logits_match_jax():
    jnet, tnet, _ = make_pair(seed=4)
    jq.quantize_for_inference(jnet, weight_dtype="int4")
    tq.quantize_for_inference(tnet, weight_dtype="int4")
    assert tuple(tnet.lm_head.weight_scale.shape) == (64 // 16, 64)
    ids = np.random.default_rng(1).integers(0, 64, (2, 9)).astype(np.int32)
    with torch.no_grad():
        got = tnet(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, _np(jnet(jp.to_tensor(ids))),
                               rtol=1e-4, atol=1e-4)


def test_converted_state_dict_round_trip_and_bridge(converted_pair):
    jnet, tnet = converted_pair
    fresh = copy.deepcopy(tnet)
    for b in fresh.buffers():
        b.zero_()
    fresh.load_state_dict(tnet.state_dict())
    for k, v in tnet.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert any(v.dtype == torch.int8 for v in fresh.state_dict().values())
    # JAX converted state -> the port's converted model and back
    jstate = {k: _np(v) for k, v in jnet.state_dict().items()}
    port = llama_state_from_numpy(jstate)
    assert port["lm_head.weight"].dtype == torch.int8
    assert tuple(port["lm_head.weight"].shape) == jstate[
        "lm_head.weight"].shape                  # [in, out], untransposed
    assert tuple(port["lm_head.weight_scale"].shape) == (64,)
    fresh.load_state_dict(port)
    back = llama_state_to_numpy(fresh.state_dict())
    assert sorted(back) == sorted(jstate)
    for k, v in jstate.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # the float weights still cross transposed
    assert llama_state_from_numpy(
        {"x.q_proj.weight": np.zeros((3, 5), np.float32)})[
        "x.q_proj.weight"].shape == (5, 3)


class _DoubledHead(torch.nn.Module):
    """A head that is not a torch.nn.Linear: twice a linear map. Its
    ``weight`` is the map's, so a model reading the weight instead of
    calling the head computes half the logits."""

    def __init__(self, linear):
        super().__init__()
        self.weight = linear.weight

    def forward(self, h):
        return 2.0 * torch.nn.functional.linear(h, self.weight)


def test_the_head_is_called_not_read():
    _, tnet, _ = make_pair(seed=6)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, 64, (2, 5)).astype(np.int64))
    with torch.no_grad():
        base = tnet(ids)
        tnet.lm_head = _DoubledHead(tnet.lm_head)
        got = tnet(ids)
        toks = generate(tnet, ids.numpy(), 4, cache_dtype="float32")
    torch.testing.assert_close(got, 2.0 * base)
    assert toks.shape == (2, 9)


def test_fused_ce_refuses_a_quantized_head():
    cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=4)
    net = LlamaForCausalLM(dataclasses.replace(cfg, fused_linear_ce=True),
                           device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.int64)
    assert torch.isfinite(net(ids, labels=ids))
    tq.quantize_for_inference(net)
    with pytest.raises(ValueError, match="quantize_for_inference"):
        net(ids, labels=ids)
    assert net(ids).shape == (1, 4, 64)       # the logits still serve
