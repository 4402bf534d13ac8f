"""The port's MoE path held to the JAX package on the CPU, with the same
weights: the gates (routing, weights, aux loss), ``MoELayer`` in its three
dispatch modes (outputs, ``l_aux`` and gradients into ``gate_weight``, the
experts and the input), serving decode mode with a token mask, ERNIE-MoE
logits, ``TrainStep`` over three steps in f32 and in bf16 AMP, the weight
and Adam-state bridge — and the one divergence by design, the int32
routing positions.

Tolerances. Routing decisions (expert, position, keep) exactly; combine
weights and aux rtol 1e-6 (f32 softmax in two frameworks). Layer outputs,
``l_aux`` and gradients rtol 1e-4, atol 1e-5 (f32, the products summed in
other orders; the JAX MoE gradient test's bar). ERNIE-MoE logits atol =
rtol = 1e-4 (as the LLaMA tests). TrainStep: PR 2's bars
(``test_torch_trainstep.py``): f32 — losses rtol 1e-5, 99.9 % of parameter
elements within 1e-6 and all within 1e-4, moments within 1e-4 of each
slot's largest value; bf16 AMP with bf16 moments — losses rtol 2e-3, 99 %
of elements within 5e-4 and all within 2 * STEPS * lr, moments within 5e-2
(bf16 stays under 256 tokens per expert, where JAX's bf16 positions are
exact).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.distributed.models.moe.moe_layer as jmoe_layer
import paddle_tpu.nn as jnn
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JaxMoE
from paddle_tpu.incubate.distributed.models.moe import gate as jgate
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models.ernie_moe import ErnieMoEConfig as JaxCfg
from paddle_tpu.text.models.ernie_moe import ErnieMoEForCausalLM as JaxErnie
from paddle_tpu.text.models.ernie_moe import \
    ernie_moe_flops_per_token as jax_flops
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import monitor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.bridge import (adam_state_from_numpy,
                                     adam_state_to_numpy,
                                     ernie_moe_state_from_numpy,
                                     ernie_moe_state_to_numpy)
from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer, gate
from paddle_tpu_torch.text.models import (ErnieMoEConfig,
                                          ErnieMoEForCausalLM,
                                          ernie_moe_flops_per_token)

TOL = dict(rtol=1e-4, atol=1e-5)
ROUTE = ("idx", "pos", "keep", "w", "aux")


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX test hook that sends MoELayer's "pallas" mode down its
    kernel dispatch (sparse route, padded buffer) on the CPU, where
    grouped_ffn falls back to grouped_ffn_reference."""
    monkeypatch.setattr(jmoe_layer, "_FORCE_PALLAS", True)


def _logits(seed, n, e, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((n, e))
            * scale).astype(np.float32)


@pytest.mark.parametrize("top_k,cap,masked", [(1, 8, False), (2, 6, False),
                                              (2, 40, True), (3, 5, True)])
def test_sparse_routing_matches_jax(top_k, cap, masked):
    lg = _logits(top_k * 10 + cap, 40, 4)
    mask = np.random.default_rng(cap).random(40) > 0.3 if masked else None
    want = jgate.topk_gating_sparse(
        jnp.asarray(lg), top_k, cap, train=False,
        token_mask=None if mask is None else jnp.asarray(mask))
    got = gate.topk_gating_sparse(
        torch.from_numpy(lg), top_k, cap, train=False,
        token_mask=None if mask is None else torch.from_numpy(mask))
    for n, g, w in zip(ROUTE, got, want):
        g, w = g.numpy(), np.asarray(w)
        if n in ("idx", "pos", "keep"):
            np.testing.assert_array_equal(g, w, err_msg=n)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=n)
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("top_k,cap", [(1, 8), (2, 6), (2, 40)])
def test_dense_routing_matches_jax(top_k, cap):
    lg = _logits(cap, 24, 4)
    want = jgate.topk_gating(jnp.asarray(lg), top_k, cap, train=False)
    got = gate.topk_gating(torch.from_numpy(lg), top_k, cap, train=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_routing_positions_are_exact_where_jax_rounds():
    """The divergence by design (ROADMAP section 3): JAX counts a token's
    slot as a cumsum of a one-hot in the logits' dtype (gate.py:39,
    :145-151); in bf16 positions past 256 round and tokens collide in one
    slot. The port counts in int32: every kept assignment has its own slot,
    and with f32 logits the two agree exactly."""
    n, e, cap = 1200, 2, 1200
    lg = _logits(9, n, e, 0.5)
    lg[:, 0] += 3.0                     # expert 0 takes every first choice
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = gate.topk_gating_sparse(torch.from_numpy(lg).to(dt), 2, cap,
                                      train=False)
        want = jgate.topk_gating_sparse(jnp.asarray(lg, jdt), 2, cap,
                                        train=False)
        slots = got[0].long() * cap + got[1].long()
        kept = slots[got[2]]
        assert kept.numel() == 2 * n and kept.unique().numel() == 2 * n
        jslots = (np.asarray(want[0], np.int64) * cap
                  + np.asarray(want[1], np.int64))[np.asarray(want[2])]
        if dt == torch.float32:
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(want[1]))
        else:
            # JAX: positions 0..1199 of expert 0 round to bf16 steps of
            # 4 and 8 past 256, so far fewer distinct slots than tokens
            assert np.unique(jslots).size < 0.7 * jslots.size
            np.testing.assert_array_equal(got[1].numpy()[:, :256],
                                          np.asarray(want[1])[:, :256])


def _layer_pair(mode, gate_name="gshard", top_k=2, cf=2.0, group_size=None,
                h=32, dff=48, e=4, seed=0):
    paddle.seed(seed)
    jl = JaxMoE(d_model=h, d_hidden=dff, num_experts=e, gate=gate_name,
                top_k=top_k, capacity_factor=cf, group_size=group_size,
                dispatch_mode=mode)
    tl = MoELayer(d_model=h, d_hidden=dff, num_experts=e, gate=gate_name,
                  top_k=top_k, capacity_factor=cf, group_size=group_size,
                  dispatch_mode=mode, device="cpu")
    params = {k: np.asarray(v, np.float32) for k, v in get_params(jl).items()}
    tl.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    return jl, tl


def _jax_grads(jl, x_np, g_np, **kw):
    x = paddle.to_tensor(x_np, stop_gradient=False)
    out = jl(x, **kw)
    loss = (out * paddle.to_tensor(g_np)).sum() + jl.l_aux
    loss.backward()
    grads = {"x": x.grad, "gate_weight": jl.gate_weight.grad}
    for n in ("w1", "b1", "w2", "b2"):
        grads[n] = getattr(jl.experts, n).grad
    return (np.asarray(out.numpy()), float(jl.l_aux.numpy()),
            {k: np.asarray(v.numpy()) for k, v in grads.items()})


def _port_grads(tl, x_np, g_np, **kw):
    x = torch.from_numpy(x_np).requires_grad_()
    out = tl(x, **kw)
    ((out * torch.from_numpy(g_np)).sum() + tl.l_aux).backward()
    grads = {"x": x.grad, "gate_weight": tl.gate_weight.grad}
    for n in ("w1", "b1", "w2", "b2"):
        grads[n] = getattr(tl.experts, n).grad
    return (out.detach().numpy(), float(tl.l_aux.detach()),
            {k: v.numpy() for k, v in grads.items()})


# (mode, gate, top_k, capacity factor, group_size)
LAYER_CASES = {
    "pallas_gshard": ("pallas", "gshard", 2, 2.0, None),
    "pallas_switch": ("pallas", "switch", 1, 4.0, None),
    "pallas_drops": ("pallas", "gshard", 2, 0.26, None),
    "scatter_gshard": ("scatter", "gshard", 2, 2.0, None),
    "scatter_drops": ("scatter", "naive", 2, 0.3, None),
    "einsum_gshard": ("einsum", "gshard", 2, 2.0, None),
    "einsum_groups": ("einsum", "gshard", 2, 1.0, 16),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_moe_layer_matches_jax(name, jax_pallas):
    mode, gname, top_k, cf, gs = LAYER_CASES[name]
    jl, tl = _layer_pair(mode, gname, top_k, cf, gs, seed=len(name))
    jl.eval()
    tl.eval()
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    g = rng.standard_normal((2, 32, 32)).astype(np.float32)
    counter = monitor.counter(f"kernels.moe.dispatch_path.{mode}")
    before = counter.get()
    jo, ja, jg = _jax_grads(jl, x, g)
    to, ta, tg = _port_grads(tl, x, g)
    assert counter.get() == before + 1
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(ta, ja, rtol=1e-5)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **TOL)
    assert np.abs(tg["gate_weight"]).sum() > 0


def test_decode_mode_with_token_mask_matches_jax(jax_pallas):
    """Serving decode mode: capacity = the tick's tokens (no drop), dead
    lanes claim no slot — outputs as JAX's, dead rows zero, and each live
    token's output the same as with the dead lanes left out of the tick."""
    jl, tl = _layer_pair("pallas", seed=4)
    jl.eval()
    tl.eval()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 1, 32)).astype(np.float32)
    mask = np.array([True, False, True, True, False, True])
    want = np.asarray(jl(paddle.to_tensor(x), token_mask=paddle.to_tensor(
        mask[:, None]), decode_mode=True).numpy())
    before = monitor.counter("kernels.moe.decode_path.pallas").get()
    with torch.no_grad():
        got = tl(torch.from_numpy(x), token_mask=torch.from_numpy(
            mask[:, None]), decode_mode=True).numpy()
        alone = tl(torch.from_numpy(x[mask]), decode_mode=True).numpy()
    assert monitor.counter("kernels.moe.decode_path.pallas").get() == \
        before + 2
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[~mask].any()
    np.testing.assert_allclose(got[mask], alone, rtol=1e-6, atol=1e-7)


def test_fallback_reasons_are_counter_visible():
    """Custom experts leave the kernel path, counted: the forward takes the
    einsum dispatch (as JAX), decode mode the scatter dispatch; an
    expert-parallel layer holds its rows of experts and leaves the kernels
    as "ep-sharded"; unknown modes raise."""
    class Experts(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.randn(2, 16, 16) * 0.1)

        def forward(self, x):
            return torch.einsum("ech,ehf->ecf", x, self.w)

    layer = MoELayer(16, 16, 2, experts=Experts(), device="cpu")
    x = torch.randn(1, 8, 16)
    names = ["kernels.moe.dispatch_path.fallback.custom-experts",
             "kernels.moe.dispatch_path.einsum",
             "kernels.moe.decode_path.fallback.custom-experts"]
    before = [monitor.counter(n).get() for n in names]
    layer(x)
    layer(x, decode_mode=True)
    assert [monitor.counter(n).get() - b for n, b in zip(names, before)] == \
        [1, 1, 1]
    # expert parallelism: a moe_group of n ranks leaves this rank E / n
    # experts (rank 1 of 2: the second of a one-rank layer's, same seed),
    # marked expert-parallel, and the kernel dispatch falls back, counted
    # as "ep-sharded"
    class _Group:
        nranks, rank = 2, 1

    ep = MoELayer(16, 16, 2, moe_group=_Group(), device="cpu", seed=4)
    whole = MoELayer(16, 16, 2, device="cpu", seed=4)
    assert ep.experts.num_local_experts == 1
    assert torch.equal(ep.experts.w1, whole.experts.w1[1:])
    assert torch.equal(ep.experts.w2, whole.experts.w2[1:])
    assert torch.equal(ep.gate_weight, whole.gate_weight)
    assert ep.experts.w1.expert_parallel and \
        not whole.experts.w1.expert_parallel
    assert ep._pallas_fallback_reason() == "ep-sharded"
    assert whole._pallas_fallback_reason() is None
    with pytest.raises(ValueError, match="dispatch_mode"):
        MoELayer(16, 16, 2, dispatch_mode="cuda", device="cpu")


def make_ernie_pair(seed=0, dispatch="pallas", layers=2, hidden=64,
                    experts=4, vocab=64, heads=4, top_k=2):
    """(jax_net, torch_net, params): the tiny ERNIE-MoE in both packages
    with the same weights."""
    paddle.seed(seed)
    jc = JaxCfg.tiny(vocab=vocab, hidden=hidden, layers=layers, heads=heads,
                     experts=experts)
    jc.top_k = top_k
    jc.moe_dispatch_mode = dispatch
    jnet = JaxErnie(jc)
    params = {k: np.asarray(v, np.float32)
              for k, v in get_params(jnet).items()}
    tnet = ErnieMoEForCausalLM(ErnieMoEConfig(**dataclasses.asdict(jc)),
                               device="cpu")
    tnet.load_state_dict(ernie_moe_state_from_numpy(params))
    return jnet, tnet, params


@pytest.mark.parametrize("dispatch", ["pallas", "scatter", "einsum"])
def test_ernie_moe_logits_match_jax(dispatch, jax_pallas):
    jnet, tnet, _ = make_ernie_pair(dispatch=dispatch, layers=4)
    jnet.eval()
    tnet.eval()
    ids = np.random.default_rng(1).integers(0, 64, (2, 13)).astype(np.int32)
    want = np.asarray(jnet(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tnet(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(tnet.aux_loss()),
                               float(jnet.aux_loss().numpy()), rtol=1e-5)
    spec = tnet.serving_spec()
    assert spec["num_heads"] == 4 and spec["moe"]["num_moe_layers"] == 2
    assert spec["moe_layer"] is tnet.layers[1].mlp


def test_bridge_round_trip_and_layouts():
    _, tnet, params = make_ernie_pair()
    back = ernie_moe_state_to_numpy(tnet.state_dict())
    assert sorted(back) == sorted(params)
    for name, arr in params.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    # Linear weights transposed, the MoE block's raw parameters not
    np.testing.assert_array_equal(
        tnet.layers[0].self_attn.q_proj.weight.detach().numpy(),
        params["layers.0.self_attn.q_proj.weight"].T)
    for n in ("gate_weight", "experts.w1", "experts.b1", "experts.w2",
              "experts.b2"):
        np.testing.assert_array_equal(
            tnet.state_dict()[f"layers.1.mlp.{n}"].numpy(),
            params[f"layers.1.mlp.{n}"], err_msg=n)


def test_flops_and_seeded_init():
    for c in (ErnieMoEConfig.tiny(), ErnieMoEConfig(
            vocab_size=32000, hidden_size=1024, intermediate_size=2816,
            num_hidden_layers=8, num_attention_heads=16,
            num_key_value_heads=16)):
        assert ernie_moe_flops_per_token(c) == jax_flops(
            JaxCfg(**dataclasses.asdict(c)))
    cfg = ErnieMoEConfig.tiny(vocab=32, hidden=16, heads=2)
    a = ErnieMoEForCausalLM(cfg, device="cpu", seed=3).state_dict()
    b = ErnieMoEForCausalLM(cfg, device="cpu", seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not a["layers.1.mlp.experts.b1"].any()
    assert a["layers.1.mlp.experts.w1"].std() > 0


B, S, VOCAB, STEPS, LR = 2, 12, 64, 3, 1e-3


def _run_jax_train(amp, ids, labels, seed):
    paddle.seed(seed)
    jc = JaxCfg.tiny(vocab=VOCAB, hidden=64, layers=2, heads=4, experts=4)
    net = JaxErnie(jc)
    params0 = {k: np.asarray(v, np.float32)
               for k, v in get_params(net).items()}
    ce = jnn.CrossEntropyLoss()
    opt = paddle.optimizer.AdamW(LR, parameters=net.parameters(),
                                 moment_dtype=amp)
    step = paddle.jit.TrainStep(
        net, lambda out, lab: ce(out, lab) + net.aux_loss(), opt,
        amp_dtype=amp)
    x, y = paddle.to_tensor(ids), paddle.to_tensor(labels)
    losses = [float(step(x, y).numpy()) for _ in range(STEPS)]
    state = {n: {s: np.asarray(a.astype(np.float32)) for s, a in st.items()}
             for n, st in step._opt_state.items()}
    params = {k: np.asarray(v, np.float32) for k, v in get_params(net).items()}
    return jc, params0, losses, params, state


def _port_train(jc, params0, amp, ids, labels, state=None, steps=STEPS):
    net = ErnieMoEForCausalLM(ErnieMoEConfig(**dataclasses.asdict(jc)),
                              device="cpu")
    net.load_state_dict(ernie_moe_state_from_numpy(params0))
    ce = tnn.CrossEntropyLoss()
    opt = topt.AdamW(LR, parameters=net.parameters(), moment_dtype=amp)
    step = tjit.TrainStep(net, lambda out, lab: ce(out, lab) + net.aux_loss(),
                          opt, amp_dtype=amp)
    if state is not None:
        step.opt_state = state
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    losses = [float(step(x, y)) for _ in range(steps)]
    return losses, ernie_moe_state_to_numpy(net.state_dict()), \
        adam_state_to_numpy(step.opt_state)


def _assert_state_close(got, want, m_tol):
    assert sorted(got) == sorted(want)
    for n in want:
        for slot, w in want[n].items():
            g = got[n][slot]
            if slot.startswith("moment"):
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=m_tol * float(np.abs(w).max()) + 1e-30,
                    err_msg=f"{n}.{slot}")
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6,
                                           err_msg=f"{n}.{slot}")


@pytest.mark.parametrize("amp", [None, "bfloat16"], ids=["f32", "amp_bf16"])
def test_trainstep_matches_jax(amp):
    rng = np.random.default_rng(11)
    ids = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    jc, params0, jl, jp, js = _run_jax_train(amp, ids, labels, seed=11)
    before = monitor.counter("kernels.moe.grouped_ffn_bwd_plain").get()
    tl, tp, ts = _port_train(jc, params0, amp, ids, labels)
    assert monitor.counter("kernels.moe.grouped_ffn_bwd_plain").get() == \
        before + STEPS                   # one MoE block, one backward a step
    bf16 = amp is not None
    np.testing.assert_allclose(tl, jl, rtol=2e-3 if bf16 else 1e-5)
    assert tl[-1] < tl[0]
    d = np.concatenate([np.abs(tp[n] - jp[n]).ravel() for n in jp])
    q, q_tol, cap = (0.99, 5e-4, 2 * STEPS * LR) if bf16 else \
        (0.999, 1e-6, 1e-4)
    assert np.quantile(d, q) <= q_tol, (np.quantile(d, q), q_tol)
    assert d.max() <= cap, (d.max(), cap)
    _assert_state_close(ts, js, 5e-2 if bf16 else 1e-4)


def test_adam_state_bridge_resumes_a_jax_moe_run():
    """The Adam state bridge holds for MoE unchanged: the JAX run's
    parameters and AdamW state after step 1, crossed over, let the port
    take steps 2 and 3 to the JAX run's losses and parameters."""
    rng = np.random.default_rng(12)
    ids = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    paddle.seed(12)
    jc = JaxCfg.tiny(vocab=VOCAB, hidden=64, layers=2, heads=4, experts=4)
    net = JaxErnie(jc)
    ce = jnn.CrossEntropyLoss()
    opt = paddle.optimizer.AdamW(LR, parameters=net.parameters())
    jstep = paddle.jit.TrainStep(
        net, lambda out, lab: ce(out, lab) + net.aux_loss(), opt)
    x, y = paddle.to_tensor(ids), paddle.to_tensor(labels)
    jl = [float(jstep(x, y).numpy())]
    params1 = {k: np.asarray(v, np.float32) for k, v in get_params(net).items()}
    state1 = {n: {s: np.asarray(a, np.float32) for s, a in st.items()}
              for n, st in jstep._opt_state.items()}
    jl += [float(jstep(x, y).numpy()) for _ in range(2)]
    jp = {k: np.asarray(v, np.float32) for k, v in get_params(net).items()}
    tl, tp, _ = _port_train(jc, params1, None, ids, labels,
                            state=adam_state_from_numpy(state1, "cpu"),
                            steps=2)
    np.testing.assert_allclose(tl, jl[1:], rtol=1e-5)
    d = np.concatenate([np.abs(tp[n] - jp[n]).ravel() for n in jp])
    assert np.quantile(d, 0.999) <= 1e-6 and d.max() <= 1e-4, d.max()
