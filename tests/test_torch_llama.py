"""The port's LLaMA (paddle_tpu_torch.text.models) held to the JAX
model with the same weights, crossed over through the bridge.

Tolerance: atol = rtol = 1e-4 on f32 logits (the two frameworks sum in
different orders; everything is f32 and tiny). Inputs are numpy arrays
with explicit int32 dtypes (``import paddle_tpu`` turns on jax x64).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functional import get_buffers, get_frozen, get_params
from paddle_tpu.text.generation import _model_forward as jax_forward
from paddle_tpu.text.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import monitor
from paddle_tpu_torch.bridge import (llama_state_from_numpy,
                                     llama_state_to_numpy)
from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

TOL = dict(atol=1e-4, rtol=1e-4)
VARIANTS = {"mha": dict(), "gqa": dict(kv=2), "window": dict(window=5),
            "gqa_window": dict(kv=1, window=7)}


def make_pair(seed=0, kv=None, window=None, layers=2, hidden=64, heads=4,
              vocab=64):
    """(jax_net, torch_net, params): the JAX tiny LLaMA and the port's,
    holding the same weights (numpy, JAX layout)."""
    paddle.seed(seed)
    jc = JaxLlamaConfig.tiny(vocab=vocab, hidden=hidden, layers=layers,
                             heads=heads)
    if kv is not None:
        jc.num_key_value_heads = kv
    jc.sliding_window = window
    jnet = JaxLlama(jc)
    jnet.eval()
    params = {k: np.asarray(v, np.float32)
              for k, v in get_params(jnet).items()}
    tnet = LlamaForCausalLM(LlamaConfig(**dataclasses.asdict(jc)),
                            device="cpu")
    tnet.load_state_dict(llama_state_from_numpy(params))
    tnet.eval()
    return jnet, tnet, params


def test_bridge_round_trip():
    _, tnet, params = make_pair(kv=2)
    back = llama_state_to_numpy(tnet.state_dict())
    assert sorted(back) == sorted(params)
    for name, arr in params.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    # Linear weights really are transposed ([in, out] -> [out, in])
    q = tnet.llama.layers[0].self_attn.q_proj.weight
    np.testing.assert_array_equal(
        q.detach().numpy(), params["llama.layers.0.self_attn.q_proj.weight"].T)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_no_cache_logits_match_jax(variant):
    jnet, tnet, _ = make_pair(**VARIANTS[variant])
    ids = np.random.default_rng(1).integers(0, 64, (2, 13)).astype(np.int32)
    want = np.asarray(jnet(paddle.to_tensor(ids)).numpy())
    before = monitor.counter("kernels.flash.fwd_plain").get()
    with torch.no_grad():
        got = tnet(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # one plain flash call per layer on the CPU
    assert monitor.counter("kernels.flash.fwd_plain").get() - before == 2


def _paged_pools(layers, rows, hkv, bs, hd):
    return [(np.zeros((rows, hkv, bs, hd), np.float32),
             np.zeros((rows, hkv, bs, hd), np.float32))
            for _ in range(layers)]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_prefill_and_decode_logits_match_jax(variant):
    """A bucketed prefill chunk then a single-token decode tick through
    the paged cache (rows at different positions plus an idle lane at
    cache index -1 on the scratch page): logits and written pools match
    the JAX model's paged path."""
    jnet, tnet, _ = make_pair(**VARIANTS[variant])
    c = tnet.config
    hkv, hd, bs = c.num_key_value_heads, c.hidden_size // c.num_attention_heads, 4
    rng = np.random.default_rng(2)
    # three sequences of 9 prompt tokens, pages 1..9 (page 0 = scratch)
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 0, 0, 0]], np.int32)
    pools = _paged_pools(2, 10, hkv, bs, hd)
    st = (get_params(jnet), get_buffers(jnet), get_frozen(jnet))
    jcache = [(jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt))
              for k, v in pools]
    tcache = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
               torch.from_numpy(bt)) for k, v in pools]
    prompt = rng.integers(0, 64, (3, 9)).astype(np.int32)
    start = np.array([0, 0, 0], np.int32)
    jl, jcache = jax_forward(jnet, st, jnp.asarray(prompt), jcache,
                             jnp.asarray(start))
    with torch.no_grad():
        tl, tcache = tnet(torch.from_numpy(prompt), kv_caches=tcache,
                          cache_index=torch.from_numpy(start))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for (jk, jv, _), (tk, tv, _) in zip(jcache, tcache):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    # decode tick: rows at positions 9 and 5 (row 1 rewrites its tail),
    # row 2 idle at -1 with an all-zero block-table row
    bt2 = bt.copy()
    bt2[2] = 0
    jcache = [(k, v, jnp.asarray(bt2)) for k, v, _ in jcache]
    tcache = [(k, v, torch.from_numpy(bt2)) for k, v, _ in tcache]
    tok = rng.integers(0, 64, (3, 1)).astype(np.int32)
    idx = np.array([9, 5, -1], np.int32)
    jl, jcache = jax_forward(jnet, st, jnp.asarray(tok), jcache,
                             jnp.asarray(idx))
    before = monitor.counter("kernels.decode.paged_plain").get()
    with torch.no_grad():
        tl, tcache = tnet(torch.from_numpy(tok), kv_caches=tcache,
                          cache_index=torch.from_numpy(idx))
    assert monitor.counter("kernels.decode.paged_plain").get() - before == 2
    # the idle lane's output is garbage by contract (JAX averages the
    # scratch page, the port emits zeros): compare live rows
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
    for (jk, jv, _), (tk, tv, _) in zip(jcache, tcache):
        np.testing.assert_allclose(tk.numpy()[1:], np.asarray(jk)[1:], **TOL)
        np.testing.assert_allclose(tv.numpy()[1:], np.asarray(jv)[1:], **TOL)


def test_unsupported_arguments_raise():
    _, tnet, _ = make_pair()
    ids = torch.zeros((1, 4), dtype=torch.int64)
    se = torch.zeros(1, 1, 4, 1, dtype=torch.int32)
    dense = [(torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4, 16))] * 2
    # the JAX package's flashmask checks (llama.py:221-248, :735-740)
    with pytest.raises(ValueError, match="kv_caches"):
        tnet(ids, attn_mask_startend_row_indices=se, kv_caches=dense,
             cache_index=0)
    _, wnet, _ = make_pair(window=3)
    with pytest.raises(ValueError, match="sliding_window"):
        wnet(ids, attn_mask_startend_row_indices=se)
    # sequence_parallel is a layout of mp > 1: at mp=1 it builds the
    # plain model, equal to the one without it
    cfg = LlamaConfig.tiny(vocab=64)
    cfg.recompute, cfg.sequence_parallel = True, True
    sp = LlamaForCausalLM(cfg, device="cpu", seed=3)
    plain = LlamaForCausalLM(dataclasses.replace(cfg, sequence_parallel=False),
                             device="cpu", seed=3)
    ids = torch.arange(8).reshape(1, 8) % 64
    with torch.no_grad():
        assert torch.equal(sp(ids), plain(ids))
    cfg = LlamaConfig.tiny(vocab=64)
    cfg.recompute, cfg.recompute_granularity = True, "layer"
    with pytest.raises(ValueError, match="recompute_granularity"):
        LlamaForCausalLM(cfg, device="cpu")


def test_seeded_init_is_reproducible():
    cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=1, heads=2)
    a = LlamaForCausalLM(cfg, device="cpu", seed=3).state_dict()
    b = LlamaForCausalLM(cfg, device="cpu", seed=3).state_dict()
    c = LlamaForCausalLM(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head.weight"], c["lm_head.weight"])
    assert torch.equal(a["llama.norm.weight"], torch.ones(32))


@pytest.mark.parametrize("mode", ["fused_loss", "flashmask_logits",
                                  "unfused_labels_ignored"])
def test_training_forward_matches_jax(mode):
    """forward(ids, labels) with fused_linear_ce returns the chunked loss;
    a flashmask document mask reaches every layer; without fused CE the
    labels are ignored and logits come back — as in the JAX model."""
    import paddle_tpu.nn.functional as jF
    from paddle_tpu_torch.nn.functional import document_startend_row_indices
    jnet, tnet, _ = make_pair(kv=2)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, (2, 11)).astype(np.int32)
    lab = rng.integers(0, 64, (2, 11)).astype(np.int32)
    lab[1, 4] = -100
    if mode == "fused_loss":
        jnet.config.fused_linear_ce = tnet.config.fused_linear_ce = True
        jnet.config.fused_ce_chunks = tnet.config.fused_ce_chunks = 3
        want = np.asarray(jnet(paddle.to_tensor(ids),
                               paddle.to_tensor(lab)).numpy())
        got = tnet(torch.from_numpy(ids), torch.from_numpy(lab))
        assert got.shape == () and got.dtype == torch.float32
    elif mode == "flashmask_logits":
        want = np.asarray(jnet(paddle.to_tensor(ids), None,
                               jF.document_startend_row_indices([4, 7]))
                          .numpy())
        got = tnet(torch.from_numpy(ids), None,
                   document_startend_row_indices([4, 7]))
    else:
        want = np.asarray(jnet(paddle.to_tensor(ids),
                               paddle.to_tensor(lab)).numpy())
        got = tnet(torch.from_numpy(ids), torch.from_numpy(lab))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_recompute_full_gives_the_same_grads():
    """Full recompute reruns each layer in the backward (two flash
    forwards per layer) and changes no gradient."""
    from paddle_tpu_torch.text.models import llama_flops_per_token
    _, plain, params = make_pair()
    cfg = dataclasses.replace(plain.config, recompute=True)
    ckpt = LlamaForCausalLM(cfg, device="cpu")
    ckpt.load_state_dict(llama_state_from_numpy(params))
    ids = torch.from_numpy(
        np.random.default_rng(5).integers(0, 64, (2, 9)).astype(np.int32))
    grads = []
    for net in (plain, ckpt):
        before = monitor.counter("kernels.flash.fwd_plain").get()
        net(ids).square().mean().backward()
        grads.append({n: p.grad for n, p in net.named_parameters()})
        fwd = monitor.counter("kernels.flash.fwd_plain").get() - before
        assert fwd == (4 if net is ckpt else 2)
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6,
                                   atol=1e-7)
    from paddle_tpu.text.models.llama import \
        llama_flops_per_token as jax_flops
    for c in (plain.config, LlamaConfig()):
        assert llama_flops_per_token(c) == jax_flops(c)
