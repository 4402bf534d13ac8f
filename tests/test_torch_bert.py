"""The port's BERT path held to the JAX package on the CPU, with the same
weights (``bridge.bert_state_from_numpy``): the head-dim-64 probe's plain
version, ``layer_norm``, ``gelu``, ``dropout``, the routes of
``scaled_dot_product_attention``, ``BertModel``, ``BertForPretraining``
(logits, dense and fused MLM loss, gradients), ``TrainStep`` over three
steps, the bridge, and the one divergence by design (a sequence past
``max_position_embeddings`` raises).

Tolerances. ``layer_norm`` and ``gelu`` in bf16: bit-equal — the port
rounds at the JAX package's points (the mean and the variance in f32
rounded to bf16, then each bf16 op; ``erfc`` in f32 rounded to bf16,
each product in bf16), and bf16 rounding absorbs the f32 differences
below. In f32 they differ by ulps: XLA and PyTorch sum the mean and
variance in other orders and evaluate ``erfc`` with other polynomials:
2e-6 of the tensor's largest value. The probe's plain version on small integers:
exact. Attention and model outputs, f32: rtol 1e-4, atol 1e-5 (the
products summed in other orders; the LLaMA tests' bar); gradients the
same. TrainStep: the bars of ``test_torch_trainstep.py``: f32 — losses
rtol 1e-5, 99.9 % of parameter elements within 1e-6 and all within 1e-4,
moments within 1e-4 of each slot's largest value; bf16 AMP with bf16
moments — losses rtol 2e-3, 99 % of elements within 5e-4 and all within
2 * STEPS * lr, moments within 5e-2. Dropout runs at p 0 against JAX (its
threefry masks cannot be reproduced) and is held to its own distribution:
the kept share within 0.005 of 1 - p over 400,000 draws (about 7 standard
deviations), the kept values exactly x / (1 - p).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models import BertConfig as JaxBertConfig
from paddle_tpu.text.models import BertForPretraining as JaxBertPT
from paddle_tpu.text.models import BertModel as JaxBertModel
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import monitor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import _modules
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.bridge import (adam_state_from_numpy,
                                     adam_state_to_numpy,
                                     bert_state_from_numpy,
                                     bert_state_to_numpy)
from paddle_tpu_torch.kernels.flash_attention import (MINOR64_SHAPE,
                                                      minor64_input,
                                                      minor64_probe_plain)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.text.models import (BertConfig, BertForPretraining,
                                          BertModel)

TOL = dict(rtol=1e-4, atol=1e-5)
VOCAB, STEPS, LR = 64, 3, 1e-3


def _np(t):
    return np.asarray(t.numpy()).astype(np.float32)


def _jax_cfg(**over):
    c = JaxBertConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=2)
    c.hidden_dropout_prob = 0.0
    for k, v in over.items():
        setattr(c, k, v)
    return c


def _pair(cls_jax, cls_port, seed=0, **over):
    """A JAX model and the port's, same weights, both in eval mode."""
    paddle.seed(seed)
    jc = _jax_cfg(**over)
    jnet = cls_jax(jc)
    params = {k: np.asarray(v, np.float32)
              for k, v in get_params(jnet).items()}
    tnet = cls_port(BertConfig(**dataclasses.asdict(jc)), device="cpu")
    tnet.load_state_dict(bert_state_from_numpy(params))
    jnet.eval()
    tnet.eval()
    return jnet, tnet, params


def _batch(seed, b=3, s=10, dead_row=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (b, s)).astype(np.int64)
    tt = rng.integers(0, 2, (b, s)).astype(np.int64)
    am = np.ones((b, s), np.int64)
    am[1, 6:] = 0
    if dead_row:
        am[2, :] = 0                  # a dead row of a pinned batch
    return ids, tt, am


# -- the head-dim-64 probe ---------------------------------------------------

def test_minor64_probe_plain_matches_the_probe_body():
    """The two dot_generals of the Pallas probe body (flash_attention.py
    :818-822) on the same seeded small-integer x: exact in f32."""
    x = np.random.default_rng(0).integers(-3, 4, (128, 64)).astype(
        np.float32)
    xj = jnp.asarray(x)
    s = jax.lax.dot_general(xj, xj, (((1,), (1,)), ((), ())),
                            preferred_element_type=jnp.float32)
    want = np.asarray(jax.lax.dot_general(
        s, xj, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32))
    got = minor64_probe_plain(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (128, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    # a layout fault (x read column-major, say) would not pass
    xc = x.reshape(64, 128).T
    assert not np.array_equal(xc @ xc.T @ xc, want)


def test_minor64_input_is_one_fixed_exact_tile():
    """The probe's input is one fixed f32 tile of integers in [-3, 3], on
    which (x x^T) x is exact in f32 (it equals the f64 product), so the
    card's answer can be held to it bit for bit."""
    x = minor64_input(torch.device("cpu"))
    assert x.dtype == torch.float32 and tuple(x.shape) == MINOR64_SHAPE
    assert torch.equal(x, minor64_input(torch.device("cpu")))
    assert torch.equal(x, x.round()) and int(x.abs().max()) == 3
    x64 = x.double()
    assert torch.equal(minor64_probe_plain(x).double(), (x64 @ x64.T) @ x64)


# -- layer_norm, gelu, dropout ----------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 768)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(768).astype(np.float32)
    b = rng.standard_normal(768).astype(np.float32)
    jx, jw, jb = (paddle.to_tensor(a).astype(dtype) for a in (x, w, b))
    want = _np(jF.layer_norm(jx, 768, jw, jb, epsilon=1e-12)
               .astype("float32"))
    tdt = getattr(torch, dtype)
    got = F.layer_norm(torch.from_numpy(x).to(tdt), 768,
                       *(torch.from_numpy(a).to(tdt) for a in (w, b)), 1e-12)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(dtype, approximate):
    x = (np.random.default_rng(2).standard_normal((256, 3072)) * 2).astype(
        np.float32)
    want = _np(jF.gelu(paddle.to_tensor(x).astype(dtype),
                       approximate=approximate).astype("float32"))
    tdt = getattr(torch, dtype)
    got = F.gelu(torch.from_numpy(x).to(tdt), approximate=approximate)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "bfloat16" and not approximate:
        np.testing.assert_array_equal(got, want)
    else:
        # the tanh form's x**3 is an integer power in XLA (its own
        # rounding in bf16): held within one bf16 ulp of the largest value
        tol = 2e-6 if dtype == "float32" else 2 ** -7
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_dropout_distribution_and_scale():
    x = torch.full((400_000,), 2.0)
    for p in (0.1, 0.5):
        gen = torch.Generator().manual_seed(3)
        out = F.dropout(x, p, generator=gen)
        kept = out != 0
        assert abs(float(kept.float().mean()) - (1 - p)) < 0.005
        assert torch.equal(out[kept], torch.full_like(out[kept], 2 / (1 - p)))
        down = F.dropout(x, p, mode="downscale_in_infer", generator=gen)
        assert set(down.unique().tolist()) == {0.0, 2.0}
    assert F.dropout(x, 0.0) is x
    assert not F.dropout(x, 1.0).any()
    with pytest.raises(ValueError, match="dropout p"):
        F.dropout(x, 1.5)


def test_dropout_generator_rules_and_eval():
    x = torch.ones(4096)

    def mask(gen):
        return F.dropout(x, 0.3, generator=gen) != 0
    one = mask(torch.Generator().manual_seed(7))
    assert torch.equal(one, mask(torch.Generator().manual_seed(7)))
    gen_a, gen_b = (torch.Generator().manual_seed(s) for s in (7, 8))
    a1, b1, a2 = mask(gen_a), mask(gen_b), mask(gen_a)
    # independent masks: agreement near p^2 + (1 - p)^2 = 0.58, not 1
    for u, v in ((a1, b1), (a1, a2)):
        assert abs(float((u == v).float().mean()) - 0.58) < 0.05
    assert F.dropout(x, 0.3, training=False) is x
    assert torch.equal(F.dropout(x, 0.3, training=False,
                                 mode="downscale_in_infer"), x * 0.7)
    layer = tnn.Dropout(0.3, generator=torch.Generator().manual_seed(7))
    layer.eval()
    assert layer(x) is x
    layer.train()
    assert torch.equal(layer(x) != 0, one)


def test_model_dropout_draws_from_its_generator():
    cfg = BertConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=2)
    net = BertModel(cfg, device="cpu", seed=5)
    ids = torch.randint(0, VOCAB, (2, 8))
    net.train()
    a = net(ids)[0]
    b = net(ids)[0]
    assert not torch.equal(a, b)             # masks differ step to step
    net.generator.manual_seed(5)
    torch.testing.assert_close(net(ids)[0], a, rtol=0, atol=0)
    net.eval()
    torch.testing.assert_close(net(ids)[0], net(ids)[0], rtol=0, atol=0)
    drops = [m for m in net.modules() if isinstance(m, _modules.Dropout)]
    assert drops and all(m.generator is net.generator for m in drops)


# -- scaled_dot_product_attention -------------------------------------------

def _sdpa_inputs(seed=0, b=2, s=7, h=4, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _key_mask(shape, seed):
    m = np.random.default_rng(seed).random(shape) > 0.3
    m[..., 0] = True                  # every row keeps a key
    return m


# name -> (mask (numpy bool or None), is_causal, route counter)
def _sdpa_cases():
    b, s, h = 2, 7, 4
    dense = np.random.default_rng(5).random((b, 1, s, s)) > 0.4
    dense[..., 0] = True
    dead = _key_mask((b, 1, 1, s), 4)
    dead[1] = False                   # batch row 1: every key masked
    return {
        "none": (None, False, "plain"),
        "none_causal": (None, True, "plain"),
        "b1sk": (_key_mask((b, 1, s), 1), False, "plain_mask"),
        "b11sk": (_key_mask((b, 1, 1, s), 2), False, "plain_mask"),
        "bh1sk": (_key_mask((b, h, 1, s), 3), False, "plain_mask"),
        "b11sk_causal": (_key_mask((b, 1, 1, s), 2), True, "plain_mask"),
        "all_masked_rows": (dead, False, "plain_mask"),
        "dense_b1sqsk": (dense, False, "dense_mask"),
    }


@pytest.mark.parametrize("name", sorted(_sdpa_cases()))
def test_sdpa_matches_jax_and_counts_its_route(name):
    mask, causal, route = _sdpa_cases()[name]
    q, k, v = _sdpa_inputs(seed=len(name))
    jm = None if mask is None else paddle.to_tensor(mask)
    want = _np(jF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), attn_mask=jm,
        is_causal=causal))
    counter = monitor.counter(f"kernels.flash.sdpa.{route}")
    before = counter.get()
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        dropout_p=0.1, is_causal=causal)
    assert counter.get() == before + 1
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if name == "all_masked_rows":
        assert not got[1].any()                  # zeros, not NaN


def test_sdpa_use_flash_false_takes_the_core():
    q, k, v = (torch.from_numpy(a) for a in _sdpa_inputs(seed=9))
    before = monitor.counter("kernels.flash.sdpa.core").get()
    got = F.scaled_dot_product_attention(q, k, v, use_flash=False)
    assert monitor.counter("kernels.flash.sdpa.core").get() == before + 1
    torch.testing.assert_close(got, F.scaled_dot_product_attention(q, k, v),
                               **TOL)


# -- BertModel, BertForPretraining -------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_bert_model_matches_jax(masked):
    jnet, tnet, _ = _pair(JaxBertModel, BertModel, seed=1)
    ids, tt, am = _batch(1)
    jargs = [paddle.to_tensor(ids), paddle.to_tensor(tt)]
    targs = [torch.from_numpy(ids), torch.from_numpy(tt)]
    if masked:
        jargs.append(paddle.to_tensor(am))
        targs.append(torch.from_numpy(am))
    want = jnet(*jargs)
    with torch.no_grad():
        got = tnet(*targs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
    assert tnet.serving_spec() == dict(
        jnet.serving_spec(), head_dim=16)


def _grads_jax(jnet, args, nsp_w):
    loss, nsp = jnet(*args)
    (loss + (nsp * paddle.to_tensor(nsp_w)).sum()).backward()
    return float(loss.numpy()), {n: _np(p.grad)
                                 for n, p in jnet.named_parameters()}


def _grads_port(tnet, args, nsp_w):
    loss, nsp = tnet(*args)
    (loss + (nsp * torch.from_numpy(nsp_w)).sum()).backward()
    grads = {n: p.grad for n, p in tnet.named_parameters()}
    return float(loss.detach()), bert_state_to_numpy(grads)


@pytest.mark.parametrize("fused", [False, True])
def test_pretraining_losses_and_grads_match_jax(fused):
    """forward(ids, tt, labels, mask) -> (loss, nsp): the dense mean CE or
    the 3-chunk fused head, and every parameter's gradient of loss +
    <nsp, w> (the tied decoder's share lands on the word embeddings)."""
    jnet, tnet, _ = _pair(JaxBertPT, BertForPretraining, seed=2,
                          fused_mlm_ce=fused, fused_ce_chunks=3)
    jnet.train()
    tnet.train()
    ids, tt, am = _batch(2, dead_row=False)
    labels = np.random.default_rng(3).integers(0, VOCAB, ids.shape)
    labels[0, :2] = -100
    nsp_w = np.random.default_rng(4).standard_normal((3, 2)).astype(
        np.float32)
    jl, jg = _grads_jax(jnet, [paddle.to_tensor(a)
                               for a in (ids, tt, labels, am)], nsp_w)
    tl, tg = _grads_port(tnet, [torch.from_numpy(a)
                                for a in (ids, tt, labels, am)], nsp_w)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert sorted(tg) == sorted(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL)


def test_pretraining_logits_match_jax():
    jnet, tnet, _ = _pair(JaxBertPT, BertForPretraining, seed=3)
    ids, tt, am = _batch(3)
    want = jnet(paddle.to_tensor(ids), paddle.to_tensor(tt), None,
                paddle.to_tensor(am))
    with torch.no_grad():
        got = tnet(torch.from_numpy(ids), torch.from_numpy(tt), None,
                   torch.from_numpy(am))
    assert got[0].shape == (3, 10, VOCAB) and got[1].shape == (3, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_bridge_round_trip_and_tied_decoder():
    _, tnet, params = _pair(JaxBertPT, BertForPretraining, seed=4)
    back = bert_state_to_numpy(tnet.state_dict())
    assert sorted(back) == sorted(params)
    for n in params:
        np.testing.assert_array_equal(back[n], params[n], err_msg=n)
    assert tnet.state_dict()["bert.encoder.0.attention.qkv.weight"].shape \
        == (96, 32)                      # transposed from [in, out]
    # the decoder is the word embedding: one parameter, moved by both uses
    names = [n for n, _ in tnet.named_parameters()]
    assert len(names) == len(params) and not any("decoder" in n
                                                 for n in names)
    ids = torch.randint(0, VOCAB, (1, 5))
    with torch.no_grad():
        before = tnet(ids)[0]
        tnet.bert.embeddings.word_embeddings.weight[:, 0] += 1.0
        after = tnet(ids)[0]
    assert not torch.allclose(before, after)


def test_position_limit_raises_where_jax_gives_nan():
    """Divergence by design: JAX's jnp.take fills rows past the position
    table with NaN (fill gather mode), and attention spreads them to every
    position; the port raises."""
    jnet, tnet, _ = _pair(JaxBertModel, BertModel, seed=5)
    ids = np.zeros((1, 129), np.int64)            # tiny(): 128 positions
    out = _np(jnet(paddle.to_tensor(ids))[0])
    assert np.isnan(out).all()
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tnet(torch.from_numpy(ids))


def test_tensor_parallel_raises():
    """Tensor-parallel BERT is built under a hybrid topology with mp = 2
    (``fleet.init``; its parity case is
    ``test_torch_fleet_tp.py::test_bert_mp2_per_rank_qkv_matches_jax``):
    asking for mp_degree=2 without one raises."""
    with pytest.raises(ValueError, match="hybrid topology's mp degree"):
        BertModel(BertConfig.tiny(), device="cpu", mp_degree=2)


# -- TrainStep ----------------------------------------------------------------

def _train_jax(amp, fused, ids, tt, labels, seed):
    paddle.seed(seed)
    jc = _jax_cfg(fused_mlm_ce=fused, fused_ce_chunks=2)
    net = JaxBertPT(jc)
    params0 = {k: np.asarray(v, np.float32)
               for k, v in get_params(net).items()}
    opt = paddle.optimizer.AdamW(LR, parameters=net.parameters(),
                                 moment_dtype=amp)
    ce = jnn.CrossEntropyLoss()
    x, t, y = (paddle.to_tensor(a) for a in (ids, tt, labels))
    if fused:
        step = paddle.jit.TrainStep(net, lambda out, lab: out[0], opt,
                                    amp_dtype=amp)
        inputs = (x, t, y)
    else:
        step = paddle.jit.TrainStep(net, lambda out, lab: ce(out[0], lab),
                                    opt, amp_dtype=amp)
        inputs = (x, t)
    losses = [float(step(inputs, y).numpy()) for _ in range(STEPS)]
    state = {n: {s: np.asarray(a.astype(np.float32)) for s, a in st.items()}
             for n, st in step._opt_state.items()}
    params = {k: np.asarray(v, np.float32) for k, v in get_params(net).items()}
    return jc, params0, losses, params, state


def _train_port(jc, params0, amp, ids, tt, labels):
    net = BertForPretraining(BertConfig(**dataclasses.asdict(jc)),
                             device="cpu")
    net.load_state_dict(bert_state_from_numpy(params0))
    opt = topt.AdamW(LR, parameters=net.parameters(), moment_dtype=amp)
    ce = tnn.CrossEntropyLoss()
    x, t, y = (torch.from_numpy(a) for a in (ids, tt, labels))
    if jc.fused_mlm_ce:
        step = tjit.TrainStep(net, lambda out, lab: out[0], opt,
                              amp_dtype=amp)
        inputs = (x, t, y)
    else:
        step = tjit.TrainStep(net, lambda out, lab: ce(out[0], lab), opt,
                              amp_dtype=amp)
        inputs = (x, t)
    losses = [float(step(inputs, y)) for _ in range(STEPS)]
    return losses, bert_state_to_numpy(net.state_dict()), \
        adam_state_to_numpy(step.opt_state)


@pytest.mark.parametrize("amp,fused", [(None, False), (None, True),
                                       ("bfloat16", False)])
def test_trainstep_matches_jax(amp, fused):
    """bench_bert's step at tiny widths: int32 ids, token types, dense CE
    on the MLM logits (or the fused head), AdamW, 3 steps, dropout 0.
    The AdamW state crosses with the unchanged Adam bridge."""
    rng = np.random.default_rng(11)
    ids = rng.integers(0, VOCAB, (2, 12)).astype(np.int32)
    tt = rng.integers(0, 2, (2, 12)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (2, 12)).astype(np.int32)
    jc, params0, jl, jp, js = _train_jax(amp, fused, ids, tt, labels, 11)
    tl, tp, ts = _train_port(jc, params0, amp, ids, tt, labels)
    bf16 = amp is not None
    # the dense bf16 loss: the port rounds CE's sum and mean to bf16 as the
    # eager JAX op does; XLA's compiled step keeps them in f32 (excess
    # precision), so the two part by up to half a bf16 ulp, 2^-8
    np.testing.assert_allclose(tl, jl, rtol=2 ** -8 if bf16 else 1e-5)
    assert tl[-1] < tl[0]
    assert sorted(tp) == sorted(jp) and sorted(ts) == sorted(js)
    # the key third of each qkv bias has a zero gradient in exact
    # arithmetic (a per-row constant in the logits, which softmax drops):
    # both frameworks' gradients there are rounding noise, which AdamW's
    # normalization turns into steps of up to lr of either sign. They are
    # held to that bound, the other parameters to the bars above.
    h = jc.hidden_size
    d, noise = [], []
    for n in jp:
        diff = np.abs(tp[n] - jp[n])
        if n.endswith("attention.qkv.bias"):
            noise.append(diff[h:2 * h])
            diff = np.concatenate([diff[:h], diff[2 * h:]])
        d.append(diff.ravel())
    assert np.concatenate(noise).max() <= 2 * STEPS * LR * 1.01
    d = np.concatenate(d)
    q, q_tol, cap = (0.99, 5e-4, 2 * STEPS * LR) if bf16 else \
        (0.999, 1e-6, 1e-4)
    assert np.quantile(d, q) <= q_tol, (np.quantile(d, q), q_tol)
    assert d.max() <= cap, (d.max(), cap)
    m_tol = 5e-2 if bf16 else 1e-4
    for n in js:
        for slot, w in js[n].items():
            if slot.startswith("moment"):
                np.testing.assert_allclose(
                    ts[n][slot], w, rtol=0,
                    atol=m_tol * float(np.abs(w).max()) + 1e-30,
                    err_msg=f"{n}.{slot}")
            else:
                np.testing.assert_allclose(ts[n][slot], w, rtol=1e-6)
    # the Adam bridge crosses the JAX state into the port and back
    back = adam_state_to_numpy(adam_state_from_numpy(js))
    for n in js:
        for slot in js[n]:
            np.testing.assert_array_equal(back[n][slot], js[n][slot])
