"""The slice as a whole at a small size: the eager training loop written
against the paddle API (Embedding -> TransformerEncoder with a bool key
padding mask -> Linear head on the first token -> cross_entropy; AdamW,
backward, step, clear_grad), run through the JAX package and through the
port on the CPU, the port's weights carried across from the JAX model
(bridge.layer_state_from_jax). 2 layers, d_model 32, 4 heads, FFN 64,
batch 4 x 16, dropout 0 (dropout is held to its keep rate and scale in
test_torch_nn_layers.py).

Tolerance: after 3 AdamW steps the losses and every parameter agree
within 1e-5 (absolute and relative) in float32, and within 2e-2 under
amp.auto_cast O1 bfloat16.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import monitor
from paddle_tpu_torch.bridge import layer_state_from_jax
from paddle_tpu_torch.core import place as place_mod

VOCAB, D, HEADS, FFN, LAYERS, B, L, STEPS = 50, 32, 4, 64, 2, 4, 16, 3


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


def build(P):
    nn = P.nn
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        D, HEADS, FFN, dropout=0.0, activation="gelu"), LAYERS)
    return nn.Sequential(nn.Embedding(VOCAB, D), enc, nn.Linear(D, 2))


def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (B, L))
    lens = np.array([16, 11, 7, 16])
    keep = (np.arange(L)[None] < lens[:, None])[:, None, None, :]
    labels = rng.integers(0, 2, (B,))
    return ids, keep, labels


def train(P, model, amp):
    emb, enc, head = model[0], model[1], model[2]
    opt = P.optimizer.AdamW(learning_rate=1e-3,
                            parameters=model.parameters(), weight_decay=0.01)
    ids, keep, labels = (P.to_tensor(x) for x in batch())
    losses, dtypes = [], None
    for _ in range(STEPS):
        with P.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
            h = enc(emb(ids), src_mask=keep)
            logits = head(h[:, 0])
            loss = P.nn.functional.cross_entropy(logits, labels)
        dtypes = (logits.dtype.name, h.dtype.name, loss.dtype.name)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    params = {k: np.asarray(v.astype("float32").numpy(), np.float64)
              for k, v in model.state_dict().items()}
    return np.array(losses), params, dtypes


@pytest.mark.parametrize("amp,tol", [(False, 1e-5), (True, 2e-2)],
                         ids=["f32", "o1_bf16"])
def test_eager_training_matches_jax(amp, tol):
    # the JAX model's initial weights must not depend on the test files an
    # xdist worker ran before this one: the default generator's first draws
    jp.seed(0)
    jm, tm = build(jp), build(tp)
    init = layer_state_from_jax(jm)
    tm.set_state_dict(init)
    monitor.reset()
    jl, jparams, jd = train(jp, jm, amp)
    tl, tparams, td = train(tp, tm, amp)
    counts = monitor.snapshot()
    assert td == jd
    if amp:
        assert td == ("bfloat16", "float32", "float32")
    np.testing.assert_allclose(tl, jl, rtol=tol, atol=tol)
    assert tl[-1] < tl[0]
    assert sorted(tparams) == sorted(jparams)
    for k in jparams:
        if k.endswith("k_proj.bias"):
            # its gradient is 0 in exact arithmetic (softmax ignores a
            # shift shared by every key), so Adam steps it by rounding
            # noise in either package: held to Adam's step bound
            moved = np.abs(tparams[k] - init[k])
            assert moved.max() <= STEPS * 1e-3 * 1.01 + 1e-6, k
            continue
        np.testing.assert_allclose(tparams[k], jparams[k], rtol=tol,
                                   atol=tol, err_msg=k)
    # the path ran the flash kernels' plain versions with key-mask bands
    assert counts["kernels.flash.sdpa.plain_mask"] == LAYERS * STEPS
    assert counts["kernels.flash.fwd_plain"] == LAYERS * STEPS
    assert counts["kernels.flash.bwd_plain"] == LAYERS * STEPS
    assert counts.get("kernels.flash.sdpa.dense_mask", 0) == 0


def test_minimize_clip_and_grad_scaler_take_surface_tensors():
    m = build(tp)
    opt = tp.optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters(),
                             grad_clip=tp.nn.ClipGradByGlobalNorm(0.1))
    ids, keep, labels = (tp.to_tensor(x) for x in batch())
    before = m[2].weight.numpy().copy()
    scaler = tp.amp.GradScaler(init_loss_scaling=128.0)
    loss = tp.nn.functional.cross_entropy(m[2](m[1](m[0](ids), keep)[:, 0]),
                                          labels)
    scaled = scaler.scale(loss)
    assert isinstance(scaled, tp.Tensor)
    np.testing.assert_allclose(float(scaled), 128.0 * float(loss), rtol=1e-6)
    scaled.backward()
    scaler.step(opt)
    scaler.update()
    assert not np.array_equal(m[2].weight.numpy(), before)
    opt.clear_grad()
    assert all(p.grad is None for p in m.parameters())
    loss = tp.nn.functional.cross_entropy(m[2](m[1](m[0](ids), keep)[:, 0]),
                                          labels)
    opt.minimize(loss)
    clip = tp.nn.ClipGradByNorm(0.5)
    g = tp.to_tensor(np.full(4, 3.0, np.float32))
    (out,) = clip.clip_grads([g])
    assert isinstance(out, tp.Tensor)
    np.testing.assert_allclose(np.linalg.norm(out.numpy()), 0.5, rtol=1e-6)
    ((p, c),) = clip([(m[2].bias, g)])
    assert p is m[2].bias and isinstance(c, tp.Tensor)
