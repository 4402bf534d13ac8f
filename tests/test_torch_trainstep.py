"""The port's ``TrainStep`` held to the JAX ``TrainStep`` on the CPU:
the tiny LLaMA (2 layers, hidden 64) from the same weights, AdamW, three
steps on one fixed batch. Losses per step, the parameters after the
steps and the whole AdamW state (moments and beta powers, crossed back
with ``bridge.adam_state_to_numpy``) must match, for the unfused and the
fused (4-chunk) LM loss, GQA with a window, a flashmask document mask,
full recompute, global-norm clipping, and bf16 AMP with bf16 moments.

Tolerances. AdamW's step is normalized, lr * m / sqrt(v): where a
gradient element is near zero it acts like a sign, so a difference in the
last bits of such an element (the frameworks sum in other orders) moves
that parameter by up to lr per step. Parameters are therefore held to a
quantile plus a cap: f32 cases — losses rtol 1e-5, 99.9 % of parameter
elements within 1e-6 (measured 1.2e-7) and every element within 1e-4, a
tenth of one step's lr (measured <= 1.3e-5); moments within 1e-4 of each
slot's largest value (measured <= 7e-6). bf16 AMP with bf16 moments —
both forwards round in bf16 at other places (XLA fuses, PyTorch rounds
per op), measured loss gap 5.5e-4 relative: losses rtol 2e-3, 99 % of
parameter elements within 5e-4 (measured 1.9e-4) and every element
within 2 * STEPS * lr, the most two 3-step trajectories can part
(measured 4.3e-3); moments within 5e-2 of each slot's largest value
(measured 2.3e-2: bf16 gradients differ by ~1 %, and the moments are
stored in bf16).
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.bridge import (adam_state_from_numpy,
                                     adam_state_to_numpy,
                                     llama_state_from_numpy,
                                     llama_state_to_numpy)
from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

B, S, VOCAB, STEPS, LR = 2, 12, 64, 3, 1e-3

# name -> (config overrides, flashmask doc lengths, clip, amp)
CASES = {
    "unfused_ce": (dict(), None, None, None),
    "fused_ce4": (dict(fused_linear_ce=True, fused_ce_chunks=4), None, None,
                  None),
    "gqa_window": (dict(num_key_value_heads=2, sliding_window=5), None, None,
                   None),
    "flashmask_doc": (dict(fused_linear_ce=True, fused_ce_chunks=2),
                      [5, 4, 3], None, None),
    "recompute_full": (dict(recompute=True), None, None, None),
    "clip_global": (dict(), None, 0.5, None),
    "amp_bf16": (dict(fused_linear_ce=True, fused_ce_chunks=4), None, None,
                 "bfloat16"),
}


def _run_jax(over, docs, clip, amp, ids, labels, seed):
    paddle.seed(seed)
    jc = JaxLlamaConfig.tiny(vocab=VOCAB, hidden=64, layers=2, heads=4)
    for k, v in over.items():
        setattr(jc, k, v)
    net = JaxLlama(jc)
    params0 = {k: np.asarray(v, np.float32)
               for k, v in get_params(net).items()}
    opt = paddle.optimizer.AdamW(
        LR, parameters=net.parameters(),
        grad_clip=None if clip is None else jnn.ClipGradByGlobalNorm(clip),
        moment_dtype=amp)
    fused = over.get("fused_linear_ce", False)
    step = paddle.jit.TrainStep(
        net, (lambda out, lab: out) if fused else jnn.CrossEntropyLoss(),
        opt, amp_dtype=amp)
    x, y = paddle.to_tensor(ids), paddle.to_tensor(labels)
    inputs = x
    if fused:
        inputs = (x, y) if docs is None else (
            x, y, jF.document_startend_row_indices(docs))
    losses = [float(step(inputs, y).numpy()) for _ in range(STEPS)]
    state = {n: {s: np.asarray(a.astype(np.float32)) for s, a in st.items()}
             for n, st in step._opt_state.items()}
    params = {k: np.asarray(v, np.float32) for k, v in get_params(net).items()}
    return jc, params0, losses, params, state


def _run_port(jc, params0, docs, clip, amp, ids, labels):
    net = LlamaForCausalLM(LlamaConfig(**dataclasses.asdict(jc)),
                           device="cpu")
    net.load_state_dict(llama_state_from_numpy(params0))
    opt = topt.AdamW(
        LR, parameters=net.parameters(),
        grad_clip=None if clip is None else tnn.ClipGradByGlobalNorm(clip),
        moment_dtype=amp)
    fused = jc.fused_linear_ce
    step = tjit.TrainStep(
        net, (lambda out, lab: out) if fused else tnn.CrossEntropyLoss(),
        opt, amp_dtype=amp)
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    inputs = x
    if fused:
        inputs = (x, y) if docs is None else (
            x, y, tnn.functional.document_startend_row_indices(docs))
    losses = [float(step(inputs, y)) for _ in range(STEPS)]
    return losses, llama_state_to_numpy(net.state_dict()), \
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
            else:                              # beta powers: f32 scalars
                np.testing.assert_allclose(g, w, rtol=1e-6,
                                           err_msg=f"{n}.{slot}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_trainstep_matches_jax(name):
    over, docs, clip, amp = CASES[name]
    rng = np.random.default_rng(len(name))
    ids = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels[0, :2] = -100                      # ignored targets
    jc, params0, jl, jp, js = _run_jax(over, docs, clip, amp, ids, labels,
                                       seed=len(name))
    tl, tp, ts = _run_port(jc, params0, docs, clip, amp, ids, labels)
    bf16 = amp is not None
    np.testing.assert_allclose(tl, jl, rtol=2e-3 if bf16 else 1e-5)
    assert tl[-1] < tl[0]
    assert sorted(tp) == sorted(jp) and sorted(ts) == sorted(js)
    d = np.concatenate([np.abs(tp[n] - jp[n]).ravel() for n in jp])
    q, q_tol, cap = (0.99, 5e-4, 2 * STEPS * LR) if bf16 else \
        (0.999, 1e-6, 1e-4)
    assert np.quantile(d, q) <= q_tol, (np.quantile(d, q), q_tol)
    assert d.max() <= cap, (d.max(), cap)
    _assert_state_close(ts, js, 5e-2 if bf16 else 1e-4)


def test_adam_state_from_numpy_resumes_jax_run():
    """The JAX run's parameters and AdamW state after its first step,
    crossed in with ``adam_state_from_numpy`` (bf16 moments, as the main
    path keeps them), let the port's TrainStep take steps 2 and 3: its
    losses and parameters then match the JAX run's within the f32 cases'
    tolerances, and its moments within 1e-2 of each slot's largest value
    (measured 1.5e-3: a moment whose f32 value lies near a bf16 rounding
    boundary may round to its neighbour, 2^-8 of it, on one side)."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    paddle.seed(7)
    jc = JaxLlamaConfig.tiny(vocab=VOCAB, hidden=64, layers=2, heads=4)
    net = JaxLlama(jc)
    opt = paddle.optimizer.AdamW(LR, parameters=net.parameters(),
                                 moment_dtype="bfloat16")
    jstep = paddle.jit.TrainStep(net, jnn.CrossEntropyLoss(), opt)
    x, y = paddle.to_tensor(ids), paddle.to_tensor(labels)
    jl = [float(jstep(x, y).numpy())]
    params1 = {k: np.asarray(v, np.float32) for k, v in get_params(net).items()}
    state1 = {n: {s: np.asarray(a.astype(np.float32)) for s, a in st.items()}
              for n, st in jstep._opt_state.items()}
    jl += [float(jstep(x, y).numpy()) for _ in range(2)]
    jp = {k: np.asarray(v, np.float32) for k, v in get_params(net).items()}
    js = {n: {s: np.asarray(a.astype(np.float32)) for s, a in st.items()}
          for n, st in jstep._opt_state.items()}

    tnet = LlamaForCausalLM(LlamaConfig(**dataclasses.asdict(jc)),
                            device="cpu")
    tnet.load_state_dict(llama_state_from_numpy(params1))
    topt_ = topt.AdamW(LR, parameters=tnet.parameters(),
                       moment_dtype="bfloat16")
    tstep = tjit.TrainStep(tnet, tnn.CrossEntropyLoss(), topt_)
    tstep.opt_state = adam_state_from_numpy(state1, device="cpu",
                                            moment_dtype=torch.bfloat16)
    assert all(st["moment1"].dtype == torch.bfloat16
               for st in tstep.opt_state.values())
    tl = [float(tstep(torch.from_numpy(ids), torch.from_numpy(labels)))
          for _ in range(2)]
    np.testing.assert_allclose(tl, jl[1:], rtol=1e-5)
    tp = llama_state_to_numpy(tnet.state_dict())
    d = np.concatenate([np.abs(tp[n] - jp[n]).ravel() for n in jp])
    assert np.quantile(d, 0.999) <= 1e-6 and d.max() <= 1e-4, d.max()
    _assert_state_close(adam_state_to_numpy(tstep.opt_state), js, 1e-2)
    with pytest.raises(ValueError, match="trainable parameters"):
        tstep.opt_state = {"no.such.param": {}}


def test_sync_to_model_hands_state_to_eager_step():
    """After ``sync_to_model`` the optimizer's eager step continues the
    TrainStep run: one eager step (``backward`` then ``opt.step()``) lands
    where a second TrainStep step lands, and shares its state."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(0, VOCAB, (B, S)).astype(np.int64))
    y = torch.from_numpy(rng.integers(0, VOCAB, (B, S)).astype(np.int64))
    cfg = LlamaConfig.tiny(vocab=VOCAB)
    nets = [LlamaForCausalLM(cfg, device="cpu", seed=3) for _ in range(2)]
    opts = [topt.AdamW(LR, parameters=n.parameters()) for n in nets]
    steps = [tjit.TrainStep(n, tnn.CrossEntropyLoss(), o)
             for n, o in zip(nets, opts)]
    for st in steps:
        st(x, y)
    steps[0](x, y)                              # step 2 by TrainStep
    steps[1].sync_to_model()                    # step 2 eager
    tnn.CrossEntropyLoss()(nets[1](x), y).backward()
    opts[1].step()
    for (n, a), b in zip(nets[0].named_parameters(), nets[1].parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6, msg=n)
        st = opts[1]._accumulators[id(b)]
        assert st is steps[1].opt_state[n]
        torch.testing.assert_close(st["beta1_pow"],
                                   steps[0].opt_state[n]["beta1_pow"])
