"""The port's ``TrainStep`` held to the JAX ``TrainStep`` on the CPU with
the rest of the optimizer layer: the tiny LLaMA (2 layers, hidden 64)
from the same weights, three steps on one fixed batch, under

- the LLaMA pretraining recipe's schedule (AdamW on LinearWarmup around
  CosineAnnealingDecay, ``scheduler.step()`` after each step; the lr of
  every step equal);
- SGD, Momentum (Nesterov) and Lamb;
- each recompute granularity (full, selective, selective_qkv), without
  and with a flashmask document mask;

and a JAX run of Momentum, RMSProp, NAdam, ASGD, Rprop or Lamb resumed
in the port after one step through ``bridge.optimizer_state_from_numpy``.

Tolerances as ``test_torch_trainstep.py``'s f32 cases: losses rtol
1e-5; 99.9 % of parameter elements within 1e-6 and every one within 1e-4
(an Adam-family step is normalized: a last-bit difference of a near-zero
gradient element moves that parameter by up to lr); state slots within
1e-4 of each slot's largest value (scalars rtol 1e-6).
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.bridge import (llama_state_from_numpy,
                                     llama_state_to_numpy,
                                     optimizer_state_from_numpy,
                                     optimizer_state_to_numpy)
from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

B, S, VOCAB, STEPS, LR = 2, 12, 64, 3, 1e-3
DOCS = [5, 4, 3]


def _opt(mod, name, params):
    """The optimizer of a case, built by ``mod`` (``paddle.optimizer`` or
    the port's)."""
    if name == "warmup_cosine":
        sched = mod.lr.LinearWarmup(mod.lr.CosineAnnealingDecay(
            LR, T_max=10), warmup_steps=2, start_lr=LR / 10, end_lr=LR)
        return mod.AdamW(sched, parameters=params), sched
    kw = {"SGD": dict(learning_rate=0.5),
          "Momentum": dict(learning_rate=0.1, momentum=0.9,
                           use_nesterov=True),
          "Lamb": dict(learning_rate=LR, lamb_weight_decay=0.01),
          "RMSProp": dict(learning_rate=LR, centered=True, momentum=0.5),
          "NAdam": dict(learning_rate=LR),
          "ASGD": dict(learning_rate=0.5, batch_num=2),
          "Rprop": dict(learning_rate=LR),
          "AdamW": dict(learning_rate=LR)}[name]
    return getattr(mod, name)(parameters=params, **kw), None


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels[0, :2] = -100
    return ids, labels


def _jax_run(over, opt_name, docs, ids, labels, seed, steps=STEPS,
             keep_state_after=None):
    paddle.seed(seed)
    jc = JaxLlamaConfig.tiny(vocab=VOCAB, hidden=64, layers=2, heads=4)
    for k, v in dict(over, fused_linear_ce=True, fused_ce_chunks=2).items():
        setattr(jc, k, v)
    net = JaxLlama(jc)
    params0 = {k: np.asarray(v, np.float32)
               for k, v in get_params(net).items()}
    opt, sched = _opt(paddle.optimizer, opt_name, net.parameters())
    step = paddle.jit.TrainStep(net, lambda out, lab: out, opt)
    x, y = paddle.to_tensor(ids), paddle.to_tensor(labels)
    inputs = (x, y) if docs is None else (
        x, y, jF.document_startend_row_indices(docs))
    losses, lrs, mid = [], [], None
    for i in range(steps):
        lrs.append(opt.get_lr())
        losses.append(float(step(inputs, y).numpy()))
        if sched is not None:
            sched.step()
        if keep_state_after == i + 1:
            mid = ({k: np.asarray(v, np.float32)
                    for k, v in get_params(net).items()},
                   _jax_state(step))
    return dict(config=jc, params0=params0, losses=losses, lrs=lrs,
                params={k: np.asarray(v, np.float32)
                        for k, v in get_params(net).items()},
                state=_jax_state(step), mid=mid)


def _jax_state(step):
    return {n: {s: np.asarray(a) for s, a in st.items()}
            for n, st in step._opt_state.items()}


def _port_run(jc, params, opt_name, docs, ids, labels, steps=STEPS,
              state=None):
    net = LlamaForCausalLM(LlamaConfig(**dataclasses.asdict(jc)),
                           device="cpu")
    net.load_state_dict(llama_state_from_numpy(params))
    opt, sched = _opt(topt, opt_name, net.parameters())
    step = tjit.compile_train_step(net, lambda out, lab: out, opt)
    assert step.loss_scale == 1.0
    if state is not None:
        step.opt_state = optimizer_state_from_numpy(state, device="cpu")
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    inputs = (x, y) if docs is None else (
        x, y, tnn.functional.document_startend_row_indices(docs))
    losses, lrs = [], []
    for _ in range(steps):
        lrs.append(opt.get_lr())
        losses.append(float(step(inputs, y)))
        if sched is not None:
            sched.step()
    return dict(losses=losses, lrs=lrs,
                params=llama_state_to_numpy(net.state_dict()),
                state=optimizer_state_to_numpy(step.opt_state))


def _assert_params_close(got, want):
    assert sorted(got) == sorted(want)
    d = np.concatenate([np.abs(got[n] - want[n]).ravel() for n in want])
    assert np.quantile(d, 0.999) <= 1e-6, np.quantile(d, 0.999)
    assert d.max() <= 1e-4, d.max()


def _assert_state_close(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        assert sorted(got[n]) == sorted(want[n]), n
        for slot, w in want[n].items():
            g, w = np.asarray(got[n][slot], np.float64), \
                np.asarray(w, np.float64)
            if w.ndim:
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=1e-4 * float(np.abs(w).max()) + 1e-30,
                    err_msg=f"{n}.{slot}")
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6,
                                           err_msg=f"{n}.{slot}")


# name -> (config overrides, optimizer, flashmask documents)
CASES = {
    "warmup_cosine": ({}, "warmup_cosine", None),
    "sgd": ({}, "SGD", None),
    "momentum_nesterov": ({}, "Momentum", None),
    "lamb": ({}, "Lamb", None),
}
for _gran in ("full", "selective", "selective_qkv"):
    for _docs in (None, DOCS):
        CASES[f"{_gran}{'_flashmask' if _docs else ''}"] = (
            dict(recompute=True, recompute_granularity=_gran), "AdamW",
            _docs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_trainstep_matches_jax(name):
    over, opt_name, docs = CASES[name]
    ids, labels = _batch(len(name))
    j = _jax_run(over, opt_name, docs, ids, labels, seed=len(name))
    t = _port_run(j["config"], j["params0"], opt_name, docs, ids, labels)
    assert t["lrs"] == j["lrs"]
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-5)
    assert t["losses"][-1] < t["losses"][0]
    _assert_params_close(t["params"], j["params"])
    _assert_state_close(t["state"], j["state"])
    if name == "warmup_cosine":
        assert t["lrs"][0] == LR / 10 and t["lrs"][2] == LR


@pytest.mark.parametrize("opt_name", ["Momentum", "RMSProp", "NAdam",
                                      "ASGD", "Rprop", "Lamb"])
def test_jax_state_resumes_in_port(opt_name):
    """The JAX run's parameters and optimizer state after its first step,
    crossed with the bridges, let the port's TrainStep take steps 2 and
    3 to the JAX run's parameters and state."""
    ids, labels = _batch(7)
    j = _jax_run({}, opt_name, None, ids, labels, seed=7,
                 keep_state_after=1)
    params1, state1 = j["mid"]
    t = _port_run(j["config"], params1, opt_name, None, ids, labels,
                  steps=STEPS - 1, state=state1)
    np.testing.assert_allclose(t["losses"], j["losses"][1:], rtol=1e-5)
    _assert_params_close(t["params"], j["params"])
    _assert_state_close(t["state"], j["state"])
