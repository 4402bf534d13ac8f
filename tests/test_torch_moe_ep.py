"""The port's expert parallelism (the MoE ``ep`` axis) held to the JAX
package on the CPU.

Gloo worlds of 2 ranks (ep=2, and dp=2 with no ep: every rank holds the
4 experts, and routes the data group's tokens as one device does) and 4
ranks (dp=2 x ep=2, dryrun phase 3's mesh,
``paddle_tpu/distributed/dryrun.py:1120``), the port's ``spawn`` and a
``FileStore`` (ranks in ``torch_dist_worker.py``), each run: an
``MoELayer`` (h 32, dff 48, 4 experts, two a rank at ep=2) in the einsum
mode
(one routing group and groups of 16 tokens, which span the data ranks),
the scatter mode (and with drops) and the kernel mode, which falls back
to the einsum dispatch over an ep group (``kernels.moe.dispatch_path.
fallback.ep-sharded``) and keeps the grouped-FFN kernels' plain
versions at dp=2 with no ep; dryrun phase 3's MoENet (the layer and a Linear
head, CE + 0.01 l_aux) for STEPS AdamW steps through
``DistributedTrainStep``; and (ep=2) the tiny ERNIE-MoE's CE + aux loss
with every gradient.

References: the JAX package's ``MoELayer``, ``TrainStep`` and
ERNIE-MoE on one device with the same global weights — its routing is
global, as on its ep mesh, so one device's result is the mesh's. The
kernel mode's reference is JAX's einsum dispatch (its ep-sharded
fallback). Each data rank's loss is D * sum(out * cot) + l_aux on its
rows, the parameter gradients averaged over the data group (as a step
averages them), so they equal JAX's gradients of sum(out * cot) + l_aux
and the input gradient is D times JAX's rows.

Tolerances: outputs, ``l_aux`` and gradients rtol 1e-4, atol 1e-5
(``test_torch_moe.py``'s MoE bar); the step losses rtol 1e-4, atol
1e-5; ERNIE-MoE's loss rtol 1e-5, logits and gradients within
closeness's f32 gate (|got - want| <= 1e-4 max(1, max |want|)).
"""
import dataclasses
import pickle

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JaxMoE
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models.ernie_moe import ErnieMoEConfig as JaxCfg
from paddle_tpu.text.models.ernie_moe import ErnieMoEForCausalLM as JaxErnie
from paddle_tpu_torch.bridge import LINEAR_SUFFIXES

import torch_dist_worker as W

TOL = dict(rtol=1e-4, atol=1e-5)
H, DFF, E = 32, 48, 4
#: name -> (port mode, gate, top_k, capacity factor, group_size); the JAX
#: reference runs "pallas" as its ep fallback, the einsum dispatch
CASES = {"einsum": ("einsum", "gshard", 2, 2.0, None),
         "einsum_groups": ("einsum", "gshard", 2, 1.0, 16),
         "scatter": ("scatter", "gshard", 2, 2.0, None),
         "scatter_drops": ("scatter", "naive", 2, 0.3, None),
         "pallas": ("pallas", "gshard", 2, 2.0, None)}


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _jax_layer(case, params):
    mode, gname, top_k, cf, gs = case
    jl = JaxMoE(d_model=H, d_hidden=DFF, num_experts=E, gate=gname,
                top_k=top_k, capacity_factor=cf, group_size=gs,
                dispatch_mode="einsum" if mode == "pallas" else mode)
    jl.set_state_dict({k: paddle.to_tensor(v) for k, v in params.items()})
    jl.eval()
    return jl


def _jax_layer_grads(case, params, x_np, cot_np):
    jl = _jax_layer(case, params)
    x = paddle.to_tensor(x_np, stop_gradient=False)
    out = jl(x)
    ((out * paddle.to_tensor(cot_np)).sum() + jl.l_aux).backward()
    grads = {"gate_weight": _np(jl.gate_weight.grad)}
    for n in ("w1", "b1", "w2", "b2"):
        grads[n] = _np(getattr(jl.experts, n).grad)
    return dict(out=_np(out), l_aux=float(jl.l_aux.numpy()),
                x_grad=_np(x.grad), grads=grads)


def _jax_net_steps(params, head_w, head_b, x, y):
    class MoENet(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.moe = _jax_layer(CASES["einsum"], params)
            self.head = jnn.Linear(H, 8)

        def forward(self, x):
            return self.head(self.moe(x))

    net = MoENet()
    net.head.weight.set_value(head_w)
    net.head.bias.set_value(head_b)
    net.train()
    ce = jnn.CrossEntropyLoss()

    def loss_fn(out, lab):
        return ce(out.reshape([-1, 8]), lab.reshape([-1])) + \
            0.01 * net.moe.l_aux

    opt = paddle.optimizer.AdamW(W.LR, parameters=net.parameters())
    step = paddle.jit.TrainStep(net, loss_fn, opt)
    return [float(step(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
            for _ in range(W.STEPS)]


def _jax_ernie(ids):
    paddle.seed(5)
    jc = JaxCfg.tiny(vocab=64, hidden=32, layers=2, heads=4, experts=4)
    net = JaxErnie(jc)
    net.eval()
    params = {k: np.asarray(v, np.float32)
              for k, v in get_params(net).items()}
    x = paddle.to_tensor(ids)
    logits = net(x)
    aux = net.aux_loss()
    loss = jF.cross_entropy(logits.reshape([-1, 64]), x.reshape([-1])) + aux
    loss.backward()
    grads = {n: _np(p.grad) for n, p in net.named_parameters()}
    return jc, params, dict(loss=float(loss.numpy()),
                            aux=float(aux.numpy()), logits=_np(logits),
                            grads=grads)


def _world(tmp_path_factory, n, ep=2):
    tmp = tmp_path_factory.mktemp(f"moe{n}_ep{ep}")
    paddle.seed(2)
    jl = JaxMoE(d_model=H, d_hidden=DFF, num_experts=E)
    params = {k: np.asarray(v, np.float32) for k, v in get_params(jl).items()}
    rng = np.random.default_rng(40 + n)
    f = np.float32
    inputs = dict(moe_h=H, moe_dff=DFF, moe_e=E, moe_params=params,
                  moe_cases=CASES, moe_ep=ep,
                  moe_x=rng.standard_normal((2, 32, H)).astype(f),
                  moe_cot=rng.standard_normal((2, 32, H)).astype(f),
                  head_w=(rng.standard_normal((H, 8)) * 0.2).astype(f),
                  head_b=(rng.standard_normal(8) * 0.1).astype(f),
                  net_x=rng.standard_normal((4, 8, H)).astype(f),
                  net_y=rng.integers(0, 8, (4, 8)))
    ids = rng.integers(0, 64, (2, 12))
    jc, eparams, ernie = _jax_ernie(ids)
    inputs.update(ernie_cfg=dataclasses.asdict(jc), ernie_params=eparams,
                  ernie_ids=ids)
    with open(tmp / "inputs.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    ctx = W.start_world(n, "moe_world", tmp)
    want = dict(layer={name: _jax_layer_grads(c, params, inputs["moe_x"],
                                              inputs["moe_cot"])
                       for name, c in CASES.items()},
                net=_jax_net_steps(params, inputs["head_w"],
                                   inputs["head_b"], inputs["net_x"],
                                   inputs["net_y"]),
                ernie=ernie)
    return W.join_world(ctx, str(tmp)), want


@pytest.fixture(scope="module")
def ep2(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return _world(tmp_path_factory, 2, ep=1)


@pytest.fixture(scope="module")
def dp2_ep2(tmp_path_factory):
    return _world(tmp_path_factory, 4)


def _check_layer(ranks, want, name):
    w = want["layer"][name]
    for out in ranks:
        e_local = E // out["ep"]
        got = out["layer"][name]
        d = out["dp"]
        k = w["out"].shape[0] // d
        rows = slice(got["dp_rank"] * k, (got["dp_rank"] + 1) * k)
        assert got["local_experts"] == e_local
        np.testing.assert_allclose(got["out"], w["out"][rows], **TOL)
        np.testing.assert_allclose(got["l_aux"], w["l_aux"], **TOL)
        np.testing.assert_allclose(got["x_grad"], d * w["x_grad"][rows],
                                   **TOL)
        np.testing.assert_allclose(got["grads"]["gate_weight"],
                                   w["grads"]["gate_weight"], **TOL)
        ex = slice(got["ep_rank"] * e_local, (got["ep_rank"] + 1) * e_local)
        for n in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(got["grads"][n], w["grads"][n][ex],
                                       err_msg=n, **TOL)
        path = "kernels.moe.dispatch_path."
        if name == "pallas" and out["ep"] > 1:
            assert got["counters"][path + "fallback.ep-sharded"] == 1
            assert got["counters"][path + "einsum"] == 1
        else:
            assert got["counters"][path + CASES[name][0]] == 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_layer_ep2_matches_jax(ep2, name):
    ranks, want = ep2
    assert [o["ep"] for o in ranks] == [2, 2]
    _check_layer(ranks, want, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_layer_dp2_matches_jax(dp2, name):
    """Data parallelism with no ep: routing is the data group's, as on
    JAX's dp mesh (the capacity from the global token count)."""
    ranks, want = dp2
    assert [(o["dp"], o["ep"]) for o in ranks] == [(2, 1)] * 2
    _check_layer(ranks, want, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_layer_dp2_ep2_matches_jax(dp2_ep2, name):
    ranks, want = dp2_ep2
    assert [(o["dp"], o["ep"]) for o in ranks] == [(2, 2)] * 4
    _check_layer(ranks, want, name)


@pytest.mark.parametrize("world", ["ep2", "dp2", "dp2_ep2"])
def test_moe_net_steps_match_jax(world, request):
    ranks, want = request.getfixturevalue(world)
    for out in ranks:
        np.testing.assert_allclose(out["net"]["losses"], want["net"],
                                   rtol=1e-4, atol=1e-5)


def test_ernie_moe_ep2_matches_jax(ep2):
    ranks, want = ep2
    w = want["ernie"]
    for out in ranks:
        got = out["ernie"]
        assert got["seeded_equal"]
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["aux"], w["aux"], rtol=1e-5)
        np.testing.assert_allclose(got["logits"], w["logits"], rtol=1e-4,
                                   atol=1e-4)
        assert sorted(got["grads"]) == sorted(w["grads"])
        for n, g in got["grads"].items():
            ref = w["grads"][n].T if n.endswith(LINEAR_SUFFIXES) \
                else w["grads"][n]
            tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
            assert float(np.abs(g - ref).max()) <= tol, n
    # each rank holds half of the expert parameters
    full = sum(v.size for n, v in want["ernie"]["grads"].items()
               if ".experts." in n)
    assert all(o["ernie"]["expert_bytes"] * 2 == full for o in ranks)
