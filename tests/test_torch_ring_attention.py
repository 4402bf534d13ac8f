"""The port's ring attention (``kernels/ring_attention.py``) and its MPMD
form (``mpmd_graph.ring_graph``, ``mpmd_runtime.MpmdRingExecutor``) held
to the JAX package's ``ring_attention_arrays`` on the conftest's
8-device CPU mesh (sep=2 and sep=4), mirroring
``tests/test_recompute_sp_ring.py``.

Gloo worlds of 2 and 4 ranks (the port's ``spawn``, a ``FileStore``;
ranks in ``torch_dist_worker.py``) each run every case on their chunks of
the same inputs: causal and not, GQA with 1 and 2 kv heads, windows of 5
(crossing the chunk boundary) and 16. Tolerances: outputs rtol 1e-4,
atol 1e-5 (the JAX test's against dense attention); the gradients of
sum(out * cot) rtol 1e-3, atol 1e-5 (its gradient tolerance; the port
replays p from the logsumexp where JAX differentiates the online
softmax).

In process: the sep=1 fallback keeps the [b, h, s, d] layout through the
flash entry; ``ring_graph``'s events, messages and dependencies equal
JAX's and pass ``mpmd_lint``; ``MpmdRingExecutor`` (one process, every
stage on the CPU) against JAX ``ring_attention_arrays``, forward and
gradients, at the tolerances above.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import mpmd_graph as jmg
from paddle_tpu.kernels.ring_attention import \
    ring_attention_arrays as jax_ring
from paddle_tpu_torch.analysis.mpmd_lint import check_graph
from paddle_tpu_torch.distributed import mpmd_graph as tmg
from paddle_tpu_torch.distributed.mpmd_runtime import (MpmdGraphRejected,
                                                       MpmdRingExecutor)
from paddle_tpu_torch.kernels.ring_attention import \
    ring_attention_arrays as torch_ring

import torch_dist_worker as W

#: (causal, kv heads, window) over q [2, 4, 16, 8]
CASES = ((False, 4, None), (True, 4, None), (True, 1, None),
         (True, 2, None), (False, 2, None), (True, 4, 5), (True, 2, 5),
         (True, 1, 16))
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def _cases():
    rng = np.random.default_rng(31)
    out = []
    for causal, h_kv, window in CASES:
        f = np.float32
        out.append(dict(
            causal=causal, window=window,
            q=rng.standard_normal((2, 4, 16, 8)).astype(f),
            k=rng.standard_normal((2, h_kv, 16, 8)).astype(f),
            v=rng.standard_normal((2, h_kv, 16, 8)).astype(f),
            cot=rng.standard_normal((2, 4, 16, 8)).astype(f)))
    return out


def _jax_ring(case, sep):
    """JAX ring_attention_arrays on {dp: 8 / sep, sep}: the output and the
    gradients of sum(out * cot)."""
    mesh = jmesh.build_mesh({"dp": 8 // sep, "sep": sep})
    q, k, v, cot = (jnp.asarray(case[n]) for n in ("q", "k", "v", "cot"))

    def loss(q, k, v):
        return jnp.sum(jax_ring(q, k, v, mesh=mesh, causal=case["causal"],
                                window=case["window"]) * cot)

    with jax.set_mesh(mesh):
        out = jax_ring(q, k, v, mesh=mesh, causal=case["causal"],
                       window=case["window"])
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return dict(out=np.asarray(out), dq=np.asarray(grads[0]),
                dk=np.asarray(grads[1]), dv=np.asarray(grads[2]))


def _world(tmp_path_factory, n):
    tmp = tmp_path_factory.mktemp(f"ring{n}")
    cases = _cases()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(dict(ring_cases=cases), f)
    ctx = W.start_world(n, "ring_world", tmp)
    want = [_jax_ring(c, n) for c in cases]
    return W.join_world(ctx, str(tmp)), want


@pytest.fixture(scope="module")
def ring2(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


def _check(ranks, want, i, n):
    s = 16 // n
    for out in ranks:
        got = out["ring"][i]
        part = slice(got["rank"] * s, (got["rank"] + 1) * s)
        np.testing.assert_allclose(got["out"], want[i]["out"][:, :, part],
                                   **OUT_TOL)
        for g in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[g], want[i][g][:, :, part],
                                       **GRAD_TOL)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"causal{c}-hkv{h}-w{w}" for c, h, w in CASES])
def test_ring_sep2_matches_jax(ring2, i):
    _check(*ring2, i, 2)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"causal{c}-hkv{h}-w{w}" for c, h, w in CASES])
def test_ring_sep4_matches_jax(ring4, i):
    _check(*ring4, i, 4)


def test_ring_sep1_keeps_the_layout():
    """With no sep group the entry runs the flash entry in the [b, h, s,
    d] layout (JAX :120-129), equal to JAX's fallback."""
    case = _cases()[3]
    prev = jmesh.get_mesh()
    jmesh.set_mesh(jmesh.build_mesh({"dp": 8}))
    try:
        want = np.asarray(jax_ring(*(jnp.asarray(case[n])
                                     for n in ("q", "k", "v")), causal=True))
    finally:
        jmesh._global_mesh = prev
    got = torch_ring(*(torch.from_numpy(case[n]) for n in ("q", "k", "v")),
                     causal=True)
    assert got.shape == (2, 4, 16, 8)
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)
    with pytest.raises(ValueError, match="causal"):
        torch_ring(*(torch.from_numpy(case[n]) for n in ("q", "k", "v")),
                   causal=False, window=4)


def _events(g):
    return sorted((ev.stage, ev.micro, ev.phase, ev.tick,
                   tuple(sorted((m.peer, tuple(m.tag), tuple(m.shape))
                                for m in ev.sends)),
                   tuple(sorted((m.peer, tuple(m.tag)) for m in ev.recvs)))
                  for ev in g.events())


@pytest.mark.parametrize("R,backward", [(2, True), (4, True), (4, False),
                                        (3, True)])
def test_ring_graph_matches_jax_and_lints_clean(R, backward):
    want = jmg.ring_graph(R, backward=backward)
    got = tmg.ring_graph(R, backward=backward)
    assert _events(got) == _events(want)
    assert sorted(got.deps) == sorted(want.deps)
    assert got.subject == want.subject
    assert not check_graph(got)


@pytest.mark.parametrize("i", [0, 2, 6])
@pytest.mark.parametrize("R", [2, 4])
def test_mpmd_ring_executor_matches_jax(R, i):
    case = _cases()[i]
    want = _jax_ring(case, R)
    ex = MpmdRingExecutor(R, causal=case["causal"], window=case["window"],
                          devices=[torch.device("cpu")])
    out, (dq, dk, dv) = ex.run(*(torch.from_numpy(case[n])
                                 for n in ("q", "k", "v")),
                               dout=torch.from_numpy(case["cot"]))
    np.testing.assert_allclose(out.numpy(), want["out"], **OUT_TOL)
    for name, g in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD_TOL)
    assert ex.stats()["busy_cells"] == 2 * R * R


def test_mpmd_ring_executor_scale_follows_each_run():
    """One executor built without a scale runs two head dims, each at its
    own head_dim ** -0.5, against JAX ``ring_attention_arrays`` (the JAX
    executor keeps the first run's scale; the port's does not)."""
    rng = np.random.default_rng(32)
    ex = MpmdRingExecutor(2, causal=True, devices=[torch.device("cpu")])
    for d in (8, 32):
        case = dict(causal=True, window=None, **{
            n: rng.standard_normal((1, 2, 8, d)).astype(np.float32)
            for n in ("q", "k", "v", "cot")})
        want = _jax_ring(case, 2)
        out, (dq, dk, dv) = ex.run(*(torch.from_numpy(case[n])
                                     for n in ("q", "k", "v")),
                                   dout=torch.from_numpy(case["cot"]))
        np.testing.assert_allclose(out.numpy(), want["out"], **OUT_TOL)
        for name, g in (("dq", dq), ("dk", dk), ("dv", dv)):
            np.testing.assert_allclose(g.numpy(), want[name], **GRAD_TOL)
    assert ex.scale is None


def test_mpmd_ring_executor_refuses_a_bad_graph():
    from paddle_tpu_torch.distributed.mpmd_runtime import MpmdDriver
    g = tmg.ring_graph(2)
    ev = next(e for e in g.events() if e.recvs)
    ev.recvs.clear()
    with pytest.raises(MpmdGraphRejected):
        MpmdDriver(g)
    with pytest.raises(ValueError, match="ring_degree"):
        MpmdRingExecutor(1)
