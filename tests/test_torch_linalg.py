"""paddle_tpu_torch.linalg (ops/linalg.py and the linalg module) against
the JAX package on the same inputs: values and input gradients where the
result is unique; the decompositions (qr, svd, eig, eigh, lu, cholesky)
by reconstruction and invariants, since their factors are unique only up
to sign or phase; svd_lowrank / pca_lowrank by reconstruction error;
``paddle.linalg`` as a real module; the Tensor methods.

Tolerance: float32 within rtol 1e-4, atol 1e-4 (LAPACK routines differ
in summation order); float64 cases within 1e-9; reconstructions within
1e-4 of the input in f32.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.linalg as jL
import paddle_tpu_torch as tp
import paddle_tpu_torch.linalg as tL

from test_torch_parity_util import arr, cpu_place, run_both  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _cpu(cpu_place):
    yield


def spd(n, batch=(), seed=0):
    a = arr(*batch, n, n, seed=seed)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def both(name, arrays, grad=True, tol=TOL, **kw):
    return run_both(lambda *a: getattr(jL, name)(*a, **kw),
                    lambda *a: getattr(tL, name)(*a, **kw), arrays,
                    grad=grad, tol=tol)


NORMS = {
    "fro": dict(), "fro_axis": dict(axis=1), "fro_2axes": dict(axis=[0, 1]),
    "nuc": dict(p="nuc"), "inf": dict(p=np.inf), "inf_axis": dict(
        p=np.inf, axis=1), "ninf": dict(p=-np.inf), "ninf_axis": dict(
        p=-np.inf, axis=0), "p3": dict(p=3), "p3_axis": dict(p=3, axis=1,
                                                             keepdim=True),
    "p1_2axes": dict(p=1, axis=[0, 1]), "p2_2axes": dict(p=2, axis=[0, 1]),
}


@pytest.mark.parametrize("case", sorted(NORMS))
def test_norm_matches_jax(case):
    both("norm", [arr(4, 5, seed=1)], **NORMS[case])


def test_vector_matrix_norms_cond():
    x = arr(3, 4, 5, seed=2)
    both("vector_norm", [x], p=3.0, axis=[1, 2])
    both("vector_norm", [x])
    both("matrix_norm", [x], p="fro")
    both("matrix_norm", [x], p=1, keepdim=True)
    both("matrix_norm", [x], p="nuc")
    both("cond", [spd(4, seed=3)])
    both("cond", [arr(4, 4, seed=4)], p="fro")


@pytest.mark.parametrize("name,make,kw", [
    ("det", lambda: arr(2, 4, 4, seed=5), {}),
    ("slogdet", lambda: arr(4, 4, seed=6), {}),
    ("inv", lambda: spd(4, (2,), seed=7), {}),
    ("inverse", lambda: spd(3, seed=8), {}),
    ("pinv", lambda: arr(5, 3, seed=9), {}),
    ("matrix_power", lambda: arr(3, 3, seed=10) * 0.5, dict(n=3)),
    ("matrix_power", lambda: spd(3, seed=11), dict(n=-2)),
    ("matrix_exp", lambda: arr(3, 3, seed=12) * 0.5, {}),
    ("matrix_transpose", lambda: arr(2, 3, 4, seed=13), {}),
    ("eigvalsh", lambda: spd(4, seed=14), {}),
    ("svdvals", lambda: arr(5, 3, seed=15), {}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_unary_matches_jax(name, make, kw):
    both(name, [make()], **kw)


def test_solves_match_jax():
    a, b = spd(4, (2,), seed=16), arr(2, 4, 3, seed=17)
    both("solve", [a, b])
    L = np.linalg.cholesky(spd(4, seed=18)).astype(np.float32)
    rhs = arr(4, 2, seed=19)
    for upper in (False, True):
        for transpose in (False, True):
            m = L.T.copy() if upper else L
            both("triangular_solve", [m, rhs], upper=upper,
                 transpose=transpose)
    both("triangular_solve", [L, rhs], upper=False, unitriangular=True)
    both("cholesky_solve", [rhs, L], upper=False)
    both("cholesky_solve", [rhs, L.T.copy()], upper=True)
    both("cholesky_inverse", [L])
    both("cholesky_inverse", [L.T.copy()], upper=True)


@pytest.mark.parametrize("shape,rcond", [((6, 4), None), ((4, 4), None),
                                         ((5, 5), 0.3)])
def test_lstsq_matches_jax(shape, rcond):
    a = arr(*shape, seed=20).astype(np.float64)
    if rcond:
        a[:, -1] = a[:, 0] * 1e-3            # a near-dependent column
    b = arr(shape[0], 2, seed=21).astype(np.float64)
    f64 = dict(dtype="float64")
    want = jL.lstsq(jp.to_tensor(a, **f64), jp.to_tensor(b, **f64),
                    rcond=rcond)
    got = tL.lstsq(tp.to_tensor(a, **f64), tp.to_tensor(b, **f64),
                   rcond=rcond)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-9)
    assert int(got[2].numpy()) == int(want[2].numpy())


def test_lstsq_batched_and_vector():
    a = arr(3, 6, 4, seed=22).astype(np.float64)
    b = arr(3, 6, seed=23).astype(np.float64)
    f64 = dict(dtype="float64")
    sol, res, rank, sv = tL.lstsq(tp.to_tensor(a, **f64),
                                  tp.to_tensor(b, **f64))
    for i in range(3):
        w = jL.lstsq(jp.to_tensor(a[i], **f64), jp.to_tensor(b[i], **f64))
        np.testing.assert_allclose(sol.numpy()[i], w[0].numpy(), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(res.numpy()[i], w[1].numpy(), rtol=1e-9,
                                   atol=1e-9)


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("mode", ["reduced", "complete"])
def test_qr_reconstructs(mode):
    x = arr(2, 5, 3, seed=24)
    q, r = tL.qr(tp.to_tensor(x), mode=mode)
    jq, jr = jL.qr(jp.to_tensor(x), mode=mode)
    assert q.shape == list(jq.shape) and r.shape == list(jr.shape)
    q, r = q.numpy(), r.numpy()
    _close(q @ r, x)
    _close(np.swapaxes(q, -1, -2) @ q, np.eye(q.shape[-1])[None].repeat(2, 0))
    assert np.allclose(np.tril(r, -1), 0)
    # R is unique up to the signs of its rows
    _close(np.abs(r), np.abs(jr.numpy()))
    r_only = tL.qr(tp.to_tensor(x), mode="r")
    _close(np.abs(r_only.numpy()), np.abs(jr.numpy())[..., :3, :])


@pytest.mark.parametrize("full", [False, True])
def test_svd_reconstructs_and_grads_of_invariants(full):
    x = arr(2, 5, 4, seed=25)
    u, s, vh = tL.svd(tp.to_tensor(x), full_matrices=full)
    ju, js, jvh = jL.svd(jp.to_tensor(x), full_matrices=full)
    assert u.shape == list(ju.shape) and vh.shape == list(jvh.shape)
    _close(s.numpy(), js.numpy())
    k = s.shape[-1]
    _close((u.numpy()[..., :k] * s.numpy()[..., None, :]) @
           vh.numpy()[..., :k, :], x)
    # the singular values' gradient is sign-free: hold it to JAX's
    run_both(lambda a: jL.svd(a)[1], lambda a: tL.svd(a)[1], [x], tol=TOL)


def test_eigh_reconstructs_and_eigvalue_grads():
    a = spd(5, (2,), seed=26)
    w, v = tL.eigh(tp.to_tensor(a))
    jw, _ = jL.eigh(jp.to_tensor(a))
    _close(w.numpy(), jw.numpy())
    vv = v.numpy()
    _close(vv @ (w.numpy()[..., None] * np.swapaxes(vv, -1, -2)), a, 1e-3)
    run_both(lambda m: jL.eigh(m)[0], lambda m: tL.eigh(m)[0], [a], tol=TOL)
    up = tL.eigh(tp.to_tensor(a), UPLO="U")[0].numpy()
    _close(up, jL.eigh(jp.to_tensor(a), UPLO="U")[0].numpy())


def test_eig_and_eigvals():
    a = arr(4, 4, seed=27)
    w, v = tL.eig(tp.to_tensor(a))
    jw = jL.eigvals(jp.to_tensor(a)).numpy()
    key = lambda z: np.round(z.real, 4) + 1j * np.round(z.imag, 4)  # noqa
    _close(np.sort_complex(key(w.numpy())), np.sort_complex(key(jw)), 1e-3)
    _close(a.astype(np.complex64) @ v.numpy(), v.numpy() * w.numpy(), 1e-3)
    _close(np.sort_complex(key(tL.eigvals(tp.to_tensor(a)).numpy())),
           np.sort_complex(key(jw)), 1e-3)
    assert w.stop_gradient


def test_cholesky_and_grads():
    a = spd(4, (2,), seed=28)
    both("cholesky", [a])
    both("cholesky", [a], upper=True)


def test_lu_and_unpack_match_jax():
    a = arr(4, 4, seed=29)
    lu_, piv = tL.lu(tp.to_tensor(a))
    jlu, jpiv = jL.lu(jp.to_tensor(a))
    _close(lu_.numpy(), jlu.numpy())
    np.testing.assert_array_equal(piv.numpy(), jpiv.numpy())
    assert piv.numpy().dtype == np.int32
    P, L, U = tL.lu_unpack(lu_, piv)
    jP, jLm, jU = jL.lu_unpack(jlu, jpiv)
    for g, w in ((P, jP), (L, jLm), (U, jU)):
        _close(g.numpy(), w.numpy())
    _close(P.numpy() @ L.numpy() @ U.numpy(), a)
    _, _, info = tL.lu(tp.to_tensor(a), get_infos=True)
    assert int(info.numpy()) == 0


def test_lowrank_reconstruction():
    rng = np.random.default_rng(30)
    x = (rng.standard_normal((8, 3)) @ rng.standard_normal((3, 6))
         ).astype(np.float32)                     # rank 3
    u, s, v = tL.svd_lowrank(tp.to_tensor(x), q=3)
    assert u.shape == [8, 3] and s.shape == [3] and v.shape == [6, 3]
    _close((u.numpy() * s.numpy()) @ v.numpy().T, x, 1e-3)
    u, s, v = tL.pca_lowrank(tp.to_tensor(x), q=3)
    xc = x - x.mean(0, keepdims=True)
    _close((u.numpy() * s.numpy()) @ v.numpy().T, xc, 1e-3)
    js = jL.pca_lowrank(jp.to_tensor(x), q=3)[1].numpy()
    _close(s.numpy(), js)


def test_householder_ormqr_multi_dot():
    a = arr(5, 3, seed=31)
    tau = arr(3, seed=32, lo=0.2, hi=1.0)
    both("householder_product", [a, tau])
    both("ormqr", [a, tau, arr(5, 2, seed=33)])
    both("ormqr", [a, tau, arr(2, 5, seed=34)], left=False, transpose=True)
    run_both(lambda *m: jL.multi_dot(list(m)),
             lambda *m: tL.multi_dot(list(m)),
             [arr(3, 4, seed=35), arr(4, 5, seed=36), arr(5, 2, seed=37)],
             tol=TOL)


def test_rank_and_distances():
    low = (arr(6, 2, seed=38) @ arr(2, 5, seed=39)).astype(np.float32)
    both("matrix_rank", [low], grad=False)
    run_both(lambda a: jp.ops.linalg.matrix_rank_atol_rtol(a, rtol=1e-3),
             lambda a: tp.ops.linalg.matrix_rank_atol_rtol(a, rtol=1e-3),
             [low], grad=False)
    run_both(lambda a: jp.ops.linalg.matrix_rank_tol(a, tol=1e-3),
             lambda a: tp.ops.linalg.matrix_rank_tol(a, tol=1e-3),
             [low], grad=False)
    x, y = arr(2, 4, 3, seed=40), arr(2, 5, 3, seed=41)
    for p in (2.0, 1.0, 0.0, np.inf):
        run_both(lambda a, b: jp.cdist(a, b, p=p),
                 lambda a, b: tp.cdist(a, b, p=p), [x, y], tol=TOL,
                 grad=p != 0.0)
    run_both(lambda a: jp.pdist(a), lambda a: tp.pdist(a),
             [arr(5, 3, seed=42)], tol=TOL)
    run_both(lambda w: jp.ops.linalg.spectral_norm(w, power_iters=3),
             lambda w: tp.ops.linalg.spectral_norm(w, power_iters=3),
             [arr(4, 6, seed=43)], tol=TOL)


def test_cross_einsum_cov_corrcoef():
    a, b = arr(4, 3, seed=44), arr(4, 3, seed=45)
    both("cross", [a, b])                     # axis 9: first size-3 axis
    both("cross", [a, b], axis=1)
    run_both(lambda x, y: jp.einsum("ij,kj->ik", x, y),
             lambda x, y: tp.einsum("ij,kj->ik", x, y), [a, b], tol=TOL)
    both("cov", [arr(3, 6, seed=46)])
    both("corrcoef", [arr(3, 6, seed=47)])


@pytest.mark.parametrize("tx,ty,bias", [(False, False, False),
                                        (True, False, True),
                                        (False, True, False)])
@pytest.mark.parametrize("out", ["float16", "bfloat16"])
def test_fp8_gemm_emulation_matches_jax(tx, ty, bias, out):
    x = arr(8, 16, seed=48, lo=-3, hi=3)
    y = arr(16, 8, seed=49, lo=-3, hi=3)
    if tx:
        x = x.T.copy()
    if ty:
        y = y.T.copy()
    args = [x, y] + ([arr(8, seed=50)] if bias else [])
    jo = jL.fp8_fp8_half_gemm_fused(
        *[jp.to_tensor(v) for v in args[:2]],
        bias=jp.to_tensor(args[2]) if bias else None, transpose_x=tx,
        transpose_y=ty, scale=0.5, output_dtype=out)
    to = tL.fp8_fp8_half_gemm_fused(
        *[tp.to_tensor(v) for v in args[:2]],
        bias=tp.to_tensor(args[2]) if bias else None, transpose_x=tx,
        transpose_y=ty, scale=0.5, output_dtype=out)
    assert str(to.dtype).endswith(out)
    # the quantised operands are equal bit for bit; the half-precision
    # products may round differently in the last place
    np.testing.assert_allclose(np.asarray(to.numpy(), np.float32),
                               np.asarray(jo.numpy(), np.float32),
                               rtol=2e-2, atol=0.25)


def test_linalg_is_a_module_and_methods():
    import importlib
    mod = importlib.import_module("paddle_tpu_torch.linalg")
    assert tp.linalg is mod
    for name in ("cholesky", "inv", "det", "qr", "svd", "lstsq", "norm",
                 "eigh", "solve", "pinv", "matrix_power", "multi_dot"):
        assert callable(getattr(mod, name)), name
    x = tp.to_tensor(spd(3, seed=51))
    for name in ("cholesky", "inv", "det", "norm", "slogdet", "pinv"):
        got = getattr(x, name)()
        want = getattr(jp.to_tensor(spd(3, seed=51)), name)()
        _close(got.numpy(), want.numpy())
    assert tp.norm is tL.norm and tp.einsum is tp.ops.linalg.einsum
