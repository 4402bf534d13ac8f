"""Linear algebra ops (counterpart of ``paddle_tpu/ops/linalg.py``).

Each op is ``run_op`` over ``torch.linalg`` (LAPACK on the CPU, cuSOLVER
and cuBLAS on the card) under the JAX package's op name. Where the JAX
op returns plain arrays with no gradient (``lstsq``, ``eig``,
``eigvals``, ``lu``, ``lu_unpack``, ``pca_lowrank``), the port does too.
``lstsq`` is the JAX package's SVD solve (rank-revealing on every
device, with batch dims); ``svd_lowrank`` and ``pca_lowrank`` are the
full SVD cut to ``q`` columns, as in the JAX package, so they draw no
randomness. ``fp8_fp8_half_gemm_fused`` quantises both operands through
``float8_e4m3fn`` and multiplies in the half output dtype.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op, run_op_nodiff, unwrap, wrap
from .math import bmm, conj, dot, matmul, mm, mv  # noqa: F401
from .math import cross as _math_cross
from .stat import corrcoef as _stat_corrcoef, cov  # noqa: F401


def _ax(axis):
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return None if axis is None else int(axis)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    def fn(a):
        ax = _ax(axis)
        if p is None or p == "fro":
            if ax is None:
                return torch.sqrt(torch.sum(a * a))
            return torch.linalg.norm(a, ord=None, dim=ax, keepdim=keepdim)
        if p == "nuc":
            return torch.linalg.norm(a, ord="nuc", dim=ax, keepdim=keepdim)
        if p == float("inf"):
            if ax is None:
                return torch.max(torch.abs(a))
            return torch.linalg.norm(a, ord=float("inf"), dim=ax,
                                     keepdim=keepdim)
        if p == float("-inf"):
            if ax is None:
                return torch.min(torch.abs(a))
            return torch.linalg.norm(a, ord=float("-inf"), dim=ax,
                                     keepdim=keepdim)
        if ax is None:
            return torch.sum(torch.abs(a) ** p) ** (1.0 / p)
        if isinstance(ax, tuple) and len(ax) == 2:
            return torch.linalg.norm(a, ord=p, dim=ax, keepdim=keepdim)
        return torch.sum(torch.abs(a) ** p, dim=ax,
                         keepdim=keepdim) ** (1.0 / p)
    return run_op("norm", fn, [x])


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return run_op("vector_norm", lambda a: torch.linalg.vector_norm(
        a, ord=p, dim=_ax(axis), keepdim=keepdim), [x])


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    # the JAX op reads the last two axes whatever ``axis`` says
    return run_op("matrix_norm", lambda a: torch.linalg.matrix_norm(
        a, ord=p, keepdim=keepdim), [x])


def cond(x, p=None, name=None):
    """The JAX rule: s_max / s_min for p None / 2 / -2 (its inverse for
    -2), else norm(x, p) * norm(inv(x), p)."""
    def fn(a):
        if p is None or p in (2, -2):
            s = torch.linalg.svdvals(a)
            r = s[..., 0] / s[..., -1]
            return 1.0 / r if p == -2 else r
        return torch.linalg.matrix_norm(a, ord=p) * torch.linalg.matrix_norm(
            torch.linalg.inv(a), ord=p)
    return run_op("cond", fn, [x])


def matrix_rank(x, tol=None, hermitian=False, name=None):
    def fn(a):
        if tol:
            return torch.linalg.matrix_rank(a, rtol=tol).to(torch.int64)
        return torch.linalg.matrix_rank(a).to(torch.int64)
    return run_op_nodiff("matrix_rank", fn, [x])


def matrix_transpose(x, name=None):
    return run_op("matrix_transpose", lambda a: a.transpose(-1, -2), [x])


def matrix_power(x, n, name=None):
    return run_op("matrix_power",
                  lambda a: torch.linalg.matrix_power(a, n), [x])


def det(x, name=None):
    return run_op("det", torch.linalg.det, [x])


def slogdet(x, name=None):
    def fn(a):
        sign, logabs = torch.linalg.slogdet(a)
        return torch.stack([sign, logabs])
    return run_op("slogdet", fn, [x])


def inv(x, name=None):
    return run_op("inv", torch.linalg.inv, [x])


def inverse(x, name=None):
    return inv(x, name)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return run_op("pinv", lambda a: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian), [x])


def solve(x, y, name=None):
    return run_op("solve", torch.linalg.solve, [x, y])


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def fn(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)
    return run_op("triangular_solve", fn, [x, y])


def _cho_solve(b, c, upper):
    """A^-1 b for A = c c^H (lower c) or c^H c (upper c), as two
    triangular solves: the gradient reaches c's triangle only, as the JAX
    ``cho_solve``'s does."""
    if upper:
        y = torch.linalg.solve_triangular(c.mH, b, upper=False)
        return torch.linalg.solve_triangular(c, y, upper=True)
    y = torch.linalg.solve_triangular(c, b, upper=False)
    return torch.linalg.solve_triangular(c.mH, y, upper=True)


def cholesky_solve(x, y, upper=False, name=None):
    return run_op("cholesky_solve", lambda b, c: _cho_solve(b, c, upper),
                  [x, y])


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values) by the JAX package's
    SVD solve: singular values below ``rcond`` x the largest are dropped;
    residuals are the squared column norms of ``y - x @ solution``."""
    a, b = unwrap(x).detach(), unwrap(y).detach()
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b[..., None]
    m, n = a.shape[-2], a.shape[-1]
    if rcond is None:
        rcond = float(torch.finfo(a.dtype).eps) * builtins.max(m, n)
    elif rcond < 0:
        rcond = float(torch.finfo(a.dtype).eps)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[..., :1])
    rank = mask.sum(-1)
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[..., None]
    sol = vh.mH @ (s_inv * (u.mH @ b))
    res = torch.linalg.vector_norm(b - a @ sol, dim=-2) ** 2
    if vec:
        sol, res = sol[..., 0], res[..., 0]
    return wrap(sol), wrap(res), wrap(rank), wrap(s)


def cholesky(x, upper=False, name=None):
    return run_op("cholesky",
                  lambda a: torch.linalg.cholesky(a, upper=upper), [x])


def cholesky_inverse(x, upper=False, name=None):
    def fn(c):
        eye = torch.eye(c.shape[-1], dtype=c.dtype, device=c.device)
        return _cho_solve(eye, c, upper)
    return run_op("cholesky_inverse", fn, [x])


def qr(x, mode="reduced", name=None):
    """(Q, R) for ``reduced`` / ``complete``; R alone for ``r``."""
    if mode == "r":
        return run_op("qr", lambda a: torch.linalg.qr(a, mode="r")[1], [x])
    q, r = run_op("qr", lambda a: tuple(torch.linalg.qr(a, mode=mode)), [x])
    return q, r


def svd(x, full_matrices=False, name=None):
    """(U, S, VH) with X = U @ diag(S) @ VH."""
    return run_op("svd", lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), [x])


def svdvals(x, name=None):
    return run_op("svdvals", torch.linalg.svdvals, [x])


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """(U, S, V) of the leading min(q, m, n) singular triplets (V, not
    VH): the full SVD cut to size, as in the JAX package."""
    from .manipulation import slice as slice_op
    u, s, vh = svd(x)
    v = conj(matrix_transpose(vh))
    shp = unwrap(x).shape
    k = builtins.min(q, shp[-1], shp[-2])
    return (slice_op(u, [u.ndim - 1], [0], [k]),
            slice_op(s, [s.ndim - 1], [0], [k]),
            slice_op(v, [v.ndim - 1], [0], [k]))


def eig(x, name=None):
    w, v = run_op_nodiff("eig", lambda a: tuple(torch.linalg.eig(a)), [x])
    return w, v


def eigvals(x, name=None):
    return run_op_nodiff("eigvals", torch.linalg.eigvals, [x])


def eigh(x, UPLO="L", name=None):
    return run_op("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)),
                  [x])


def eigvalsh(x, UPLO="L", name=None):
    return run_op("eigvalsh",
                  lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO), [x])


def lu(x, pivot=True, get_infos=False, name=None):
    """(LU, 1-based int32 pivots[, info]) of the packed factorisation."""
    lu_, piv = run_op_nodiff(
        "lu", lambda a: tuple(torch.linalg.lu_factor(a)), [x])
    if get_infos:
        info = torch.zeros((), dtype=torch.int32, device=lu_._data.device)
        return lu_, piv, wrap(info)
    return lu_, piv


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) with X = P @ L @ U from ``lu``'s packed output."""
    lu_, piv = unwrap(x).detach(), unwrap(y)
    n = lu_.shape[-2]
    eye = torch.eye(n, lu_.shape[-1], dtype=lu_.dtype, device=lu_.device)
    L = torch.tril(lu_, -1) + eye
    U = torch.triu(lu_)
    perm = np.arange(n)
    pv = np.asarray(piv.detach().cpu()) - 1
    for i, p in enumerate(pv.reshape(-1)[:n]):
        perm[i], perm[p] = perm[p], perm[i]
    P = torch.eye(n, dtype=lu_.dtype, device=lu_.device)[
        torch.as_tensor(perm, device=lu_.device)].T
    return (wrap(P), wrap(L[..., :n, :builtins.min(n, lu_.shape[-1])]),
            wrap(U))


def multi_dot(x, name=None):
    return run_op("multi_dot", lambda *xs: torch.linalg.multi_dot(xs),
                  list(x))


def householder_product(x, tau, name=None):
    return run_op("householder_product", torch.linalg.householder_product,
                  [x, tau])


def corrcoef(x, rowvar=True, name=None):
    return _stat_corrcoef(x, rowvar, name)


def cross(x, y, axis=9, name=None):
    """``axis`` 9 (the default) is the first axis of size 3."""
    return _math_cross(x, y, axis, name)


def einsum(equation, *operands):
    ops_list = list(operands[0]) if len(operands) == 1 and isinstance(
        operands[0], (list, tuple)) else list(operands)
    return run_op("einsum", lambda *arrs: torch.einsum(equation, *arrs),
                  ops_list)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """(U, S, V) of the (centred) input's leading q triplets, from the
    full SVD."""
    shp = unwrap(x).shape
    q = q if q is not None else builtins.min(6, shp[-2], shp[-1])

    def fn(a):
        if center:
            a = a - a.mean(dim=-2, keepdim=True)
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        return u[..., :q], s[..., :q], vh.transpose(-1, -2)[..., :q]
    u, s, v = run_op_nodiff("pca_lowrank", fn, [x])
    return u, s, v


def matrix_rank_tol(x, tol=None, use_default_tol=True, hermitian=False,
                    name=None):
    return run_op_nodiff("matrix_rank_tol", lambda a: torch.linalg.matrix_rank(
        a, rtol=tol), [x])


def matrix_rank_atol_rtol(x, atol=None, rtol=None, hermitian=False,
                          name=None):
    def fn(a):
        s = torch.linalg.svdvals(a)
        smax = s.max(dim=-1, keepdim=True).values
        a_ = 0.0 if atol is None else atol
        r_ = (float(torch.finfo(a.dtype).eps) * builtins.max(a.shape[-2:])
              if rtol is None else rtol)
        thresh = torch.clamp(r_ * smax, min=a_)
        return (s > thresh).sum(-1)
    return run_op_nodiff("matrix_rank_atol_rtol", fn, [x])


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Power-iteration spectral normalisation."""
    def fn(w):
        wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
        u = torch.ones(wm.shape[0], dtype=w.dtype, device=w.device) \
            / np.sqrt(wm.shape[0])
        v = torch.ones(wm.shape[1], dtype=w.dtype, device=w.device) \
            / np.sqrt(wm.shape[1])
        for _ in range(builtins.max(power_iters, 1)):
            v = wm.T @ u
            v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
            u = wm @ v
            u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
        sigma = u @ wm @ v
        return w / torch.clamp(sigma, min=eps)
    return run_op("spectral_norm", fn, [weight])


def _cdist(a, b, p, use_mm):
    if use_mm:
        a2 = torch.sum(a * a, -1)[..., :, None]
        b2 = torch.sum(b * b, -1)[..., None, :]
        d2 = a2 + b2 - 2.0 * torch.matmul(a, b.transpose(-2, -1))
        # a safe sqrt: the gradient of sqrt at 0 is inf (NaN grads for
        # coincident rows, pdist's diagonal)
        pos = d2 > 0
        return torch.where(pos, torch.sqrt(torch.where(
            pos, d2, torch.ones_like(d2))), torch.zeros_like(d2))
    diff = torch.abs(a[..., :, None, :] - b[..., None, :, :])
    if p == 0:
        return torch.sum((diff != 0).to(a.dtype), -1)
    if np.isinf(p):
        return torch.amax(diff, -1)
    return torch.sum(diff ** p, -1) ** (1.0 / p)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Batched pairwise distance between row vectors; p 2 takes one
    matmul instead of the [..., m, n, d] broadcast."""
    use_mm = p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist"
    return run_op("cdist", lambda a, b: _cdist(a, b, p, use_mm), [x, y])


def pdist(x, p=2.0, name=None):
    """The upper triangle of cdist(x, x) of a [n, d] tensor, flat."""
    def fn(a):
        n = a.shape[0]
        full = _cdist(a, a, p, p == 2.0)
        iu, ju = np.triu_indices(n, k=1)
        return full[torch.as_tensor(iu, device=a.device),
                    torch.as_tensor(ju, device=a.device)]
    return run_op("pdist", fn, [x])


def matrix_exp(x, name=None):
    return run_op("matrix_exp", torch.linalg.matrix_exp, [x])


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    """y multiplied by Q (or Q^T) of the Householder QR (x, tau): Q is
    the k reflectors applied to the identity."""
    def fn(a, t, b):
        m = a.shape[-2]
        k = t.shape[-1]
        eye = torch.eye(m, dtype=a.dtype, device=a.device)
        q = eye.expand(a.shape[:-2] + (m, m))
        rows = torch.arange(m, device=a.device)
        for i in range(k):
            v = torch.where(rows < i, torch.zeros_like(a[..., :, i]),
                            a[..., :, i])
            v = torch.where(rows == i, torch.ones_like(v), v)
            ti = t[..., i][..., None, None]
            q = q @ (eye - ti * (v[..., :, None] * v[..., None, :]))
        if transpose:
            q = q.transpose(-2, -1)
        return q @ b if left else b @ q
    return run_op("ormqr", fn, [x, tau, y])


def fp8_fp8_half_gemm_fused(x, y, bias=None, transpose_x=False,
                            transpose_y=False, scale=1.0,
                            output_dtype="float16", name=None):
    """FP8 x FP8 -> half GEMM, emulated: both operands round through
    ``float8_e4m3fn``, then a matmul in the half output dtype, times
    ``scale``, plus ``bias``."""
    out_dt = dtype_mod.to_torch(output_dtype)

    def fn(a, b, *rest):
        a8 = a.to(torch.float8_e4m3fn).to(out_dt)
        b8 = b.to(torch.float8_e4m3fn).to(out_dt)
        if transpose_x:
            a8 = a8.transpose(-2, -1)
        if transpose_y:
            b8 = b8.transpose(-2, -1)
        out = torch.matmul(a8, b8) * torch.tensor(scale, dtype=out_dt,
                                                  device=a.device)
        if rest:
            out = out + rest[0].to(out_dt)
        return out
    args = [x, y] + ([bias] if bias is not None else [])
    return run_op("fp8_fp8_half_gemm_fused", fn, args)
