"""paddle.linalg as a real module (counterpart of ``paddle_tpu/linalg.py``):
``import paddle_tpu_torch.linalg`` works. The ops live in ``ops/linalg.py``."""
from .ops.linalg import *  # noqa: F401,F403
from .ops.linalg import (  # noqa: F401
    cholesky, cholesky_inverse, cholesky_solve, cond, corrcoef, cov, det,
    eig, eigh, eigvals, eigvalsh, fp8_fp8_half_gemm_fused,
    householder_product, inv, lstsq, lu, lu_unpack, matrix_exp,
    matrix_norm, matrix_power, matrix_rank, matrix_transpose, multi_dot,
    norm, ormqr, pinv, qr, slogdet, solve, svd, svd_lowrank, svdvals,
    triangular_solve, vector_norm,
)
