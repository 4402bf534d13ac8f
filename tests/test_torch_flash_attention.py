"""The port's flash attention forward (paddle_tpu_torch.kernels.
flash_attention) held to the JAX package's ``flash_attention_arrays``
on the CPU, which routes to its XLA path ``_flash_xla``.

Tolerance: atol = rtol = 1e-4 on f32 outputs. On the CPU the
``flash_fwd`` wrapper runs the plain version; the CUDA kernel is held to
that plain version on the card (tests/test_torch_kernels_cuda.py and
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401 — the JAX package's x64 setup
from paddle_tpu.kernels.flash_attention import \
    flash_attention_arrays as jax_flash
from paddle_tpu_torch import monitor
from paddle_tpu_torch.kernels import flash_attention as tfa

TOL = dict(atol=1e-4, rtol=1e-4)

# (sq, sk, h, hkv, causal, window)
CASES = {
    "causal": (16, 16, 4, 4, True, None),
    "full": (16, 16, 4, 4, False, None),
    "bottom_right": (5, 19, 4, 4, True, None),     # sq < sk
    "gqa": (12, 12, 6, 2, True, None),
    "mqa_full": (7, 9, 4, 1, False, None),
    "window": (20, 20, 4, 2, True, 6),
    "window_sq_lt_sk": (6, 17, 2, 2, True, 3),
    "rows_masked": (9, 4, 2, 2, True, None),       # sq > sk: empty rows
}


def _qkv(rng, sq, sk, h, hkv, d=16, b=2):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_flash_matches_jax(name):
    sq, sk, h, hkv, causal, window = CASES[name]
    q, k, v = _qkv(np.random.default_rng(len(name)), sq, sk, h, hkv)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                window=window))
    got = tfa.flash_attention_arrays(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if name == "rows_masked":
        # query rows 0..4 see no key (bottom-right band): exact zeros
        assert not got[:, : sq - sk].any()


def test_wrapper_on_cpu_runs_plain_version():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(0), 8, 8, 2, 2))
    launches = tfa.flash_fwd.launches
    before = monitor.counter("kernels.flash.fwd_plain").get()
    got = tfa.flash_fwd(q, k, v, True, 0.25)
    want = tfa.flash_plain(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), True, 0.25).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tfa.flash_fwd.launches == launches
    assert monitor.counter("kernels.flash.fwd_plain").get() == before + 1


def test_entry_validation():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(0), 4, 4, 4, 2))
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa.flash_attention(q, k, v, causal=True,
                            startend_row_indices=torch.zeros(2, 1, 4, 1))
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, k, v, causal=False, window=2)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, v, causal=True, window=0)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1),
                            v[:, :, :1].expand(-1, -1, 3, -1))
