"""The port's CUDA kernels held to their plain PyTorch versions on the
card, at small shapes that cover the edges (dead slots, ragged page and
tile edges, GQA, windows, every pool dtype). They need an NVIDIA GPU
and nvcc, so they skip elsewhere; on the card run

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

(chip_smoke.py repeats the comparison at the serving shapes.)
Tolerances: 1e-4 relative to the output's scale for f32, 1e-2 for half
precision outputs (the kernels accumulate in f32; the plain versions sum
in another order).
"""
import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.quantization import kv_quantize_arrays

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol):
    err = float((got.float() - want.float()).abs().max())
    assert err <= rtol * max(1.0, float(want.abs().max())), err


def test_probe_runs(dev):
    for name in _build.SOURCES:
        out = _build.probe(name, dev)
        assert torch.equal(out.flatten()[:3].cpu(), torch.tensor([0., 2., 4.]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int8])
@pytest.mark.parametrize("rep,window,d,bs", [(1, None, 64, 16),
                                             (4, None, 128, 8),
                                             (2, 5, 40, 7),
                                             (8, 33, 256, 32)])
def test_paged_decode_matches_plain(dev, dtype, rep, window, d, bs):
    g = torch.Generator(device=dev).manual_seed(rep * 100 + bs)
    b, hkv, nblk = 6, 2, 5
    nb = b * nblk + 1
    ctx = torch.tensor([0, 1, bs, bs + 1, nblk * bs, nblk * bs + 9],
                       device=dev)
    bt = (torch.randperm(nb - 1, generator=g, device=dev) + 1).reshape(
        b, nblk).to(torch.int32)
    q = torch.randn(b, hkv * rep, d, generator=g, device=dev)
    kf = torch.randn(nb, hkv, bs, d, generator=g, device=dev)
    vf = torch.randn(nb, hkv, bs, d, generator=g, device=dev)
    ks = vs = None
    if dtype == torch.int8:
        (kc, ks), (vc, vs) = kv_quantize_arrays(kf), kv_quantize_arrays(vf)
    else:
        kc, vc = kf.to(dtype), vf.to(dtype)
    launches = pa.paged_decode.launches
    got = pa.paged_decode(q, kc, vc, bt, ctx, window=window, k_scale=ks,
                          v_scale=vs)
    torch.cuda.synchronize()
    assert pa.paged_decode.launches == launches + 1
    want = pa.paged_attention_arrays(q, kc, vc, bt, ctx, window=window,
                                     k_scale=ks, v_scale=vs)
    _close(got, want, 1e-4)
    assert not got[0].any()                       # dead slot: zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,sq,sk,h,hkv,d,causal,window", [
    (2, 64, 64, 4, 4, 128, True, None),
    (1, 100, 77, 4, 2, 80, True, None),         # sq > sk: empty rows
    (2, 37, 129, 6, 3, 64, True, 20),
    (1, 70, 70, 2, 1, 32, False, None),
    (1, 65, 65, 2, 2, 256, True, 7),
    (1, 20, 33, 2, 2, 30, False, None),         # head dim not /4
])
def test_flash_fwd_matches_plain(dev, dtype, B, sq, sk, h, hkv, d, causal,
                                 window):
    g = torch.Generator(device=dev).manual_seed(sq + sk + d)
    q = torch.randn(B, sq, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(B, sk, hkv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(B, sk, hkv, d, generator=g, device=dev).to(dtype)
    launches = fa.flash_fwd.launches
    got = fa.flash_fwd(q, k, v, causal, d ** -0.5, window)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == launches + 1
    want = fa.flash_plain(q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                          v.transpose(1, 2).float(), causal, d ** -0.5,
                          window).transpose(1, 2)
    _close(got, want, 1e-4 if dtype == torch.float32 else 1e-2)


def test_flash_fwd_reads_strided_inputs(dev):
    """q/k/v as views of one fused [B, S, 3, H, D] projection: no copy,
    same answer."""
    qkv = torch.randn(2, 48, 3, 4, 64, device=dev)
    q, k, v = qkv.unbind(2)
    got = fa.flash_fwd(q, k, v, True, 0.125)
    want = fa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                        True, 0.125)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
