"""Flash attention, forward and backward (counterpart of
``paddle_tpu/kernels/flash_attention.py``).

- ``flash_plain``: the plain PyTorch attention on [B, H, S, D]
  (counterpart of ``_flash_xla``, :747), optionally with its row
  logsumexp — the contract the forward kernel is held to.
- ``flash_bwd_plain``: the plain backward by the kernels' recompute
  formulas — the contract the two backward kernels are held to.
- ``flash_fwd`` / ``flash_bwd``: the kernel wrappers (counterparts of
  ``_flash_pallas_fwd`` :387 and ``_flash_pallas_bwd`` :601) on the
  paddle layout [B, S, H, D]. On CUDA tensors they launch the
  hand-written Hopper kernels ``csrc/flash_fwd.cu`` / ``csrc/flash_bwd.cu``
  or raise; the plain versions run only for CPU tensors.
- ``flash_route``: which of the three CUDA routes a launch of the
  forward, dQ or dK/dV kernel takes, by dtype, head dim, strides and
  addresses: "tc" (the 16-bit tensor-core kernels: bf16 for all three,
  fp16 for the forward only), "tf32x3" (the f32 forward on the tensor
  cores, 3xTF32) or "simt" (the f32 CUDA-core kernels, which take the
  rest). ``flash_tc_kernel``: which kernel a launch of the forward, dQ
  or dK/dV on the tc route runs, one rule for the three: "wgmma" (head
  dims up to 128) or "mma_sync" (above).
- ``probe_minor64`` / ``minor64_supported``: the head-dim-64 probe
  (counterpart of ``_pallas_minor64_supported``, :801) and its
  once-per-device check, which the wrappers run before their first
  launch at head dim 64 (as ``_head_dim_ok`` :845 gates the Pallas
  path); ``minor64_probe_plain`` is its plain version.
- ``flash_attention_arrays`` / ``flash_attention``: the validated,
  differentiable entry (counterparts of :871 and :943). With a gradient
  to take it runs ``_FlashAttnFn`` (the ``_flash_pallas`` custom_vjp,
  :700); under ``torch.no_grad()`` only the forward, with no lse. While
  torch traces the call (``torch.export``, as ``jit.save`` exports, or
  ``torch.compile``, as ``jit.to_static`` compiles) the C entries cannot
  run: they launch on ``data_ptr()`` through ctypes, which a fake tensor
  cannot give. So the traced graph holds custom ops that launch the
  kernels when it runs: ``paddle_tpu_torch::flash_fwd_lse``
  (``flash_fwd_lse_op``, with a gradient; its autograd, registered with
  ``register_autograd``, puts ``paddle_tpu_torch::flash_bwd``,
  ``flash_bwd_op``, in the backward graph) and
  ``paddle_tpu_torch::flash_fwd`` (``flash_fwd_op``, without one).

Semantics shared by every version: causal masking is bottom-right
aligned (query i sees keys j <= i + sk - sq); GQA by index (query head h
reads kv head h // rep); an optional sliding window keeps keys with
i + sk - sq - j < window; flashmask bands (``startend_row_indices``,
normalized to [B|1, h_se, 4, Sk] by ``_normalize_startend``) mask key
column j for rows in [lts, lte) or [uts, ute); a row that sees no key
outputs 0 and has logsumexp NEG_INF.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import monitor
from . import _build

NEG_INF = -1e30
#: rows whose logsumexp is at or below this saw no key (:273)
ROW_INVALID_LSE = NEG_INF / 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256


#: the kernels of the route rule
FLASH_KERNELS = ("fwd", "dq", "dkv")


def flash_route(kernel, dtype, head_dim, strides, addresses):
    """The route of one launch of ``kernel`` ("fwd", "dq" or "dkv"), the
    rule the C entries apply (``tc::route``, ``csrc/flash_tc.cuh``). Every
    route but "simt" needs a head dim that is a multiple of 8 up to
    ``MAX_HEAD_DIM`` and every address in ``addresses`` a multiple of 16;
    then "tc" for bfloat16 (any kernel) or float16 (the forward only: the
    backward's dS does not fit float16's range once split) with every
    batch, sequence and head stride in ``strides`` a multiple of 8
    elements, "tf32x3" for a float32 forward with those strides a multiple
    of 4; "simt" for everything else."""
    if kernel not in FLASH_KERNELS:
        raise ValueError(f"flash_route: kernel must be one of "
                         f"{FLASH_KERNELS}, got {kernel!r}")
    if head_dim % 8 or head_dim > MAX_HEAD_DIM or \
            any(a % 16 for a in addresses):
        return "simt"
    if dtype == torch.bfloat16 or (dtype == torch.float16 and
                                   kernel == "fwd"):
        route, align = "tc", 8
    elif dtype == torch.float32 and kernel == "fwd":
        route, align = "tf32x3", 4
    else:
        return "simt"
    return "simt" if any(s % align for s in strides) else route


#: the largest head dim whose tc-route launches (forward, dQ and dK/dV)
#: run the wgmma kernels
WGMMA_MAX_HEAD_DIM = 128


def flash_tc_kernel(kernel, head_dim):
    """The kernel a launch of ``kernel`` ("fwd", "dq" or "dkv") on the
    "tc" route runs, the one rule the C entries apply (``tc::wgmma``,
    ``csrc/flash_tc.cuh``): "wgmma" (``flash_fwd_wgmma_kernel``,
    ``flash_bwd_dq_wgmma_kernel``, ``flash_bwd_dkv_wgmma_kernel``: wgmma
    fed by TMA) for head dims up to ``WGMMA_MAX_HEAD_DIM``, "mma_sync"
    (``flash_fwd_mma_kernel``, ``flash_bwd_dq_tc_kernel``,
    ``flash_bwd_dkv_tc_kernel``) for larger ones (up to
    ``MAX_HEAD_DIM``)."""
    if kernel not in FLASH_KERNELS:
        raise ValueError(f"flash_tc_kernel: kernel must be one of "
                         f"{FLASH_KERNELS}, got {kernel!r}")
    if not 0 < head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"flash_tc_kernel: head_dim must be in "
                         f"(0, {MAX_HEAD_DIM}], got {head_dim}")
    return "wgmma" if head_dim <= WGMMA_MAX_HEAD_DIM else "mma_sync"


def flash_fwd_tc_kernel(head_dim):
    """``flash_tc_kernel`` of the forward."""
    return flash_tc_kernel("fwd", head_dim)


def _route_of(kernel, tensors):
    """``flash_route`` of ``kernel`` on checked CUDA operands [B, S, H, D]."""
    q = tensors[0]
    return flash_route(kernel, q.dtype, q.shape[-1],
                       [t.stride(i) for t in tensors for i in range(3)],
                       [t.data_ptr() for t in tensors])


def _normalize_startend(se, sq, sk, causal):
    """Flashmask ``startend_row_indices`` [b, h_se, sk, {1,2,4}] -> four
    per-column row bands [b, h_se, 4, sk] int32 (lts, lte, uts, ute), as
    ``_normalize_startend`` (:190) does:

    C=1: LT-start -> [start, sq); causal C=2: [start, end); non-causal
    C=2: LT [start, sq) plus UT [0, end); non-causal C=4: LT [s0, s1)
    plus UT [s2, s3)."""
    se = torch.as_tensor(se).to(torch.int32)
    if se.dim() != 4 or se.shape[2] != sk:
        raise ValueError(
            f"startend_row_indices must be [batch, kv_heads, seq_k, C], "
            f"got {tuple(se.shape)} (seq_k={sk})")
    C = se.shape[3]
    set_ = se.transpose(2, 3)                        # [b, h_se, C, sk]
    zeros = torch.zeros_like(set_[:, :, :1])
    full = torch.full_like(set_[:, :, :1], sq)
    if C == 1:
        bands = [set_[:, :, 0:1], full, zeros, zeros]
    elif causal and C == 2:
        bands = [set_[:, :, 0:1], set_[:, :, 1:2], zeros, zeros]
    elif not causal and C == 2:
        bands = [set_[:, :, 0:1], full, zeros, set_[:, :, 1:2]]
    elif not causal and C == 4:
        bands = [set_[:, :, i:i + 1] for i in range(4)]
    else:
        raise ValueError(
            f"startend_row_indices last dim must be "
            f"{'1 or 2' if causal else '1, 2 or 4'} for causal={causal}, "
            f"got {C}")
    return torch.cat(bands, dim=2).contiguous()


def _keep_mask(sq, sk, h, causal, window, se, device):
    """Boolean [b|1, h|1, sq, sk] (or [sq, sk]) mask of the visible
    (query, key) pairs, or None when every pair is visible."""
    keep = None
    if causal:
        qi = torch.arange(sq, device=device)[:, None]
        kj = torch.arange(sk, device=device)[None, :]
        keep = qi + (sk - sq) >= kj
        if window is not None:
            keep = keep & (qi + (sk - sq) - kj < int(window))
    if se is not None:
        rows = torch.arange(sq, dtype=torch.int32,
                            device=device)[None, None, :, None]
        lts, lte, uts, ute = (se[:, :, i][:, :, None, :] for i in range(4))
        fm = ((rows >= lts) & (rows < lte)) | ((rows >= uts) & (rows < ute))
        if fm.shape[1] not in (1, h):
            fm = fm.repeat_interleave(h // fm.shape[1], dim=1)
        keep = ~fm if keep is None else keep & ~fm
    return keep


def flash_plain(q, k, v, causal, scale, window=None, se=None,
                return_lse=False):
    """Plain attention on q [B, H, Sq, D], k/v [B, H_kv, Sk, D] (the
    counterpart of ``_flash_xla``): logits in the input dtype, softmax
    in f32, probabilities cast back, rows with no visible key zeroed.
    ``se``: normalized flashmask bands [B|1, h_se, 4, Sk]. With
    ``return_lse`` also returns the f32 row logsumexp [B, H, Sq] of the
    scaled, masked logits (NEG_INF on rows with no visible key)."""
    h = q.shape[1]
    if k.shape[1] != h:
        rep = h // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    sq, sk = logits.shape[-2], logits.shape[-1]
    keep = _keep_mask(sq, sk, h, causal, window, se, q.device)
    valid = None
    if keep is not None:
        logits = torch.where(keep, logits, NEG_INF)
        # row validity is data-dependent once flashmask bands are in play
        valid = (logits > ROW_INVALID_LSE).any(-1) if se is not None \
            else keep.any(-1)
    p = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    if valid is not None:
        # rows with no visible key (sq > sk, a window past the start, or
        # fully banded) emit zeros, not softmax's uniform average of V
        out = torch.where(valid[..., None], out, torch.zeros_like(out))
    if not return_lse:
        return out
    lse = torch.logsumexp(logits.float(), dim=-1)
    if valid is not None:
        lse = torch.where(valid, lse, NEG_INF)
    return out, lse.contiguous()


def flash_bwd_plain(q, k, v, o, lse, do, causal, scale, window=None,
                    se=None):
    """Plain flash backward on q/o/do [B, H, Sq, D], k/v [B, H_kv, Sk, D],
    lse f32 [B, H, Sq] -> (dq, dk, dv) in the inputs' dtypes, dk/dv in
    the kv-head shape. The kernels' recompute formulas in f32:
    P = exp(S - lse), zero where lse <= ROW_INVALID_LSE;
    Delta = rowsum(dO * O); dS = P * (dO V^T - Delta); dQ = scale dS K,
    dK = scale dS^T Q, dV = P^T dO (GQA groups summed in f32)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    if rep != 1:
        kf = kf.repeat_interleave(rep, dim=1)
        vf = vf.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    keep = _keep_mask(sq, sk, h, causal, window, se, q.device)
    if keep is not None:
        s = torch.where(keep, s, NEG_INF)
    lse = lse.float()[..., None]
    p = torch.where(lse > ROW_INVALID_LSE, torch.exp(s - lse), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    if rep != 1:
        dk = dk.reshape(b, hkv, rep, sk, d).sum(2)
        dv = dv.reshape(b, hkv, rep, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _t(x):
    return x.transpose(1, 2)


#: the probe's operand: [128, 64] f32 (the flash tiles at head dim 64)
MINOR64_SHAPE = (128, 64)
#: the seed of the probe's one fixed input tile (``minor64_input``)
MINOR64_SEED = 0


def minor64_probe_plain(x):
    """The probe's function, ``(x x^T) x`` in f32 (the two
    ``dot_general``s of the Pallas probe body, :816-822)."""
    x = x.float()
    return (x @ x.T) @ x


def _cuda_device(device):
    dev = torch.device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def minor64_input(device):
    """The probe's one fixed input: the [128, 64] f32 tile of small
    integers in [-3, 3] seeded by ``MINOR64_SEED``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(MINOR64_SEED)
    return torch.randint(-3, 4, MINOR64_SHAPE, generator=gen, device=device,
                         dtype=torch.int32).float()


def _minor64_launch(x, o):
    """One launch of ``flash_fwd_minor64_probe`` on x -> o (both f32
    [128, 64] on one CUDA device), uncounted and unchecked; raises on a
    refused launch."""
    lib = _build.load("flash_fwd")
    _build.check(lib.flash_fwd_minor64_probe(
        x.data_ptr(), o.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream),
        "flash_fwd minor64 probe")


def probe_minor64(device=None):
    """Launch the head-dim-64 probe of ``csrc/flash_fwd.cu`` once on
    ``device`` (default: the current CUDA device) and check it: on
    ``minor64_input`` every product and sum is exact in f32, so the
    answer must equal ``minor64_probe_plain`` bit for bit. Raises when it
    does not: the port has no other route for head dim 64 (the JAX
    package sends it to XLA). Counts the launch on
    ``probe_minor64.launches``; returns the kernel's output."""
    dev = _cuda_device(device)
    x = minor64_input(dev)
    o = torch.empty_like(x)
    _minor64_launch(x, o)
    probe_minor64.launches += 1
    if not torch.equal(o, minor64_probe_plain(x)):
        raise RuntimeError(
            f"the head-dim-64 flash probe returned a wrong result on "
            f"{torch.cuda.get_device_name(dev)}: the flash kernels cannot "
            f"be trusted at head dim 64 on this card")
    _minor64_ok[dev] = True
    return o


probe_minor64.launches = 0
#: devices whose head-dim-64 probe passed in this process
_minor64_ok = {}


def minor64_supported(device) -> bool:
    """True once the head-dim-64 probe has passed on ``device`` in this
    process (it is launched on the first call, as ``_minor64_ok`` caches
    the Pallas probe); a wrong answer raises."""
    dev = _cuda_device(device)
    if dev not in _minor64_ok:
        probe_minor64(dev)
    return True


def flash_fwd(q, k, v, causal: bool, scale: float,
              window: Optional[int] = None, se=None, want_lse: bool = False):
    """Flash forward on the paddle layout: q [B, Sq, H, D], k/v
    [B, Sk, H_kv, D] -> out [B, Sq, H, D], or (out, lse [B, H, Sq] f32)
    when ``want_lse`` (the caller differentiates). ``se``: normalized
    flashmask bands [B|1, h_se, 4, Sk] int32.

    On CUDA tensors this launches ``csrc/flash_fwd.cu`` (any sequence
    lengths, head dim <= 256, unit last-dim stride; at head dim 64 only
    once ``minor64_supported`` holds) on the route ``flash_route`` names,
    and counts the launch on ``flash_fwd.launches`` and, by the kernel
    the C entry reports it ran, on the counter ``kernels.flash.fwd_cuda_tc``,
    ``_tf32x3`` or ``_simt`` (a tc launch of the wgmma kernel also on
    ``kernels.flash.fwd_cuda_tc_wgmma``); on CPU tensors it runs
    ``flash_plain``."""
    if q.device.type == "cpu":
        monitor.counter("kernels.flash.fwd_plain").increase()
        res = flash_plain(_t(q), _t(k), _t(v), causal, scale, window, se,
                          return_lse=want_lse)
        if want_lse:
            return _t(res[0]), res[1]
        return _t(res)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    return _flash_fwd_cuda(q, k, v, causal, scale, window, se, want_lse)


flash_fwd.launches = 0


def _check_cuda_inputs(what, tensors, se):
    q = tensors[0]
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(
            f"{what} kernel takes float32/bfloat16/float16 operands of one "
            f"dtype, got {[t.dtype for t in tensors]}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{what} kernel takes head_dim <= {MAX_HEAD_DIM}, "
                         f"got {q.shape[-1]}")
    if any(t.device != q.device for t in tensors) or (
            se is not None and se.device != q.device):
        raise ValueError(f"{what}: all operands must be on one device")
    return [t if t.stride(-1) == 1 else t.contiguous() for t in tensors]


def _se_args(se, B):
    """(pointer, batch, head and band strides, h_se) of the normalized
    bands for a kernel; batch stride 0 broadcasts a batch-1 mask."""
    if se is None:
        return None, 0, 0, 0, 1
    if se.dtype != torch.int32 or se.dim() != 4 or se.shape[2] != 4 or \
            se.shape[0] not in (1, B) or se.stride(-1) != 1:
        raise ValueError(
            f"flashmask bands must be int32 [1|{B}, h_se, 4, seq_k] with a "
            f"unit last stride, got {se.dtype} {tuple(se.shape)}")
    sb = 0 if se.shape[0] == 1 else se.stride(0)
    return se.data_ptr(), sb, se.stride(1), se.stride(2), se.shape[1]


def _flash_fwd_cuda(q, k, v, causal, scale, window, se, want_lse):
    B, Sq, H, D = q.shape
    q, k, v = _check_cuda_inputs("flash_fwd", [q, k, v], se)
    if D == 64:
        minor64_supported(q.device)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if want_lse else None
    if out.numel() == 0:
        return (out, lse) if want_lse else out
    route, kernel = _fwd_launch(q, k, v, out, lse, causal, scale, window,
                                se)
    flash_fwd.launches += 1
    monitor.counter("kernels.flash.fwd_cuda").increase()
    monitor.counter(f"kernels.flash.fwd_cuda_{route}").increase()
    if kernel == "wgmma":
        monitor.counter("kernels.flash.fwd_cuda_tc_wgmma").increase()
    return (out, lse) if want_lse else out


#: (route, tc kernel) of each kernel a C entry reports it ran, by the id
#: it writes (``tc::Launched``, ``csrc/flash_tc.cuh``; the backward
#: entries never report tf32x3)
_LAUNCHED = (("simt", None), ("tf32x3", None), ("tc", "mma_sync"),
             ("tc", "wgmma"))


def _fwd_launch(q, k, v, out, lse, causal, scale, window, se):
    """One launch of ``flash_fwd_launch`` on checked operands into ``out``
    (and ``lse`` unless None), uncounted; raises on a refused launch.
    Returns the (route, tc kernel) the C entry reports it ran: ("simt",
    None), ("tf32x3", None), ("tc", "mma_sync") or ("tc", "wgmma")."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    lib = _build.load("flash_fwd")
    launched = ctypes.c_int(-1)
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, H, Hkv, Sq, Sk, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        *_se_args(se, B),
        int(bool(causal)), 0 if window is None else int(window),
        float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
        ctypes.addressof(launched))
    _build.check(err, "flash_fwd kernel")
    return _LAUNCHED[launched.value]


def flash_bwd(q, k, v, o, lse, do, causal: bool, scale: float,
              window: Optional[int] = None, se=None):
    """Flash backward on the paddle layout: q/o/do [B, Sq, H, D], k/v
    [B, Sk, H_kv, D], lse f32 [B, H, Sq] (from ``flash_fwd(...,
    want_lse=True)``) -> (dq, dk, dv) in the inputs' layouts and dtypes.

    On CUDA tensors this computes Delta = rowsum(dO * O) in f32 and
    launches the two kernels of ``csrc/flash_bwd.cu`` (counted on
    ``flash_bwd.launches_dq`` / ``flash_bwd.launches_dkv`` and, by the
    kernel each C entry reports it ran, on ``kernels.flash.dq_cuda_tc``
    or ``_simt`` and ``kernels.flash.dkv_cuda_tc`` or ``_simt``, a tc
    launch of a wgmma kernel also on ``kernels.flash.dq_cuda_tc_wgmma`` /
    ``dkv_cuda_tc_wgmma``); on CPU tensors it runs ``flash_bwd_plain``."""
    if q.device.type == "cpu":
        monitor.counter("kernels.flash.bwd_plain").increase()
        dq, dk, dv = flash_bwd_plain(_t(q), _t(k), _t(v), _t(o), lse, _t(do),
                                     causal, scale, window, se)
        return _t(dq), _t(dk), _t(dv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    return _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, window, se)


flash_bwd.launches_dq = 0
flash_bwd.launches_dkv = 0


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, window, se):
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    q, k, v, do = _check_cuda_inputs("flash_bwd", [q, k, v, do], se)
    if D == 64:
        minor64_supported(q.device)
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_bwd: lse must be float32 {(B, H, Sq)}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    lse = lse.contiguous()
    # Delta = rowsum(dO * O) in f32, the narrow layout the kernels read
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, Hkv, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Sk, Hkv, D), dtype=v.dtype, device=q.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    args = (q, k, v, do, lse, delta)
    ran = {"dq": _bwd_launch("flash_bwd_dq_launch", args, dq, None, causal,
                             scale, window, se)}
    flash_bwd.launches_dq += 1
    ran["dkv"] = _bwd_launch("flash_bwd_dkv_launch", args, dk, dv, causal,
                             scale, window, se)
    flash_bwd.launches_dkv += 1
    monitor.counter("kernels.flash.bwd_cuda").increase()
    for kernel, (route, tc_kernel) in ran.items():
        monitor.counter(f"kernels.flash.{kernel}_cuda_{route}").increase()
        if tc_kernel == "wgmma":
            monitor.counter(f"kernels.flash.{kernel}_cuda_tc_wgmma") \
                .increase()
    return dq, dk, dv


def _bwd_launch(entry, args, out0, out1, causal, scale, window, se):
    """One launch of a ``csrc/flash_bwd.cu`` entry on checked operands
    ``args`` = (q, k, v, do, lse, delta), uncounted; raises on a refused
    launch. Returns the (route, tc kernel) the C entry reports it ran:
    ("simt", None), ("tc", "mma_sync") or ("tc", "wgmma")."""
    q, k, v, do, lse, delta = args
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    lib = _build.load("flash_bwd")
    launched = ctypes.c_int(-1)
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), out0.data_ptr(),
        None if out1 is None else out1.data_ptr(),
        B, H, Hkv, Sq, Sk, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        do.stride(0), do.stride(1), do.stride(2),
        *_se_args(se, B),
        int(bool(causal)), 0 if window is None else int(window),
        float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
        ctypes.addressof(launched))
    _build.check(err, entry)
    return _LAUNCHED[launched.value]


def _traced(q) -> bool:
    """Whether torch is tracing this call (``torch.export`` /
    ``torch.compile``: the operands are fake tensors)."""
    from torch._subclasses.fake_tensor import is_fake
    return torch.compiler.is_compiling() or is_fake(q)


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 se: Optional[torch.Tensor], causal: bool, scale: float,
                 window: Optional[int]) -> torch.Tensor:
    """``flash_fwd`` (no lse) as an op a traced graph can hold: on a CUDA
    tensor the kernel launch, counted as ``flash_fwd`` counts it; on a
    CPU tensor the plain version (made contiguous, as the fake says)."""
    out = flash_fwd(q, k, v, causal, scale, window, se)
    return out if q.device.type == "cuda" else out.contiguous()


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, se, causal, scale, window):
    return q.new_empty(q.shape)


@torch.library.custom_op("paddle_tpu_torch::flash_fwd_lse", mutates_args=())
def flash_fwd_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     se: Optional[torch.Tensor], causal: bool, scale: float,
                     window: Optional[int]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_fwd(..., want_lse=True)`` as an op a traced graph can hold,
    differentiable (its backward is ``flash_bwd_op``): on a CUDA tensor
    the kernel launch, counted as ``flash_fwd`` counts it; on a CPU tensor
    the plain version (made contiguous, as the fake says)."""
    out, lse = flash_fwd(q, k, v, causal, scale, window, se, want_lse=True)
    return (out if q.device.type == "cuda" else out.contiguous()), lse


@flash_fwd_lse_op.register_fake
def _flash_fwd_lse_fake(q, k, v, se, causal, scale, window):
    b, sq, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, sq), dtype=torch.float32)


@torch.library.custom_op("paddle_tpu_torch::flash_bwd", mutates_args=())
def flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 se: Optional[torch.Tensor], causal: bool, scale: float,
                 window: Optional[int]
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_bwd`` as an op a traced graph can hold: on a CUDA tensor
    the dQ and dK/dV launches, counted as ``flash_bwd`` counts them; on a
    CPU tensor the plain backward (made contiguous, as the fake says)."""
    grads = flash_bwd(q, k, v, o, lse, do, causal, scale, window, se)
    if q.device.type == "cuda":
        return grads
    return tuple(g.contiguous() for g in grads)


@flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, o, lse, do, se, causal, scale, window):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _fwd_lse_setup(ctx, inputs, output):
    q, k, v, se, causal, scale, window = inputs
    ctx.save_for_backward(q, k, v, output[0], output[1], se)
    ctx.causal, ctx.scale, ctx.window = causal, scale, window


def _fwd_lse_backward(ctx, do, _dlse):
    q, k, v, out, lse, se = ctx.saved_tensors
    dq, dk, dv = flash_bwd_op(q, k, v, out, lse, do, se, ctx.causal,
                              ctx.scale, ctx.window)
    return dq, dk, dv, None, None, None, None


flash_fwd_lse_op.register_autograd(_fwd_lse_backward,
                                   setup_context=_fwd_lse_setup)


class _FlashAttnFn(torch.autograd.Function):
    """Differentiable flash attention (the ``_flash_pallas`` custom_vjp,
    :700-740): the forward writes the logsumexp and saves q, k, v, out,
    lse and the bands; the backward runs ``flash_bwd``. On a CUDA tensor
    that is the two kernels or an error: there is no fallback."""

    @staticmethod
    def forward(ctx, q, k, v, se, causal, scale, window):
        out, lse = flash_fwd(q, k, v, causal, scale, window, se,
                             want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, se)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, se = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do, ctx.causal, ctx.scale,
                               ctx.window, se)
        return dq, dk, dv, None, None, None, None


def flash_attention_arrays(q, k, v, causal=False, scale=None,
                           window=None, startend_row_indices=None):
    """Attention entry on the paddle layout [B, S, H, D] (counterpart of
    ``flash_attention_arrays``). k/v may carry fewer heads than q (GQA,
    served in-kernel). ``window`` requires ``causal=True``.
    ``startend_row_indices``: the flashmask column-sparse mask
    [b|1, h_se, seq_k, {1,2,4}] int, h_se dividing the kv heads; it
    requires seq_q == seq_k. Differentiable in q, k and v."""
    if k.shape[2] != v.shape[2]:
        raise ValueError(
            f"key heads ({k.shape[2]}) != value heads ({v.shape[2]})")
    if k.shape[2] < 1 or q.shape[2] % k.shape[2] != 0:
        raise ValueError(
            f"GQA requires query heads ({q.shape[2]}) to be a multiple "
            f"of key/value heads ({k.shape[2]})")
    if window is not None:
        window = int(window)
        if not causal:
            raise ValueError(
                "flash attention window requires causal=True (the "
                "window is measured back from the causal diagonal)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    se = None
    if startend_row_indices is not None:
        if q.shape[1] != k.shape[1]:
            raise ValueError(
                "flashmask startend_row_indices requires seq_q == seq_k "
                f"(got {q.shape[1]} vs {k.shape[1]})")
        h_se = startend_row_indices.shape[1]
        if k.shape[2] % h_se != 0:
            raise ValueError(
                f"startend_row_indices heads ({h_se}) must divide kv "
                f"heads ({k.shape[2]})")
        if startend_row_indices.shape[0] not in (1, q.shape[0]):
            raise ValueError(
                f"startend_row_indices batch ({startend_row_indices.shape[0]}"
                f") must be 1 or the batch ({q.shape[0]})")
        se = _normalize_startend(
            torch.as_tensor(startend_row_indices, device=q.device),
            q.shape[1], k.shape[1], causal)
    traced = _traced(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if traced:
            return flash_fwd_lse_op(q, k, v, se, causal, s, window)[0]
        # eagerly the autograd.Function: the same launches and counts.
        # Through the custom op, phase 19's host-bound eager BERT-base
        # step ran slower (profile_eager in turns on an H100: medians
        # 80.7 ms a step with this Function, 112.4 ms with the op)
        return _FlashAttnFn.apply(q, k, v, se, causal, s, window)
    if traced:
        return flash_fwd_op(q, k, v, se, causal, s, window)
    return flash_fwd(q, k, v, causal, s, window, se)


#: the models' entry (the JAX package's tensor-level name)
flash_attention = flash_attention_arrays
