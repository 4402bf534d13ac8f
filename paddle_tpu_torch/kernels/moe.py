"""Grouped expert FFN, forward and backward (counterpart of
``paddle_tpu/kernels/moe.py``).

Tokens arrive sorted by expert in a capacity buffer ``x [E, C, h]`` (the
MoE layer's dispatch scatter); ``counts [E]`` int32 says how many rows of
each expert are live. The function is

    out[e, c] = (act(x[e, c] w1[e] + b1[e]) w2[e] + b2[e]) * ws[e, c]

with rows at or past ``counts[e]`` zero and skipped.

- ``grouped_ffn_plain`` / ``grouped_ffn_bwd_plain``: the plain PyTorch
  versions, with the kernels' rounding points (:271-279, :413-455,
  :523-541): products of the operand dtype T accumulated in f32; the
  activation ``ha`` rounded to T before the second product; bias and
  combine weight applied in f32; ``gw = g * ws`` and ``dz`` rounded to T
  before the products that read them; ``db1`` summed from f32 ``dz``.
  Each is two stages (``grouped_ffn_down_plain``;
  ``grouped_ffn_bwd_intermediates`` then ``grouped_ffn_bwd_outputs``), so
  a kernel's rounded intermediates can be checked, and its outputs held
  to the plain formula on them.
- ``grouped_ffn_fwd`` / ``grouped_ffn_bwd``: the kernel wrappers
  (counterparts of ``_grouped_ffn_fwd_pallas`` :296 and
  ``_grouped_ffn_bwd_pallas`` :552). On CUDA tensors they launch
  ``csrc/grouped_ffn_fwd.cu`` and the dx and dw kernels of
  ``csrc/grouped_ffn_bwd.cu`` or raise; the plain versions run only for
  CPU tensors. The forward, dx and dw kernels take one of two routes
  (``grouped_ffn_route``): "tc", wgmma on TMA-fed tiles
  (``csrc/grouped_gemm_tc.cuh``), or "simt", f32 FMA on the CUDA cores
  (``csrc/grouped_gemm.cuh``); the forward also takes "rows" for f32
  buffers of few rows (a serving decode tick), which streams the live
  experts' weights across many blocks and sums K splits.
- ``grouped_ffn``: the differentiable entry (:711), casting as JAX does:
  x, w1 and w2 to their promoted dtype, b1, b2 and ws to f32, the result
  to x's dtype. With a gradient to take it runs ``_GroupedFFNFn`` (the
  custom_vjp :671-708); under ``torch.no_grad()`` only the forward.

``moe_pallas_requirements`` (:115, the 128-lane rule) is a TPU constraint
and is not carried: the CUDA kernels take any h, dff and capacity.
"""
from __future__ import annotations

import ctypes

import torch

from .. import monitor
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACTS = {"gelu": 0, "relu": 1}
#: row and column tile of the backward's per-tile partial sums
#: (csrc/grouped_gemm.cuh kBM, kBN; the tc route's 128 x 128 blocks write
#: two of each)
ROW_TILE = 64
COL_TILE = 64

#: the forward's "rows" route (csrc/grouped_ffn_fwd.cu, namespace rows):
#: the largest capacity it takes (gg::kRowsMaxC) and the K rows a block
#: streams (the K split, kKS)
ROWS_MAX_CAPACITY = 16
ROWS_K_SPLIT = 256
#: gg::Route codes the forward's C entry reports
_ROUTES = {0: "simt", 1: "tc", 2: "rows"}

BLOCK_TOKENS = 256
_SUBLANE = {torch.int8: 32, torch.bfloat16: 16, torch.float16: 16}

_GELU_C = 0.7978845608028654     # sqrt(2/pi)
_GELU_K = 0.044715


def pick_token_block(capacity: int, dtype=torch.float32) -> int:
    """Token-block size of the JAX kernel for a per-expert capacity: the
    smallest power of two >= capacity, clamped to [sublane minimum,
    BLOCK_TOKENS] (:86)."""
    b = _SUBLANE.get(dtype, 8)
    while b < min(capacity, BLOCK_TOKENS):
        b *= 2
    return min(b, BLOCK_TOKENS)


def padded_capacity(capacity: int, dtype=torch.float32) -> int:
    """Capacity rounded up to whole token blocks (:95). The MoE layer
    sizes its dispatch buffer with it, so the buffer has the JAX layout;
    routing still drops at the unpadded capacity and the pad rows are
    dead."""
    bt = pick_token_block(capacity, dtype)
    return -(-capacity // bt) * bt


def _act_apply(z, activation):
    """tanh-GELU (``jax.nn.gelu``'s default, its operation order) or
    ReLU, in f32."""
    if activation == "gelu":
        cdf = 0.5 * (1.0 + torch.tanh(_GELU_C * (z + _GELU_K * (z ** 3))))
        return z * cdf
    return torch.clamp_min(z, 0.0)


def _act_grad(z, activation):
    """The hand-coded derivative of ``_act_apply`` (:156)."""
    if activation == "gelu":
        u = _GELU_C * (z + _GELU_K * z * z * z)
        t = torch.tanh(u)
        du = _GELU_C * (1.0 + 3.0 * _GELU_K * z * z)
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du
    return (z > 0.0).float()


def grouped_ffn_route(dtype, h, dff, capacity=None):
    """The route of one launch of the forward, the dx or the dw kernel,
    the rule the C entries apply (``gg::route``,
    ``csrc/grouped_gemm_tc.cuh``): "tc" (wgmma and TMA) for bfloat16 and
    float16 with h and dff multiples of 8, so that every row is a
    multiple of 16 bytes as TMA needs; for the forward, which passes its
    buffer's ``capacity``, "rows" (the weight-streaming passes) for
    float32 with capacity <= ROWS_MAX_CAPACITY and h and dff multiples of
    4; "simt" (f32 FMA on the CUDA cores) for everything else. The dx
    and dw kernels pass no capacity and apply it to the same operands, so
    the dw kernel finds the gw scratch the dx kernel wrote on the tc
    route."""
    if dtype in (torch.bfloat16, torch.float16) and h % 8 == 0 \
            and dff % 8 == 0:
        return "tc"
    if dtype == torch.float32 and capacity is not None \
            and 0 < capacity <= ROWS_MAX_CAPACITY and h % 4 == 0 \
            and dff % 4 == 0:
        return "rows"
    return "simt"


def grouped_ffn_rows_scratch(E, C, h, dff, device=None):
    """The f32 scratch of the forward's "rows" route: the K splits'
    partial sums of the live rows, [S, E, C, N] for the up pass (S =
    ceil(h / ROWS_K_SPLIT), N = dff) and then the down pass (S =
    ceil(dff / ROWS_K_SPLIT), N = h), flat, as large as the larger."""
    up = -(-h // ROWS_K_SPLIT) * dff
    down = -(-dff // ROWS_K_SPLIT) * h
    return torch.empty(max(up, down) * E * C, dtype=torch.float32,
                       device=device)


def _row_mask(counts, cap, device):
    """[E, C, 1] keep-mask: slot c of expert e is live iff c < counts[e]."""
    slot = torch.arange(cap, device=device, dtype=torch.int32)
    return (slot[None, :] < counts.to(torch.int32)[:, None])[..., None]


def grouped_ffn_gw_plain(g, ws, counts):
    """The dx kernel's first pass on the tc route: gw = g ws in f32,
    rounded to g's dtype (the reference's rounding point, :413-416), zero
    on dead rows -> [E, C, h] in g's dtype."""
    gw32 = torch.where(_row_mask(counts, g.shape[1], g.device),
                       g.float() * ws.float(), 0.0)
    return gw32.to(g.dtype)


def grouped_ffn_down_plain(ha, w2, b2, ws, counts, dtype):
    """The forward's second stage from a given activation ``ha`` (f32
    values already rounded to ``dtype``): out = (ha w2 + b2) ws on live
    rows, zero on dead rows, rounded once to ``dtype``."""
    out = (torch.bmm(ha, w2.float()) + b2.float()) * ws.float()
    out = torch.where(_row_mask(counts, ha.shape[1], ha.device), out, 0.0)
    return out.to(dtype)


def grouped_ffn_plain(x, w1, b1, w2, b2, ws, counts, activation="gelu"):
    """Plain grouped FFN: x [E, C, h], w1 [E, h, dff], b1 [E, 1, dff], w2
    [E, dff, h], b2 [E, 1, h], ws [E, C, 1], counts [E] -> out [E, C, h]
    in x's dtype, with the forward kernel's rounding points."""
    z = torch.bmm(x.float(), w1.float()) + b1.float()
    ha = _act_apply(z, activation).to(x.dtype).float()
    return grouped_ffn_down_plain(ha, w2, b2, ws, counts, x.dtype)


def grouped_ffn_bwd_intermediates(x, w1, b1, w2, b2, ws, counts, g,
                                  activation="gelu"):
    """The backward's first stage (the dx kernel's first pass): f32
    tensors, zero on dead rows, at the kernels' rounding points (T = x's
    dtype): gw32 = g ws, gw = round_T(gw32) (``grouped_ffn_gw_plain``),
    ha = round_T(act(z)) with z = x w1 + b1, dz32 = (gw w2^T) act'(z),
    dz = round_T(dz32)."""
    t = x.dtype
    keep = _row_mask(counts, x.shape[1], x.device)
    gw32 = torch.where(keep, g.float() * ws.float(), 0.0)
    gw = grouped_ffn_gw_plain(g.to(t), ws, counts).float()
    z = torch.bmm(x.float(), w1.float()) + b1.float()
    ha = torch.where(keep, _act_apply(z, activation).to(t).float(), 0.0)
    dh = torch.bmm(gw, w2.float().transpose(1, 2))
    dz32 = torch.where(keep, dh * _act_grad(z, activation), 0.0)
    return dict(gw32=gw32, gw=gw, ha=ha, dz32=dz32, dz=dz32.to(t).float())


def grouped_ffn_bwd_outputs(x, w1, b1, w2, b2, ws, counts, g, gw32, gw, ha,
                            dz32, dz):
    """The backward's outputs from its intermediates (those of
    ``grouped_ffn_bwd_intermediates``, or a kernel's) -> (dx, dw1, db1,
    dw2, db2, dws), each in its operand's dtype: dx = dz w1^T, dw1 = x^T
    dz, db1 = sum_rows dz32, dw2 = ha^T gw, db2 = sum_rows gw32, dws =
    sum_h g (ha w2 + b2), dx and dws zero on dead rows."""
    keep = _row_mask(counts, x.shape[1], x.device)
    ffn = torch.bmm(ha, w2.float()) + b2.float()
    dx = torch.where(keep, torch.bmm(dz, w1.float().transpose(1, 2)), 0.0)
    dws = torch.where(keep, g.float() * ffn, 0.0).sum(-1, keepdim=True)
    dw1 = torch.bmm(x.float().transpose(1, 2), dz)
    dw2 = torch.bmm(ha.transpose(1, 2), gw)
    return (dx.to(x.dtype), dw1.to(w1.dtype),
            dz32.sum(1, keepdim=True).to(b1.dtype), dw2.to(w2.dtype),
            gw32.sum(1, keepdim=True).to(b2.dtype), dws.to(ws.dtype))


def grouped_ffn_bwd_plain(x, w1, b1, w2, b2, ws, counts, g,
                          activation="gelu"):
    """Plain backward by the kernels' recompute formulas (:351-354,
    :472-474) -> (dx, dw1, db1, dw2, db2, dws): the two stages above,
    composed."""
    ops = (x, w1, b1, w2, b2, ws, counts, g)
    return grouped_ffn_bwd_outputs(
        *ops, **grouped_ffn_bwd_intermediates(*ops, activation))


def _check_cuda(what, x, w1, b1, w2, b2, ws, counts, g=None):
    E, C, h = x.shape
    dff = w1.shape[2]
    ops = [x, w1, w2] + ([] if g is None else [g])
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ops):
        raise ValueError(
            f"{what} kernel takes x, w1, w2 (and g) of one dtype among "
            f"float32/bfloat16/float16, got {[t.dtype for t in ops]}")
    if any(t.dtype != torch.float32 for t in (b1, b2, ws)):
        raise ValueError(f"{what} kernel takes f32 b1, b2 and ws, got "
                         f"{[t.dtype for t in (b1, b2, ws)]}")
    want = {"w1": (E, h, dff), "b1": (E, 1, dff), "w2": (E, dff, h),
            "b2": (E, 1, h), "ws": (E, C, 1), "counts": (E,)}
    got = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "ws": ws,
           "counts": counts}
    if g is not None:
        want["g"], got["g"] = (E, C, h), g
    bad = {n: tuple(got[n].shape) for n in want
           if tuple(got[n].shape) != want[n]}
    if bad:
        raise ValueError(f"{what}: shapes {bad} do not fit x {(E, C, h)} "
                         f"and w1 {tuple(w1.shape)}")
    if counts.dtype != torch.int32:
        raise ValueError(f"{what}: counts must be int32, got {counts.dtype}")
    if any(t.device != x.device for t in got.values()):
        raise ValueError(f"{what}: all operands must be on one device")
    # contiguous, and 16-byte aligned as the tc route's TMA loads need (a
    # view that starts mid-row is copied)
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in
            (t.contiguous() for t in [x, w1, b1, w2, b2, ws, counts]
             + ([] if g is None else [g]))]


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _fwd_launch(ops, ha, out, activation, part=None):
    """One launch of ``csrc/grouped_ffn_fwd.cu`` on checked operands
    ``ops`` = (x, w1, b1, w2, b2, ws, counts) with the scratch ``ha``
    [E, C, dff] in x's dtype and, on the "rows" route, ``part``
    (``grouped_ffn_rows_scratch``, allocated here when None). Returns the
    route the C entry reports it ran."""
    x, w1, b1, w2, b2, ws, counts = ops
    E, C, h = x.shape
    dff = w1.shape[2]
    if part is None and grouped_ffn_route(x.dtype, h, dff, C) == "rows":
        part = grouped_ffn_rows_scratch(E, C, h, dff, x.device)
    lib = _build.load("grouped_ffn_fwd")
    route = ctypes.c_int(-1)
    _build.check(lib.grouped_ffn_fwd_launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), ws.data_ptr(), counts.data_ptr(), ha.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), E, C, h,
        dff, _ACTS[activation], _DTYPES[x.dtype],
        0 if part is None else part.numel(), _build.stream(x.device),
        ctypes.addressof(route)), "grouped_ffn_fwd kernel")
    return _ROUTES[route.value]


def grouped_ffn_fwd(x, w1, b1, w2, b2, ws, counts, activation="gelu"):
    """The grouped FFN forward: operands as ``grouped_ffn_plain`` with x,
    w1, w2 in one dtype and b1, b2, ws in f32, counts int32. On CUDA
    tensors this launches ``csrc/grouped_ffn_fwd.cu`` on the route
    ``grouped_ffn_route`` names for the capacity (counted on
    ``grouped_ffn_fwd.launches`` and, by the route the C entry reports,
    ``kernels.moe.grouped_ffn_fwd_cuda_{tc,rows,simt}``); on CPU tensors
    it runs ``grouped_ffn_plain``."""
    if activation not in _ACTS:
        raise ValueError(f"activation must be 'gelu' or 'relu', got "
                         f"{activation!r}")
    if x.device.type == "cpu":
        monitor.counter("kernels.moe.grouped_ffn_fwd_plain").increase()
        return grouped_ffn_plain(x, w1, b1, w2, b2, ws, counts, activation)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_ffn_fwd: unsupported device {x.device}")
    x, w1, b1, w2, b2, ws, counts = _check_cuda(
        "grouped_ffn_fwd", x, w1, b1, w2, b2, ws, counts)
    E, C, h = x.shape
    dff = w1.shape[2]
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    # the activation of the live rows, rounded to x's dtype (the JAX
    # kernel keeps it in VMEM; see the source's note)
    ha = torch.empty((E, C, dff), dtype=x.dtype, device=x.device)
    route = _fwd_launch((x, w1, b1, w2, b2, ws, counts), ha, out,
                        activation)
    grouped_ffn_fwd.launches += 1
    monitor.counter("kernels.moe.grouped_ffn_fwd_cuda").increase()
    monitor.counter("kernels.moe.grouped_ffn_fwd_cuda_" + route).increase()
    return out


grouped_ffn_fwd.launches = 0


def _bwd_scratch(x, dff):
    """The scratch the dx kernel writes and the dw kernel reads: ha and
    dz of the live rows in x's dtype, and the per-tile partial sums; and
    gw, which the dx kernel writes and reads on the tc route (an empty
    tensor on the simt route)."""
    E, C, h = x.shape
    nrt = -(-C // ROW_TILE)
    nct = -(-h // COL_TILE)
    dev = x.device
    tc = grouped_ffn_route(x.dtype, h, dff) == "tc"
    return dict(
        ha=torch.empty((E, C, dff), dtype=x.dtype, device=dev),
        dz=torch.empty((E, C, dff), dtype=x.dtype, device=dev),
        gw=torch.empty((E, C, h) if tc else (0,), dtype=x.dtype, device=dev),
        db1_part=torch.empty((E, nrt, dff), dtype=torch.float32, device=dev),
        db2_part=torch.empty((E, nrt, h), dtype=torch.float32, device=dev),
        dws_part=torch.empty((E, C, nct), dtype=torch.float32, device=dev))


def _bwd_dx_launch(ops, s, dx, dws, db2, activation):
    """One launch of the dx entry of ``csrc/grouped_ffn_bwd.cu`` on checked
    operands ``ops`` = (x, w1, b1, w2, b2, ws, counts, g) with scratch
    ``s`` (``_bwd_scratch``)."""
    x, w1, b1, w2, b2, ws, counts, g = ops
    E, C, h = x.shape
    lib = _build.load("grouped_ffn_bwd")
    _build.check(lib.grouped_ffn_bwd_dx_launch(
        x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), ws.data_ptr(), counts.data_ptr(),
        s["ha"].data_ptr(), s["dz"].data_ptr(), s["gw"].data_ptr(),
        s["db1_part"].data_ptr(), s["db2_part"].data_ptr(),
        s["dws_part"].data_ptr(), dx.data_ptr(),
        dws.data_ptr(), db2.data_ptr(), E, C, h, w1.shape[2],
        _ACTS[activation], _DTYPES[x.dtype], _stream(x)),
        "grouped_ffn_bwd dx kernel")


def _bwd_dw_launch(ops, s, dw1, db1, dw2):
    """One launch of the dw entry of ``csrc/grouped_ffn_bwd.cu``: reads
    the dx entry's scratch ``s``, its gw too on the tc route (raises when
    ``s`` holds none there)."""
    x, w1, b1, w2, b2, ws, counts, g = ops
    E, C, h = x.shape
    dff = w1.shape[2]
    gw = s["gw"]
    if grouped_ffn_route(x.dtype, h, dff) == "tc" and \
            tuple(gw.shape) != (E, C, h):
        raise ValueError(
            f"grouped_ffn_bwd dw kernel: the tc route reads the dx "
            f"kernel's gw scratch [{E}, {C}, {h}], got {tuple(gw.shape)}")
    lib = _build.load("grouped_ffn_bwd")
    _build.check(lib.grouped_ffn_bwd_dw_launch(
        x.data_ptr(), g.data_ptr(), ws.data_ptr(), counts.data_ptr(),
        s["ha"].data_ptr(), s["dz"].data_ptr(),
        gw.data_ptr() if gw.numel() else None, s["db1_part"].data_ptr(),
        dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), E, C, h, dff,
        _DTYPES[x.dtype], _stream(x)), "grouped_ffn_bwd dw kernel")


def grouped_ffn_bwd(x, w1, b1, w2, b2, ws, counts, g, activation="gelu"):
    """The grouped FFN backward -> (dx, dw1, db1, dw2, db2, dws). On CUDA
    tensors this launches the dx kernel (dx, dws, db2; it also writes ha
    and dz of the live rows) on the route ``grouped_ffn_route`` names and
    then the dw kernel (dw1, db1, dw2) of ``csrc/grouped_ffn_bwd.cu`` on
    the same route, counted on ``grouped_ffn_bwd.launches_dx`` /
    ``launches_dw`` and by route on
    ``kernels.moe.grouped_ffn_{dx,dw}_cuda_{tc,simt}``; on CPU tensors it
    runs ``grouped_ffn_bwd_plain``."""
    if activation not in _ACTS:
        raise ValueError(f"activation must be 'gelu' or 'relu', got "
                         f"{activation!r}")
    if x.device.type == "cpu":
        monitor.counter("kernels.moe.grouped_ffn_bwd_plain").increase()
        return grouped_ffn_bwd_plain(x, w1, b1, w2, b2, ws, counts, g,
                                     activation)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_ffn_bwd: unsupported device {x.device}")
    ops = _check_cuda("grouped_ffn_bwd", x, w1, b1, w2, b2, ws, counts, g)
    x, w1 = ops[0], ops[1]
    E, C, h = x.shape
    dff = w1.shape[2]
    dx = torch.empty_like(x)
    dws = torch.empty((E, C, 1), dtype=torch.float32, device=x.device)
    db2 = torch.empty((E, 1, h), dtype=torch.float32, device=x.device)
    dw1 = torch.empty_like(w1)
    db1 = torch.empty((E, 1, dff), dtype=torch.float32, device=x.device)
    dw2 = torch.empty_like(ops[3])
    if x.numel() == 0 or dw1.numel() == 0:
        return tuple(t.zero_() for t in (dx, dw1, db1, dw2, db2, dws))
    s = _bwd_scratch(x, dff)
    route = grouped_ffn_route(x.dtype, h, dff)
    _bwd_dx_launch(ops, s, dx, dws, db2, activation)
    grouped_ffn_bwd.launches_dx += 1
    monitor.counter("kernels.moe.grouped_ffn_dx_cuda_" + route).increase()
    _bwd_dw_launch(ops, s, dw1, db1, dw2)
    grouped_ffn_bwd.launches_dw += 1
    monitor.counter("kernels.moe.grouped_ffn_dw_cuda_" + route).increase()
    monitor.counter("kernels.moe.grouped_ffn_bwd_cuda").increase()
    return dx, dw1, db1, dw2, db2, dws


grouped_ffn_bwd.launches_dx = 0
grouped_ffn_bwd.launches_dw = 0


class _GroupedFFNFn(torch.autograd.Function):
    """Differentiable grouped FFN (the ``_grouped_ffn_pallas`` custom_vjp,
    :671-708): the forward saves its operands, the backward runs
    ``grouped_ffn_bwd``. ``counts`` gets no gradient. On a CUDA tensor
    that is the kernels or an error: there is no fallback."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ws, counts, activation):
        ctx.save_for_backward(x, w1, b1, w2, b2, ws, counts)
        ctx.activation = activation
        return grouped_ffn_fwd(x, w1, b1, w2, b2, ws, counts, activation)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, ws, counts = ctx.saved_tensors
        grads = grouped_ffn_bwd(x, w1, b1, w2, b2, ws, counts,
                                g.to(x.dtype), ctx.activation)
        return (*grads, None, None)


def grouped_ffn(x, w1, b1, w2, b2, ws, counts, *, activation="gelu"):
    """Fused grouped expert FFN over the sorted-by-expert capacity buffer:
    out[e, c] = (act(x[e, c] w1[e] + b1[e]) w2[e] + b2[e]) ws[e, c], rows
    at or past counts[e] zero. Differentiable in everything but counts.
    On CUDA tensors it always runs the kernels (any h, dff, capacity)."""
    mm = torch.promote_types(x.dtype, w1.dtype)
    args = (x.to(mm), w1.to(mm), b1.float(), w2.to(mm), b2.float(),
            ws.float(), torch.as_tensor(counts, device=x.device).to(
                torch.int32))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2, ws)):
        out = _GroupedFFNFn.apply(*args, activation)
    else:
        out = grouped_ffn_fwd(*args, activation)
    return out.to(x.dtype)
