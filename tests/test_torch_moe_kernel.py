"""The port's grouped expert FFN (paddle_tpu_torch.kernels.moe) held to the
JAX package's on the CPU: ``grouped_ffn_plain`` — what the CUDA forward
kernel computes — against ``grouped_ffn_reference``, and
``grouped_ffn_bwd_plain`` and the autograd Function ``_GroupedFFNFn`` —
what the dx and dw kernels compute — against ``jax.vjp`` of it.

The JAX Pallas interpret path cannot be the oracle on this tree: the
kernels use ``pltpu.TPUMemorySpace`` / ``TPUCompilerParams``, which the
installed jax lacks, and ``grouped_ffn`` then falls back to the
reference.

Tolerances. f32: rtol 1e-5, atol 1e-6 for the forward (the frameworks sum
in other orders; the JAX test's own f32 bar), rtol 1e-4, atol 1e-5 for
the gradients (the JAX gradient test's bar: six products deep). bf16
operands with f32 accumulation against the all-f32 reference: rtol 2e-2,
atol 1e-2 (the JAX test's bf16 bar, ``test_moe_kernel.py:78-91``); the
gradients, which sum 64 rows, against 2e-2 of the gradient's largest
value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import moe as jmoe
from paddle_tpu_torch import monitor
from paddle_tpu_torch.kernels import moe

NAMES = ("dx", "dw1", "db1", "dw2", "db2", "dws")
# name -> (E, C, h, dff, counts, activation)
CASES = {
    "ragged_empty": (4, 16, 128, 256, [16, 0, 7, 12], "gelu"),
    "all_dead": (4, 16, 128, 256, [0, 0, 0, 0], "gelu"),
    "full": (4, 16, 128, 256, [16, 16, 16, 16], "gelu"),
    "relu_multiblock": (3, 96, 64, 192, [96, 65, 0], "relu"),
    "odd_geometry": (3, 37, 96, 200, [0, 37, 13], "gelu"),
    "odd_geometry_relu": (2, 37, 96, 200, [1, 36], "relu"),
}


def _operands(seed, e, c, h, f):
    rng = np.random.default_rng(seed)

    def mk(shape, sc):
        return (rng.standard_normal(shape) * sc).astype(np.float32)
    return dict(x=mk((e, c, h), 0.3), w1=mk((e, h, f), 0.1),
                b1=mk((e, 1, f), 0.1), w2=mk((e, f, h), 0.1),
                b2=mk((e, 1, h), 0.1),
                ws=rng.uniform(0.1, 1.0, (e, c, 1)).astype(np.float32),
                g=mk((e, c, h), 1.0))


ORDER = ("x", "w1", "b1", "w2", "b2", "ws")


def _jax_ref(ops, counts, act):
    cnt = jnp.asarray(counts, jnp.int32)
    args = [jnp.asarray(ops[n]) for n in ORDER]
    out, vjp = jax.vjp(lambda *a: jmoe.grouped_ffn_reference(
        *a, cnt, activation=act), *args)
    grads = vjp(jnp.asarray(ops["g"]))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch(ops, dtype=torch.float32):
    t = {n: torch.from_numpy(a) for n, a in ops.items()}
    for n in ("x", "w1", "w2", "g"):
        t[n] = t[n].to(dtype)
    return t


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_backward_plain_match_jax_f32(name):
    e, c, h, f, counts, act = CASES[name]
    ops = _operands(len(name), e, c, h, f)
    want, wgrads = _jax_ref(ops, counts, act)
    t = _torch(ops)
    cnt = torch.tensor(counts, dtype=torch.int32)
    got = moe.grouped_ffn_plain(*(t[n] for n in ORDER), cnt, act)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    grads = moe.grouped_ffn_bwd_plain(*(t[n] for n in ORDER), cnt, t["g"],
                                      act)
    for n, gt, gw in zip(NAMES, grads, wgrads):
        assert gt.shape == gw.shape, n
        np.testing.assert_allclose(gt.numpy(), gw, rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    dead = torch.arange(c)[None, :] >= cnt[:, None]
    assert not got[dead].any() and not grads[0][dead].any()
    assert not grads[5][dead].any()


@pytest.mark.parametrize("name", ["ragged_empty", "odd_geometry_relu"])
def test_autograd_function_matches_jax_vjp(name):
    """grouped_ffn with requires_grad runs _GroupedFFNFn: one forward and
    one backward of the wrappers (their plain versions on the CPU), and
    autograd's gradients equal jax.vjp's."""
    e, c, h, f, counts, act = CASES[name]
    ops = _operands(7, e, c, h, f)
    want, wgrads = _jax_ref(ops, counts, act)
    t = _torch(ops)
    args = [t[n].clone().requires_grad_() for n in ORDER]
    n_fwd = monitor.counter("kernels.moe.grouped_ffn_fwd_plain").get()
    n_bwd = monitor.counter("kernels.moe.grouped_ffn_bwd_plain").get()
    out = moe.grouped_ffn(*args, torch.tensor(counts, dtype=torch.int32),
                          activation=act)
    out.backward(t["g"])
    assert monitor.counter("kernels.moe.grouped_ffn_fwd_plain").get() == \
        n_fwd + 1
    assert monitor.counter("kernels.moe.grouped_ffn_bwd_plain").get() == \
        n_bwd + 1
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    for n, a, gw in zip(NAMES, args, wgrads):
        np.testing.assert_allclose(a.grad.numpy(), gw, rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_bf16_within_the_jax_bar_of_the_f32_reference():
    """bf16 operands, f32 accumulation: output in bf16, within the JAX
    test's bar of the all-f32 reference; the gradients within 2e-2 of
    their largest value; under no_grad only the forward runs."""
    e, c, h, f, counts, act = 4, 64, 128, 256, [64, 11, 0, 48], "gelu"
    ops = _operands(2, e, c, h, f)
    want, wgrads = _jax_ref(ops, counts, act)
    t = _torch(ops, torch.bfloat16)
    cnt = torch.tensor(counts, dtype=torch.int32)
    n_bwd = monitor.counter("kernels.moe.grouped_ffn_bwd_plain").get()
    with torch.no_grad():
        out = moe.grouped_ffn(*(t[n] for n in ORDER), cnt)
    assert out.dtype == torch.bfloat16
    assert monitor.counter("kernels.moe.grouped_ffn_bwd_plain").get() == n_bwd
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2e-2,
                               atol=1e-2)
    grads = moe.grouped_ffn_bwd_plain(*(t[n] for n in ORDER), cnt, t["g"])
    assert [g.dtype for g in grads] == [torch.bfloat16] * 2 + [
        torch.float32, torch.bfloat16] + [torch.float32] * 2
    for n, gt, gw in zip(NAMES, grads, wgrads):
        err = float(np.abs(gt.float().numpy() - gw).max())
        assert err <= 2e-2 * float(np.abs(gw).max()), (n, err)


def test_rounding_points_are_the_kernels():
    """The bf16 plain forward rounds the activation to bf16 before the
    second product and nowhere else before the output: it equals the f32
    plain forward fed the rounded activation, and differs from one that
    keeps the activation in f32."""
    e, c, h, f = 2, 8, 32, 48
    ops = _operands(3, e, c, h, f)
    t = _torch(ops, torch.bfloat16)
    cnt = torch.tensor([8, 5], dtype=torch.int32)
    got = moe.grouped_ffn_plain(*(t[n] for n in ORDER), cnt).float()
    z = torch.bmm(t["x"].float(), t["w1"].float()) + t["b1"]
    ha = moe._act_apply(z, "gelu").to(torch.bfloat16).float()
    out = (torch.bmm(ha, t["w2"].float()) + t["b2"]) * t["ws"]
    keep = moe._row_mask(cnt, c, "cpu")
    out = torch.where(keep, out, 0.0)
    assert torch.equal(got, out.to(torch.bfloat16).float())
    ha32 = moe._act_apply(z, "gelu")
    out32 = torch.where(keep, (torch.bmm(ha32, t["w2"].float()) + t["b2"])
                        * t["ws"], 0.0)
    assert not torch.equal(got, out32.to(torch.bfloat16).float())


def test_plain_stages_compose():
    """The plain versions split at their rounding points: the backward's
    rounded ha through the forward's second stage is the plain forward bit
    for bit, the two backward stages composed are grouped_ffn_bwd_plain,
    and the output stage computes from the intermediates it is given."""
    ops = _operands(4, 3, 16, 32, 48)
    t = _torch(ops, torch.bfloat16)
    cnt = torch.tensor([16, 0, 9], dtype=torch.int32)
    args = [t[n] for n in ORDER] + [cnt, t["g"]]
    inter = moe.grouped_ffn_bwd_intermediates(*args, "relu")
    assert torch.equal(inter["dz"], inter["dz32"].to(torch.bfloat16).float())
    fwd = moe.grouped_ffn_down_plain(inter["ha"], t["w2"], t["b2"], t["ws"],
                                     cnt, torch.bfloat16)
    assert torch.equal(fwd, moe.grouped_ffn_plain(*args[:7], "relu"))
    plain = moe.grouped_ffn_bwd_plain(*args, "relu")
    for a, b in zip(moe.grouped_ffn_bwd_outputs(*args, **inter), plain):
        assert torch.equal(a, b)
    dz = inter["dz"].clone()
    dz[2, 3] = 0.0
    dw1 = moe.grouped_ffn_bwd_outputs(*args, **dict(inter, dz=dz))[1]
    assert torch.equal(dw1, torch.bmm(t["x"].float().transpose(1, 2),
                                      dz).to(torch.bfloat16))
    assert not torch.equal(dw1, plain[1])


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_hand_coded_derivative_matches_autograd(act):
    z = torch.linspace(-6, 6, 1001, dtype=torch.float64).requires_grad_()
    (d,) = torch.autograd.grad(moe._act_apply(z, act).sum(), z)
    torch.testing.assert_close(moe._act_grad(z.detach(), act).double(), d,
                               rtol=1e-6, atol=1e-7)
    # the JAX package's own pair agrees, within XLA's f32 tanh
    # approximation (it stops 5e-6 short of +-1 in the tails)
    zj = jnp.asarray(z.detach().numpy(), jnp.float32)
    np.testing.assert_allclose(
        moe._act_apply(z.detach().float(), act).numpy(),
        np.asarray(jmoe._act_apply(zj, act)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        moe._act_grad(z.detach().float(), act).numpy(),
        np.asarray(jmoe._act_grad(zj, act)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("cap", [1, 5, 8, 9, 16, 17, 100, 256, 300, 8192])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_token_block_helpers_match_jax(cap, dt):
    tdt = getattr(torch, dt)
    assert moe.pick_token_block(cap, tdt) == jmoe.pick_token_block(cap, dt)
    assert moe.padded_capacity(cap, tdt) == jmoe.padded_capacity(cap, dt)


def test_wrappers_reject_other_devices_and_activations():
    ops = _torch(_operands(0, 1, 4, 8, 8))
    cnt = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(ValueError, match="activation"):
        moe.grouped_ffn_fwd(*(ops[n] for n in ORDER), cnt, "silu")
    meta = [ops[n].to("meta") for n in ORDER]
    with pytest.raises(ValueError, match="unsupported device"):
        moe.grouped_ffn_fwd(*meta, cnt.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        moe.grouped_ffn_bwd(*meta, cnt.to("meta"), ops["g"].to("meta"))


# -- the forward's "rows" route (csrc/grouped_ffn_fwd.cu, namespace rows) ---

def _rows_emulation(x, w1, b1, w2, b2, ws, counts, act,
                    split=moe.ROWS_K_SPLIT):
    """The rows route's arithmetic in f32 torch, schedule and all: each
    pass sums every K split of ``split`` rows over the expert's live rows
    only (a row at or past counts[e] is never read) into a partial, and
    the reduce epilogue sums the partials in split order, then adds b1
    and applies act into ha (up) or adds b2 and multiplies by ws, with
    rows past the count zero (down)."""
    E, C, h = x.shape

    def passes(a, w, e, n):
        K = w.shape[1]
        parts = [a[e, :n, k0:k0 + split] @ w[e, k0:k0 + split]
                 for k0 in range(0, K, split)]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total
    out = torch.zeros(E, C, h)
    for e in range(E):
        n = min(int(counts[e]), C)
        if n == 0:
            continue
        ha = moe._act_apply(passes(x, w1, e, n) + b1[e], act)
        y = passes(ha[None], w2[e:e + 1], 0, n)
        out[e, :n] = (y + b2[e]) * ws[e, :n]
    return out


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_rows_schedule_matches_jax_reference(act):
    """Counts 0..C (an empty expert, every count up to the capacity), NaN
    in every dead row of x, and K not a multiple of the split on both
    passes (h 304: splits 256 + 48; dff 520: 256 + 256 + 8): the rows
    route's schedule against ``grouped_ffn_reference``, which zeroes the
    dead rows by a select. f32: the module's forward bar."""
    C = 8
    counts = list(range(C + 1))
    e, h, f = len(counts), 304, 520
    ops = _operands(11, e, C, h, f)
    cnt = torch.tensor(counts, dtype=torch.int32)
    dead = np.arange(C)[None, :] >= np.asarray(counts)[:, None]
    ops["x"][dead] = np.nan
    want, _ = _jax_ref(ops, counts, act)
    assert np.isfinite(want).all()
    t = _torch(ops)
    got = _rows_emulation(*(t[n] for n in ORDER), cnt, act)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert not got[torch.from_numpy(dead)].any()
    assert moe.grouped_ffn_route(torch.float32, h, f, C) == "rows"


def test_rows_scratch_holds_both_passes():
    """The scratch the wrapper allocates for the rows route: the larger of
    the two passes' [S, E, C, N] partials."""
    E, C, h, f = 8, 8, 1024, 2816
    s = moe.grouped_ffn_rows_scratch(E, C, h, f)
    assert s.dtype == torch.float32
    assert s.numel() == max(4 * f, 11 * h) * E * C
    assert moe.grouped_ffn_rows_scratch(2, 3, 304, 520).numel() == \
        max(2 * 520, 3 * 304) * 2 * 3


@pytest.mark.parametrize("dtype,h,dff,cap,route", [
    (torch.float32, 1024, 2816, 8, "rows"),     # the serving decode tick
    (torch.float32, 1024, 2816, moe.ROWS_MAX_CAPACITY, "rows"),
    (torch.float32, 1024, 2816, moe.ROWS_MAX_CAPACITY + 1, "simt"),
    (torch.float32, 1024, 2816, 128, "simt"),   # the serving prefill
    (torch.float32, 1024, 2816, None, "simt"),  # dx and dw: no capacity
    (torch.float32, 1022, 2816, 8, "simt"),     # rows not 16-byte runs
    (torch.float32, 1024, 2814, 8, "simt"),
    (torch.bfloat16, 1024, 2816, 8, "tc"),
    (torch.float16, 1024, 2816, 8, "tc"),
    (torch.bfloat16, 1020, 2812, 8, "simt"),    # bf16 never takes rows
])
def test_rows_route_rule(dtype, h, dff, cap, route):
    assert moe.grouped_ffn_route(dtype, h, dff, cap) == route
