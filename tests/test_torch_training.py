"""The port's training pieces held to the JAX package on the CPU, on the
same numpy inputs: ``fused_linear_cross_entropy`` and ``cross_entropy``
(loss and gradients against ``jax.value_and_grad``), one Adam / AdamW
update against ``_update`` / ``_adam_core``, and the gradient clips
against ``_clip_pytree``.

Tolerances: f32 throughout, rtol 1e-5 / atol 1e-6 on losses, gradients
and updates (one reduction order differs; no bf16 arithmetic) and exact
equality where the arithmetic is elementwise and identical. bf16 moments
are compared after the f32 update is rounded to nearest even by both
sides: equal, or one bf16 step apart where the two f32 results straddle
a rounding boundary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core.dispatch import unwrap
from paddle_tpu.incubate.nn.functional import \
    fused_linear_cross_entropy as jax_fused_ce
from paddle_tpu.jit.api import _clip_pytree
from paddle_tpu.nn.functional import cross_entropy as jax_ce
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.incubate.nn.functional import fused_linear_cross_entropy
from paddle_tpu_torch.nn.functional import cross_entropy

TOL = dict(rtol=1e-5, atol=1e-6)


def _ce_inputs(rng, n_rows=(3, 7), h=16, v=37):
    hid = rng.standard_normal(n_rows + (h,)).astype(np.float32)
    w = (rng.standard_normal((h, v)) * 0.3).astype(np.float32)
    lab = rng.integers(0, v, n_rows).astype(np.int32)
    lab[0, 0] = -100             # ignored
    lab[1, 2] = v + 3            # out of range: invalid, not clipped
    lab[2, 5] = -7               # negative: invalid
    return hid, w, lab


@pytest.mark.parametrize("chunks", [1, 4, 5, 64])
def test_fused_linear_ce_matches_jax(chunks):
    """21 rows: 4 and 5 chunks pad with ignored rows, 64 caps at 21."""
    hid, w, lab = _ce_inputs(np.random.default_rng(chunks))

    def jloss(h, w_):
        return unwrap(jax_fused_ce(h, w_, jnp.asarray(lab), n_chunks=chunks))
    want, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hid), jnp.asarray(w))
    th = torch.from_numpy(hid).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = fused_linear_cross_entropy(th, tw, torch.from_numpy(lab),
                                     n_chunks=chunks)
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


def test_fused_linear_ce_all_ignored_is_zero():
    hid, w, _ = _ce_inputs(np.random.default_rng(0))
    lab = torch.full((3, 7), -100)
    th = torch.from_numpy(hid).requires_grad_()
    loss = fused_linear_cross_entropy(th, torch.from_numpy(w), lab, 4)
    loss.backward()
    assert float(loss) == 0.0 and not th.grad.any()


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("trailing", [False, True])
def test_cross_entropy_matches_jax(reduction, trailing):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    lab = rng.integers(0, 11, (2, 5)).astype(np.int32)
    lab[1, 3] = -100
    if trailing:
        lab = lab[..., None]

    def jloss(x):
        out = unwrap(jax_ce(x, jnp.asarray(lab), reduction=reduction))
        return jnp.sum(out), out
    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy(tl, torch.from_numpy(lab), reduction=reduction)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad), **TOL)
    layer = tnn.CrossEntropyLoss(reduction=reduction)
    np.testing.assert_allclose(
        layer(torch.from_numpy(logits), torch.from_numpy(lab)).numpy(),
        np.asarray(want), **TOL)


def test_cross_entropy_refuses_later_slice_options():
    """The options a slice once refused (soft labels, label smoothing,
    class weights, use_softmax=False) came with the eager surface's
    whole loss.py: on raw tensors they equal the JAX cross_entropy."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0.05, 1.0, (4, 3)).astype(np.float32)
    y = np.array([0, 2, 1, 2])
    soft = rng.uniform(0, 1, (4, 3)).astype(np.float32)
    w = np.array([0.5, 1.0, 2.0], np.float32)
    for lab, kw in ((soft, dict(soft_label=True)),
                    (y, dict(label_smoothing=0.1)),
                    (y, dict(weight=w)), (y, dict(use_softmax=False))):
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jkw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        got = cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                            **tkw)
        want = jax_ce(paddle.to_tensor(x), paddle.to_tensor(lab), **jkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=1e-6, err_msg=str(kw))


def _bf16_close(got, want):
    """Both sides round the same f32 math to bf16: equal, or one bf16 step
    apart where the f32 results straddle a rounding boundary."""
    g = torch.from_numpy(np.array(got, np.float32))
    w = torch.from_numpy(np.array(want, np.float32))
    step = w.abs().clamp(min=1e-30) * 2.0 ** -7
    assert bool(((g - w).abs() <= step).all()), float((g - w).abs().max())


OPT_CASES = {
    "adamw_f32": ("AdamW", dict(weight_decay=0.01), None),
    "adamw_nodecay": ("AdamW", dict(weight_decay=0.0), None),
    "adamw_bf16_moments": ("AdamW", dict(weight_decay=0.05), "bfloat16"),
    "adamw_amsgrad": ("AdamW", dict(amsgrad=True), None),
    "adam_l2": ("Adam", dict(weight_decay=0.02), None),
    "adam_bf16_amsgrad": ("Adam", dict(amsgrad=True), "bfloat16"),
}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_adam_update_matches_jax(name):
    """Three updates of one parameter through the optimizer's rule; the
    parameter and every state slot match the JAX rule's."""
    cls, kw, mdt = OPT_CASES[name]
    rng = np.random.default_rng(len(name))
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) * 0.1
             for _ in range(3)]
    lr = 3e-3
    jopt = getattr(paddle.optimizer, cls)(
        lr, parameters=[paddle.to_tensor(p0)], moment_dtype=mdt, **kw)
    jp, jst = jnp.asarray(p0), jopt._init_state(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy())
    to = getattr(topt, cls)(lr, parameters=[tp], moment_dtype=mdt, **kw)
    tst = to._init_state(tp)
    for g in grads:
        jp, jst = jopt._update(jp, jnp.asarray(g), jst, jnp.float32(lr))
        to._update(tp, torch.from_numpy(g), tst,
                   torch.tensor(lr, dtype=torch.float32))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    assert sorted(tst) == sorted(jst)
    for slot, want in jst.items():
        got = tst[slot]
        if mdt is not None and slot.startswith("moment"):
            assert got.dtype == torch.bfloat16
            _bf16_close(got.float().numpy(),
                        np.asarray(want.astype(jnp.float32)))
        else:
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       err_msg=slot, **TOL)


def test_eager_step_matches_rule_and_refuses_decay_fun():
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 0.5)
    opt = topt.AdamW(0.1, parameters=[p])
    opt.step()
    q = torch.ones(3)
    topt.AdamW(0.1, parameters=[q])._update(
        q, torch.full((3,), 0.5), opt._init_state(q), torch.tensor(0.1))
    torch.testing.assert_close(p.detach(), q, rtol=0, atol=0)
    opt.clear_grad()
    assert p.grad is None


@pytest.mark.parametrize("clip", ["global", "norm", "value"])
def test_clip_matches_jax(clip):
    rng = np.random.default_rng(3)
    grads = {f"g{i}": rng.standard_normal(s).astype(np.float32)
             for i, s in enumerate([(4, 3), (7,), (2, 2, 2)])}
    make = {"global": ("ClipGradByGlobalNorm", 1.5),
            "norm": ("ClipGradByNorm", 1.0),
            "value": ("ClipGradByValue", 0.7)}[clip]
    want = _clip_pytree({k: jnp.asarray(v) for k, v in grads.items()},
                        getattr(jnn, make[0])(make[1]))
    got = getattr(tnn, make[0])(make[1]).clip_grads(
        [torch.from_numpy(v) for v in grads.values()])
    for (k, w), g in zip(want.items(), got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=k,
                                   **TOL)
