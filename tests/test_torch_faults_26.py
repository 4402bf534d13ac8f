"""Two faults of the port against the JAX package (ROADMAP section 3,
faults 14 and 15), each held to the JAX package.

Fault 14: seven ``incubate.nn.functional`` ops took raw torch tensors
only. Handed the port's own ``Tensor`` (``paddle.to_tensor``) each now
returns surface Tensors with the JAX op's values, and RoPE and the fused
linear cross entropy the JAX gradients; the in-place pool writes hand the
caller's own Tensors back.

Fault 15: names and signatures of ported submodules. ``framework``'s
seed / dtype / Tensor / mode names, ``text.models``'s LLaMA names,
``distributed.launch``'s entries, ``core.flags.all_flags``, the fused CE's
``name`` keyword and ``UserDefinedRoleMaker``'s positional order
(``tests/test_torch_submodule_names.py`` walks every ported submodule).

Tolerance: 1e-5 (f32 values and gradients); exact for names, types and
identities.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.incubate.nn import functional as jF
from paddle_tpu_torch.incubate.nn import functional as tF

from test_torch_parity_util import arr, cpu_place, run_both  # noqa: F401

pytestmark = pytest.mark.usefixtures("cpu_place")

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(jfn, tfn, arrays):
    """(JAX outputs, port outputs) of the op on the arrays as each
    package's Tensors; every port output leaf is a surface Tensor."""
    jout = jfn(*[jp.to_tensor(a) for a in arrays])
    tout = tfn(*[tp.to_tensor(a) for a in arrays])
    leaves = tout if isinstance(tout, (tuple, list)) else [tout]
    assert all(isinstance(t, tp.Tensor) for t in leaves if t is not None)
    return jout, tout


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t.numpy()), np.asarray(j.numpy()),
                               **TOL)


# -- fault 14 ----------------------------------------------------------------

@pytest.mark.parametrize("neox", [True, False], ids=["neox", "interleaved"])
def test_rope_takes_surface_tensors_with_jax_gradients(neox):
    q, k, v = arr(2, 5, 3, 8, seed=1), arr(2, 5, 3, 8, seed=2), \
        arr(2, 5, 3, 8, seed=3)
    pid = np.arange(4, 9, dtype=np.int64)
    out = run_both(
        lambda a, b, c, p: jF.fused_rotary_position_embedding(
            a, b, c, position_ids=p, use_neox_rotary_style=neox),
        lambda a, b, c, p: tF.fused_rotary_position_embedding(
            a, b, c, position_ids=p, use_neox_rotary_style=neox),
        [q, k, v, pid], int_args=(3,), tol=TOL)
    assert all(isinstance(t, tp.Tensor) for t in out)
    # absent inputs stay None; user sin / cos tables as Tensors too
    sin, cos = arr(1, 5, 1, 8, seed=4), arr(1, 5, 1, 8, seed=5)
    jout, tout = _both(
        lambda a, s, c: jF.fused_rotary_position_embedding(
            a, sin=s, cos=c, use_neox_rotary_style=neox),
        lambda a, s, c: tF.fused_rotary_position_embedding(
            a, sin=s, cos=c, use_neox_rotary_style=neox), [q, sin, cos])
    assert tout[1] is None and tout[2] is None
    _close(tout[0], jout[0])


def test_fused_linear_cross_entropy_takes_surface_tensors_and_name():
    h, w = arr(10, 16, seed=6), arr(16, 24, seed=7, lo=-0.3, hi=0.3)
    labels = np.array([1, 5, -100, 23, 0, 7, 7, 2, 30, 11], np.int64)
    out = run_both(
        lambda a, b, c: jF.fused_linear_cross_entropy(a, b, c, n_chunks=3,
                                                      name="ce"),
        lambda a, b, c: tF.fused_linear_cross_entropy(a, b, c, n_chunks=3,
                                                      name="ce"),
        [h, w, labels], int_args=(2,), tol=TOL)
    assert isinstance(out[0], tp.Tensor) and out[0].shape == []
    # raw torch in, raw torch out, as before
    import torch
    raw = tF.fused_linear_cross_entropy(torch.from_numpy(h),
                                        torch.from_numpy(w),
                                        torch.from_numpy(labels), 3)
    assert type(raw) is torch.Tensor
    np.testing.assert_allclose(raw.numpy(), np.asarray(out[0].numpy()),
                               **TOL)


def test_masked_multihead_attention_takes_surface_tensors():
    b, h, L, d = 3, 2, 10, 8
    x, cache = arr(b, 3 * h * d, seed=8), arr(2, b, h, L, d, seed=9)
    lens = np.array([[0], [4], [9]], np.int32)
    bias = arr(3, h, d, seed=10)
    jo, jc = jF.masked_multihead_attention(
        jp.to_tensor(x), jp.to_tensor(cache), bias=jp.to_tensor(bias),
        sequence_lengths=jp.to_tensor(lens))
    tcache = tp.to_tensor(cache)
    to, tc = tF.masked_multihead_attention(
        tp.to_tensor(x), tcache, bias=tp.to_tensor(bias),
        sequence_lengths=tp.to_tensor(lens))
    assert isinstance(to, tp.Tensor) and tc is tcache
    _close(to, jo)
    _close(tc, jc)


def test_varlen_attention_takes_surface_tensors():
    B, H, S, T, D = 3, 2, 4, 7, 8
    arrays = [arr(B, H, S, D, seed=11), arr(B, H, T, D, seed=12),
              arr(B, H, T, D, seed=13), np.array([4, 2, 3], np.int32),
              np.array([7, 5, 6], np.int32), arr(B, 1, S, T, seed=14)]
    jout, tout = _both(
        lambda q, k, v, s, t, m:
            jF.variable_length_memory_efficient_attention(
                q, k, v, s, t, mask=m, causal=True),
        lambda q, k, v, s, t, m:
            tF.variable_length_memory_efficient_attention(
                q, k, v, s, t, mask=m, causal=True), arrays)
    _close(tout, jout)


def test_paged_attention_takes_surface_tensors():
    rng = np.random.default_rng(15)
    kc = rng.standard_normal((7, 2, 4, 8)).astype(np.float32)
    vc = rng.standard_normal((7, 2, 4, 8)).astype(np.float32)
    arrays = [arr(3, 4, 8, seed=16), kc, vc,
              np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0]], np.int32),
              np.array([9, 5, 0], np.int32)]
    jout, tout = _both(
        lambda *a: jF.paged_attention(*a, scale=0.3),
        lambda *a: tF.paged_attention(*a, scale=0.3), arrays)
    _close(tout, jout)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_writes_hand_back_the_callers_tensors(quant):
    rng = np.random.default_rng(17)
    kf = rng.standard_normal((7, 2, 4, 8)).astype(np.float32)
    vf = rng.standard_normal((7, 2, 4, 8)).astype(np.float32)
    if quant:
        pools = [np.zeros((7, 2, 4, 8), np.int8),
                 np.zeros((7, 2, 4, 8), np.int8),
                 np.ones((7, 2, 4), np.float32),
                 np.ones((7, 2, 4), np.float32)]
    else:
        pools = [kf, vf]
    bt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    k, v = arr(2, 3, 2, 8, seed=18), arr(2, 3, 2, 8, seed=19)
    pos = np.array([4, 0], np.int32)
    op = "paged_quant_write" if quant else "paged_write"
    jout = getattr(jF, op)(*[jp.to_tensor(a) for a in [k, v] + pools
                             + [bt, pos]])
    tpools = [tp.to_tensor(a) for a in pools]
    tout = getattr(tF, op)(tp.to_tensor(k), tp.to_tensor(v), *tpools,
                           tp.to_tensor(bt), tp.to_tensor(pos))
    assert len(tout) == len(pools)
    assert all(a is b for a, b in zip(tout, tpools))
    for t, j in zip(tout, jout):
        tv, jv = np.asarray(t.numpy()), np.asarray(j.numpy())
        if tv.dtype == np.int8:
            assert np.abs(tv.astype(int) - jv.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-7)


# -- fault 15 ----------------------------------------------------------------

def test_framework_exports_the_jax_names():
    from paddle_tpu import framework as jfw
    from paddle_tpu_torch import framework as tfw
    for name in ("seed", "get_rng_state", "set_rng_state",
                 "get_default_dtype", "set_default_dtype", "Tensor",
                 "in_dynamic_mode", "in_pir_mode"):
        assert hasattr(jfw, name) and hasattr(tfw, name), name
    assert tfw.in_pir_mode() is False is jfw.in_pir_mode()
    assert tfw.in_dynamic_mode() is True
    assert tfw.Tensor is tp.Tensor
    assert tfw.get_default_dtype() == jfw.get_default_dtype() == "float32"
    tfw.seed(5)
    a = tp.rand([3]).numpy()
    state = tfw.get_rng_state()
    b = tp.rand([3]).numpy()
    tfw.set_rng_state(state)
    np.testing.assert_array_equal(tp.rand([3]).numpy(), b)
    assert not np.array_equal(a, b)


def test_text_models_and_launch_and_flags_export_the_jax_names():
    from paddle_tpu.core import flags as jflags
    from paddle_tpu_torch.core import flags as tflags
    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.text import models
    from paddle_tpu_torch.text.models import llama
    assert models.LlamaModel is llama.LlamaModel
    assert models.LlamaDecoderLayer is llama.LlamaDecoderLayer
    assert models.force_tp_layers is llama.force_tp_layers
    assert callable(launch.launch) and callable(launch.main)
    ns = launch.build_parser().parse_args(["--nproc_per_node", "2", "x.py"])
    assert ns.nproc_per_node == 2
    names = tflags.all_flags()
    assert "check_nan_inf" in names and names == list(tflags._registry)
    assert set(names) >= {"check_nan_inf", "check_nan_inf_level"} & set(
        jflags.all_flags())


def test_user_defined_role_maker_takes_the_jax_positional_order():
    from paddle_tpu.distributed.fleet.compat import \
        UserDefinedRoleMaker as JaxRM
    from paddle_tpu_torch.distributed.fleet import (Role,
                                                    UserDefinedRoleMaker)
    for args, kw in (((False, 3), {}), ((True, 0, Role.WORKER, 4), {}),
                     ((), dict(current_id=2, worker_num=5))):
        j, t = JaxRM(*args, **kw), UserDefinedRoleMaker(*args, **kw)
        assert t.worker_index() == j.worker_index()
        assert t.worker_num() == j.worker_num()
        assert t.is_first_worker() == j.is_first_worker()
        assert t.is_worker() == j.is_worker()
    assert UserDefinedRoleMaker(False, 3).worker_index() == 3
    server = UserDefinedRoleMaker(False, 0, Role.SERVER,
                                  server_endpoints=["127.0.0.1:1"])
    assert server.is_server() and not server.is_worker()
