"""The port's ``incubate`` (``paddle_tpu_torch.incubate``) held to the JAX
package on the same seeded numpy inputs: the fused functionals and the
fused layers (values and input gradients, dropout 0 or eval mode; the
dropouts' rate and scaling on their own, as torch cannot draw JAX's
threefry masks), ``LookAhead`` / ``ModelAverage`` trajectories,
``minimize_lbfgs`` / ``minimize_bfgs``, the ASP masks and ``decorate``,
``forward_grad`` / ``grad`` and the prim switches, ``autotune``, and the
package's names.

Tolerances: f32 throughout; rtol 1e-5, atol 1e-5 on single ops, rtol 1e-4,
atol 1e-5 on layers and trajectories (products summed in another order);
masks, switches and configs exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.incubate as jinc
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
import paddle_tpu_torch.incubate as tinc
import paddle_tpu_torch.nn as tnn
from paddle_tpu.incubate.nn import functional as JF
from paddle_tpu_torch.bridge import layer_state_from_jax
from paddle_tpu_torch.incubate.nn import functional as TF

from test_torch_parity_util import arr, cpu_place, run_both  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
LTOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _cpu(cpu_place):
    yield


def _np(t):
    return np.asarray(t.numpy())


def both(fn, arrays, **kw):
    """``fn(module)`` -> a function of tensors, run in both packages."""
    return run_both(fn(JF), fn(TF), arrays, **kw)


# -- fused functionals ------------------------------------------------------

@pytest.mark.parametrize("biases,norm", [(False, True), (True, True),
                                         (True, False)])
def test_fused_moe_matches_jax(biases, norm):
    b, s, d, f, e = 2, 5, 8, 6, 4
    arrays = [arr(b, s, d, seed=1), arr(b, s, e, seed=2, lo=-2, hi=2),
              arr(e, d, 2 * f, seed=3), arr(e, f, d, seed=4)]
    if biases:
        arrays += [arr(e, 1, 2 * f, seed=5), arr(e, 1, d, seed=6)]

    def fn(F):
        def call(x, g, w1, w2, *bb):
            kw = dict(ffn1_bias=bb[0], ffn2_bias=bb[1]) if bb else {}
            return F.fused_moe(x, g, w1, w2, moe_topk=2,
                               norm_topk_prob=norm, **kw)
        return call
    both(fn, arrays, tol=TOL)


def test_fused_moe_breaks_gate_ties_by_the_lowest_index():
    """Three experts tie for the top two: experts 0 and 1 are chosen, as
    jax.lax.top_k chooses."""
    x = arr(1, 2, 4, seed=7)
    g = np.zeros((1, 2, 3), np.float32)
    w1, w2 = arr(3, 4, 6, seed=8), arr(3, 3, 4, seed=9)
    got = both(lambda F: lambda *a: F.fused_moe(*a, moe_topk=2),
               [x, g, w1, w2], tol=TOL)
    only01 = w2.copy()
    only01[2] = 0.0
    ref = TF.fused_moe(*(tp.to_tensor(a) for a in (x, g, w1, only01)),
                       moe_topk=2)
    np.testing.assert_allclose(_np(got[0]), _np(ref), **TOL)
    with pytest.raises(NotImplementedError):
        TF.fused_moe(*(tp.to_tensor(a) for a in (x, g, w1, w2)),
                     quant_method="weight_only_int8")


@pytest.mark.parametrize("axis,bias", [(-1, False), (-1, True), (1, True)])
def test_fused_rms_norm_matches_jax(axis, bias):
    arrays = [arr(2, 3, 8, seed=10), arr(*((8,) if axis == -1 else (3, 8)),
                                         seed=11)]
    if bias:
        arrays.append(arr(*arrays[1].shape, seed=12))
    both(lambda F: lambda x, w, *bb: F.fused_rms_norm(
        x, w, bb[0] if bb else None, begin_norm_axis=axis), arrays, tol=TOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_and_matmul_bias_match_jax(transpose):
    w = arr(6, 5, seed=13) if transpose else arr(5, 6, seed=13)
    both(lambda F: lambda x, ww, b: F.fused_linear(x, ww, b, transpose),
         [arr(3, 5, seed=14), w, arr(6, seed=15)], tol=TOL)
    both(lambda F: lambda x, y, b: F.fused_matmul_bias(
        x, y, b, transpose_x=transpose, transpose_y=not transpose),
        [arr(2, 5, 3, seed=16) if transpose else arr(2, 3, 5, seed=16),
         arr(4, 5, seed=17) if not transpose else arr(5, 4, seed=17),
         arr(4, seed=18)], tol=TOL)


@pytest.mark.parametrize("act", ["gelu", "relu", "none"])
def test_fused_linear_activation_matches_jax(act):
    both(lambda F: lambda x, y, b: F.fused_linear_activation(
        x, y, b, activation=act),
        [arr(3, 5, seed=19), arr(5, 4, seed=20), arr(4, seed=21)], tol=TOL)


@pytest.mark.parametrize("act", ["gelu", "relu", "swiglu", "geglu"])
def test_fused_bias_act_matches_jax(act):
    both(lambda F: lambda x, b: F.fused_bias_act(x, b, act_method=act),
         [arr(3, 8, seed=22), arr(8, seed=23)], tol=TOL)
    both(lambda F: lambda x: F.fused_bias_act(x, act_method=act),
         [arr(3, 8, seed=24)], tol=TOL)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_fused_dropout_add_matches_jax_without_dropout(mode):
    xy = [arr(3, 4, seed=25), arr(3, 4, seed=26)]
    both(lambda F: lambda x, y: F.fused_dropout_add(x, y, p=0.0), xy,
         tol=TOL)
    both(lambda F: lambda x, y: F.fused_dropout_add(
        x, y, p=0.3, training=False, mode=mode), xy, tol=TOL)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_fused_dropouts_keep_the_rate_and_the_scale(mode):
    """p = 0.3 over 10^5 elements: the kept share within 0.01 of 0.7 (7
    standard deviations), kept values scaled by 1 / 0.7 under
    upscale_in_train, unscaled under downscale_in_infer; masks from the
    port's seeded generator repeat after ``seed``."""
    n, p = 100_000, 0.3
    ones, zeros = tp.ones([n]), tp.zeros([n])
    tp.seed(5)
    out = _np(TF.fused_dropout_add(ones, zeros, p=p, mode=mode))
    kept = out != 0
    assert abs(kept.mean() - (1 - p)) < 0.01
    scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(out[kept], scale, rtol=1e-6)
    tp.seed(5)
    again = _np(TF.fused_dropout_add(ones, zeros, p=p, mode=mode))
    np.testing.assert_array_equal(out, again)
    res = _np(TF.fused_bias_dropout_residual_layer_norm(
        tp.ones([4, n // 4]), tp.zeros([4, n // 4]), dropout_rate=p,
        mode=mode))
    assert np.isfinite(res).all()


@pytest.mark.parametrize("residual", [False, True])
def test_fused_layer_norm_matches_jax(residual):
    arrays = [arr(2, 3, 8, seed=27), arr(3, 8, seed=28), arr(3, 8, seed=29),
              arr(3, 8, seed=30)]
    if residual:
        arrays.append(arr(2, 3, 8, seed=31))
    both(lambda F: lambda x, w, b, bi, *r: F.fused_layer_norm(
        x, w, b, bias=bi, residual=r[0] if r else None,
        residual_alpha=0.5), arrays, tol=TOL)


def test_fused_bias_dropout_residual_layer_norm_matches_jax():
    both(lambda F: lambda x, r, b, s, bb: (
        F.fused_bias_dropout_residual_layer_norm(x, r, b, s, bb,
                                                 dropout_rate=0.0)),
         [arr(2, 3, 8, seed=32), arr(2, 3, 8, seed=33), arr(8, seed=34),
          arr(8, seed=35), arr(8, seed=36)], tol=TOL)


@pytest.mark.parametrize("pre_ln,act", [(False, "relu"), (True, "gelu")])
def test_fused_feedforward_matches_jax(pre_ln, act):
    d, f = 8, 16
    both(lambda F: lambda x, w1, w2, b1, b2, s1, bb1, s2, bb2: (
        F.fused_feedforward(x, w1, w2, b1, b2, s1, bb1, s2, bb2,
                            dropout1_rate=0.0, dropout2_rate=0.0,
                            activation=act, pre_layer_norm=pre_ln)),
         [arr(2, 3, d, seed=37), arr(d, f, seed=38), arr(f, d, seed=39),
          arr(f, seed=40), arr(d, seed=41), arr(d, seed=42),
          arr(d, seed=43), arr(d, seed=44), arr(d, seed=45)], tol=TOL)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_multi_head_attention_matches_jax(pre_ln):
    b, s, h, d = 2, 5, 2, 4
    e = h * d
    mask = np.where(np.tril(np.ones((s, s))), 0.0, -1e4).astype(
        np.float32)[None, None]
    arrays = [arr(b, s, e, seed=46), arr(3, h, d, e, seed=47),
              arr(e, e, seed=48), arr(e, seed=49), arr(e, seed=50),
              arr(e, seed=51), arr(e, seed=52), arr(3 * e, seed=53),
              arr(e, seed=54), mask]
    both(lambda F: lambda x, qkv, wo, pls, plb, ls, lb, bqkv, bo, m: (
        F.fused_multi_head_attention(
            x, qkv, wo, pre_ln, pls, plb, ls, lb, qkv_bias=bqkv,
            linear_bias=bo, attn_mask=m, dropout_rate=0.0,
            attn_dropout_rate=0.0)), arrays, tol=TOL)
    with pytest.raises(NotImplementedError):
        TF.fused_multi_head_attention(
            *(tp.to_tensor(a) for a in arrays[:3]),
            cache_kv=tp.to_tensor(arrays[0]))
    with pytest.raises(NotImplementedError):
        TF.fused_multi_transformer()


# -- fused layers -----------------------------------------------------------

def _layer_pair(build, seed=0):
    jp.seed(seed)
    jl, tl = build(jinc.nn), build(tinc.nn)
    tl.set_state_dict(layer_state_from_jax(jl))
    assert sorted(jl.state_dict()) == sorted(tl.state_dict())
    jl.eval()
    tl.eval()
    return jl, tl


LAYERS = {
    "linear": (lambda n: n.FusedLinear(8, 6), [(3, 8)]),
    "linear_t": (lambda n: n.FusedLinear(8, 6, transpose_weight=True),
                 [(3, 8)]),
    "dropout_add": (lambda n: n.FusedDropoutAdd(0.4), [(3, 8), (3, 8)]),
    "bias_dropout_residual_ln": (
        lambda n: n.FusedBiasDropoutResidualLayerNorm(8, 0.3),
        [(2, 3, 8), (2, 3, 8)]),
    "feedforward": (lambda n: n.FusedFeedForward(8, 16, 0.2), [(2, 3, 8)]),
    "feedforward_pre_gelu": (lambda n: n.FusedFeedForward(
        8, 16, 0.2, activation="gelu", normalize_before=True), [(2, 3, 8)]),
    "mha": (lambda n: n.FusedMultiHeadAttention(8, 2, 0.1, 0.1),
            [(2, 5, 8)]),
    "encoder_layer": (lambda n: n.FusedTransformerEncoderLayer(
        8, 2, 16, 0.1), [(2, 5, 8)]),
    "encoder_layer_pre": (lambda n: n.FusedTransformerEncoderLayer(
        8, 2, 16, 0.1, activation="gelu", normalize_before=True),
        [(2, 5, 8)]),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_fused_layers_match_jax(case):
    """Eval mode (no dropout): outputs and input gradients, then the
    parameters' gradients of one backward."""
    build, shapes = LAYERS[case]
    jl, tl = _layer_pair(build)
    arrays = [arr(*sh, seed=60 + i) for i, sh in enumerate(shapes)]
    run_both(jl, tl, arrays, tol=LTOL)
    if not tl.parameters():
        return
    jx = [jp.to_tensor(a) for a in arrays]
    tx = [tp.to_tensor(a) for a in arrays]
    (jl(*jx) ** 2).sum().backward()
    (tl(*tx) ** 2).sum().backward()
    jps = dict(jl.named_parameters())
    for k, p in tl.named_parameters():
        # a parameter the layer does not use (the post-LN block's ln1_*)
        # has no gradient in the port and zeros in the JAX package
        want = np.zeros(p.shape, np.float32) if jps[k].grad is None \
            else _np(jps[k].grad)
        got = np.zeros(p.shape, np.float32) if p.grad is None \
            else _np(p.grad)
        np.testing.assert_allclose(got, want, **LTOL, err_msg=k)


def test_fused_multi_transformer_layer_is_refused():
    with pytest.raises(NotImplementedError):
        tinc.nn.FusedMultiTransformer(8, 2, 16)


# -- incubate.optimizer -----------------------------------------------------

def _net_pair(seed=3):
    jp.seed(seed)
    jl, tl = jnn.Linear(6, 3), tnn.Linear(6, 3)
    tl.set_state_dict(layer_state_from_jax(jl))
    return jl, tl


def _steps(pkg, net, opt, n, seed=70, x_shape=(4, 6)):
    losses = []
    for i in range(n):
        x = pkg.to_tensor(arr(*x_shape, seed=seed + i))
        loss = (net(x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def test_lookahead_trajectory_matches_jax():
    jl, tl = _net_pair()
    jo = jinc.LookAhead(jp.optimizer.SGD(0.3, parameters=jl.parameters()),
                        alpha=0.4, k=3)
    to = tinc.LookAhead(tp.optimizer.SGD(0.3, parameters=tl.parameters()),
                        alpha=0.4, k=3)
    np.testing.assert_allclose(_steps(tp, tl, to, 7), _steps(jp, jl, jo, 7),
                               **LTOL)
    for k, v in jl.state_dict().items():
        np.testing.assert_allclose(_np(tl.state_dict()[k]), _np(v), **LTOL,
                                   err_msg=k)
    assert to.get_lr() == jo.get_lr() == 0.3


def test_model_average_trajectory_matches_jax():
    jl, tl = _net_pair(seed=4)
    jopt = jp.optimizer.SGD(0.2, parameters=jl.parameters())
    topt = tp.optimizer.SGD(0.2, parameters=tl.parameters())
    jma = jinc.ModelAverage(0.15, parameters=jl.parameters(),
                            max_average_window=4)
    tma = tinc.ModelAverage(0.15, parameters=tl.parameters(),
                            max_average_window=4)
    x = arr(2, 6, seed=80)
    for i in range(6):
        _steps(jp, jl, jopt, 1, seed=90 + i)
        _steps(tp, tl, topt, 1, seed=90 + i)
        jma.step()
        tma.step()
    before = _np(tl(tp.to_tensor(x)))
    with jma.apply(), tma.apply():
        np.testing.assert_allclose(_np(tl(tp.to_tensor(x))),
                                   _np(jl(jp.to_tensor(x))), **LTOL)
        assert not np.allclose(_np(tl(tp.to_tensor(x))), before)
    np.testing.assert_array_equal(_np(tl(tp.to_tensor(x))), before)
    # need_restore=False keeps the averages until restore()
    with tma.apply(need_restore=False):
        pass
    assert not np.allclose(_np(tl(tp.to_tensor(x))), before)
    tma.restore()
    np.testing.assert_array_equal(_np(tl(tp.to_tensor(x))), before)


@pytest.mark.parametrize("which", ["minimize_lbfgs", "minimize_bfgs"])
def test_functional_minimizers_match_jax(which):
    """The objective of tests/test_deep_namespaces.py::test_minimize_lbfgs
    and a coupled quadratic."""
    target = np.array([1.0, -2.0], np.float32)
    a = np.array([[3.0, 1.0], [1.0, 2.0]], np.float32)

    def objectives(pkg):
        t, m = pkg.to_tensor(target), pkg.to_tensor(a)
        return [lambda x: ((x - t) ** 2).sum(),
                lambda x: ((pkg.matmul(m, (x - t).unsqueeze(-1)) ** 2)
                           .sum())]
    jfn = getattr(jinc.optimizer.functional, which)
    tfn = getattr(tinc.optimizer.functional, which)
    for jobj, tobj in zip(objectives(jp), objectives(tp)):
        x0 = np.zeros(2, np.float32)
        jres = jfn(jobj, jp.to_tensor(x0))
        tres = tfn(tobj, tp.to_tensor(x0))
        np.testing.assert_allclose(_np(tres[2]), target, atol=1e-4)
        np.testing.assert_allclose(_np(tres[2]), _np(jres[2]), atol=1e-5)
        assert bool(_np(tres[0])) == bool(_np(jres[0])) is True
        np.testing.assert_allclose(float(tres[4]), float(jres[4]),
                                   atol=1e-6)
        np.testing.assert_array_equal(_np(tres[5]), _np(jres[5]))
        assert int(_np(tres[1])) >= 1
    assert tinc.optimizer.LBFGS is tp.optimizer.LBFGS


# -- asp --------------------------------------------------------------------

def test_asp_masks_match_jax():
    from paddle_tpu.incubate.asp import _mask_2to4 as jmask
    from paddle_tpu_torch.incubate.asp import _mask_2to4 as tmask
    w = arr(6, 10, seed=100)
    for n, m in ((2, 4), (1, 4), (2, 8)):
        np.testing.assert_array_equal(tmask(w, n, m), jmask(w, n, m))


def _asp_pair(seed):
    jp.seed(seed)
    jl, tl = jnn.Linear(6, 8), tnn.Linear(6, 8)
    tl.set_state_dict(layer_state_from_jax(jl))
    return jl, tl


def test_asp_prune_and_decorate_match_jax():
    jl, tl = _asp_pair(seed=5)
    jl2, tl2 = _asp_pair(seed=6)
    jmasks = jinc.asp.prune_model(jl)
    tmasks = tinc.asp.prune_model(tl)
    assert sorted(jmasks) == sorted(tmasks) == ["weight"]
    np.testing.assert_array_equal(tmasks["weight"], jmasks["weight"])
    np.testing.assert_array_equal(_np(tl.weight), _np(jl.weight))
    assert tinc.asp.calculate_density(tl.weight) == pytest.approx(0.5)
    tinc.asp.prune_model(tl2)
    jinc.asp.prune_model(jl2)
    jopt = jinc.asp.decorate(jp.optimizer.SGD(0.1,
                                              parameters=jl.parameters()))
    topt = tinc.asp.decorate(tp.optimizer.SGD(0.1,
                                              parameters=tl.parameters()))
    _steps(jp, jl, jopt, 2, x_shape=(4, 6))
    _steps(tp, tl, topt, 2, x_shape=(4, 6))
    np.testing.assert_allclose(_np(tl.weight), _np(jl.weight), **LTOL)
    assert tinc.asp.calculate_density(tl.weight) == pytest.approx(0.5)
    # another model's masks are not this optimizer's
    opt2 = tp.optimizer.SGD(0.1, parameters=tl2.parameters())
    _steps(tp, tl2, opt2, 1, x_shape=(4, 6))
    assert tinc.asp.calculate_density(tl2.weight) > 0.5
    # excluded and custom-mask layers
    tinc.asp.set_excluded_layers([tl2.weight.name])
    assert tinc.asp.prune_model(tl2) == {}
    tinc.asp.reset_excluded_layers()

    class Custom(tnn.Linear):
        pass
    tinc.asp.add_supported_layer(
        Custom, lambda w, n, m: np.ones_like(w))
    c = Custom(4, 4)
    assert tinc.asp.prune_model(c)["weight"].all()


# -- autograd, autotune, names ---------------------------------------------

def test_forward_grad_and_grad_match_jax():
    x = arr(3, seed=110, lo=0.5, hi=1.5)
    v = arr(3, seed=111)

    def f(pkg):
        return lambda t: pkg.exp(t) * t
    jt = jinc.autograd.forward_grad(f(jp), jp.to_tensor(x))
    tt = tinc.autograd.forward_grad(f(tp), tp.to_tensor(x))
    np.testing.assert_allclose(_np(tt), _np(jt), **TOL)
    jt = jinc.autograd.forward_grad(f(jp), jp.to_tensor(x), jp.to_tensor(v))
    tt = tinc.autograd.forward_grad(f(tp), tp.to_tensor(x), tp.to_tensor(v))
    np.testing.assert_allclose(_np(tt), _np(jt), **TOL)
    with pytest.raises(TypeError):
        tinc.autograd.forward_grad(tp.to_tensor(x), tp.to_tensor(x))
    jx = jp.to_tensor(x, stop_gradient=False)
    tx = tp.to_tensor(x, stop_gradient=False)
    (jg,) = jinc.autograd.grad((jx ** 3).sum(), jx)
    (tg,) = tinc.autograd.grad((tx ** 3).sum(), tx)
    np.testing.assert_allclose(_np(tg), _np(jg), **TOL)
    assert not tinc.autograd.prim_enabled()
    tinc.autograd.enable_prim()
    assert tinc.autograd.prim_enabled()
    tinc.autograd.disable_prim()
    assert not tinc.autograd.prim_enabled()
    for name in ("vjp", "jvp", "Jacobian", "Hessian"):
        assert hasattr(tinc.autograd, name)


def test_autotune_records_the_config(tmp_path):
    import json
    from paddle_tpu_torch.incubate import autotune
    saved = {k: dict(v) for k, v in autotune.get_config().items()}
    try:
        autotune.set_config({"kernel": {"enable": True, "tuning_range":
                                        [1, 3]}})
        assert autotune.get_config()["kernel"] == {"enable": True,
                                                   "tuning_range": [1, 3]}
        path = tmp_path / "tune.json"
        path.write_text(json.dumps({"layout": {"enable": True}}))
        autotune.set_config(str(path))
        assert autotune.get_config()["layout"]["enable"] is True
        with pytest.warns(UserWarning):
            autotune.set_config({"nope": {}})
        autotune.set_config()
        assert all(v["enable"] for v in autotune.get_config().values())
    finally:
        autotune._config = saved


@pytest.mark.parametrize("path", ["incubate", "incubate.nn",
                                  "incubate.nn.functional",
                                  "incubate.optimizer",
                                  "incubate.optimizer.functional",
                                  "incubate.asp", "incubate.autograd",
                                  "incubate.autotune"])
def test_incubate_names_match_jax(path):
    def get(mod):
        for part in path.split("."):
            mod = getattr(mod, part)
        return mod

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")} - {
            "annotations", "jax", "jnp", "np", "json", "warnings",
            "weakref", "torch", "math", "run_op"}
    missing = public(get(jp)) - public(get(tp))
    assert missing == set()


def test_incubate_reexports():
    x = arr(2, 3, 4, 4, seed=120)
    run_both(jinc.softmax_mask_fuse_upper_triangle,
             tinc.softmax_mask_fuse_upper_triangle, [x], tol=TOL)
    run_both(lambda a, m: jinc.softmax_mask_fuse(a, m),
             lambda a, m: tinc.softmax_mask_fuse(a, m),
             [x, np.zeros((2, 1, 4, 4), np.float32)], tol=TOL)
    run_both(jinc.identity_loss, tinc.identity_loss, [arr(3, seed=121)],
             tol=TOL)
    assert tinc.inference is tp.inference
    assert callable(tinc.inference.create_predictor)
