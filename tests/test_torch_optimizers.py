"""The port's optimizer layer held to the JAX package on the CPU, on the
same numpy inputs:

- every optimizer's rule: three (RAdam: eight) ``_update``s of one
  parameter, the parameter and every state slot against the JAX rule's;
- L-BFGS on a quadratic and on Rosenbrock, with and without the
  strong-Wolfe line search: the same losses and iterates;
- the eager ``step()`` with parameter groups, a parameter's
  ``optimize_attr`` rate, ``lr_ratio``, ``apply_decay_param_fun`` and
  ``multi_precision`` on bf16 parameters;
- ``state_dict`` in the JAX key format, and a JAX optimizer's state
  resuming in the port;
- ``GradScaler``: skip decisions, the scale trajectory and the
  parameters under an injected inf;
- the fused Adam route: decided by ``adam_update_route`` alone, every CPU
  parameter on "plain", the kernel's launch refusing a CPU tensor.

Tolerances: ``TOL`` (rtol 1e-5, atol 1e-6) for f32 tensors, as in
``test_torch_training.py`` (the frameworks round a few ops differently:
torch's CPU ``sqrt`` is not always correctly rounded, the Python-float
learning rate of the JAX eager step rounds ``1 - lr * coeff`` in double);
L-BFGS iterates rtol 1e-4 (a line search multiplies a last-bit difference
of a dot product); bf16 parameters within one bf16 step of each other;
scale trajectories and skip decisions exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.framework.param_attr import Parameter
from paddle_tpu.regularizer import L2Decay as JaxL2Decay
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import monitor
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.bridge import (optimizer_state_from_numpy,
                                     optimizer_state_to_numpy)
from paddle_tpu_torch.kernels import fused_adam
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

TOL = dict(rtol=1e-5, atol=1e-6)

# name -> (optimizer, constructor kwargs, updates)
RULES = {
    "sgd": ("SGD", {}, 3),
    "sgd_l2": ("SGD", dict(weight_decay=0.02), 3),
    "sgd_l2decay": ("SGD", dict(weight_decay="L2Decay(0.03)"), 3),
    "momentum": ("Momentum", dict(momentum=0.9), 3),
    "momentum_nesterov_l2": ("Momentum", dict(momentum=0.8,
                                              use_nesterov=True,
                                              weight_decay=0.02), 3),
    "adagrad": ("Adagrad", dict(initial_accumulator_value=0.1), 3),
    "adagrad_l2": ("Adagrad", dict(weight_decay=0.01, epsilon=1e-5), 3),
    "rmsprop": ("RMSProp", dict(rho=0.9), 3),
    "rmsprop_centered_momentum": ("RMSProp", dict(
        rho=0.9, centered=True, momentum=0.5, weight_decay=0.01), 3),
    "lamb": ("Lamb", dict(lamb_weight_decay=0.01), 3),
    "lamb_exclude_fn": ("Lamb", dict(
        lamb_weight_decay=0.05,
        exclude_from_weight_decay_fn=lambda name: True), 3),
    "lamb_nodecay": ("Lamb", dict(lamb_weight_decay=0.0), 3),
    "adamax": ("Adamax", {}, 3),
    "adamax_l2": ("Adamax", dict(weight_decay=0.02, beta2=0.99), 3),
    "adadelta": ("Adadelta", dict(rho=0.9), 3),
    "adadelta_l2": ("Adadelta", dict(weight_decay=0.02), 3),
    "nadam": ("NAdam", {}, 3),
    "nadam_l2": ("NAdam", dict(weight_decay=0.02, momentum_decay=0.01), 3),
    "radam": ("RAdam", dict(beta2=0.9), 8),
    "radam_l2": ("RAdam", dict(beta2=0.9, weight_decay=0.02), 8),
    "asgd": ("ASGD", dict(batch_num=2), 3),
    "asgd_l2": ("ASGD", dict(batch_num=4, weight_decay=0.01), 3),
    "rprop": ("Rprop", {}, 3),
    "rprop_l2": ("Rprop", dict(weight_decay=0.02, etas=(0.4, 1.3)), 3),
    "adam": ("Adam", {}, 3),
    "adam_l2_amsgrad": ("Adam", dict(weight_decay=0.02, amsgrad=True), 3),
    "adamw": ("AdamW", dict(weight_decay=0.05), 3),
    "adamw_nodecay": ("AdamW", dict(weight_decay=0.0), 3),
}


def _kw(kw, side):
    """Constructor kwargs for one side (a regularizer built by its own
    package)."""
    out = dict(kw)
    if isinstance(out.get("weight_decay"), str):
        coeff = float(out["weight_decay"][len("L2Decay("):-1])
        out["weight_decay"] = JaxL2Decay(coeff) if side == "jax" \
            else L2Decay(coeff)
    return out


@pytest.mark.parametrize("name", sorted(RULES))
def test_rule_matches_jax(name):
    """The parameter and every state slot after the updates equal the JAX
    rule's."""
    cls, kw, n = RULES[name]
    rng = np.random.default_rng(len(name))
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) * 0.1
             for _ in range(n)]
    grads[1][0, :2] = 0.0                    # Rprop's and Adam's zeros
    lr = 3e-3
    jopt = getattr(paddle.optimizer, cls)(
        lr, parameters=[paddle.to_tensor(p0)], **_kw(kw, "jax"))
    jp, jst = jnp.asarray(p0), jopt._init_state(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy())
    to = getattr(topt, cls)(lr, parameters=[tp], **_kw(kw, "port"))
    tst = to._init_state(tp)
    for g in grads:
        jp, jst = jopt._update(jp, jnp.asarray(g), jst, jnp.float32(lr))
        to._update(tp, torch.from_numpy(g), tst,
                   torch.tensor(lr, dtype=torch.float32))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    assert not np.array_equal(tp.numpy(), p0)
    assert sorted(tst) == sorted(jst)
    for slot, want in jst.items():
        got = tst[slot]
        assert tuple(got.shape) == tuple(want.shape), slot
        np.testing.assert_allclose(got.double().numpy(),
                                   np.asarray(want, np.float64),
                                   err_msg=slot, **TOL)


def test_regularizers_carry_their_coefficient():
    assert repr(L2Decay(0.5)) == "L2Decay(0.5)"
    assert repr(L1Decay(0.25)) == "L1Decay(0.25)"
    p = torch.zeros(2)
    for wd, want in ((None, 0.0), (0.1, 0.1), (L2Decay(0.3), 0.3),
                     (L1Decay(0.2), 0.2)):
        assert topt.Adam(0.1, parameters=[p], weight_decay=wd)._coeff(None) \
            == want


# -- L-BFGS ------------------------------------------------------------------

def _quadratic(rng):
    m = rng.standard_normal((5, 5)).astype(np.float32)
    a = (m @ m.T / 5 + np.eye(5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    x0 = rng.standard_normal(5).astype(np.float32)
    return a, b, x0


@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock"])
@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_jax(problem, line_search):
    """Three ``step(closure)`` calls of three iterations each: the
    returned losses and the iterate after each equal the JAX LBFGS's (rtol
    1e-4). The steps stop short of the optimum: there the curvature pairs
    are f32 noise and any two f32 runs part (measured 1.8e-4 relative
    after 18 iterations on the quadratic; 7.7e-8 with f64 iterates)."""
    rng = np.random.default_rng(11)
    a, b, x0 = _quadratic(rng)
    if problem == "rosenbrock":
        x0 = np.array([-1.2, 1.0], np.float32)
    kw = dict(learning_rate=1.0 if line_search else 0.5, max_iter=3,
              history_size=4, line_search_fn=line_search)

    def jax_loss(x):
        if problem == "quadratic":
            ax = paddle.matmul(paddle.to_tensor(a), x)
            return 0.5 * (x * ax).sum() - (paddle.to_tensor(b) * x).sum()
        return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2

    def port_loss(x):
        if problem == "quadratic":
            return 0.5 * (x * (torch.from_numpy(a) @ x)).sum() \
                - (torch.from_numpy(b) * x).sum()
        return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2

    jx = Parameter(x0.copy())
    jopt = paddle.optimizer.LBFGS(parameters=[jx], **kw)
    tx = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    to = topt.LBFGS(parameters=[tx], **kw)

    def jclosure():
        loss = jax_loss(jx)
        loss.backward()
        return loss

    def tclosure():
        loss = port_loss(tx)
        loss.backward()
        return loss

    for _ in range(3):
        jl = float(jopt.step(jclosure).numpy())
        tl = float(to.step(tclosure))
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tx.detach().numpy(), jx.numpy(),
                                   rtol=1e-4, atol=1e-6)
    assert tl < float(port_loss(torch.from_numpy(x0)))


def test_lbfgs_requires_a_closure_and_a_known_search():
    p = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="closure"):
        topt.LBFGS(parameters=[p]).step()
    with pytest.raises(ValueError, match="strong_wolfe"):
        topt.LBFGS(parameters=[p], line_search_fn="backtracking")


# -- the eager step: groups, rates, decay options, master weights -------------

def _jax_param(arr, name=None, lr=1.0, dtype=None):
    data = jnp.asarray(arr) if dtype is None else jnp.asarray(arr, dtype)
    p = Parameter(data, name=name, learning_rate=lr)
    return p


def _port_param(arr, lr=None, dtype=None):
    t = torch.from_numpy(arr.copy())
    p = torch.nn.Parameter(t if dtype is None else t.to(dtype))
    if lr is not None:
        p.optimize_attr = {"learning_rate": lr}
    return p


def _eager_steps(opt, params, grads_per_step, framework):
    for grads in grads_per_step:
        for p, g in zip(params, grads):
            if framework == "jax":
                p.grad = Tensor(jnp.asarray(g, p._data.dtype))
            else:
                p.grad = torch.from_numpy(g.copy()).to(p.dtype)
        opt.step()
        opt.clear_grad()


EAGER = {
    # two groups (an lr scale and a weight decay), one parameter with an
    # optimize_attr rate
    "groups_adamw": ("AdamW", dict(weight_decay=0.02), "groups"),
    "groups_momentum": ("Momentum", dict(momentum=0.9), "groups"),
    "groups_sgd_l2": ("SGD", dict(weight_decay=0.01), "groups"),
    "lr_ratio": ("AdamW", dict(lr_ratio=lambda p: 0.1), "flat"),
    "decay_fun": ("AdamW", dict(
        weight_decay=0.1,
        apply_decay_param_fun=lambda n: n is not None and "norm" not in n),
        "named"),
    "decay_fun_bf16_moments": ("AdamW", dict(
        weight_decay=0.1, moment_dtype="bfloat16",
        apply_decay_param_fun=lambda n: n is not None and "norm" not in n),
        "named"),
}


def _build_eager(kind, framework, values):
    """(parameters, the optimizer's ``parameters`` argument): the port
    names a parameter by a (name, tensor) pair, the JAX package by its
    ``name``."""
    mk = _jax_param if framework == "jax" else _port_param
    if kind == "named":
        if framework == "jax":
            params = [mk(values[0], name="w"), mk(values[1], name="norm.w"),
                      mk(values[2])]
            return params, params
        params = [mk(v) for v in values]
        return params, [("w", params[0]), ("norm.w", params[1]), params[2]]
    params = [mk(values[0]), mk(values[1]), mk(values[2], lr=0.5)]
    if kind == "groups":
        groups = [{"params": [params[0]], "learning_rate": 0.5,
                   "weight_decay": 0.1}, {"params": params[1:]}]
        return params, groups
    return params, params


@pytest.mark.parametrize("name", sorted(EAGER))
def test_eager_step_matches_jax(name):
    cls, kw, kind = EAGER[name]
    rng = np.random.default_rng(len(name) + 3)
    values = [rng.standard_normal(s).astype(np.float32)
              for s in ((4, 3), (5,), (2, 2, 2))]
    steps = [[rng.standard_normal(v.shape).astype(np.float32) * 0.1
              for v in values] for _ in range(3)]
    out = {}
    for fw, mod in (("jax", paddle.optimizer), ("port", topt)):
        params, arg = _build_eager(kind, fw, values)
        opt = getattr(mod, cls)(0.01, parameters=arg, **kw)
        _eager_steps(opt, params, steps, fw)
        out[fw] = ([np.asarray(p.numpy() if fw == "jax"
                               else p.detach().numpy()) for p in params],
                   opt._global_step)
    for got, want in zip(*[out[k][0] for k in ("port", "jax")]):
        np.testing.assert_allclose(got, want, **TOL)
    assert out["port"][1] == out["jax"][1] == 3
    moved = [not np.array_equal(v, p) for v, p in zip(values,
                                                      out["port"][0])]
    assert all(moved)


def test_groups_and_rates_scale_the_step():
    """SGD without momentum makes the scales visible: group 0 at half the
    lr, the optimize_attr parameter at half."""
    ps = [_port_param(np.ones(2, np.float32)),
          _port_param(np.ones(2, np.float32)),
          _port_param(np.ones(2, np.float32), lr=0.5)]
    opt = topt.SGD(0.1, parameters=[{"params": ps[:1],
                                     "learning_rate": 0.5},
                                    {"params": ps[1:]}])
    for p in ps:
        p.grad = torch.ones(2)
    opt.step()
    np.testing.assert_allclose([float(p[0]) for p in ps],
                               [0.95, 0.9, 0.95], rtol=1e-6)
    assert opt._param_groups[1]["learning_rate"] == 1.0


@pytest.mark.parametrize("cls", ["Adam", "AdamW"])
def test_multi_precision_bf16_matches_jax(cls):
    """bf16 parameters under ``multi_precision``: the f32 masters and
    moments equal the JAX ones (TOL), the bf16 parameters are the masters
    rounded (within one bf16 step of the JAX parameters)."""
    rng = np.random.default_rng(21)
    values = [rng.standard_normal(s).astype(np.float32)
              for s in ((4, 3), (7,))]
    steps = [[rng.standard_normal(v.shape).astype(np.float32) * 0.1
              for v in values] for _ in range(3)]
    res = {}
    for fw, mod in (("jax", paddle.optimizer), ("port", topt)):
        if fw == "jax":
            params = [_jax_param(v, dtype=jnp.bfloat16) for v in values]
        else:
            params = [_port_param(v, dtype=torch.bfloat16) for v in values]
        opt = getattr(mod, cls)(0.01, parameters=params,
                                multi_precision=True)
        _eager_steps(opt, params, steps, fw)
        res[fw] = (params, opt)
    (jps, jopt), (tps, topt_) = res["jax"], res["port"]
    for jp, tp in zip(jps, tps):
        assert tp.dtype == torch.bfloat16
        js, ts = jopt._accumulators[id(jp)], topt_._accumulators[id(tp)]
        assert sorted(js) == sorted(ts)
        assert ts["_master_weight"].dtype == torch.float32
        for slot in js:
            np.testing.assert_allclose(
                ts[slot].numpy(), np.asarray(js[slot], np.float32),
                err_msg=slot, **TOL)
        torch.testing.assert_close(
            tp.detach(), ts["_master_weight"].to(torch.bfloat16), rtol=0,
            atol=0)
        want = np.asarray(jp._data.astype(jnp.float32))
        got = tp.detach().float().numpy()
        assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7)


# -- state dicts --------------------------------------------------------------

def test_state_dict_keys_and_resume_from_jax():
    """The port's state_dict uses the JAX keys; the JAX optimizer's
    state_dict after two eager steps (and one scheduler step), loaded by
    the port's ``set_state_dict`` onto the same parameters, resumes to the
    JAX optimizer's third step."""
    rng = np.random.default_rng(31)
    values = [rng.standard_normal(s).astype(np.float32) for s in ((3, 2),
                                                                 (4,))]
    steps = [[rng.standard_normal(v.shape).astype(np.float32) * 0.1
              for v in values] for _ in range(3)]
    sched = dict(learning_rate=0.05, step_size=1, gamma=0.5)
    jps = [_jax_param(v) for v in values]
    jsch = paddle.optimizer.lr.StepDecay(**sched)
    jopt = paddle.optimizer.NAdam(jsch, parameters=jps)
    _eager_steps(jopt, jps, steps[:2], "jax")
    jsch.step()
    params2 = [np.asarray(p.numpy()) for p in jps]
    jsd = {k: (np.asarray(v.numpy()) if hasattr(v, "numpy") else v)
           for k, v in jopt.state_dict().items()}
    lr2 = jopt.get_lr()
    _eager_steps(jopt, jps, steps[2:], "jax")

    tps = [_port_param(v) for v in params2]
    to = topt.NAdam(topt.lr.StepDecay(**sched), parameters=tps)
    to.set_state_dict(jsd)
    assert to.get_lr() == lr2 == 0.025 and to._global_step == 2
    _eager_steps(to, tps, steps[2:], "port")
    for tp, jp in zip(tps, jps):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), **TOL)
    sd = to.state_dict()
    assert sorted(sd) == sorted(jopt.state_dict())
    assert sd["@global_step"] == 3 and "param_1.mu_product" in sd
    assert sd["@lr_state"] == jopt.state_dict()["@lr_state"]


# -- GradScaler ---------------------------------------------------------------

@pytest.mark.parametrize("cls", ["SGD", "AdamW"])
def test_grad_scaler_matches_jax(cls):
    """Eight scaled steps of a linear least-squares fit, an inf injected
    into one gradient at steps 3 and 4 (two in a row, so the second halves
    the scale again), growth every 2 good steps: the same skip decisions,
    scale after every update and parameters as the JAX GradScaler."""
    rng = np.random.default_rng(41)
    x = rng.standard_normal((8, 3)).astype(np.float32)
    y = rng.standard_normal((8, 2)).astype(np.float32)
    w0 = rng.standard_normal((3, 2)).astype(np.float32)
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    runs = {}
    for fw in ("jax", "port"):
        if fw == "jax":
            w = _jax_param(w0)
            opt = getattr(paddle.optimizer, cls)(0.05, parameters=[w])
            scaler = paddle.amp.GradScaler(**kw)
        else:
            w = _port_param(w0)
            opt = getattr(topt, cls)(0.05, parameters=[w])
            scaler = tamp.GradScaler(**kw)
        scales, skipped = [], []
        for i in range(8):
            if fw == "jax":
                r = paddle.matmul(paddle.to_tensor(x), w) \
                    - paddle.to_tensor(y)
                scaler.scale((r * r).mean()).backward()
                if i in (3, 4):
                    w.grad._data = w.grad._data.at[0, 1].set(jnp.inf)
            else:
                r = torch.from_numpy(x) @ w - torch.from_numpy(y)
                scaler.scale((r * r).mean()).backward()
                if i in (3, 4):
                    w.grad[0, 1] = float("inf")
            scaler.step(opt)
            skipped.append(scaler._found_inf)
            scaler.update()
            scales.append(scaler._scale)
            opt.clear_grad()
        runs[fw] = (scales, skipped, np.asarray(
            w.numpy() if fw == "jax" else w.detach().numpy()),
            scaler.state_dict())
    assert runs["port"][1] == runs["jax"][1] == \
        [False, False, False, True, True, False, False, False]
    assert runs["port"][0] == runs["jax"][0]
    np.testing.assert_allclose(runs["port"][2], runs["jax"][2], **TOL)
    assert runs["port"][3] == runs["jax"][3]
    fresh = tamp.GradScaler(**kw)
    fresh.load_state_dict(runs["port"][3])
    assert fresh._scale == runs["port"][0][-1]


def test_grad_scaler_disabled_and_helpers():
    w = _port_param(np.ones(2, np.float32))
    opt = topt.SGD(0.5, parameters=[w])
    off = tamp.GradScaler(enable=False)
    loss = (w * 2).sum()
    assert off.scale(loss) is loss
    off.minimize(opt, loss)
    np.testing.assert_allclose(w.detach().numpy(), [0.0, 0.0])
    assert off.state_dict() == {} and not off.is_enable()
    on = tamp.GradScaler(init_loss_scaling=8.0)
    assert on.get_init_loss_scaling() == 8.0 and on.get_incr_ratio() == 2.0
    assert on.get_decr_ratio() == 0.5 and on.is_use_dynamic_loss_scaling()
    assert float(on.scale(torch.tensor(1.5))) == 12.0
    assert tamp.is_bfloat16_supported() and tamp.is_float16_supported()
    assert tamp.AmpScaler is tamp.GradScaler


# -- the fused Adam route -----------------------------------------------------

ROUTES = [
    ("cpu", torch.float32, torch.float32, torch.float32, "plain"),
    ("cpu", torch.float32, torch.float32, torch.bfloat16, "plain"),
    ("cuda", torch.float32, torch.float32, torch.float32, "fused"),
    ("cuda", torch.float32, torch.float32, torch.bfloat16, "fused"),
    ("cuda", torch.float32, torch.float32, torch.float16, "plain"),
    ("cuda", torch.bfloat16, torch.float32, torch.float32, "plain"),
    ("cuda", torch.float16, torch.float16, torch.float16, "plain"),
    ("cuda", torch.float32, torch.bfloat16, torch.float32, "plain"),
    ("cuda:1", torch.float32, torch.float32, torch.bfloat16, "fused"),
]


@pytest.mark.parametrize("case", ROUTES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_adam_update_route_rule(case):
    dev, pdt, gdt, mdt, want = case
    assert fused_adam.adam_update_route(torch.device(dev), pdt, gdt,
                                        mdt) == want


def test_cpu_parameters_take_the_plain_route_and_count_it():
    monitor.reset()
    ps = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))]
    for p in ps:
        p.grad = torch.full_like(p, 0.5)
    topt.AdamW(0.1, parameters=ps).step()
    snap = monitor.snapshot()
    assert snap.get("kernels.optimizer.adam_plain") == 2
    assert not snap.get("kernels.optimizer.adam_fused")


def test_kernel_launch_refuses_cpu_tensors():
    p, g = torch.ones(4), torch.ones(4)
    st = topt.Adam(0.1, parameters=[p])._init_state(p)
    with pytest.raises(ValueError, match="adam_update_route"):
        fused_adam.fused_adam_launch([p], [g], [st], 0.1, 0.9, 0.999, 1e-8,
                                     amsgrad=False)
    with pytest.raises(ValueError, match="no parameters"):
        fused_adam.fused_adam_launch([], [], [], 0.1, 0.9, 0.999, 1e-8,
                                     amsgrad=False)


def test_chunk_table_covers_every_element_once():
    sizes = [1, 7, 8192, 8193, 20011]
    table = fused_adam.adam_chunks(sizes, "cpu")
    assert fused_adam.adam_chunks(sizes, "cpu") is table         # cached
    for i, n in enumerate(sizes):
        rows = table[table[:, 0] == i]
        assert int(rows[:, 2].sum()) == n
        assert bool((rows[:, 1] % fused_adam.ADAM_CHUNK == 0).all())
        assert bool((rows[:, 2] <= fused_adam.ADAM_CHUNK).all())
    assert table.shape[0] == 1 + 1 + 1 + 2 + 3


def test_optimizer_state_bridge_round_trips():
    st = {"llama.layers.0.self_attn.q_proj.weight": {
              "velocity": np.arange(6, dtype=np.float32).reshape(2, 3)},
          "llama.norm.weight": {"y": np.ones((2, 4), np.float32),
                                "step": np.int32(3)}}
    port = optimizer_state_from_numpy(st)
    assert port["llama.layers.0.self_attn.q_proj.weight"]["velocity"] \
        .shape == (3, 2)
    assert port["llama.norm.weight"]["step"].dtype == torch.int32
    back = optimizer_state_to_numpy(port)
    for n in st:
        for s, v in st[n].items():
            np.testing.assert_array_equal(back[n][s], v)


def test_minimize_and_scaler_minimize_over_groups():
    """``minimize`` runs backward and the step as the JAX one does;
    ``GradScaler.minimize`` unscales every group's gradients before it."""
    w, b = _port_param(np.ones(3, np.float32)), _port_param(
        np.zeros(1, np.float32))
    opt = topt.SGD(0.1, parameters=[{"params": [w]},
                                    {"params": [b], "learning_rate": 2.0}])
    _, pg = opt.minimize((w * 2).sum() + (b * 3).sum())
    assert [p is q for (p, _), q in zip(pg, (w, b))] == [True, True]
    np.testing.assert_allclose(w.detach().numpy(), [0.8] * 3, rtol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), [-0.6], rtol=1e-6)
    assert opt._global_step == 1
    opt.clear_grad()
    scaler = tamp.GradScaler(init_loss_scaling=4.0)
    scaler.minimize(opt, scaler.scale((w * 2).sum() + (b * 3).sum()))
    np.testing.assert_allclose(w.detach().numpy(), [0.6] * 3, rtol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), [-1.2], rtol=1e-6)
    assert not scaler._found_inf and scaler._good_steps == 1
