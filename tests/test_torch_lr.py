"""The port's learning-rate schedulers held to the JAX package's
(``paddle_tpu/optimizer/lr.py``): every schedule gives the same lr
sequence over 48 steps, a ``state_dict`` taken mid-run resumes a fresh
scheduler to the same sequence, and an optimizer under a scheduler reads
it through ``get_lr`` and refuses ``set_lr``.

Tolerance: exact. Both modules are the same plain Python over floats, so
every value must be equal, not close.
"""
import math

import pytest
import torch

import paddle_tpu.optimizer.lr as jlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 48

# name -> (class name, constructor kwargs) over both modules
CASES = {
    "noam": ("NoamDecay", dict(d_model=64, warmup_steps=8,
                               learning_rate=0.5)),
    "piecewise": ("PiecewiseDecay", dict(boundaries=[5, 17, 30],
                                         values=[0.1, 0.05, 0.01, 0.002])),
    "natural_exp": ("NaturalExpDecay", dict(learning_rate=0.3, gamma=0.07)),
    "inverse_time": ("InverseTimeDecay", dict(learning_rate=0.3,
                                              gamma=0.2)),
    "polynomial": ("PolynomialDecay", dict(learning_rate=0.2,
                                           decay_steps=30, end_lr=1e-3,
                                           power=2.0)),
    "polynomial_cycle": ("PolynomialDecay", dict(
        learning_rate=0.2, decay_steps=12, end_lr=1e-3, cycle=True)),
    "warmup_float": ("LinearWarmup", dict(learning_rate=0.1,
                                          warmup_steps=10, start_lr=0.0,
                                          end_lr=0.1)),
    "exponential": ("ExponentialDecay", dict(learning_rate=0.4, gamma=0.93)),
    "multistep": ("MultiStepDecay", dict(learning_rate=0.4,
                                         milestones=[6, 19, 33],
                                         gamma=0.3)),
    "step": ("StepDecay", dict(learning_rate=0.4, step_size=7, gamma=0.5)),
    "lambda": ("LambdaDecay", dict(learning_rate=0.4,
                                   lr_lambda=lambda e: 0.95 ** e)),
    "multiplicative": ("MultiplicativeDecay", dict(
        learning_rate=0.4, lr_lambda=lambda e: 0.97 if e % 3 else 0.9)),
    "cosine": ("CosineAnnealingDecay", dict(learning_rate=3e-4, T_max=40,
                                            eta_min=1e-5)),
    "warm_restarts": ("CosineAnnealingWarmRestarts", dict(
        learning_rate=0.1, T_0=5, T_mult=2, eta_min=1e-3)),
    "one_cycle_cos": ("OneCycleLR", dict(max_learning_rate=0.05,
                                         total_steps=40)),
    "one_cycle_linear": ("OneCycleLR", dict(
        max_learning_rate=0.05, total_steps=40, anneal_strategy="linear",
        phase_pct=0.25)),
    "cyclic": ("CyclicLR", dict(base_learning_rate=0.01,
                                max_learning_rate=0.1, step_size_up=6,
                                step_size_down=4)),
    "cyclic_tri2": ("CyclicLR", dict(base_learning_rate=0.01,
                                     max_learning_rate=0.1, step_size_up=5,
                                     mode="triangular2")),
    "cyclic_exp": ("CyclicLR", dict(base_learning_rate=0.01,
                                    max_learning_rate=0.1, step_size_up=5,
                                    mode="exp_range", exp_gamma=0.97)),
    "linear_lr": ("LinearLR", dict(learning_rate=0.3, total_steps=25,
                                   start_factor=0.2, end_factor=1.1)),
}


def _make(module, cls, kw):
    return getattr(module, cls)(**kw)


def _sequence(sched, steps=STEPS):
    out = []
    for _ in range(steps):
        out.append(sched())
        sched.step()
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_jax(name):
    cls, kw = CASES[name]
    want = _sequence(_make(jlr, cls, kw))
    got = _sequence(_make(tlr, cls, kw))
    assert got == want
    assert len(set(want)) > 1                     # the schedule moves


def test_warmup_around_cosine_matches_jax():
    """The LLaMA pretraining recipe: LinearWarmup to 3e-4 over 8 steps,
    then cosine decay over 40."""
    def make(m):
        return m.LinearWarmup(m.CosineAnnealingDecay(3e-4, T_max=40),
                              warmup_steps=8, start_lr=0.0, end_lr=3e-4)
    want, got = _sequence(make(jlr)), _sequence(make(tlr))
    assert got == want
    assert want[0] == 0.0 and want[8] == 3e-4 and want[-1] < want[8]


def test_warm_restarts_cross_restarts():
    """T_0 5, T_mult 2: restarts at steps 5, 15 and 35 go back to the
    base lr, as in the JAX schedule."""
    kw = CASES["warm_restarts"][1]
    got = _sequence(_make(tlr, "CosineAnnealingWarmRestarts", kw))
    assert got == _sequence(_make(jlr, "CosineAnnealingWarmRestarts", kw))
    assert [i for i, v in enumerate(got) if v == kw["learning_rate"]] == \
        [0, 5, 15, 35]


@pytest.mark.parametrize("metric_kind", ["float", "tensor"])
def test_reduce_on_plateau_matches_jax(metric_kind):
    """Fed a metric that improves, stalls and recovers (and, in one case,
    as a torch tensor on the port's side): the same lr after every step."""
    metrics = [1.0, 0.9, 0.85, 0.86, 0.86, 0.87, 0.85, 0.84, 0.9, 0.9,
               0.91, 0.9, 0.92, 0.6, 0.61, 0.62, 0.63, 0.64, 0.65, 0.66,
               0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
               0.49, 0.48, 0.48, 0.48, 0.48, 0.48, 0.48, 0.48, 0.48, 0.48]
    kw = dict(learning_rate=0.1, factor=0.5, patience=2, cooldown=1,
              min_lr=1e-3)
    js, ts = jlr.ReduceOnPlateau(**kw), tlr.ReduceOnPlateau(**kw)
    want, got = [], []
    for m in metrics:
        js.step(m)
        ts.step(torch.tensor(m) if metric_kind == "tensor" else m)
        want.append(js())
        got.append(ts())
    assert got == want
    assert min(got) < 0.1 / 4                      # it did reduce
    ts.step(None)                                  # no metric: no change
    assert ts() == got[-1]


@pytest.mark.parametrize("name", ["cosine", "multiplicative",
                                  "warm_restarts", "one_cycle_cos",
                                  "polynomial_cycle"])
def test_state_dict_round_trip_mid_run(name):
    """A scheduler's state taken after 17 steps, loaded into a fresh one,
    continues the uninterrupted sequence."""
    cls, kw = CASES[name]
    ref = _sequence(_make(tlr, cls, kw))
    first = _make(tlr, cls, kw)
    head = _sequence(first, 17)
    sd = first.state_dict()
    assert sd == _make(jlr, cls, kw).__class__.state_dict(
        _jax_at(cls, kw, 17))
    resumed = _make(tlr, cls, kw)
    resumed.set_state_dict(sd)
    assert head + _sequence(resumed, STEPS - 17) == ref


def _jax_at(cls, kw, steps):
    s = _make(jlr, cls, kw)
    _sequence(s, steps)
    return s


def test_optimizer_reads_scheduler_and_saves_it():
    """An optimizer built on a scheduler: ``get_lr`` follows
    ``scheduler.step()``, ``set_lr`` raises, and ``state_dict`` carries the
    scheduler under ``@lr_state`` as the JAX optimizer does."""
    p = torch.nn.Parameter(torch.ones(3))
    sched = tlr.StepDecay(0.4, step_size=2, gamma=0.5)
    opt = topt.SGD(sched, parameters=[p])
    seen = []
    for _ in range(5):
        seen.append(opt.get_lr())
        sched.step()
    assert seen == [0.4, 0.4, 0.2, 0.2, 0.1]
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    sd = opt.state_dict()
    assert sd["@lr_state"]["last_epoch"] == 5 and sd["@global_step"] == 0
    opt2 = topt.SGD(tlr.StepDecay(0.4, step_size=2, gamma=0.5),
                    parameters=[p])
    opt2.set_state_dict(sd)
    assert opt2.get_lr() == opt.get_lr() == 0.1
    plain = topt.SGD(0.25, parameters=[p])
    plain.set_lr_scheduler(tlr.ExponentialDecay(0.5, gamma=0.5))
    assert plain.get_lr() == 0.5
    assert not math.isnan(plain.get_lr())
