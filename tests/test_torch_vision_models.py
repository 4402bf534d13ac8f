"""``paddle_tpu_torch.vision.models`` against ``paddle_tpu.vision.models`` on
the CPU, JAX weights carried across with ``bridge.layer_state_from_jax``
(every key taken, none left over), within chip_smoke's f32 gate (atol
1e-4 x max(1, max |ref|)):

- forward parity, eval and train mode, for ``LeNet``, ``resnet18`` at
  4 x 64 x 64 (train mode normalizes over 16 values a channel at the
  last stage; at 2 x 32 x 32 only 2, and the rounding of the two packages
  then moves the output by 1e-2) and ``shufflenet_v2_x0_25`` at 64 x 64
  (the cheap JAX legs); the other families' parity is nightly, as
  ``test_vision_batch.py`` marks its compile-heavy legs;
- three ``paddle.Model.train_batch`` steps of ``resnet18`` at 4 x 64 x 64
  (PaddleClas's Momentum 0.9 with L2Decay, cross-entropy) against the JAX
  ``Model``: each step's gradients (the port's ``TrainStep.loss_and_grads``
  against ``jax.grad`` of the same loss, the batch statistics
  differentiated), each step's loss, and after each step every parameter
  and every BatchNorm ``_mean`` / ``_variance``. The learning rate is
  0.01: at PaddleClas's 0.1 a batch of 4 noise images drives the loss
  from 2.5 to 16 in three steps, and conv1's gradient then moves by 1e-2
  for a 5e-6 change in the weights (JAX's own gradient at the port's
  weights moves as much), so the comparison would read the chaos, not
  the port;
- the port alone: every factory that ``models`` exports builds and runs a
  forward at a small size, its ``state_dict`` names and shapes equal to
  the JAX model's where building that is cheap, and
  ``pretrained=True`` raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.jit.functional import functional_call, get_buffers, \
    get_params
from paddle_tpu_torch.bridge import layer_state_from_jax
from paddle_tpu_torch.vision import models as TM
from test_torch_parity_util import assert_f32_gate, cpu_place  # noqa: F401

JM = jp.vision.models


@pytest.fixture(autouse=True, scope="module")
def _cpu(cpu_place):  # noqa: F811
    yield


def _pair(factory, **kw):
    """(JAX model, port model with the JAX weights)."""
    jp.seed(0)
    jnet = getattr(JM, factory)(**kw)
    tnet = getattr(TM, factory)(**kw)
    missing, unexpected = tnet.set_state_dict(layer_state_from_jax(jnet))
    assert missing == [] and unexpected == [], (missing, unexpected)
    return jnet, tnet


def _image(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _forward_parity(factory, shape, train=False, **kw):
    jnet, tnet = _pair(factory, **kw)
    for net in (jnet, tnet):
        net.train() if train else net.eval()
    x = _image(shape)
    with torch.no_grad():
        got = tnet(tp.to_tensor(x))
    want = jnet(jp.to_tensor(x))
    dropout = any(isinstance(m, tp.nn.Dropout) for m in tnet.sublayers())
    if train and dropout:
        pass     # the two packages draw different dropout masks
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_f32_gate(g.numpy(), w.numpy(), factory)
    else:
        assert_f32_gate(got.numpy(), want.numpy(), factory)
    if train:      # the batch statistics written into the buffers
        jstate, tstate = jnet.state_dict(), tnet.state_dict()
        for k in tstate:
            if k.endswith(("_mean", "_variance")):
                assert_f32_gate(tstate[k].numpy(), jstate[k].numpy(), k)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("factory,shape,kw", [
    ("LeNet", (2, 1, 28, 28), {}),
    ("resnet18", (4, 3, 64, 64), dict(num_classes=10)),
    ("shufflenet_v2_x0_25", (2, 3, 64, 64), dict(num_classes=10)),
])
def test_forward_matches_jax(factory, shape, kw, train):
    _forward_parity(factory, shape, train, **kw)


_N = pytest.mark.nightly


@pytest.mark.parametrize("factory,size,train", [
    pytest.param("alexnet", 224, False, marks=_N),
    pytest.param("vgg11", 64, False, marks=_N),
    pytest.param("resnext50_32x4d", 64, False, marks=_N),
    pytest.param("wide_resnet50_2", 64, False, marks=_N),
    pytest.param("mobilenet_v1", 64, True, marks=_N),
    pytest.param("mobilenet_v2", 64, True, marks=_N),
    pytest.param("mobilenet_v3_small", 64, True, marks=_N),
    pytest.param("mobilenet_v3_large", 64, False, marks=_N),
    pytest.param("squeezenet1_1", 224, False, marks=_N),
    pytest.param("densenet121", 64, True, marks=_N),
    pytest.param("googlenet", 224, True, marks=_N),
    pytest.param("inception_v3", 299, False, marks=_N),
    pytest.param("shufflenet_v2_swish", 64, True, marks=_N),
])
def test_zoo_forward_matches_jax(factory, size, train):
    """Eval mode at batch 1; train mode at batch 4 (16 values a channel at
    the last stage), where a model with dropout is held by its running
    statistics only."""
    _forward_parity(factory, (4 if train else 1, 3, size, size), train,
                    num_classes=7)


# -- three training steps against the JAX Model -------------------------------

LR, MOMENTUM, DECAY = 0.01, 0.9, 1e-4


def _models(P, net):
    opt = P.optimizer.Momentum(learning_rate=LR, momentum=MOMENTUM,
                               parameters=net.parameters(),
                               weight_decay=P.regularizer.L2Decay(DECAY))
    model = P.Model(net)
    model.prepare(opt, P.nn.CrossEntropyLoss())
    return model


def _jax_grads(jnet, x, y):
    """jax.grad of the mean cross-entropy of the JAX network in training
    mode at its current weights and buffers (the loss its TrainStep
    differentiates), without touching its state."""
    params, buffers = get_params(jnet), get_buffers(jnet)

    def loss_of(p):
        out, _ = functional_call(jnet, p, buffers, (jnp.asarray(x),), {},
                                 training=True)
        logp = jax.nn.log_softmax(out, -1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             1))
    return jax.jit(jax.grad(loss_of))(params)


def test_resnet18_train_batch_matches_jax_model():
    jnet, tnet = _pair("resnet18", num_classes=10)
    jmodel, tmodel = _models(jp, jnet), _models(tp, tnet)
    assert tmodel._train_step is not None
    rng = np.random.default_rng(7)
    for step in range(3):
        x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
        y = rng.integers(0, 10, (4,)).astype(np.int64)
        # the step's gradients, the running stats restored after
        bufs = {k: b._data.clone() for k, b in tnet.named_buffers()}
        _, grads = tmodel._train_step.loss_and_grads(
            (torch.from_numpy(x),), torch.from_numpy(y))
        for k, b in tnet.named_buffers():
            b._data.copy_(bufs[k])
        want = _jax_grads(jnet, x, y)
        assert sorted(grads) == sorted(want)
        for k, g in grads.items():
            assert_f32_gate(g.numpy(), np.asarray(want[k]),
                            f"step {step} grad {k}")
        tl = tmodel.train_batch([tp.to_tensor(x)], tp.to_tensor(y))
        jl = jmodel.train_batch([jp.to_tensor(x)], jp.to_tensor(y))
        assert_f32_gate(tl, jl, f"step {step} loss")
        jstate, tstate = jnet.state_dict(), tnet.state_dict()
        assert sorted(jstate) == sorted(tstate)
        for k, v in tstate.items():
            assert_f32_gate(v.numpy(), jstate[k].numpy(),
                            f"step {step} {k}")
    moved = [k for k, v in tnet.state_dict().items()
             if k.endswith("_mean") and np.abs(v.numpy()).max() > 0]
    assert len(moved) == 20             # every BatchNorm's running mean


# -- the port alone -----------------------------------------------------------

def _factories():
    return sorted(n for n in dir(TM) if n[0].islower() and callable(
        getattr(TM, n)))


#: the input size a factory runs at here (the smallest its pooling takes)
_SIZE = {"alexnet": 224, "squeezenet1_0": 224, "squeezenet1_1": 224,
         "googlenet": 96, "inception_v3": 299}
#: the families whose JAX models are cheap to build next to each other
#: (one parameter shape set compiled, the rest reuse it)
_JAX_CHEAP = {"resnet18", "resnet34", "resnet50", "resnext50_32x4d",
              "resnext50_64x4d", "wide_resnet50_2", "vgg11", "vgg13"}


def test_factory_list_matches_jax():
    jnames = sorted(n for n in dir(JM) if n[0].islower() and callable(
        getattr(JM, n)))
    assert _factories() == jnames and len(jnames) == 38


@pytest.mark.parametrize("factory", _factories())
def test_every_factory_runs_alone(factory):
    net = getattr(TM, factory)(num_classes=5)
    net.eval()
    size = _SIZE.get(factory, 32)
    with torch.no_grad():
        out = net(tp.to_tensor(_image((1, 3, size, size))))
    assert out.shape == [1, 5] and np.isfinite(out.numpy()).all()
    if factory in _JAX_CHEAP:
        jnet = getattr(JM, factory)(num_classes=5)
        assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == \
            {k: tuple(v.shape) for k, v in jnet.state_dict().items()}
    with pytest.raises(ValueError, match="pretrained"):
        getattr(TM, factory)(pretrained=True)


def test_models_without_head_or_pool():
    net = TM.resnet18(num_classes=0, with_pool=False)
    net.eval()
    with torch.no_grad():
        out = net(tp.to_tensor(_image((1, 3, 64, 64))))
    assert out.shape == [1, 512, 2, 2]
    lenet = TM.LeNet(num_classes=0)
    with torch.no_grad():
        assert lenet(tp.to_tensor(_image((1, 1, 28, 28)))).shape == \
            [1, 16, 5, 5]


def test_googlenet_train_mode_returns_three_heads():
    net = TM.googlenet(num_classes=4)
    net.train()
    with torch.no_grad():
        out, a1, a2 = net(tp.to_tensor(_image((2, 3, 96, 96))))
    assert out.shape == a1.shape == a2.shape == [2, 4]
