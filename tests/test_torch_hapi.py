"""The port's ``paddle.Model`` (``paddle_tpu_torch.hapi``) against the JAX
package's on the CPU, same weights (``bridge.layer_state_from_jax``,
``bridge.llama_state_from_numpy``), same data from numpy seeds:

- ``fit`` of an MLP and of a small surface Transformer classifier with
  ``shuffle=False`` (and with a seeded ``RandomSampler``), Adam, f32:
  the per-step losses within rtol 1e-5 (the same f32 math in another
  summation order); under ``amp_configs`` O1 (a bf16 TrainStep in both)
  within rtol 2e-2, bf16's rounding;
- ``evaluate`` (loss and accuracy) and ``predict(stack_outputs=True)``
  within rtol 1e-5 / atol 1e-6;
- ``EarlyStopping``, ``ReduceLROnPlateau``, ``LRScheduler`` and
  ``ModelCheckpoint`` firing at JAX's epochs and steps;
- ``save`` / ``load``: the same ``.pdparams`` / ``.pdopt`` keys as the
  JAX Model writes, a fresh port Model and the JAX Model loading the
  port's files evaluate as the original;
- ``summary`` and ``flops`` equal to JAX's (totals and printed tables);
- a raw port model (a 2-layer LLaMA) through ``Model.train_batch``
  against the JAX ``Model`` on the bridged JAX LLaMA (rtol 1e-5);
- every network above got a ``TrainStep`` from ``prepare``.
"""
import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.bridge import layer_state_from_jax, \
    llama_state_from_numpy
from paddle_tpu_torch.core import place as place_mod
from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB, SEQ, N = 50, 12, 24


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.Tanh(),
                           P.nn.Linear(16, 4))


def _classifier(P, d=32, heads=4, ffn=64, layers=2):
    nn = P.nn

    class Classifier(nn.Layer):
        """Embedding -> TransformerEncoder -> Linear on the first token."""

        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(VOCAB, d)
            self.enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                d, heads, ffn, dropout=0.0, activation="gelu"), layers)
            self.head = nn.Linear(d, 2)

        def forward(self, ids):
            return self.head(self.enc(self.emb(ids))[:, 0])
    return Classifier()


def _data(kind, n=N, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "mlp":
        return (rng.standard_normal((n, 8)).astype(np.float32),
                rng.integers(0, 4, n).astype(np.int64))
    ids = rng.integers(0, VOCAB, (n, SEQ)).astype(np.int64)
    return ids, (ids[:, 0] % 2).astype(np.int64)


MAKE = {"mlp": _mlp, "transformer": _classifier}


def _pair(kind, seed=0):
    jp.seed(seed)
    jm = MAKE[kind](jp)
    tm = MAKE[kind](tp)
    tm.set_state_dict(layer_state_from_jax(jm))
    return jm, tm


def _ds(P, kind, **kw):
    x, y = _data(kind, **kw)
    return P.io.TensorDataset([P.to_tensor(x), P.to_tensor(y)])


class Recorder:
    """Collects each train step's loss, each epoch's logs and the lr."""

    def __init__(self, P):
        base = P.callbacks.Callback

        class _R(base):
            def __init__(self):
                super().__init__()
                self.losses, self.epochs, self.lrs = [], [], []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(logs["loss"])

            def on_epoch_end(self, epoch, logs=None):
                self.epochs.append(epoch)
                self.lrs.append(self.model._optimizer.get_lr())
        self.cb = _R()


def _model(P, net, lr=1e-3, amp=None, opt="Adam", **okw):
    m = P.Model(net)
    opt = getattr(P.optimizer, opt)(lr, parameters=net.parameters(), **okw)
    m.prepare(opt, P.nn.CrossEntropyLoss(), P.metric.Accuracy(topk=(1, 2)),
              amp_configs=amp)
    return m


def _fit_both(kind, epochs=2, amp=None, loader=None, callbacks=None,
              eval_data=False, **fit_kw):
    jm, tm = _pair(kind)
    out = []
    for P, net in ((jp, jm), (tp, tm)):
        m = _model(P, net, amp=amp)
        rec = Recorder(P).cb
        cbs = [rec] + ([c(P) for c in callbacks] if callbacks else [])
        data = loader(P) if loader else _ds(P, kind)
        m.fit(data, eval_data=_ds(P, kind, seed=1) if eval_data else None,
              batch_size=8, epochs=epochs, shuffle=False, verbose=0,
              callbacks=cbs, **fit_kw)
        out.append((m, rec))
    return out


@pytest.mark.parametrize("kind", ["mlp", "transformer"])
def test_fit_losses_match_jax(kind):
    (jm, jr), (tm, tr) = _fit_both(kind)
    assert tm._train_step is not None and jm._train_step is not None
    assert len(tr.losses) == 6
    np.testing.assert_allclose(tr.losses, jr.losses, **TOL)
    assert all(isinstance(v, float) for v in tr.losses)


@pytest.mark.parametrize("kind", ["mlp", "transformer"])
def test_evaluate_and_predict_match_jax(kind):
    (jm, _), (tm, _) = _fit_both(kind, epochs=1)
    ev = [m.evaluate(_ds(P, kind, seed=2), batch_size=5, verbose=0)
          for P, m in ((jp, jm), (tp, tm))]
    assert sorted(ev[0]) == sorted(ev[1]) == ["acc_top1", "acc_top2", "loss"]
    for k in ev[0]:
        np.testing.assert_allclose(ev[1][k], ev[0][k], **TOL)
    pr = [m.predict(_ds(P, kind, seed=2), batch_size=5, stack_outputs=True)
          for P, m in ((jp, jm), (tp, tm))]
    assert pr[1][0].shape == pr[0][0].shape == (N, 4 if kind == "mlp" else 2)
    np.testing.assert_allclose(pr[1][0], pr[0][0], **TOL)
    raw = tm.predict(_ds(tp, kind, seed=2), batch_size=5)
    assert len(raw) == 5 and isinstance(raw[0], tp.Tensor)


def test_seeded_random_sampler_fit_matches_jax():
    def loader(P):
        ds = _ds(P, "transformer")
        sampler = P.io.RandomSampler(ds, generator=torch.Generator()
                                     .manual_seed(9))
        return P.io.DataLoader(ds, batch_sampler=P.io.BatchSampler(
            sampler=sampler, batch_size=8))
    (_, jr), (_, tr) = _fit_both("transformer", loader=loader)
    np.testing.assert_allclose(tr.losses, jr.losses, **TOL)


def test_o1_fit_matches_jax_within_bf16():
    (jm, jr), (tm, tr) = _fit_both("transformer", amp={"level": "O1"})
    assert tm._train_step is not None
    assert tm._train_step._amp_dtype == torch.bfloat16
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=2e-2)
    # the masters stay f32
    assert all(p.dtype.name == "float32" for p in tm.network.parameters())


def test_workers_give_the_main_process_losses():
    got = []
    for workers in (0, 2):
        _, tm = _pair("mlp")
        m = _model(tp, tm)
        rec = Recorder(tp).cb
        m.fit(tp.io.DataLoader(_ds(tp, "mlp"), batch_size=8,
                               num_workers=workers),
              epochs=2, verbose=0, callbacks=[rec])
        got.append(rec.losses)
    assert got[0] == got[1]


def _lr_sched(P):
    return P.optimizer.lr.StepDecay(0.05, step_size=2, gamma=0.5)


def test_callbacks_fire_at_jax_epochs(tmp_path):
    def early(P):
        return P.callbacks.EarlyStopping(monitor="loss", patience=1,
                                         min_delta=10.0, verbose=0)

    def plateau(P):
        return P.callbacks.ReduceLROnPlateau(monitor="loss", factor=0.5,
                                             patience=1, min_delta=10.0,
                                             cooldown=1, verbose=0)

    (jm, jr), (tm, tr) = _fit_both("mlp", epochs=5, callbacks=[plateau],
                                   eval_data=True)
    assert tr.epochs == jr.epochs == list(range(5))
    assert tr.lrs == jr.lrs and len(set(tr.lrs)) > 1
    (jm, jr), (tm, tr) = _fit_both("mlp", epochs=5, callbacks=[early],
                                   eval_data=True)
    assert tr.epochs == jr.epochs == [0, 1]
    assert tm.stop_training and jm.stop_training
    # ModelCheckpoint writes the JAX Model's files at the same epochs
    for P, d in ((jp, tmp_path / "jax"), (tp, tmp_path / "port")):
        _, net = _pair("mlp")
        net = _mlp(P) if P is jp else net
        m = _model(P, net)
        m.fit(_ds(P, "mlp"), batch_size=8, epochs=3, verbose=0,
              callbacks=[P.callbacks.ModelCheckpoint(save_freq=2,
                                                     save_dir=str(d))])
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "port")) == ["1.pdopt", "1.pdparams"]


def test_lr_scheduler_callback_steps_as_jax():
    lrs = []
    for P in (jp, tp):
        jp.seed(0)
        net = _mlp(P)
        m = P.Model(net)
        sched = _lr_sched(P)
        m.prepare(P.optimizer.SGD(sched, parameters=net.parameters()),
                  P.nn.CrossEntropyLoss())
        seen = []

        class Watch(P.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                seen.append(m._optimizer.get_lr())
        m.fit(_ds(P, "mlp"), batch_size=8, epochs=2, verbose=0,
              callbacks=[P.callbacks.LRScheduler(by_step=True), Watch()])
        lrs.append(seen)
    assert lrs[0] == lrs[1] and len(set(lrs[1])) > 1


def test_save_load_round_trip_and_cross_load(tmp_path):
    (jm, _), (tm, _) = _fit_both("transformer", epochs=1)
    for P, m, d in ((jp, jm, "jax"), (tp, tm, "port")):
        m.save(str(tmp_path / d / "ckpt"))
    # a key bias's gradient is 0 up to rounding (the softmax does not see
    # it), so Adam moves it by each package's rounding noise: its value
    # and moments are held by shape only
    names = [n for n, _ in tm.network.named_parameters()]
    noise = {n for n in names if "k_proj.bias" in n} | {
        f"param_{i}.{slot}" for i, n in enumerate(names)
        if "k_proj.bias" in n for slot in ("moment1", "moment2")}
    for ext in (".pdparams", ".pdopt"):
        a = jp.load(str(tmp_path / "jax" / ("ckpt" + ext)))
        b = tp.load(str(tmp_path / "port" / ("ckpt" + ext)))
        assert sorted(a) == sorted(b)
        for k in a:
            if not hasattr(a[k], "numpy"):
                continue
            assert b[k].shape == a[k].shape
            if k not in noise:
                np.testing.assert_allclose(b[k].numpy(), a[k].numpy(),
                                           rtol=1e-4, atol=1e-6, err_msg=k)
    want = tm.evaluate(_ds(tp, "transformer", seed=3), batch_size=6,
                       verbose=0)
    fresh = _model(tp, _classifier(tp))
    fresh.load(str(tmp_path / "port" / "ckpt"))
    got = fresh.evaluate(_ds(tp, "transformer", seed=3), batch_size=6,
                         verbose=0)
    assert got == want
    # the loaded Adam state is the train step's from here on
    st = fresh._train_step.opt_state
    assert any(float(s["moment1"].abs().sum()) > 0 for s in st.values())
    # the JAX Model reads the port's files
    jfresh = _model(jp, _classifier(jp))
    jfresh.load(str(tmp_path / "port" / "ckpt"))
    jgot = jfresh.evaluate(_ds(jp, "transformer", seed=3), batch_size=6,
                           verbose=0)
    for k in want:
        np.testing.assert_allclose(jgot[k], want[k], **TOL)


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn()
    return res, buf.getvalue()


@pytest.mark.parametrize("kind,size", [("mlp", (3, 8)),
                                       ("transformer", None)])
def test_summary_matches_jax(kind, size):
    jm, tm = _pair(kind)
    a = _printed(lambda: jp.summary(jm, size))
    b = _printed(lambda: tp.summary(tm, size))
    assert a == b
    if kind == "mlp":
        assert "[3, 16]" in b[1]
        assert b[0] == {"total_params": 212, "trainable_params": 212}


def test_summary_of_a_two_head_net_and_model_summary():
    def two_head(P):
        class TwoHead(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.backbone = P.nn.Linear(8, 16)
                self.head_a = P.nn.Linear(16, 4)
                self.head_b = P.nn.Linear(16, 2)

            def forward(self, x):
                h = self.backbone(x)
                return self.head_a(h), self.head_b(h)
        return TwoHead()
    outs = [_printed(lambda: P.summary(two_head(P), (3, 8)))
            for P in (jp, tp)]
    assert outs[0] == outs[1] and "[3, 4], [3, 2]" in outs[1][1]
    _, tm = _pair("mlp")
    assert _printed(lambda: tp.Model(tm).summary((2, 8)))[0][
        "total_params"] == 212


@pytest.mark.parametrize("detail", [False, True])
def test_flops_match_jax(detail):
    def conv_net(P):
        nn = P.nn
        return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4),
                             nn.ReLU(), nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                             nn.Linear(4, 10))
    for make, size in ((_mlp, [2, 8]), (conv_net, [2, 3, 8, 8])):
        a = _printed(lambda: jp.flops(make(jp), size, print_detail=detail))
        b = _printed(lambda: tp.flops(make(tp), size, print_detail=detail))
        assert a == b and b[0] > 0


def _llama_pair(seed=0):
    jp.seed(seed)
    jc = JaxLlamaConfig.tiny(vocab=64, hidden=64, layers=2, heads=4)
    jnet = JaxLlama(jc)
    params = {k: np.asarray(v, np.float32)
              for k, v in get_params(jnet).items()}
    tnet = LlamaForCausalLM(LlamaConfig(**dataclasses.asdict(jc)),
                            device="cpu")
    tnet.load_state_dict(llama_state_from_numpy(params))
    return jnet, tnet


def test_raw_llama_train_batch_matches_jax():
    jnet, tnet = _llama_pair()
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 64, (2, 10)).astype(np.int64)
    labels = rng.integers(0, 64, (2, 10)).astype(np.int64)
    losses = []
    for P, net in ((jp, jnet), (tp, tnet)):
        m = P.Model(net)
        params = net.parameters()
        m.prepare(P.optimizer.AdamW(1e-3, parameters=params),
                  P.nn.CrossEntropyLoss())
        assert m._train_step is not None
        losses.append([m.train_batch([P.to_tensor(ids)],
                                     P.to_tensor(labels))[0]
                       for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], **TOL)
    assert all(isinstance(v, float) for v in losses[1])
    # evaluate / predict on the raw module: torch tensors in and out
    m = tp.Model(tnet)
    out = m.predict(tp.io.TensorDataset([tp.to_tensor(ids),
                                         tp.to_tensor(labels)]),
                    batch_size=2, stack_outputs=True)
    assert out[0].shape == (2, 10, 64)


def test_multi_output_metrics_and_prepare_checks():
    class Counting(tp.metric.Metric):
        def __init__(self):
            self.seen, self.n = [], 0

        def name(self):
            return "counting"

        def reset(self):
            self.n = 0

        def compute(self, out_a, out_b, label):
            self.seen.append((tuple(out_a.shape), tuple(out_b.shape),
                              tuple(label.shape)))
            return 1.0

        def update(self, c):
            self.n += 1

        def accumulate(self):
            return float(self.n)

    class TwoHead(tp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tp.nn.Linear(4, 4)
            self.aux = tp.nn.Linear(4, 2)

        def forward(self, x):
            h = self.fc(x)
            return h, self.aux(h)

    m, metric = tp.Model(TwoHead()), Counting()
    m.prepare(tp.optimizer.SGD(0.1, parameters=m.parameters()),
              lambda outs, y: ((outs[0].mean() - y.mean()) ** 2), metric)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    y = rng.standard_normal((6, 1)).astype(np.float32)
    m.eval_batch([tp.to_tensor(x)], tp.to_tensor(y))
    assert metric.n == 1 and metric.seen[0] == ((6, 4), (6, 2), (6, 1))
    logs = m.evaluate([(x, y)], batch_size=6, verbose=0)
    assert logs["counting"] >= 1.0
    with pytest.raises(TypeError, match="Metric"):
        m.prepare(metrics="accuracy")
    with pytest.raises(NotImplementedError, match="analysis"):
        m.inspect()
    for name in ("VisualDL", "WandbCallback"):
        with pytest.raises(ImportError):
            getattr(tp.callbacks, name)()


def test_eager_fallback_when_the_train_step_cannot_be_built():
    """prepare keeps the reference's eager fallback: an optimizer without
    the whole-step update leaves ``_train_step`` None and train_batch runs
    the eager step."""
    _, tm = _pair("mlp")

    class EagerOnly(tp.optimizer.SGD):
        def init_state_pytree(self, params):
            raise NotImplementedError
    m = tp.Model(tm)
    m.prepare(EagerOnly(0.1, parameters=tm.parameters()),
              tp.nn.CrossEntropyLoss())
    assert m._train_step is None
    x, y = _data("mlp")
    before = tm[0].weight.numpy().copy()
    loss = m.train_batch([tp.to_tensor(x)], tp.to_tensor(y))
    assert isinstance(loss[0], float)
    assert not np.array_equal(before, tm[0].weight.numpy())
