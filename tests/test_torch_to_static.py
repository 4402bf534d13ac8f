"""``paddle.jit.to_static`` of the port (``paddle_tpu_torch.jit``) against
the JAX package's, on the CPU: the same functions and layers (weights
across with ``bridge.layer_state_from_jax``), the same numpy inputs.

Each case of ``tests/test_jit_hapi_io.py`` runs through both packages:
a function's gradient and its per-signature cache, a layer, the
graph-break fallback and its warning, partial capture (the sublayers of
a graph-broken layer compiled on their own), the eager pin's retries,
``static.nn.cond`` / ``while_loop`` kept compiled, and a frozen model's
input gradients through the fallback. A counting Dynamo backend
(``aot_eager`` that keeps every graph) shows a graph was made wherever
the JAX package compiles, so no case passes by running eagerly.

Beyond the JAX cases: the compiled forward and backward graphs of a
surface ``TransformerEncoderLayer`` under a key mask hold the flash
custom ops (``flash_fwd_lse`` / ``flash_bwd``); a fresh process whose
first surface op runs under ``to_static`` compiles without a break; the
counts of an eager training step are eager dispatch's own; keyword
tensors, buffers written back, a port ``BertModel`` against JAX's
``to_static(BertModel)``, and one small case on Inductor.
"""
import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from functorch.compile import make_boxed_func
from torch._dynamo.backends.common import aot_autograd

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models import BertConfig as JaxBertConfig
from paddle_tpu.text.models import BertModel as JaxBertModel
from paddle_tpu_torch import monitor
from paddle_tpu_torch.bridge import bert_state_from_numpy, \
    layer_state_from_jax
from paddle_tpu_torch.core import dispatch
from paddle_tpu_torch.text.models import BertConfig, BertModel
from test_torch_parity_util import cpu_place  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-6)
FLASH_FWD = "paddle_tpu_torch.flash_fwd_lse.default"
FLASH_BWD = "paddle_tpu_torch.flash_bwd.default"


@pytest.fixture(autouse=True)
def _port_on_cpu(cpu_place):  # noqa: F811
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


class Graphs:
    """A Dynamo backend: ``aot_eager`` that keeps every Dynamo graph and
    every AOTAutograd forward and backward graph it compiles."""

    def __init__(self):
        self.dynamo, self.fw, self.bw = [], [], []
        self._aot = aot_autograd(fw_compiler=self._keep(self.fw),
                                 bw_compiler=self._keep(self.bw))

    @staticmethod
    def _keep(into):
        def compiler(gm, example_inputs):
            into.append(gm)
            return make_boxed_func(gm.forward)
        return compiler

    def __call__(self, gm, example_inputs):
        self.dynamo.append(gm)
        return self._aot(gm, example_inputs)

    @staticmethod
    def targets(graphs):
        return {str(n.target) for g in graphs for n in g.graph.nodes
                if n.op == "call_function"}


def a(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return np.asarray(t.numpy())


def _same_weights(jnet, tnet):
    missing, unexpected = tnet.set_state_dict(layer_state_from_jax(jnet))
    assert not missing and not unexpected
    return tnet


def _mlp(P, seed=0):
    P.seed(seed)
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.Tanh(),
                           P.nn.Linear(16, 4))


def _mlps(seed=0):
    jnet = _mlp(jp, seed)
    return jnet, _same_weights(jnet, _mlp(tp, seed))


# -- the cases of tests/test_jit_hapi_io.py, both packages -------------------

def test_function_grad_and_cache():
    def make(P):
        def f(x, y):
            return P.tanh(P.matmul(x, y)).sum()
        return f
    g = Graphs()
    fj = jp.jit.to_static(make(jp))
    ft = tp.jit.to_static(make(tp), backend=g)
    outs = []
    for P, f in ((jp, fj), (tp, ft)):
        x = P.to_tensor(a(3, 4), stop_gradient=False)
        y = P.to_tensor(a(4, 5, seed=1))
        out = f(x, y)
        out.backward()
        outs.append((float(out), _np(x.grad)))
        assert len(f._cache) == 1
        f(P.to_tensor(a(3, 4, seed=9)), y)       # same signature: cached
        assert len(f._cache) == 1
        f(P.to_tensor(a(2, 4)), y)               # a new shape: a new entry
        assert len(f._cache) == 2
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5)
    np.testing.assert_allclose(outs[1][1], outs[0][1], **TOL)
    # no eager call: three graphs, the first signature's twice (Dynamo
    # guards on requires_grad: x took a gradient, then did not)
    assert len(g.dynamo) == 3 and not ft._eager_sigs


def test_layer_matches_and_trains():
    jnet, tnet = _mlps(1)
    g = Graphs()
    snet = tp.jit.to_static(tnet, backend=g)
    x = a(4, 8)
    out = snet(tp.to_tensor(x))
    np.testing.assert_allclose(_np(out), _np(jp.jit.to_static(jnet)(
        jp.to_tensor(x))), **TOL)
    assert len(g.dynamo) == 1 and snet.layer is tnet
    # the compiled forward is differentiable through the parameters: the
    # same gradients as the eager layer's
    out.sum().backward()
    got = {n: _np(p.grad) for n, p in tnet.named_parameters()}
    tnet.clear_gradients()
    tnet(tp.to_tensor(x)).sum().backward()
    for n, p in tnet.named_parameters():
        np.testing.assert_allclose(got[n], _np(p.grad), **TOL, err_msg=n)
    assert len(g.dynamo) == 1


def _branchy_fn(P):
    def f(x):
        if float(x.sum().numpy()) > 0:          # value-dependent Python
            return x * 2
        return x - 1
    return f


def test_graph_break_fallback():
    for P in (jp, tp):
        f = P.jit.to_static(_branchy_fn(P))
        xp = P.to_tensor(np.ones((2, 2), np.float32))
        xn = P.to_tensor(-np.ones((2, 2), np.float32))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            outp, outn = f(xp), f(xn)
        msgs = [str(m.message) for m in w if "to_static" in str(m.message)]
        assert len(msgs) == 1 and "falling back to eager" in msgs[0], msgs
        np.testing.assert_allclose(_np(outp), 2.0)
        np.testing.assert_allclose(_np(outn), -2.0)
        assert len(f._eager_sigs) == 1


def _branchy_layer(P):
    class Branchy(P.nn.Layer):
        def __init__(self):
            super().__init__()
            P.seed(0)
            self.blocks = P.nn.LayerList(
                [P.nn.Linear(8, 8) for _ in range(10)])

        def forward(self, x):
            for blk in self.blocks:
                x = blk(x)
            if float(x.sum().numpy()) > 1e9:   # value-dependent Python
                x = x * 2
            return x
    net = Branchy()
    net.eval()
    for p in net.parameters():
        p.stop_gradient = True
    return net


def test_partial_graph_capture():
    jnet = _branchy_layer(jp)
    tnet = _same_weights(jnet, _branchy_layer(tp))
    g = Graphs()
    outs = []
    for P, net, kw in ((jp, jnet, {}), (tp, tnet, dict(backend=g))):
        snet = P.jit.to_static(net, **kw)
        x = P.to_tensor(a(4, 8))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = snet(x)
        assert any("sublayer" in str(m.message) for m in w)
        np.testing.assert_allclose(_np(out), _np(net(x)), rtol=1e-5)
        outs.append(_np(out))
        compiled = sum(1 for sf in snet._child_sf.values() if sf._cache)
        assert compiled >= 9
        before = len(snet._eager_sigs)
        snet(x)
        assert len(snet._eager_sigs) == before
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    # each Linear compiled into a graph of its own (none fell to eager)
    assert len(g.dynamo) == 10


def test_eager_pin_retries():
    """A signature that broke the graph once (before a warm-up flag
    flipped) is traced again after ``_RETRY_AFTER`` eager calls. The flag
    lives outside the function: the port's trace would also guard on a
    counter the function bumps itself, and compile at every call."""
    for P in (jp, tp):
        warm = {"up": False}

        def f(x):
            if not warm["up"] and float(x.sum().numpy()) > -1e30:
                x = x + 0                  # value-dependent: breaks
            return x * 2
        sf = P.jit.to_static(f)
        x = P.to_tensor(a(2, 2))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sf(x)
        assert len(sf._eager_sigs) == 1
        warm["up"] = True
        for _ in range(sf._RETRY_AFTER - 1):
            sf(x)
        assert len(sf._eager_sigs) == 1    # still pinned: eager calls
        sf(x)
        # the retry traced: the pin is dropped, the compiled entry used
        assert len(sf._eager_sigs) == 0
        np.testing.assert_allclose(_np(sf(x)), _np(x * 2), rtol=1e-6)


def test_cond_stays_compiled():
    g = Graphs()
    res = []
    for P, kw in ((jp, {}), (tp, dict(backend=g))):
        @P.jit.to_static(**kw)
        def f(x):
            return P.static.nn.cond((x.sum() > 0), lambda: x * 2,
                                    lambda: x - 1)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            outp = f(P.to_tensor(np.ones((2, 2), np.float32)))
            outn = f(P.to_tensor(-np.ones((2, 2), np.float32)))
        assert not any("falling back" in str(m.message) for m in w)
        res.append((_np(outp), _np(outn)))
        assert not f._eager_sigs
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want)
    np.testing.assert_allclose(res[1][0], 2.0)
    np.testing.assert_allclose(res[1][1], -2.0)
    # one graph, both branches in it (torch.cond), chosen at run time
    assert len(g.dynamo) == 1
    assert "cond" in Graphs.targets(g.dynamo)


def test_while_loop_compiled():
    g = Graphs()
    res = []
    for P, kw in ((jp, {}), (tp, dict(backend=g))):
        @P.jit.to_static(**kw)
        def f(x):
            def cond(i, v):
                return i < 3

            def body(i, v):
                return i + 1, v * 2

            _, out = P.static.nn.while_loop(cond, body,
                                            [P.to_tensor(0), x])
            return out
        res.append(_np(f(P.to_tensor(np.ones((2,), np.float32)))))
        assert not f._eager_sigs
    np.testing.assert_allclose(res[1], res[0])
    np.testing.assert_allclose(res[1], 8.0)
    assert len(g.dynamo) == 1
    assert "while_loop" in Graphs.targets(g.dynamo)


def test_graph_break_frozen_model_input_grads():
    def branchy(P):
        class Branchy(P.nn.Layer):
            def __init__(self):
                super().__init__()
                P.seed(0)
                self.fc = P.nn.Linear(4, 4)

            def forward(self, x):
                x = self.fc(x)
                if float(x.sum().numpy()) > 1e9:
                    x = x * 2
                return x
        net = Branchy()
        for p in net.parameters():
            p.stop_gradient = True
        return net
    jnet = branchy(jp)
    tnet = _same_weights(jnet, branchy(tp))
    grads = []
    for P, net in ((jp, jnet), (tp, tnet)):
        snet = P.jit.to_static(net)
        x = P.to_tensor(a(2, 4), stop_gradient=False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            snet(x).sum().backward()
        assert x.grad is not None
        x2 = P.to_tensor(a(2, 4), stop_gradient=False)
        net(x2).sum().backward()
        np.testing.assert_allclose(_np(x.grad), _np(x2.grad), rtol=1e-6)
        grads.append(_np(x.grad))
    np.testing.assert_allclose(grads[1], grads[0], **TOL)


# -- the flash kernels in the compiled graphs --------------------------------

def _encoder_layer(P, seed=0):
    P.seed(seed)
    return P.nn.TransformerEncoderLayer(16, 2, 32, dropout=0.0,
                                        activation="gelu")


def _key_mask(P, b=2, s=8, lens=(8, 5)):
    keep = np.arange(s)[None] < np.asarray(lens)[:, None]
    return P.to_tensor(keep[:, None, None, :])


def test_masked_attention_graphs_hold_the_flash_ops():
    """The compiled forward of a surface TransformerEncoderLayer under a
    key (padding) mask holds ``flash_fwd_lse`` and its compiled backward
    ``flash_bwd``: on a CUDA tensor those are the kernel launches, never
    a traced copy of the plain version."""
    jlayer = _encoder_layer(jp)
    tlayer = _same_weights(jlayer, _encoder_layer(tp))
    g = Graphs()
    slayer = tp.jit.to_static(tlayer, backend=g)
    x = a(2, 8, 16)
    out = slayer(tp.to_tensor(x), src_mask=_key_mask(tp))
    assert len(g.dynamo) == 1 and len(g.fw) == 1
    assert FLASH_FWD in Graphs.targets(g.fw)
    out.sum().backward()
    assert len(g.bw) == 1 and FLASH_BWD in Graphs.targets(g.bw)
    # no plain attention was traced in its place
    assert "aten.softmax.default" not in Graphs.targets(g.fw)
    want = jlayer(jp.to_tensor(x), src_mask=_key_mask(jp))
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-4, atol=1e-5)
    got = {n: _np(p.grad) for n, p in tlayer.named_parameters()}
    tlayer.clear_gradients()
    tlayer(tp.to_tensor(x), src_mask=_key_mask(tp)).sum().backward()
    for n, p in tlayer.named_parameters():
        np.testing.assert_allclose(got[n], _np(p.grad), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_first_op_of_a_process_compiles_without_a_break():
    """A process whose first surface op runs under ``to_static``: the AMP
    state is bound at import, so the trace imports nothing; one graph,
    no warning, no eager pin, and no op dispatched eagerly."""
    code = (
        "import warnings, numpy as np, torch\n"
        "import paddle_tpu_torch as tp\n"
        "from paddle_tpu_torch.core import dispatch\n"
        "tp.set_device('cpu')\n"
        "graphs = []\n"
        "def backend(gm, ex):\n"
        "    graphs.append(gm)\n"
        "    return gm.forward\n"
        "@tp.jit.to_static(backend=backend)\n"
        "def f(x, y):\n"
        "    return tp.tanh(tp.matmul(x, y)).sum()\n"
        "x = np.arange(12, dtype=np.float32).reshape(3, 4) / 10\n"
        "y = np.ones((4, 2), np.float32)\n"
        "assert dispatch.op_count == 0\n"
        "with warnings.catch_warnings():\n"
        "    warnings.simplefilter('error')\n"
        "    out = f(tp.to_tensor(x), tp.to_tensor(y))\n"
        "assert len(graphs) == 1 and not f._eager_sigs, graphs\n"
        "assert dispatch.op_count == 0, dispatch.op_count\n"
        "np.testing.assert_allclose(float(out), np.tanh(x @ y).sum(),\n"
        "                           rtol=1e-6)\n"
        "assert 'jax' not in __import__('sys').modules\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


#: the surface ops and kernel-path counts of one eager step of
#: ``_eager_model`` (eager dispatch's own: the tracing guards must leave
#: them as they are)
EAGER_STEP_OPS = 78
EAGER_STEP_COUNTS = {"kernels.flash.bwd_plain": 2,
                     "kernels.flash.fwd_plain": 2,
                     "kernels.flash.sdpa.plain_mask": 2,
                     "kernels.optimizer.adam_plain": 35}


def _eager_model():
    """Phase 19's model (Embedding -> 2 x TransformerEncoderLayer ->
    Linear on the first token) at tiny widths, its AdamW and a batch."""
    tp.seed(0)
    nn = tp.nn
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        16, 2, 32, dropout=0.1, activation="gelu"), 2)
    model = nn.Sequential(nn.Embedding(50, 16), enc, nn.Linear(16, 2))
    opt = tp.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())
    rng = np.random.default_rng(0)
    ids = tp.to_tensor(rng.integers(0, 50, (4, 8)))
    keep = tp.to_tensor((np.arange(8)[None] < np.array([8, 5, 6, 3])[
        :, None])[:, None, None, :])
    labels = tp.to_tensor(rng.integers(0, 2, 4))
    return model, opt, (ids, keep, labels)


def _loss(model, ids, keep, labels):
    h = model[1](model[0](ids), src_mask=keep)
    return tp.nn.functional.cross_entropy(model[2](h[:, 0]), labels)


def test_eager_step_counts_are_unchanged():
    """The tracing guards leave eager dispatch as it is: an O1 step
    dispatches every surface op and bumps every kernel-path counter."""
    model, opt, batch = _eager_model()

    def step():
        with tp.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = _loss(model, *batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
    step()
    monitor.reset()
    n0 = dispatch.op_count
    step()
    assert dispatch.op_count - n0 == EAGER_STEP_OPS
    assert {k: v for k, v in monitor.snapshot().items() if v} == \
        EAGER_STEP_COUNTS


def test_compiled_step_counts_nothing_but_the_ops():
    """Under ``to_static`` no surface op is dispatched at a call and the
    Python counters of traced code stay at 0; the flash custom ops (their
    plain versions here) count at every call."""
    model, opt, batch = _eager_model()
    g = Graphs()
    floss = tp.jit.to_static(lambda ids, keep, labels: _loss(
        model, ids, keep, labels), backend=g)
    for _ in range(3):
        monitor.reset()
        n0 = dispatch.op_count
        with tp.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = floss(*batch)
        loss.backward()
        assert dispatch.op_count == n0
        counts = {k: v for k, v in monitor.snapshot().items() if v}
        assert counts == {"kernels.flash.fwd_plain": 2,
                          "kernels.flash.bwd_plain": 2}
        opt.step()
        opt.clear_grad()
    assert len(g.dynamo) == 1 and len(g.bw) == 1 and not floss._eager_sigs


# -- keyword tensors, the input spec, buffers ---------------------------------

def test_keyword_tensors_are_traced_by_name():
    g = Graphs()
    res = []
    for P, kw in ((jp, {}), (tp, dict(backend=g))):
        def f(x, *, scale, shift=None):
            return x * scale + (0.0 if shift is None else shift)
        sf = P.jit.to_static(f, **kw)
        x = P.to_tensor(a(2, 3))
        out1 = sf(x, scale=P.to_tensor(a(2, 3, seed=1)))
        out2 = sf(x, scale=P.to_tensor(a(2, 3, seed=2)),
                  shift=P.to_tensor(a(2, 3, seed=3)))
        res.append((_np(out1), _np(out2)))
        assert len(sf._cache) == 2
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, **TOL)
    assert len(g.dynamo) == 2


def test_positional_slots_and_input_spec():
    for P in (jp, tp):
        def f(x, y):
            return x - y
        spec = [P.jit.InputSpec([None, 3], "float32"),
                P.jit.InputSpec([None, 3], "float32")]
        sf = P.jit.to_static(f, input_spec=spec)
        x, y = P.to_tensor(a(2, 3)), P.to_tensor(a(2, 3, seed=1))
        np.testing.assert_allclose(_np(sf(x, y=y)), _np(x - y), **TOL)
        assert len(sf._cache) == 1
        sf(x, y)                      # the positionalized call's entry
        assert len(sf._cache) == 1
        assert sf.input_spec is spec and sf.concrete_program() is None
        with pytest.raises(ValueError, match="violates input_spec"):
            sf(P.to_tensor(a(2, 4)), P.to_tensor(a(2, 4)))


def test_buffers_are_written_back():
    def net(P):
        P.seed(3)
        return P.nn.Sequential(P.nn.Conv2D(3, 4, 3), P.nn.BatchNorm2D(4))
    jnet = net(jp)
    tnet = _same_weights(jnet, net(tp))
    g = Graphs()
    x = a(2, 3, 6, 6)
    jout = jp.jit.to_static(jnet)(jp.to_tensor(x))
    tout = tp.jit.to_static(tnet, backend=g)(tp.to_tensor(x))
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-4, atol=1e-5)
    for name in ("1._mean", "1._variance"):
        want = _np(jnet.state_dict()[name])
        np.testing.assert_allclose(_np(tnet.state_dict()[name]), want,
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        assert not np.allclose(want, 0.0 if "mean" in name else 1.0)
    assert len(g.dynamo) == 1


def test_api_surface():
    for P in (jp, tp):
        def f(x):
            return x
        assert P.jit.not_to_static(f) is f
        assert P.jit.not_to_static()(f) is f
        assert P.jit.enable_to_static(False) is None
        assert isinstance(P.jit.to_static(f), P.jit.StaticFunction)
        assert P.jit.to_static(f).layer is None
    with pytest.raises(NotImplementedError, match="analysis"):
        tp.jit.to_static(lambda x: x).inspect()


# -- a model of the port's zoo, and Inductor ---------------------------------

def test_bert_model_against_jax_to_static():
    jp.seed(0)
    jc = JaxBertConfig.tiny(vocab=64, hidden=32, layers=2, heads=2)
    jc.hidden_dropout_prob = 0.0
    jnet = JaxBertModel(jc)
    jnet.eval()
    params = {k: np.asarray(v, np.float32)
              for k, v in get_params(jnet).items()}
    tnet = BertModel(BertConfig(**dataclasses.asdict(jc)), device="cpu")
    tnet.load_state_dict(bert_state_from_numpy(params))
    tnet.eval()
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 64, (3, 10)).astype(np.int64)
    am = np.ones((3, 10), np.int64)
    am[1, 6:] = 0
    g = Graphs()
    seq, pooled = tp.jit.to_static(tnet, backend=g)(
        torch.from_numpy(ids), attention_mask=torch.from_numpy(am))
    jseq, jpooled = jp.jit.to_static(jnet)(
        jp.to_tensor(ids), attention_mask=jp.to_tensor(am))
    np.testing.assert_allclose(seq.detach().numpy(), _np(jseq), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pooled.detach().numpy(), _np(jpooled),
                               rtol=1e-4, atol=1e-5)
    assert len(g.dynamo) == 1
    assert "paddle_tpu_torch.flash_fwd.default" in Graphs.targets(g.fw) or \
        FLASH_FWD in Graphs.targets(g.fw)


def test_inductor_compiles_a_layer():
    """The default backend: Inductor generates and builds the layer's
    kernels (C++ on the CPU) and agrees with the eager layer."""
    jnet, tnet = _mlps(2)
    snet = tp.jit.to_static(tnet)
    assert snet._backend == "inductor"
    x = tp.to_tensor(a(4, 8))
    np.testing.assert_allclose(_np(snet(x)), _np(tnet(x)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(snet(x)), _np(jnet(jp.to_tensor(
        a(4, 8)))), rtol=1e-5, atol=1e-6)
    assert len(snet._cache) == 1 and not snet._eager_sigs


def test_compiled_dropout_draws_from_the_backend_generator():
    """Divergence by design: a traced graph cannot take the port's
    generator, so compiled dropout draws from the backend's (Inductor's,
    seeded from torch's default one). The same seed gives eager another
    mask; the compiled one keeps p's share and scales by 1 / (1 - p)."""
    drop = tp.nn.Dropout(0.5)
    x = tp.ones([64, 64])
    g = Graphs()
    tp.seed(3)
    eager = _np(drop(x))
    tp.seed(3)
    compiled = _np(tp.jit.to_static(drop, backend=g)(x))
    assert len(g.dynamo) == 1
    assert set(np.unique(compiled)) == {0.0, 2.0}
    assert abs((compiled == 0).mean() - 0.5) < 0.05
    assert not np.array_equal(compiled, eager)
