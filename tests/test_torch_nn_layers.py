"""The eager surface's nn.Layer and layers (paddle_tpu_torch.nn) against
the JAX package's: the cases of test_nn_layers.py that need no conv or
pooling, run through both packages on the same weights (carried with
bridge.layer_state_from_jax), the initializers' distributions, state_dict
names, paddle.save / load across the two packages both ways, and the
optimizer's state_dict keys.

Tolerance: float32 outputs within rtol 1e-5, atol 1e-6 of the JAX ones.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as tF
from paddle_tpu_torch.bridge import layer_state_from_jax
from paddle_tpu_torch.core import place as place_mod

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


def a(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def pair(build):
    """The same layer in both packages, the port's carrying the JAX
    weights."""
    jl, tl = build(jp, jnn), build(tp, tnn)
    missing, unexpected = tl.set_state_dict(layer_state_from_jax(jl))
    assert not missing and not unexpected
    return jl, tl


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.numpy(), np.float32),
                               np.asarray(want.numpy(), np.float32),
                               **(tol or TOL))


def _net(pkg, nn):
    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(4, 8)
            self.fc2 = nn.Linear(8, 2)

        def forward(self, x):
            return self.fc2(nn.functional.relu(self.fc1(x)))
    return Net()


def test_layer_registration_and_state_dict():
    jl, tl = pair(_net)
    names = [n for n, _ in tl.named_parameters()]
    assert names == ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]
    assert list(tl.state_dict()) == list(jl.state_dict())
    x = a(3, 4)
    close(tl(tp.to_tensor(x)), jl(jp.to_tensor(x)))
    t2 = _net(tp, tnn)
    t2.set_state_dict(tl.state_dict())
    close(t2(tp.to_tensor(x)), tl(tp.to_tensor(x)))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_across_packages(tmp_path, direction):
    def build(pkg, nn):
        return nn.Sequential(nn.Linear(4, 4), nn.LayerNorm(4),
                             nn.BatchNorm1D(4))
    jl, tl = pair(build)
    with torch.no_grad():
        tl[0].weight._data.mul_(2.0)        # differ from the JAX weights
    path = str(tmp_path / "m.pdparams")
    src, dst_pkg = (jl, tp) if direction == "jax_to_port" else (tl, jp)
    (jp if src is jl else tp).save(src.state_dict(), path)
    loaded = dst_pkg.load(path)
    dst = build(dst_pkg, tnn if dst_pkg is tp else jnn)
    missing, unexpected = dst.set_state_dict(loaded)
    assert not missing and not unexpected
    assert list(loaded) == list(src.state_dict())
    for k, v in src.state_dict().items():
        np.testing.assert_array_equal(np.asarray(dst.state_dict()[k].numpy()),
                                      np.asarray(v.numpy()))


def test_save_load_bf16_across_packages(tmp_path):
    x = a(3, 5)
    for saver, loader in ((jp, tp), (tp, jp)):
        path = str(tmp_path / f"t_{saver.__name__}.pd")
        saver.save({"w": saver.to_tensor(x).astype("bfloat16")}, path)
        got = loader.load(path)["w"]
        assert got.dtype == loader.bfloat16
        np.testing.assert_array_equal(
            np.asarray(got.astype("float32").numpy()),
            np.asarray(jp.to_tensor(x).astype("bfloat16").astype(
                "float32").numpy()))


def test_train_eval_propagation_and_hooks():
    net = tnn.Sequential(tnn.Linear(2, 2), tnn.Dropout(0.5))
    net.eval()
    assert not net[1].training
    net.train()
    assert net[1].training
    calls = []
    h = net.register_forward_post_hook(lambda l, i, o: calls.append(1))
    pre = net.register_forward_pre_hook(lambda l, i: calls.append(0))
    net(tp.to_tensor(a(1, 2)))
    assert calls == [0, 1]
    h.remove()
    pre.remove()
    net(tp.to_tensor(a(1, 2)))
    assert calls == [0, 1]


def test_linear_and_norms_match_jax():
    jl, tl = pair(lambda p, nn: nn.Sequential(
        nn.Linear(6, 6), nn.LayerNorm(6), nn.RMSNorm(6), nn.GELU()))
    x = a(4, 6, seed=7)
    close(tl(tp.to_tensor(x)), jl(jp.to_tensor(x)))
    xi = a(2, 6, 4, 4, seed=10)
    w, b = a(6, seed=8), a(6, seed=9)
    close(tF.group_norm(tp.to_tensor(xi), 3, weight=tp.to_tensor(w),
                        bias=tp.to_tensor(b)),
          jF.group_norm(jp.to_tensor(xi), 3, weight=jp.to_tensor(w),
                        bias=jp.to_tensor(b)), rtol=1e-4, atol=1e-5)
    jn, tn = pair(lambda p, nn: nn.InstanceNorm2D(6))
    close(tn(tp.to_tensor(xi)), jn(jp.to_tensor(xi)), rtol=1e-4, atol=1e-5)


def test_batch_norm_train_updates_stats():
    jb, tb = pair(lambda p, nn: nn.BatchNorm1D(4))
    x = a(16, 4, seed=11) * 3 + 1
    for mode in ("train", "eval"):
        getattr(jb, mode)()
        getattr(tb, mode)()
        close(tb(tp.to_tensor(x)), jb(jp.to_tensor(x)), rtol=1e-4,
              atol=1e-5)
        close(tb._mean, jb._mean)
        close(tb._variance, jb._variance, rtol=1e-5, atol=1e-5)
    assert np.abs(tb._mean.numpy()).sum() > 0


def test_embedding_padding_idx_grad():
    emb = tnn.Embedding(10, 4, padding_idx=0)
    ids = tp.to_tensor(np.array([0, 1, 2, 0]))
    out = emb(ids)
    np.testing.assert_allclose(out.numpy()[0], np.zeros(4))
    out.sum().backward()
    g = emb.weight.grad.numpy()
    np.testing.assert_allclose(g[0], np.zeros(4))
    assert np.abs(g[1]).sum() > 0
    np.testing.assert_allclose(emb.weight.numpy()[0], np.zeros(4))


def test_cross_entropy_layers_match_jax():
    logits = a(8, 5, seed=12)
    labels = np.random.default_rng(13).integers(0, 5, 8)
    labels[0] = -100
    w = np.abs(a(5, seed=14)) + 0.1
    for kw in ({}, {"weight": w}, {"label_smoothing": 0.1},
               {"reduction": "sum"}):
        jkw = {k: jp.to_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        tkw = {k: tp.to_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        close(tnn.CrossEntropyLoss(**tkw)(tp.to_tensor(logits),
                                          tp.to_tensor(labels)),
              jnn.CrossEntropyLoss(**jkw)(jp.to_tensor(logits),
                                          jp.to_tensor(labels)))


@pytest.mark.parametrize("name", ["MSELoss", "L1Loss", "SmoothL1Loss",
                                  "BCEWithLogitsLoss", "KLDivLoss",
                                  "SoftMarginLoss"])
def test_loss_layers_match_jax(name):
    x, y = a(6, 3, seed=15), a(6, 3, seed=16)
    if name in ("BCEWithLogitsLoss",):
        y = (y > 0).astype(np.float32)
    if name == "SoftMarginLoss":
        y = np.sign(y).astype(np.float32)
    close(getattr(tnn, name)()(tp.to_tensor(x), tp.to_tensor(y)),
          getattr(jnn, name)()(jp.to_tensor(x), jp.to_tensor(y)))


def test_transformer_layers_match_jax():
    def build(p, nn):
        return nn.TransformerEncoder(nn.TransformerEncoderLayer(
            16, 4, 32, dropout=0.0, activation="gelu"), 2)
    jl, tl = pair(build)
    assert len(tl.parameters()) == 2 * 16
    x = a(2, 6, 16)
    keep = np.ones((2, 1, 1, 6), bool)
    keep[1, ..., 4:] = False
    close(tl(tp.to_tensor(x), tp.to_tensor(keep)),
          jl(jp.to_tensor(x), jp.to_tensor(keep)), rtol=1e-4, atol=1e-5)


def test_multihead_attention_cache_and_decoder_match_jax():
    jm, tm = pair(lambda p, nn: nn.MultiHeadAttention(16, 4))
    x = a(2, 5, 16, seed=3)
    jc, tc = jm.gen_cache(jp.to_tensor(x)), tm.gen_cache(tp.to_tensor(x))
    jo, (jk, _) = jm(jp.to_tensor(x), cache=jc)
    to, (tk, _) = tm(tp.to_tensor(x), cache=tc)
    close(to, jo, rtol=1e-4, atol=1e-5)
    assert tk.shape == jk.shape == [2, 5, 4, 4]

    def dec(p, nn):
        return nn.Transformer(16, 4, 1, 1, 32, dropout=0.0)
    jt, tt = pair(dec)
    src, tgt = a(2, 6, 16, seed=4), a(2, 3, 16, seed=5)
    close(tt(tp.to_tensor(src), tp.to_tensor(tgt)),
          jt(jp.to_tensor(src), jp.to_tensor(tgt)), rtol=1e-4, atol=1e-5)


def test_containers():
    ll = tnn.LayerList([tnn.Linear(2, 2) for _ in range(3)])
    assert len(ll) == 3 and len(ll.parameters()) == 6
    ll.append(tnn.Linear(2, 2))
    assert len(ll) == 4
    pl = tnn.ParameterList([ll[0].weight, ll[0].bias])
    assert len(pl) == 2
    ld = tnn.LayerDict({"a": tnn.Linear(2, 2)})
    assert "a" in ld
    seq = tnn.Sequential(("fc", tnn.Linear(2, 3)), ("act", tnn.ReLU()))
    assert [n for n, _ in seq.named_parameters()] == ["fc.weight", "fc.bias"]


@pytest.mark.parametrize("init,check", [
    ("KaimingNormal", lambda w: abs(w.std() - np.sqrt(2.0 / 400)) < 0.003),
    ("XavierNormal", lambda w: abs(w.std() - np.sqrt(2.0 / 700)) < 0.003),
    ("XavierUniform", lambda w: abs(np.abs(w).max() - np.sqrt(6 / 700))
     < 0.005 and abs(w.mean()) < 0.003),
    ("Normal", lambda w: abs(w.std() - 1.0) < 0.02 and abs(w.mean()) < 0.02),
    ("Uniform", lambda w: w.min() >= -1 and w.max() <= 1
     and abs(w.std() - 1 / np.sqrt(3)) < 0.02),
    ("TruncatedNormal", lambda w: np.abs(w).max() <= 2.0
     and abs(w.std() - 0.8796) < 0.02),
])
def test_initializer_distributions(init, check):
    """Held to their distributions (threefry bits cannot be reproduced),
    the same checks passing on the JAX package's draws."""
    from paddle_tpu.nn import initializer as JI
    from paddle_tpu_torch.nn import initializer as TI
    for pkg, nn, I in ((jp, jnn, JI), (tp, tnn, TI)):
        pkg.seed(0)
        lin = nn.Linear(400, 300, weight_attr=pkg.ParamAttr(
            initializer=getattr(I, init)()))
        w = np.asarray(lin.weight.numpy())
        assert check(w), (pkg.__name__, init, w.std())
    tp.seed(3)
    w1 = tnn.Linear(8, 8).weight.numpy()
    tp.seed(3)
    np.testing.assert_array_equal(tnn.Linear(8, 8).weight.numpy(), w1)


def test_initializer_constant_assign_and_bias():
    from paddle_tpu_torch.nn import initializer as I
    lin = tnn.Linear(4, 4, weight_attr=tp.ParamAttr(
        initializer=I.Assign(np.eye(4, dtype=np.float32))),
        bias_attr=tp.ParamAttr(initializer=I.Constant(0.3)))
    np.testing.assert_array_equal(lin.weight.numpy(), np.eye(4))
    np.testing.assert_allclose(lin.bias.numpy(), 0.3)
    assert tnn.Linear(3, 2).bias.numpy().tolist() == [0.0, 0.0]


def test_dropout_keep_rate_and_scale():
    x = tp.to_tensor(np.full((200_000,), 2.0, np.float32))
    for p in (0.1, 0.5):
        out = tF.dropout(x, p).numpy()
        kept = out != 0
        assert abs(kept.mean() - (1 - p)) < 0.005
        np.testing.assert_allclose(out[kept], 2 / (1 - p), rtol=1e-6)
    assert tF.dropout(x, 0.3, training=False) is x
    layer = tnn.Dropout(0.3)
    layer.eval()
    assert layer(x) is x
    tp.seed(5)
    m1 = tF.dropout(x, 0.3).numpy() != 0
    tp.seed(5)
    np.testing.assert_array_equal(tF.dropout(x, 0.3).numpy() != 0, m1)


def test_models_dropout_modules_take_the_models_generator():
    """The torch modules the models use moved to nn._modules: the
    model's dropouts are those, and draw from its generator."""
    from paddle_tpu_torch.nn import _modules
    from paddle_tpu_torch.text.models import BertConfig, BertModel
    cfg = BertConfig.tiny(vocab=32, hidden=16, layers=2, heads=2)
    net = BertModel(cfg, device="cpu", seed=5)
    drops = [m for m in net.modules() if isinstance(m, _modules.Dropout)]
    assert len(drops) >= 3
    assert all(m.generator is net.generator for m in drops)
    assert not issubclass(tnn.Dropout, torch.nn.Module)
    assert issubclass(tnn.Dropout, tnn.Layer)


def test_layer_to_astype_keep_the_leaves():
    lin = tnn.Linear(3, 2)
    leaf = lin.weight._data
    lin.astype("bfloat16")
    assert lin.weight._data is leaf and lin.weight.dtype == tp.bfloat16
    assert not lin.weight.stop_gradient
    lin.float()
    assert lin.weight.dtype == tp.float32


def test_optimizer_state_dict_keys_equal_jax():
    jl, tl = pair(lambda p, nn: nn.Sequential(nn.Linear(3, 4),
                                              nn.LayerNorm(4)))
    tl[0].weight.name = "fc_w"
    jl[0].weight.name = "fc_w"
    x, c = a(2, 3), a(2, 4, seed=1)
    states = []
    for pkg, layer in ((jp, jl), (tp, tl)):
        opt = pkg.optimizer.AdamW(learning_rate=1e-2,
                                  parameters=layer.parameters())
        (layer(pkg.to_tensor(x)) * pkg.to_tensor(c)).sum().backward()
        opt.step()
        opt.clear_grad()
        states.append(opt.state_dict())
    jsd, tsd = states
    assert sorted(tsd) == sorted(jsd)
    assert "fc_w.moment1" in tsd
    for k, v in jsd.items():
        if k.startswith("@"):
            continue
        np.testing.assert_allclose(np.asarray(tsd[k]),
                                   np.asarray(v.numpy()), rtol=1e-5,
                                   atol=1e-7)
    for tpar, jpar in zip(tl.parameters(), jl.parameters()):
        close(tpar, jpar)


def test_attention_dropout_is_not_applied_on_the_flash_path():
    """Carried from the JAX package: MultiHeadAttention hands its dropout
    to scaled_dot_product_attention as dropout_p, which no path applies;
    in training the output equals eval's, in both packages."""
    for pkg, nn in ((jp, jnn), (tp, tnn)):
        pkg.seed(0)
        mha = nn.MultiHeadAttention(16, 4, dropout=0.9)
        x = pkg.to_tensor(a(2, 5, 16, seed=6))
        keep = pkg.to_tensor(np.ones((2, 1, 1, 5), bool))
        mha.train()
        train_out = np.asarray(mha(x, attn_mask=keep).numpy())
        mha.eval()
        np.testing.assert_array_equal(
            train_out, np.asarray(mha(x, attn_mask=keep).numpy()))


def test_batch_norm_gradient_treats_batch_stats_as_constants():
    """Carried from the JAX package, which wraps the batch mean and
    variance outside its op: the input gradient of a training batch norm
    has no term through the statistics."""
    jb, tb = pair(lambda p, nn: nn.BatchNorm1D(3))
    x, c = a(8, 3, seed=4) * 2 + 1, a(8, 3, seed=5)
    grads = []
    for pkg, bn in ((jp, jb), (tp, tb)):
        bn.train()
        t = pkg.to_tensor(x, stop_gradient=False)
        (bn(t) * pkg.to_tensor(c)).sum().backward()
        grads.append(np.asarray(t.grad.numpy()))
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-6)
    var = x.var(0)
    np.testing.assert_allclose(grads[1], c / np.sqrt(var + 1e-5),
                               rtol=1e-4)


def test_sdpa_flag_moves_only_surface_calls():
    """FLAGS_sdpa_use_flash=0 pins a surface sdpa to the plain core; a raw
    torch call (the port's models) keeps its flash route, and only
    use_flash=False moves it."""
    from paddle_tpu_torch import monitor
    q, k, v = (a(2, 6, 4, 8, seed=s) for s in (7, 8, 9))
    keep = np.ones((2, 1, 1, 6), bool)
    keep[1, ..., 4:] = False
    raw = [torch.from_numpy(t) for t in (q, k, v, keep)]
    calls = {"core": lambda: tF.scaled_dot_product_attention(
                 *(tp.to_tensor(t) for t in (q, k, v, keep))),
             "plain_mask": lambda: tF.scaled_dot_product_attention(*raw)}
    counts = {r: monitor.counter(f"kernels.flash.sdpa.{r}")
              for r in calls}
    tp.set_flags({"FLAGS_sdpa_use_flash": False})
    try:
        outs = {}
        for route, call in calls.items():
            before = {r: c.get() for r, c in counts.items()}
            outs[route] = np.asarray(call().numpy())
            assert {r: c.get() - before[r] for r, c in counts.items()} == \
                {r: int(r == route) for r in counts}
    finally:
        tp.set_flags({"FLAGS_sdpa_use_flash": True})
    np.testing.assert_allclose(outs["core"], outs["plain_mask"], **TOL)
    before = counts["core"].get()
    tF.scaled_dot_product_attention(*raw, use_flash=False)
    assert counts["core"].get() == before + 1
