"""Selective recompute in the port (``distributed/fleet/recompute.py``,
``LlamaConfig.recompute_granularity``) on the CPU.

Under "selective" and "selective_qkv" a layer runs as two checkpointed
regions that end at ``attn_core`` and ``ffn_mid``, with o_proj, down_proj
and the residual adds outside them. What each setting keeps is read from
what the regions cannot hide:

- ``saved_tensors_hooks`` around the forward see every tensor saved
  outside a region (a non-reentrant checkpoint's own hooks take
  precedence inside one): the inputs of o_proj and down_proj
  (``attn_core``, ``ffn_mid``) are among them under the selective
  settings and not under "full";
- o_proj and down_proj run once under the selective settings (the rerun
  stops at the regions' ends) and twice under "full";
- each tag's implementation counts its runs
  (``recompute.checkpoint_name.<name>``): the q / k / v tags of
  "selective_qkv" run once (saved), and nothing else is tagged;
- the flash forward runs twice a layer under every recompute setting
  (the rerun; lse carries no name) and once without.

Gradients are held to no recompute's bit for bit (the rerun repeats the
same CPU ops on the same inputs).
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu_torch import monitor
from paddle_tpu_torch.distributed.fleet import (checkpoint_name, recompute,
                                                recompute_sequential,
                                                save_only_names)
from paddle_tpu_torch.nn.functional import document_startend_row_indices
from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

LAYERS = 2
QKV = ("attn_q", "attn_k", "attn_v")


def _net(granularity, seed=1):
    cfg = LlamaConfig.tiny(vocab=64, layers=LAYERS)
    if granularity is not None:
        cfg = dataclasses.replace(cfg, recompute=True,
                                  recompute_granularity=granularity)
    return LlamaForCausalLM(cfg, device="cpu", seed=seed)


def _storage(t):
    return t.untyped_storage().data_ptr()


def _run(net, flashmask):
    """One forward and backward; returns (gradients, counters, the
    storages of o_proj / down_proj's inputs of layer 0 in call order, the
    storages saved outside the checkpointed regions). The inputs are held
    until the end, so no two of them share an address."""
    seen = {"o_proj": [], "down_proj": []}
    lyr = net.llama.layers[0]
    hooks = [getattr(lyr.self_attn if k == "o_proj" else lyr.mlp, k)
             .register_forward_pre_hook(
                 lambda m, inp, k=k: seen[k].append(inp[0]))
             for k in seen]
    ids = torch.from_numpy(
        np.random.default_rng(5).integers(0, 64, (2, 12)).astype(np.int64))
    se = document_startend_row_indices([5, 4, 3]) if flashmask else None
    saved = set()

    def pack(t):
        saved.add(_storage(t))
        return t

    monitor.reset()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = net(ids, attn_mask_startend_row_indices=se).square().mean()
    loss.backward()
    for h in hooks:
        h.remove()
    counts = {k: monitor.counter(k).get() for k in
              [f"recompute.checkpoint_name.{t}"
               for t in QKV + ("attn_core", "ffn_mid")]
              + ["kernels.flash.fwd_plain"]}
    seen = {k: [_storage(t) for t in v] for k, v in seen.items()}
    return ({n: p.grad for n, p in net.named_parameters()}, counts, seen,
            saved)


@pytest.mark.parametrize("flashmask", [False, True])
@pytest.mark.parametrize("granularity", ["full", "selective",
                                         "selective_qkv"])
def test_policy_saves_what_it_says(granularity, flashmask):
    ref_grads, ref_counts, ref_seen, ref_saved = _run(_net(None), flashmask)
    assert ref_counts["kernels.flash.fwd_plain"] == LAYERS
    assert [len(v) for v in ref_seen.values()] == [1, 1]
    assert {v[0] for v in ref_seen.values()} <= ref_saved
    grads, counts, seen, saved = _run(_net(granularity), flashmask)
    selective = granularity != "full"
    assert counts.pop("kernels.flash.fwd_plain") == 2 * LAYERS
    tagged = granularity == "selective_qkv" and not flashmask
    assert counts == {f"recompute.checkpoint_name.{t}":
                      LAYERS if tagged and t in QKV else 0
                      for t in QKV + ("attn_core", "ffn_mid")}, counts
    for key in ("o_proj", "down_proj"):
        # the forward, then (full recompute only) the rerun on a fresh
        # tensor; the selective regions end before o_proj / down_proj
        assert len(seen[key]) == (1 if selective else 2), key
        assert (seen[key][0] in saved) == selective, key
        if not selective:
            assert seen[key][1] != seen[key][0], key
    for n, g in ref_grads.items():
        assert torch.equal(grads[n], g), n


def test_checkpoint_name_copies_and_passes_the_gradient():
    x = torch.randn(3, 4, requires_grad=True)
    y = checkpoint_name(x, "attn_core")
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    (y * torch.arange(4.0)).sum().backward()
    assert torch.equal(x.grad, torch.arange(4.0).expand(3, 4))


def test_save_only_names_policy_keeps_the_tagged_op_only():
    """A hand-made region: sin -> tag "keep" -> cos -> tag "drop" ->
    square; the backward needs both tags' outputs, and the rerun
    recomputes "drop" only."""
    def region(x):
        a = checkpoint_name(torch.sin(x), "keep")
        return checkpoint_name(torch.cos(a), "drop").square().sum()

    x = torch.randn(5, requires_grad=True)
    monitor.reset()
    recompute(region, x, policy=save_only_names("keep")).backward()
    assert monitor.counter("recompute.checkpoint_name.keep").get() == 1
    assert monitor.counter("recompute.checkpoint_name.drop").get() == 2
    torch.testing.assert_close(x.grad, -2 * torch.cos(torch.sin(x))
                               * torch.sin(torch.sin(x)) * torch.cos(x))


def test_recompute_sequential_matches_plain():
    torch.manual_seed(0)
    layers = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                 torch.nn.Linear(8, 8), torch.nn.Tanh(),
                                 torch.nn.Linear(8, 2))
    x = torch.randn(3, 4)
    layers(x).square().sum().backward()
    want = [p.grad.clone() for p in layers.parameters()]
    layers.zero_grad()
    out = recompute_sequential({"segments": 2}, layers, x)
    out.square().sum().backward()
    for p, w in zip(layers.parameters(), want):
        torch.testing.assert_close(p.grad, w, rtol=1e-6, atol=1e-7)


def test_unknown_granularity_raises():
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab=64), recompute=True,
                              recompute_granularity="core_attn")
    with pytest.raises(ValueError, match="recompute_granularity"):
        LlamaForCausalLM(cfg, device="cpu")
