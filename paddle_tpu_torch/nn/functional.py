"""nn.functional subset of the LLaMA path (counterparts of
``paddle_tpu/nn/functional/norm.py:47`` ``rms_norm`` and
``activation.silu``)."""
from __future__ import annotations

import torch


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm: the mean square is taken in f32, and x is multiplied by
    ``rsqrt(ms + eps)`` cast to x's dtype (then by ``weight``) — the same
    order of roundings as the JAX package."""
    ms = x.float().square().mean(dim=-1, keepdim=True)
    out = x * torch.reciprocal(torch.sqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def silu(x):
    return torch.nn.functional.silu(x)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross entropy with hard (integer) labels (counterpart of
    ``paddle_tpu/nn/functional/loss.py:28``): ``log_softmax`` in the
    logits' dtype (bf16 under AMP, as the JAX package does), labels equal
    to ``ignore_index`` contribute nothing, and ``"mean"`` divides by the
    number of valid labels (at least 1). ``label`` may carry a trailing
    size-1 class axis."""
    if soft_label or weight is not None or label_smoothing or \
            not use_softmax:
        raise NotImplementedError(
            "soft labels, class weights, label smoothing and "
            "use_softmax=False come with a later slice of the port")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean/sum/none, got {reduction}")
    lp = torch.log_softmax(input, dim=axis)
    lab = torch.as_tensor(label, device=input.device)
    if lab.dim() == input.dim():
        lab = lab.squeeze(axis)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = torch.gather(lp, axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, 0.0)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum().to(loss.dtype), min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss


def document_startend_row_indices(doc_lens, total=None, device=None):
    """Causal document mask as flashmask ``startend_row_indices``
    ([1, 1, total, 1] int32; counterpart of
    ``paddle_tpu/nn/functional/attention.py:293``): token i may attend
    token j iff j <= i and both sit in the same packed document. Each key
    column's band masks rows from its document's end on."""
    lens = [int(n) for n in doc_lens]
    if any(n < 1 for n in lens):
        raise ValueError(f"document lengths must be >= 1, got {lens}")
    s = sum(lens)
    total = s if total is None else int(total)
    if s != total:
        raise ValueError(
            f"doc_lens sum to {s} but total={total} — packed documents "
            f"must tile the whole sequence")
    ends = torch.repeat_interleave(
        torch.cumsum(torch.tensor(lens), 0), torch.tensor(lens))
    return ends.to(torch.int32).reshape(1, 1, total, 1).to(device)
