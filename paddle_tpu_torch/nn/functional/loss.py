"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

Surface Tensors go through ``run_op``; raw torch tensors take the same
body and come out raw. ``cross_entropy`` is the whole paddle contract:
hard or soft labels, class weights, label smoothing, ``use_softmax=False``
(the input already holds probabilities), ``ignore_index``, reductions.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import surface


def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be mean/sum/none, got {reduction}")


def _cross_entropy(logits, lab, w, ignore_index, reduction, soft_label,
                   axis, use_softmax, label_smoothing):
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean/sum/none, got {reduction}")
    lp = torch.log_softmax(logits, dim=axis) if use_softmax \
        else torch.log(torch.clamp(logits, 1e-15, 1.0))
    nclass = logits.shape[axis]
    lab = torch.as_tensor(lab, device=logits.device)
    if soft_label or (lab.dim() == logits.dim() and lab.shape == logits.shape
                      and lab.is_floating_point()):
        soft = lab
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) + label_smoothing / nclass
        loss = -torch.sum(soft * lp, dim=axis)
        if w is not None:
            loss = loss * torch.sum(soft * w, dim=axis)
        return _reduce(loss, reduction)
    if lab.dim() == logits.dim():
        lab = lab.squeeze(axis)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    loss = -torch.gather(lp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        loss = (1 - label_smoothing) * loss + label_smoothing * \
            -torch.mean(lp, dim=axis)
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    if w is not None:
        wsel = w[safe]
        loss = torch.where(valid, loss * wsel, zero)
        if reduction == "mean":
            return loss.sum() / torch.clamp(
                torch.where(valid, wsel, zero.to(wsel.dtype)).sum(),
                min=1e-12)
        return _reduce(loss, reduction)
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum().to(loss.dtype), min=1.0)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy. Hard labels (integers, with or without a
    trailing size-1 class axis): ``log_softmax`` in the logits' dtype,
    labels equal to ``ignore_index`` contribute nothing and ``"mean"``
    divides by the number of valid labels (at least 1), or by their
    summed class weights. Soft labels (``soft_label`` or float labels
    shaped like the logits): ``-sum(label * log_softmax)``."""
    return surface("cross_entropy", _cross_entropy, [input, label, weight],
                   ignore_index=ignore_index, reduction=reduction,
                   soft_label=soft_label, axis=axis, use_softmax=use_softmax,
                   label_smoothing=label_smoothing)


softmax_with_cross_entropy = cross_entropy
cross_entropy_with_softmax = cross_entropy


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    def fn(lp, lab, w):
        lab = lab.long()
        valid = lab != ignore_index
        safe = torch.where(valid, lab, 0)
        loss = -torch.gather(lp, 1, safe.unsqueeze(1)).squeeze(1)
        zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
        if w is not None:
            wsel = w[safe]
            loss = torch.where(valid, loss * wsel, zero)
            if reduction == "mean":
                return loss.sum() / torch.clamp(
                    torch.where(valid, wsel, zero).sum(), min=1e-12)
        loss = torch.where(valid, loss, zero)
        if reduction == "mean":
            return loss.sum() / torch.clamp(valid.sum().to(loss.dtype),
                                            min=1.0)
        return _reduce(loss, reduction)
    return surface("nll_loss", fn, [input, label, weight])


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return surface("mse_loss", lambda a, b: _reduce(torch.square(a - b),
                                                    reduction),
                   [input, label])


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return surface("l1_loss", lambda a, b: _reduce(torch.abs(a - b),
                                                   reduction),
                   [input, label])


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    def fn(a, b):
        d = torch.abs(a - b)
        return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                                   d - 0.5 * delta), reduction)
    return surface("smooth_l1_loss", fn, [input, label])


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    def fn(p, y, w):
        p = torch.clamp(p, 1e-12, 1 - 1e-12)
        loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
        return _reduce(loss if w is None else loss * w, reduction)
    return surface("binary_cross_entropy", fn, [input, label, weight])


bce_loss = binary_cross_entropy


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    def fn(z, y, pw, w):
        if pw is not None:
            loss = -(pw * y * TF.logsigmoid(z) + (1 - y) * TF.logsigmoid(-z))
        else:
            loss = torch.clamp(z, min=0) - z * y + torch.log1p(
                torch.exp(-torch.abs(z)))
        return _reduce(loss if w is None else loss * w, reduction)
    return surface("bce_with_logits", fn, [logit, label, pos_weight, weight])


sigmoid_cross_entropy_with_logits = binary_cross_entropy_with_logits


def kl_div(input, label, reduction="mean", log_target=False, name=None):  # noqa: A002
    def fn(lp, y):
        if log_target:
            loss = torch.exp(y) * (y - lp)
        else:
            loss = y * (torch.log(torch.clamp(y, min=1e-12)) - lp)
        if reduction == "batchmean":
            return torch.sum(loss) / lp.shape[0]
        return _reduce(loss, reduction)
    return surface("kl_div", fn, [input, label])


kldiv_loss = kl_div


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",  # noqa: A002
                         name=None):
    return surface("hinge_embedding_loss", lambda a, y: _reduce(torch.where(
        y == 1., a, torch.clamp(margin - a, min=0.)), reduction),
        [input, label])


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    def fn(a, b, y):
        cos = torch.sum(a * b, -1) / torch.clamp(
            torch.linalg.vector_norm(a, dim=-1) *
            torch.linalg.vector_norm(b, dim=-1), min=1e-12)
        return _reduce(torch.where(y == 1, 1 - cos,
                                   torch.clamp(cos - margin, min=0.)),
                       reduction)
    return surface("cosine_embedding_loss", fn, [input1, input2, label])


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    return surface("margin_ranking_loss", lambda a, b, y: _reduce(
        torch.clamp(-y * (a - b) + margin, min=0.), reduction),
        [input, other, label])


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,  # noqa: A002
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def fn(a, pos, neg):
        def dist(u, v):
            return torch.sum(torch.abs(u - v + epsilon) ** p, -1) ** (1 / p)
        d_an = dist(a, neg)
        if swap:
            d_an = torch.minimum(d_an, dist(pos, neg))
        return _reduce(torch.clamp(dist(a, pos) - d_an + margin, min=0.),
                       reduction)
    return surface("triplet_margin_loss", fn, [input, positive, negative])


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def fn(z, y, nrm):
        p = torch.sigmoid(z)
        ce = torch.clamp(z, min=0) - z * y + torch.log1p(
            torch.exp(-torch.abs(z)))
        p_t = p * y + (1 - p) * (1 - y)
        loss = (alpha * y + (1 - alpha) * (1 - y)) * (1 - p_t) ** gamma * ce
        return _reduce(loss if nrm is None else loss / nrm, reduction)
    return surface("sigmoid_focal_loss", fn, [logit, label, normalizer])


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    return surface("log_loss", lambda p, y: -y * torch.log(p + epsilon) - (
        1 - y) * torch.log(1 - p + epsilon), [input, label])


def square_error_cost(input, label):  # noqa: A002
    return surface("square_error_cost", lambda a, b: torch.square(a - b),
                   [input, label])


def hinge_loss(input, label, name=None):  # noqa: A002
    return surface("hinge_loss", lambda x, y: torch.clamp(
        1.0 - (2.0 * y - 1.0) * x, min=0.0), [input, label])


def huber_loss(input, label, delta=1.0, name=None):  # noqa: A002
    def fn(x, y):
        d = x - y
        ad = torch.abs(d)
        return torch.where(ad <= delta, 0.5 * d * d,
                           delta * (ad - 0.5 * delta))
    return surface("huber_loss", fn, [input, label])


def identity_loss(x, reduction="none", name=None):
    red = {0: "sum", 1: "mean", 2: "none"}.get(reduction, reduction)
    return surface("identity_loss", lambda a: _reduce(a, red), [x])


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the forward algorithm in log space; ``log_probs`` are the
    unnormalized logits [T, B, C] (normalized here, as paddle does)."""
    def fn(lp, lab, in_len, lab_len):
        lp = torch.log_softmax(lp, dim=-1)
        T, B, C = lp.shape
        S = lab.shape[1]
        dev = lp.device
        ext = torch.full((B, 2 * S + 1), blank, dtype=torch.int64, device=dev)
        ext[:, 1::2] = lab.long()
        L = 2 * lab_len.long() + 1
        neg_inf = torch.tensor(-1e30, dtype=lp.dtype, device=dev)
        alpha = torch.full((B, 2 * S + 1), -1e30, dtype=lp.dtype, device=dev)
        alpha[:, 0] = lp[0, :, blank]
        alpha[:, 1] = torch.where(L > 1, torch.gather(lp[0], 1, ext[:, 1:2])
                                  [:, 0], neg_inf)
        same = torch.cat([torch.ones((B, 2), dtype=torch.bool, device=dev),
                          ext[:, 2:] == ext[:, :-2]], dim=1)
        for t in range(1, T):
            a1 = torch.cat([neg_inf.expand(B, 1), alpha[:, :-1]], 1)
            a2 = torch.cat([neg_inf.expand(B, 2), alpha[:, :-2]], 1)
            a2 = torch.where(same, neg_inf, a2)
            merged = torch.logaddexp(torch.logaddexp(alpha, a1), a2)
            new = merged + torch.gather(lp[t], 1, ext)
            alpha = torch.where((t < in_len)[:, None], new, alpha)
        a_last = torch.gather(alpha, 1, (L - 1)[:, None])[:, 0]
        a_prev = torch.gather(alpha, 1, torch.clamp(L - 2, min=0)[:, None])[
            :, 0]
        loss = -torch.logaddexp(a_last, torch.where(L > 1, a_prev, neg_inf))
        if reduction == "mean":
            return torch.mean(loss / torch.clamp(lab_len, min=1))
        return _reduce(loss, reduction)
    return surface("ctc_loss", fn, [log_probs, labels, input_lengths,
                                    label_lengths])


def margin_cross_entropy(logits, label, return_softmax=False,
                         margin1=1.0, margin2=0.5, margin3=0.0,
                         scale=64.0, group=None, name=None):
    """ArcFace / CosFace margin softmax cross entropy."""
    def fn(lg, lb):
        theta = torch.arccos(torch.clamp(lg, -1.0, 1.0))
        oh = TF.one_hot(lb.long().reshape(lg.shape[:-1]),
                        lg.shape[-1]).to(lg.dtype)
        adj = torch.cos(margin1 * theta + margin2) - margin3
        logp = torch.log_softmax(torch.where(oh > 0, adj, lg) * scale, dim=-1)
        loss = -torch.sum(oh * logp, dim=-1, keepdim=True)
        return (loss, torch.exp(logp)) if return_softmax else loss
    return surface("margin_cross_entropy", fn, [logits, label])


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    def fn(p, lab):
        oh = TF.one_hot(lab.long().reshape(lab.shape[:-1]),
                        p.shape[-1]).to(p.dtype)
        red = tuple(range(1, p.dim()))
        inter = torch.sum(p * oh, dim=red)
        union = torch.sum(p, dim=red) + torch.sum(oh, dim=red)
        return torch.mean(1.0 - (2 * inter + epsilon) / (union + epsilon))
    return surface("dice_loss", fn, [input, label])


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,  # noqa: A002
                      reduction="mean", name=None):
    def fn(mu, y, var):
        var = torch.clamp(var, min=epsilon)
        loss = 0.5 * (torch.log(var) + (y - mu) ** 2 / var)
        if full:
            loss = loss + 0.5 * math.log(2 * math.pi)
        return _reduce(loss, reduction)
    return surface("gaussian_nll_loss", fn, [input, label, variance])


def poisson_nll_loss(input, label, log_input=True, full=False,  # noqa: A002
                     epsilon=1e-8, reduction="mean", name=None):
    def fn(x, y):
        loss = torch.exp(x) - y * x if log_input else \
            x - y * torch.log(x + epsilon)
        if full:
            stir = y * torch.log(y) - y + 0.5 * torch.log(2 * math.pi * y)
            loss = loss + torch.where(y > 1, stir, torch.zeros_like(stir))
        return _reduce(loss, reduction)
    return surface("poisson_nll_loss", fn, [input, label])


def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return surface("soft_margin_loss", lambda x, y: _reduce(
        torch.log1p(torch.exp(-y * x)), reduction), [input, label])


def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    def fn(x, y, w):
        loss = -(y * TF.logsigmoid(x) + (1 - y) * TF.logsigmoid(-x))
        if w is not None:
            loss = loss * w
        return _reduce(torch.mean(loss, dim=-1), reduction)
    return surface("multi_label_soft_margin_loss", fn, [input, label, weight])


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,  # noqa: A002
                      reduction="mean", name=None):
    def fn(x, y, w):
        n, c = x.shape
        y = y.long()
        correct = torch.gather(x, 1, y[:, None])
        m = torch.clamp(margin - correct + x, min=0.0) ** p
        if w is not None:
            m = m * w[y][:, None]
        mask = TF.one_hot(y, c).to(x.dtype)
        return _reduce(torch.sum(m * (1 - mask), dim=1) / c, reduction)
    return surface("multi_margin_loss", fn, [input, label, weight])


def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        def distance_function(a, b):
            return ((a - b) * (a - b)).sum(-1).sqrt()
    d_pos = distance_function(input, positive)
    d_neg = distance_function(input, negative)
    if swap:
        d_pn = distance_function(positive, negative)
        d_neg = surface("minimum", torch.minimum, [d_neg, d_pn])
    return surface("triplet_margin_with_distance_loss", lambda dp, dn:
                   _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction),
                   [d_pos, d_neg])


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    def fn(a, p, y):
        reg = l2_reg * (torch.sum(a * a) / a.shape[0]
                        + torch.sum(p * p) / p.shape[0]) * 0.25
        sim = a @ p.T
        same = (y[:, None] == y[None, :]).to(a.dtype)
        tgt = same / torch.sum(same, dim=1, keepdim=True)
        return torch.mean(torch.sum(-tgt * torch.log_softmax(sim, dim=1),
                                    dim=1)) + reg
    return surface("npair_loss", fn, [anchor, positive, labels])


def _default_paths(num_classes):
    """(path_table, path_code) of the default complete binary tree in the
    heap layout (codes from the binary expansion of label + num_classes)."""
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    tables, codes = [], []
    for lab in range(num_classes):
        node = lab + num_classes
        tab, code = [], []
        while node > 1:
            tab.append(node // 2 - 1)
            code.append(node % 2)
            node //= 2
        tables.append(tab[::-1] + [-1] * (depth - len(tab)))
        codes.append(code[::-1] + [-1] * (depth - len(code)))
    return np.asarray(tables, np.int64), np.asarray(codes, np.int64)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree, or a
    custom one through ``path_table`` / ``path_code``."""
    if path_table is None:
        tab_np, code_np = _default_paths(int(num_classes))
    else:
        tab_np = code_np = None

    def fn(x, lab, w, b, ptab, pcode):
        if tab_np is not None:
            ptab = torch.as_tensor(tab_np, device=x.device)
            pcode = torch.as_tensor(code_np, device=x.device)
        tab, code = ptab[lab.long().reshape(-1)], pcode[lab.long().reshape(-1)]
        valid = tab >= 0
        safe = torch.clamp(tab, min=0)
        logits = torch.einsum("ndf,nf->nd", w[safe], x)
        if b is not None:
            logits = logits + b[safe]
        y = code.to(x.dtype)
        ll = y * TF.logsigmoid(logits) + (1 - y) * TF.logsigmoid(-logits)
        return -torch.sum(torch.where(valid, ll, torch.zeros_like(ll)),
                          dim=1, keepdim=True)
    return surface("hsigmoid_loss", fn, [input, label, weight, bias,
                                         path_table, path_code])


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,  # noqa: A002
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax (Grave et al.); returns (output, loss)."""
    n_clusters = len(cutoffs) - 1

    def fn(x, lab, hw, hb, *tails):
        lab = lab.long()
        head = x @ hw
        if hb is not None:
            head = head + hb
        head_lp = torch.log_softmax(head, dim=-1)
        out = torch.gather(head_lp, 1, torch.clamp(
            lab, 0, cutoffs[0] - 1)[:, None])[:, 0]
        for i in range(n_clusters):
            lo, hi = cutoffs[i], cutoffs[i + 1]
            tail_lp = torch.log_softmax((x @ tails[2 * i]) @ tails[2 * i + 1],
                                        dim=-1)
            rel = torch.clamp(lab - lo, 0, hi - lo - 1)
            cluster = head_lp[:, cutoffs[0] + i] + torch.gather(
                tail_lp, 1, rel[:, None])[:, 0]
            out = torch.where((lab >= lo) & (lab < hi), cluster, out)
        return out, -torch.mean(out)
    args = [input, label, head_weight, head_bias]
    for pair in tail_weights:
        args.extend(pair)
    return surface("adaptive_log_softmax_with_loss", fn, args)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,  # noqa: A002
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-T loss by the (T, U) log-space alpha recursion; input [B, T,
    U+1, V] joint logits. FastEmit weights every emission by (1 +
    lambda)."""
    def fn(logits, lab, in_len, lab_len):
        lp = torch.log_softmax(logits, dim=-1)
        B, T, U1, V = lp.shape
        U = U1 - 1
        ar = torch.arange(B, device=lp.device)
        blank_lp = lp[..., blank]
        emit_lp = torch.gather(lp[:, :, :U, :], 3, torch.clamp(
            lab.long(), 0, V - 1)[:, None, :, None].expand(B, T, U, 1))[
                ..., 0]
        if fastemit_lambda:
            emit_lp = emit_lp + math.log1p(fastemit_lambda)
        cols = [torch.zeros(B, dtype=lp.dtype, device=lp.device)]
        for u in range(1, U1):
            cols.append(cols[-1] + emit_lp[:, 0, u - 1])
        alphas = [torch.stack(cols, 1)]
        for t in range(1, T):
            from_blank = alphas[-1] + blank_lp[:, t - 1, :]
            cols = [from_blank[:, 0]]
            for u in range(1, U1):
                cols.append(torch.logaddexp(
                    from_blank[:, u], cols[-1] + emit_lp[:, t, u - 1]))
            alphas.append(torch.stack(cols, 1))
        all_alphas = torch.stack(alphas, 0)
        t_idx = torch.clamp(in_len.long() - 1, 0, T - 1)
        u_idx = torch.clamp(lab_len.long(), 0, U)
        ll = all_alphas[t_idx, ar, u_idx] + blank_lp[ar, t_idx, u_idx]
        return _reduce(-ll, reduction)
    return surface("rnnt_loss", fn, [input, label, input_lengths,
                                     label_lengths])
