"""Loss layers (counterpart of ``paddle_tpu/nn/layer/loss.py``)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self.reduction = reduction
        self.log_target = log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction, self.log_target)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.margin, self.p = margin, p
        self.epsilon, self.swap = epsilon, swap
        self.reduction = reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, self.margin,
                                     self.p, self.epsilon, self.swap,
                                     self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self.full, self.epsilon, self.reduction = full, epsilon, reduction

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, self.full,
                                   self.epsilon, self.reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self.log_input, self.full = log_input, full
        self.epsilon, self.reduction = epsilon, reduction

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, self.log_input, self.full,
                                  self.epsilon, self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.p, self.margin = p, margin
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, self.p, self.margin,
                                   self.weight, self.reduction)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin, self.swap, self.reduction = margin, swap, reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           self.blank, self.fastemit_lambda, self.reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid with learned internal-node weights
    (reference: nn.HSigmoidLoss)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if num_classes < 2 and not is_custom:
            raise ValueError(
                "num_classes must be >= 2 with the default tree")
        self.num_classes = num_classes
        # reference loss.py:572 — C = num_classes (custom tree) or
        # num_classes - 1 internal nodes (default complete binary tree)
        n_nodes = num_classes if is_custom else num_classes - 1
        self.weight = self.create_parameter(
            [n_nodes, feature_size], attr=weight_attr)
        self.bias = self.create_parameter([n_nodes], attr=bias_attr,
                                          is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table, path_code)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Adaptive softmax head (reference: nn.AdaptiveLogSoftmaxWithLoss)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if (cutoffs != sorted(cutoffs) or len(set(cutoffs)) != len(cutoffs)
                or any(int(c) != c or c <= 0 for c in cutoffs)
                or cutoffs[-1] > n_classes - 1):
            raise ValueError(
                "cutoffs must be unique positive ints, increasing, and "
                "<= n_classes - 1")
        self.cutoffs = cutoffs + [n_classes]
        self.n_clusters = len(cutoffs)
        self.head_size = cutoffs[0] + self.n_clusters
        self.head_weight = self.create_parameter(
            [in_features, self.head_size])
        self.head_bias = self.create_parameter(
            [self.head_size], is_bias=True) if head_bias else None
        self.tail_weights = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features / (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            w_dn = self.create_parameter([in_features, hsz])
            w_up = self.create_parameter([hsz, osz])
            self.add_parameter(f"tail_dn_{i}", w_dn)
            self.add_parameter(f"tail_up_{i}", w_up)
            self.tail_weights.append((w_dn, w_up))

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights,
            self.cutoffs, self.head_bias)

    def log_prob(self, input):
        """Full [n, n_classes] log-probabilities."""
        import torch
        from ...core.dispatch import run_op as _run

        def fn(x, hw, *rest):
            off = 1 if self.head_bias is not None else 0
            hb = rest[0] if off else None
            tails = rest[off:]
            head_logits = x @ hw
            if hb is not None:
                head_logits = head_logits + hb
            head_lp = torch.log_softmax(head_logits, dim=-1)
            parts = [head_lp[:, :self.cutoffs[0]]]
            for i in range(self.n_clusters):
                tail_lp = torch.log_softmax(
                    (x @ tails[2 * i]) @ tails[2 * i + 1], dim=-1)
                parts.append(head_lp[:, self.cutoffs[0] + i][:, None]
                             + tail_lp)
            return torch.cat(parts, dim=-1)
        args = [input, self.head_weight]
        if self.head_bias is not None:
            args.append(self.head_bias)
        for pair in self.tail_weights:
            args.extend(pair)
        return _run("adaptive_log_softmax", fn, args)

    def predict(self, input):
        from ...ops import search as S
        return S.argmax(self.log_prob(input), axis=-1)
