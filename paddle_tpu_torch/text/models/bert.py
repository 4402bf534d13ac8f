"""BERT model family (counterpart of ``paddle_tpu/text/models/bert.py``).

``BertConfig``, the embeddings, post-LN encoder blocks, ``BertModel``
(sequence output and tanh-pooled [CLS]) and ``BertForPretraining`` (MLM
head tied to the word embeddings, NSP head). Module and parameter names
match the JAX package, so ``bridge.bert_state_from_numpy`` maps one set
of weights onto the other.

Attention runs through ``nn.functional.scaled_dot_product_attention``:
bidirectional, mask-free or with the [b, s] padding mask turned into a
bool key mask once per forward and into flashmask key bands by each
layer, so both reach the flash kernels (head dim 64 at BERT-base, behind
the head-dim-64 probe). Dropout draws from the model's one
``torch.Generator`` on its device, seeded from ``seed``.

Divergence: a sequence longer than ``max_position_embeddings`` raises
ValueError, where the JAX package's ``jnp.take`` fills the missing
position rows with NaN.

Tensor parallelism (:59-66, :94-95, :125-126): under a hybrid topology
with ``mp`` > 1 the word embedding is a ``VocabParallelEmbeddingModule``,
qkv and fc1 ``ColumnParallelLinearModule``s, out and fc2
``RowParallelLinearModule``s, each rank holding its shard and running
its h / mp heads. The fused qkv is split by head, not by column: rank r
holds the q, k and v of its heads (``split=3``), where a plain column
split of the [h, 3h] weight would give rank 0 all of q and half of k;
``bridge.bert_state_from_numpy(..., mp_rank, mp_degree)`` permutes the
JAX package's global weight to match. The MLM head, tied to the word
embedding, produces a vocabulary shard of the logits: its loss is
vocabulary-parallel (``_c_softmax_with_cross_entropy``, or the fused
head's ``group``) and its logits are gathered. Weights are drawn at
their global shapes and sliced, so any mp degree builds the same model.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ...core.device import resolve_device
from ...distributed import mesh as mesh_mod
from ...distributed.fleet.layers.mpu.mp_layers import (
    ColumnParallelLinearModule, RowParallelLinearModule,
    VocabParallelEmbeddingModule, _ShardedModule)
from ...distributed.fleet.layers.mpu.mp_ops import (
    _c_concat, _c_identity, _c_softmax_with_cross_entropy)
from ...incubate.nn.functional import fused_linear_cross_entropy
from ...nn import functional as F
from ...nn._modules import Dropout, LayerNorm


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    # MLM loss as the chunked fused head-matmul + CE when labels are given
    fused_mlm_ce: bool = False
    fused_ce_chunks: int = 8

    @staticmethod
    def bert_base():
        return BertConfig()

    @staticmethod
    def tiny(vocab=128, hidden=64, layers=2, heads=4):
        return BertConfig(vocab_size=vocab, hidden_size=hidden,
                          num_hidden_layers=layers,
                          num_attention_heads=heads,
                          intermediate_size=hidden * 4,
                          max_position_embeddings=128)


def _linear(i, o, device):
    return nn.Linear(i, o, device=device)


def _use_tp():
    return mesh_mod.axis_degree("mp") > 1


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, device=None, generator=None):
        super().__init__()
        self.max_positions = c.max_position_embeddings
        emb = VocabParallelEmbeddingModule if _use_tp() else nn.Embedding
        self.word_embeddings = emb(c.vocab_size, c.hidden_size,
                                   device=device)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size, device=device)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size, device=device)
        self.layer_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                    device=device)
        self.dropout = Dropout(c.hidden_dropout_prob, generator=generator)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        if s > self.max_positions:
            raise ValueError(
                f"sequence of {s} tokens is longer than "
                f"max_position_embeddings ({self.max_positions})")
        pos = torch.arange(s, device=input_ids.device)[None]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        hs = c.hidden_size
        if _use_tp():
            mp = mesh_mod.axis_degree("mp")
            if self.num_heads % mp:
                raise ValueError(f"num_attention_heads ({self.num_heads}) "
                                 f"must be divisible by mp ({mp})")
            self.num_heads //= mp
            self.qkv = ColumnParallelLinearModule(hs, 3 * hs, bias=True,
                                                  device=device, split=3)
            self.out = RowParallelLinearModule(hs, hs, bias=True,
                                               device=device)
        else:
            self.qkv = _linear(hs, 3 * hs, device)
            self.out = _linear(hs, hs, device)
        self.dropout_p = c.attention_probs_dropout_prob

    def forward(self, x, attn_mask=None):
        b, s, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, s, 3, self.num_heads,
                                      self.head_dim).unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout_p,
            training=self.training)
        return self.out(out.reshape(b, s, -1))


class BertEncoderLayer(nn.Module):
    """Post-LN block, as BERT."""

    def __init__(self, c: BertConfig, device=None, generator=None):
        super().__init__()
        self.attention = BertSelfAttention(c, device)
        self.attn_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                   device=device)
        if _use_tp():
            self.fc1 = ColumnParallelLinearModule(
                c.hidden_size, c.intermediate_size, bias=True, device=device)
            self.fc2 = RowParallelLinearModule(
                c.intermediate_size, c.hidden_size, bias=True, device=device)
        else:
            self.fc1 = _linear(c.hidden_size, c.intermediate_size, device)
            self.fc2 = _linear(c.intermediate_size, c.hidden_size, device)
        self.ffn_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                  device=device)
        self.dropout = Dropout(c.hidden_dropout_prob, generator=generator)

    def forward(self, x, attn_mask=None):
        x = self.attn_norm(x + self.dropout(self.attention(x, attn_mask)))
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.ffn_norm(x + self.dropout(h))


def _init(module, seed, init_std):
    """Weights normal(0, init_std) from ``seed``; LayerNorms 1 and 0,
    Linear biases 0. A tensor-parallel weight is drawn at its global
    shape and sliced to this rank's shard."""
    gen = torch.Generator(device=module.device).manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, _ShardedModule):
                full = torch.empty(m.global_shape(), device=m.weight.device,
                                   dtype=m.weight.dtype)
                m.weight.copy_(m.shard(full.normal_(0.0, init_std,
                                                    generator=gen)))
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, init_std, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()


def _check_mp_degree(mp_degree):
    """``mp_degree`` (None: the topology's) must be the topology's."""
    have = mesh_mod.axis_degree("mp")
    if mp_degree is not None and int(mp_degree) != have:
        raise ValueError(
            f"mp_degree={mp_degree}, but the hybrid topology's mp degree is "
            f"{have}: build the model after fleet.init with "
            f"hybrid_configs={{'mp_degree': {mp_degree}}}")


class BertModel(nn.Module):
    """The encoder. ``device=None`` builds it on ``cuda`` (raising when no
    GPU is visible); ``device="cpu"`` runs the plain versions of the
    kernels. Weights are drawn from ``seed`` (or loaded with
    ``load_state_dict``, see ``bridge.bert_state_from_numpy``); dropout
    draws from ``self.generator``, seeded from ``seed`` as well."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0,
                 init_std: float = 0.02, mp_degree=None, generator=None):
        super().__init__()
        _check_mp_degree(mp_degree)
        self.config = config
        self.device = resolve_device(device)
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(int(seed))
        self.embeddings = BertEmbeddings(config, self.device, self.generator)
        self.encoder = nn.ModuleList(
            [BertEncoderLayer(config, self.device, self.generator)
             for _ in range(config.num_hidden_layers)])
        self.pooler = _linear(config.hidden_size, config.hidden_size,
                              self.device)
        if generator is None:
            _init(self, seed, init_std)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """-> (sequence [b, s, hidden], pooled [b, hidden]).
        ``attention_mask``: optional [b, s] (1 attend, 0 padding), turned
        once into the bool [b, 1, 1, s] key mask every layer shares."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        if token_type_ids is not None:
            token_type_ids = torch.as_tensor(token_type_ids,
                                             device=self.device)
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            am = torch.as_tensor(attention_mask, device=self.device)
            mask = (am != 0)[:, None, None, :]
        for lyr in self.encoder:
            x = lyr(x, mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled

    def serving_spec(self):
        """The encoder's geometry for ``inference.BatchEncoder`` (the
        decode ``Engine`` refuses ``kind: "encoder"``)."""
        c = self.config
        return {
            "kind": "encoder",
            "num_layers": c.num_hidden_layers,
            "hidden_size": c.hidden_size,
            "head_dim": c.hidden_size // c.num_attention_heads,
            "max_context": c.max_position_embeddings,
            "vocab_size": c.vocab_size,
        }


class BertForPretraining(nn.Module):
    """MLM + NSP heads; the MLM decoder is the word embedding matrix
    itself (one Parameter, no copy). ``forward`` returns ``(mlm_logits,
    nsp_logits)``, or ``(loss, nsp_logits)`` with ``labels`` — the mean
    CE over the dense logits, or the chunked fused head when
    ``config.fused_mlm_ce``."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0,
                 init_std: float = 0.02, mp_degree=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.bert = BertModel(config, dev, seed, init_std, mp_degree, gen)
        self.device = dev
        self.generator = gen
        h = config.hidden_size
        self.transform = _linear(h, h, dev)
        self.transform_norm = LayerNorm(h, epsilon=config.layer_norm_eps,
                                        device=dev)
        self.nsp_head = _linear(h, 2, dev)
        _init(self, seed, init_std)

    def forward(self, input_ids, token_type_ids=None, labels=None,
                attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(F.gelu(self.transform(seq)))
        w = self.bert.embeddings.word_embeddings.weight
        nsp_logits = self.nsp_head(pooled)
        cfg = self.bert.config
        if labels is not None:
            labels = torch.as_tensor(labels, device=self.device)
        emb = self.bert.embeddings.word_embeddings
        group = getattr(emb, "group", None)
        if group is not None and group.nranks == 1:
            group = None
        if labels is not None and cfg.fused_mlm_ce:
            # the fused CE takes the [H, V] (paddle Linear) layout
            loss = fused_linear_cross_entropy(h, w.t(), labels,
                                              n_chunks=cfg.fused_ce_chunks,
                                              group=group)
            return loss, nsp_logits
        if group is not None:
            # this rank's vocabulary shard of the logits
            local = torch.nn.functional.linear(_c_identity(h, group=group),
                                               w)
            if labels is None:
                return _c_concat(local, group=group), nsp_logits
            nll = _c_softmax_with_cross_entropy(local, labels, group=group)
            valid = (labels != -100).float()
            return (nll * valid).sum() / valid.sum().clamp(min=1.0), \
                nsp_logits
        mlm_logits = torch.nn.functional.linear(h, w)
        if labels is not None:
            loss = F.cross_entropy(mlm_logits.reshape(-1, w.shape[0]),
                                   labels.reshape(-1))
            return loss, nsp_logits
        return mlm_logits, nsp_logits
