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
position rows with NaN. Tensor-parallel layers (an ``mp`` mesh axis,
``mp_degree`` > 1 here) come with the distributed slice of the port and
raise NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ...core.device import resolve_device
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


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, device=None, generator=None):
        super().__init__()
        self.max_positions = c.max_position_embeddings
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size,
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
        self.qkv = _linear(c.hidden_size, 3 * c.hidden_size, device)
        self.out = _linear(c.hidden_size, c.hidden_size, device)
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
    Linear biases 0."""
    gen = torch.Generator(device=module.device).manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, init_std, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()


class BertModel(nn.Module):
    """The encoder. ``device=None`` builds it on ``cuda`` (raising when no
    GPU is visible); ``device="cpu"`` runs the plain versions of the
    kernels. Weights are drawn from ``seed`` (or loaded with
    ``load_state_dict``, see ``bridge.bert_state_from_numpy``); dropout
    draws from ``self.generator``, seeded from ``seed`` as well."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0,
                 init_std: float = 0.02, mp_degree: int = 1,
                 generator=None):
        super().__init__()
        if int(mp_degree) > 1:
            raise NotImplementedError(
                "tensor-parallel BERT layers (the 'mp' mesh axis) come "
                "with the distributed slice of the port")
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
                 init_std: float = 0.02, mp_degree: int = 1):
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
        if labels is not None and cfg.fused_mlm_ce:
            # the fused CE takes the [H, V] (paddle Linear) layout
            loss = fused_linear_cross_entropy(h, w.t(), labels,
                                              n_chunks=cfg.fused_ce_chunks)
            return loss, nsp_logits
        mlm_logits = torch.nn.functional.linear(h, w)
        if labels is not None:
            loss = F.cross_entropy(mlm_logits.reshape(-1, w.shape[0]),
                                   labels.reshape(-1))
            return loss, nsp_logits
        return mlm_logits, nsp_logits
