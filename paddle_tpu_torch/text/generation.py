"""Generation primitives of the serving slice (counterpart of
``paddle_tpu/text/generation.py``: ``_model_forward`` :47,
``sample_token_arrays`` :64, ``verify_token_arrays`` :131,
``_resolve_cache_dtype`` :195).

Randomness: JAX threefry keys cannot be reproduced in PyTorch, so the
sampler takes its noise as an argument — Gumbel noise the caller draws
from each request's own ``torch.Generator`` — and every row is
independent of the others: a request's sampled tokens do not depend on
its slot or its batch-mates.
"""
from __future__ import annotations

import torch

_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int8": torch.int8}


def _model_forward(model, tokens, caches, index):
    """One forward of ``model`` over ``tokens`` [b, s] with ``caches`` /
    ``index`` as the model's ``kv_caches`` / ``cache_index`` (``index`` a
    scalar or a per-sequence [b] tensor). Returns the logits (the updated
    caches are the same tensors: the port writes its pools in place)."""
    logits, _ = model(tokens, kv_caches=caches, cache_index=index)
    return logits


def gumbel_noise(vocab, generator, device):
    """[vocab] f32 Gumbel(0, 1) noise drawn from ``generator`` — the
    per-request randomness ``sample_token_arrays`` consumes."""
    u = torch.rand(vocab, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_token_arrays(logits, noise, temperature, top_k, top_p,
                        use_filters: bool = True):
    """Per-row token sampling with per-row parameters.

    logits [b, V] float; noise [b, V] f32 Gumbel noise (any values on
    greedy rows: they never read it); temperature/top_p [b] float,
    top_k [b] int (0 = filter off). Returns tokens [b] int64.

    Row semantics are the JAX sampler's: temperature 0 is greedy
    (argmax); top-k alone keeps every token tied with the k-th value;
    top-k with top-p keeps ranks < k, then the nucleus of the
    renormalized survivors (the first survivor always kept); the draw is
    the Gumbel-max of the filtered, temperature-scaled logits (the
    categorical draw ``jax.random.categorical`` makes with its own
    noise). ``use_filters=False`` skips the filters (the no-filter
    variant: identical when every row's filters are off)."""
    logits = logits.float()
    b, V = logits.shape
    temperature = temperature.float()
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    if use_filters:
        k = top_k.long()
        p = top_p.float()
        k_on = (k > 0)[:, None]
        p_on = ((p > 0.0) & (p < 1.0))[:, None]
        svals, order = torch.sort(scaled, dim=-1, descending=True,
                                  stable=True)
        kth = torch.gather(svals, 1, torch.clamp(k - 1, 0, V - 1)[:, None])
        keep_thresh = torch.where(k_on, scaled >= kth, True)
        ranks = torch.arange(V, device=logits.device)[None, :]
        keep_sorted = torch.where(k_on, ranks < k[:, None], True)
        probs = torch.softmax(
            torch.where(keep_sorted, svals,
                        torch.full_like(svals, float("-inf"))), dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        keep_sorted = keep_sorted & torch.where(
            p_on, (csum - probs) < p[:, None], True)
        keep_rank = torch.zeros_like(keep_sorted).scatter(1, order,
                                                          keep_sorted)
        keep = torch.where(p_on, keep_rank, keep_thresh)
        filt = torch.where(keep, scaled,
                           torch.full_like(scaled, float("-inf")))
    else:
        filt = scaled
    sampled = torch.argmax(filt + noise, dim=-1)
    return torch.where(temperature > 0, sampled, greedy)


def verify_token_arrays(logits, drafts, noise, temperature, top_k, top_p,
                        use_filters: bool = True, greedy: bool = False):
    """Multi-position verify scoring, the speculative-decoding acceptance
    rule. The target scored ``n = k + 1`` positions in one forward:
    position 0 continues the real context, position j the context
    extended by ``drafts[:, :j]``. The positions are walked with the
    serving sampler (``sample_token_arrays``), and a draft is accepted
    while it EQUALS the token the target emits there, so every emitted
    token is the target's own: the output is the draft-free engine's.

    logits [b, n, V] float; drafts [b, n - 1] int; noise [b, n, V] f32
    Gumbel noise, row r's position j drawn as the (j+1)-th draw of row
    r's generator this tick (ignored on greedy rows and with
    ``greedy=True``, the all-greedy variant); temperature / top_p [b]
    float, top_k [b] int; ``use_filters`` as in ``sample_token_arrays``.

    Returns (tokens [b, n] int64, accepted [b] int64): row r emits
    ``tokens[r, :accepted[r] + 1]`` (one target token always rides
    after the matched drafts). A row stops consuming randomness at its
    first mismatch, so the caller leaves a sampled row's generator
    ``accepted + 1`` draws on, where plain decoding of the same tokens
    leaves it."""
    b, n, _ = logits.shape
    # the last position has no draft to match: a -1 sentinel ends every
    # chain there
    dr = torch.cat([drafts.long(),
                    torch.full((b, 1), -1, dtype=torch.long,
                               device=logits.device)], dim=1)
    active = torch.ones((b,), dtype=torch.bool, device=logits.device)
    toks, matches = [], []
    for j in range(n):
        lg = logits[:, j]
        if greedy:
            tok = torch.argmax(lg.float(), dim=-1)
        else:
            tok = sample_token_arrays(lg, noise[:, j], temperature, top_k,
                                      top_p, use_filters=use_filters)
        active = active & (tok == dr[:, j])
        toks.append(tok)
        matches.append(active)
    tokens = torch.stack(toks, dim=1)
    accepted = torch.stack(matches, dim=1).sum(dim=1)
    return tokens, accepted


def _resolve_cache_dtype(cache_dtype, params, device):
    """The cache_dtype knob as a torch dtype. ``"auto"`` = the params'
    floating dtype when it is half precision, else bf16 on ``cuda``
    (the decode kernel accumulates in f32 whatever the pool holds) and
    f32 on the CPU (keeps CPU tests token-exact against the f32
    reference paths)."""
    if cache_dtype in (None, "auto"):
        for p in params:
            if p.is_floating_point():
                if p.dtype in (torch.bfloat16, torch.float16):
                    return p.dtype
                break
        return (torch.bfloat16 if torch.device(device).type == "cuda"
                else torch.float32)
    if isinstance(cache_dtype, torch.dtype):
        if cache_dtype in _CACHE_DTYPES.values():
            return cache_dtype
    elif str(cache_dtype) in _CACHE_DTYPES:
        return _CACHE_DTYPES[str(cache_dtype)]
    raise ValueError(
        f"cache_dtype must be one of 'auto', 'float32', 'bfloat16', "
        f"'float16', 'int8'; got {cache_dtype!r}")
