"""Autoregressive generation (counterpart of
``paddle_tpu/text/generation.py``): the serving slice's primitives
(``_model_forward`` :47, ``sample_token_arrays`` :64,
``verify_token_arrays`` :131, ``_resolve_cache_dtype`` :195) and
one-shot decoding, ``generate`` (:221) and ``beam_search`` (:545).

    out = generate(model, input_ids, max_new_tokens=32)           # greedy
    out = generate(model, input_ids, 32, temperature=0.8, top_k=40,
                   seed=0)                                         # sample

Where the JAX package compiles the whole decode loop into one program
(``lax.scan`` under ``jax.jit``), the port runs it eagerly: one forward
of the model a step, on the model's device. The loop keeps everything on
the device (the step index rides as a device tensor, no ``.item()``, no
early exit), so a step never waits for the host.

Randomness: JAX threefry keys cannot be reproduced in PyTorch, so the
sampler takes its noise as an argument — Gumbel noise the caller draws
from a ``torch.Generator`` (in the serving engine each request's own, in
``generate`` one seeded by ``seed``) — and every row is independent of
the others: a request's sampled tokens do not depend on its slot or its
batch-mates.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

#: decode-length bucket (JAX :40): the caches are sized for
#: ``s + _bucketed(max_new_tokens)``, which also decides ``"auto"``'s
#: layout and the paged pool's size, exactly as in the JAX package
CACHE_BUCKET = 64


def _bucketed(n: int) -> int:
    return -(-int(n) // CACHE_BUCKET) * CACHE_BUCKET

_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int8": torch.int8}


def _model_forward(model, tokens, caches, index):
    """One forward of ``model`` over ``tokens`` [b, s] with ``caches`` /
    ``index`` as the model's ``kv_caches`` / ``cache_index`` (``index`` a
    scalar or a per-sequence [b] tensor). Returns the logits (the updated
    caches are the same tensors: the port writes its pools in place)."""
    logits, _ = model(tokens, kv_caches=caches, cache_index=index)
    return logits


def gumbel_noise(shape, generator, device):
    """f32 Gumbel(0, 1) noise of ``shape`` ([vocab] for one request, [b,
    vocab] for a batch) drawn from ``generator`` — the randomness
    ``sample_token_arrays`` consumes."""
    u = torch.rand(shape, generator=generator, device=device)
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


def _host(x):
    """A host numpy copy of a scalar / list / array / tensor argument."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
    return np.asarray(x)


def _model_device(model):
    return next(model.parameters()).device


def _top_k_first(x, k):
    """The k largest values along the last axis and their indices, ties
    broken by the LOWEST index first (``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise on CUDA): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _make_caches(model, impl, b, total, dtype, page_size, device):
    """Zeroed per-layer caches of one layout for ``b`` rows of ``total``
    positions (JAX :405-457): dense [b, total, h_kv, d]; rolling C =
    window slots and a position track at -1; paged, a one-shot pool
    sized exactly for ``total`` whose block tables are ``arange(b *
    nblocks)``, so its capacity holds by construction. int8 adds f32
    scales, one a position (slot) and kv head."""
    cfg = model.config
    hkv = cfg.num_key_value_heads
    hd = cfg.hidden_size // cfg.num_attention_heads
    quant = dtype == torch.int8

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    caches = []
    for _ in range(cfg.num_hidden_layers):
        if impl == "paged":
            bs = int(page_size)
            nblocks = -(-total // bs)
            bt = torch.arange(b * nblocks, dtype=torch.int32,
                              device=device).reshape(b, nblocks)
            rows, lead, extra = b * nblocks, (hkv, bs), (bt,)
        elif impl == "rolling":
            C = int(cfg.sliding_window)
            rows, lead = b, (C, hkv)
            extra = (torch.full((C,), -1, dtype=torch.int32,
                                device=device),)
        else:
            rows, lead, extra = b, (total, hkv), ()
        cache = (z(rows, *lead, hd), z(rows, *lead, hd)) + extra
        if quant:
            cache += (z(rows, *lead, dt=torch.float32),
                      z(rows, *lead, dt=torch.float32))
        caches.append(cache)
    return caches


@torch.no_grad()
def generate(model, input_ids, max_new_tokens,
             temperature: float = 0.0, top_k: int = 0,
             top_p: float = 0.0,
             eos_token_id=None, seed: int = 0,
             use_cache: bool = True, cache_impl: str = "auto",
             page_size: int = 32, cache_dtype: str = "auto"):
    """Generate ``max_new_tokens`` continuations for ``input_ids`` [B, S]
    with the causal-LM ``model`` (JAX :221). temperature == 0 is greedy;
    otherwise softmax sampling at that temperature, optionally top-k
    truncated (exact ties with the k-th value kept) and/or nucleus
    filtered (``0 < top_p < 1``; both compose, top-k first). Rows that
    emit ``eos_token_id`` keep their eos and stop changing. Returns a
    tensor [B, S + max_new_tokens] in the ids' dtype on the model's
    device.

    ``use_cache=True`` (when ``model.forward`` takes ``kv_caches``)
    prefills the prompt into per-layer caches, then feeds one token a
    step; ``use_cache=False`` is the padded fallback: each step a full
    no-cache forward over the [B, S + bucketed] buffer, read at the
    current position.

    ``cache_impl``: "auto" = dense, or rolling when the model's
    ``sliding_window`` is shorter than ``S + _bucketed(max_new_tokens)``;
    "dense" / "rolling" force those; "paged" the serving block-table
    layout with ``page_size``-token pages (the CUDA paged-decode kernel
    on the card). ``cache_dtype``: "auto" (the params' half dtype, else
    bf16 on ``cuda`` and f32 on the CPU), "float32", "bfloat16",
    "float16" or "int8" (per token and kv head scales).

    The caches are sized for the bucketed length, as in the JAX package,
    but the loop stops after the last requested token, where the JAX
    scan runs on to the bucket's end and slices the tail off: the tokens
    are the same, because the tail is causally unreachable.

    ``max_new_tokens`` and ``eos_token_id`` also take per-row [B]
    vectors: row r generates at most max_new_tokens[r] tokens and freezes
    on eos_token_id[r]; past its budget a row emits its eos (or 0 with
    no eos). The result is then [B, S + max(max_new_tokens)].

    Sampling draws Gumbel noise, [B, vocab] a step, from one
    ``torch.Generator`` on the model's device seeded by ``seed``: the
    same seed gives the same tokens (JAX's threefry draws are not
    reproduced)."""
    device = _model_device(model)
    ids = torch.as_tensor(input_ids, device=device)
    if ids.dim() != 2:
        raise ValueError(f"input_ids must be [batch, seq], got shape "
                         f"{tuple(ids.shape)}")
    b, s = ids.shape
    mx = _host(max_new_tokens)
    if mx.ndim > 1 or (mx.ndim == 1 and mx.shape[0] != b):
        raise ValueError(
            f"max_new_tokens must be a scalar or a [batch] vector; got "
            f"shape {mx.shape} for batch {b}")
    eos_np = None if eos_token_id is None else _host(eos_token_id)
    if eos_np is not None and eos_np.ndim > 0 and (
            eos_np.ndim > 1 or eos_np.shape[0] != b):
        raise ValueError(
            f"eos_token_id must be a scalar or a [batch] vector; got "
            f"shape {eos_np.shape} for batch {b}")
    vdt = _resolve_cache_dtype(cache_dtype, model.parameters(), device)
    per_row = mx.ndim == 1 or (eos_np is not None and eos_np.ndim == 1)
    max_req = int(np.max(mx)) if mx.size else 0
    total = s + _bucketed(max_req)
    if max_req <= 0:
        return ids
    if use_cache:
        try:
            use_cache = "kv_caches" in inspect.signature(
                model.forward).parameters
        except (TypeError, ValueError):
            use_cache = False
    dt = ids.dtype
    has_eos = eos_np is not None
    V = model.config.vocab_size
    sampling = bool(temperature) and temperature > 0
    if sampling:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        k_eff = min(int(top_k), V) if top_k else 0
        p_on = bool(top_p) and 0.0 < float(top_p) < 1.0
        temp_v = torch.full((b,), float(temperature), device=device)
        k_v = torch.full((b,), k_eff, dtype=torch.long, device=device)
        p_v = torch.full((b,), float(top_p) if p_on else 0.0,
                         device=device)
    if per_row:
        mx_v = torch.as_tensor(np.broadcast_to(mx, (b,)).astype(np.int64),
                               device=device)
        pad_v = torch.as_tensor(np.broadcast_to(
            eos_np if has_eos else np.zeros((), np.int64), (b,)).astype(
                np.int64), device=device).to(dt)
    elif has_eos:
        pad_v = torch.full((b,), int(eos_np), dtype=dt, device=device)

    def pick(cur, done, g):
        """The next token of each row from its logits ``cur`` [b, V]
        (JAX ``pick_next`` :315 / ``pick_next_rows`` :364); ``g`` is the
        1-based index of the token being generated."""
        if sampling:
            nxt = sample_token_arrays(
                cur, gumbel_noise((b, V), gen, device), temp_v, k_v, p_v,
                use_filters=k_eff > 0 or p_on)
        else:
            nxt = torch.argmax(cur.float(), dim=-1)
        nxt = nxt.to(dt)
        if per_row:
            done = done | (g > mx_v)
        if per_row or has_eos:
            nxt = torch.where(done, pad_v, nxt)
        if has_eos:
            done = done | (nxt == pad_v)
        return nxt, done

    done = torch.zeros((b,), dtype=torch.bool, device=device)
    if not use_cache:
        tokens = torch.zeros((b, total), dtype=dt, device=device)
        tokens[:, :s] = ids
        for i in range(s, s + max_req):
            logits = model(tokens)
            tokens[:, i], done = pick(logits[:, i - 1], done, i - s + 1)
        return tokens[:, :s + max_req].contiguous()

    win = getattr(model.config, "sliding_window", None)
    impl = cache_impl
    if impl not in ("auto", "dense", "rolling", "paged"):
        raise ValueError(f"cache_impl must be 'auto', 'dense', 'rolling' "
                         f"or 'paged', got {cache_impl!r}")
    if impl == "auto":
        impl = "rolling" if win is not None and int(win) < total \
            else "dense"
    elif impl == "rolling" and win is None:
        raise ValueError(
            "cache_impl='rolling' needs the model's sliding_window set "
            "(the rolling buffer holds exactly `window` slots)")
    if impl == "rolling" and int(win) >= total:
        impl = "dense"   # the window covers everything: dense == rolling
    caches = _make_caches(model, impl, b, total, vdt, page_size, device)
    # the step index rides as a device tensor: a Python int would be
    # copied to the card (and synchronised) in every layer of every step
    steps = torch.arange(total, device=device)
    tokens = torch.zeros((b, s + max_req), dtype=dt, device=device)
    tokens[:, :s] = ids
    logits, caches = model(ids, kv_caches=caches, cache_index=steps[0])
    tokens[:, s], done = pick(logits[:, -1], done, 1)
    for i in range(s, s + max_req - 1):
        logits, caches = model(tokens[:, i:i + 1], kv_caches=caches,
                               cache_index=steps[i])
        tokens[:, i + 1], done = pick(logits[:, -1], done, i + 2 - s)
    return tokens


@torch.no_grad()
def _beam_search(model, input_ids, max_new_tokens, num_beams,
                 length_penalty, eos_token_id, cache_dtype):
    """``beam_search``'s decode (JAX :582-648) for ``num_beams`` >= 2:
    (tokens [b, S + max_new_tokens] of the best beam, its
    length-normalised score [b], its generated length [b])."""
    device = _model_device(model)
    ids = torch.as_tensor(input_ids, device=device)
    b, s = ids.shape
    k = int(num_beams)
    total = s + int(max_new_tokens)
    V = model.config.vocab_size
    vdt = _resolve_cache_dtype(cache_dtype, model.parameters(), device)
    caches = _make_caches(model, "dense", b, total, vdt, None, device)
    steps = torch.arange(total, device=device)
    logits, caches = model(ids, kv_caches=caches, cache_index=steps[0])
    lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
    scores, tok0 = _top_k_first(lp, k)                        # [b, k]
    # beams fold into the batch: row r = b_i * k + beam
    tokens = torch.zeros((b * k, total), dtype=ids.dtype, device=device)
    tokens[:, :s] = ids.repeat_interleave(k, dim=0)
    tokens[:, s] = tok0.reshape(-1).to(ids.dtype)
    caches = [tuple(a.repeat_interleave(k, dim=0) for a in c)
              for c in caches]
    scores = scores.reshape(-1)
    if eos_token_id is not None:
        done = tok0.reshape(-1) == eos_token_id
        # finished beams may only extend with eos, at zero cost
        eos_only = torch.full((V,), -1e30, device=device)
        eos_only[eos_token_id] = 0.0
    else:
        done = torch.zeros((b * k,), dtype=torch.bool, device=device)
    # generated length of each beam (stops growing at eos)
    lens = torch.ones((b * k,), dtype=torch.int32, device=device)
    base = torch.arange(b, device=device)[:, None] * k
    for i in range(s, total - 1):
        logits, caches = model(tokens[:, i:i + 1], kv_caches=caches,
                               cache_index=steps[i])
        lp = torch.log_softmax(logits[:, -1].float(), dim=-1)   # [B, V]
        if eos_token_id is not None:
            lp = torch.where(done[:, None], eos_only[None], lp)
        cand = scores.reshape(b, k, 1) + lp.reshape(b, k, V)
        scores, flat = _top_k_first(cand.reshape(b, k * V), k)
        rows = (base + torch.div(flat, V, rounding_mode="floor")).reshape(-1)
        tok = torch.remainder(flat, V).reshape(-1)
        # every tensor of every layer's cache follows its beam (int8
        # values and their scales together); the gather makes new tensors
        tokens, done, lens = tokens[rows], done[rows], lens[rows]
        caches = [tuple(a[rows] for a in c) for c in caches]
        tokens[:, i + 1] = tok.to(tokens.dtype)
        scores = scores.reshape(-1)
        lens = torch.where(done, lens, lens + 1)
        if eos_token_id is not None:
            done = done | (tok == eos_token_id)
    norm = scores / lens.float().pow(float(length_penalty))
    best = torch.argmax(norm.reshape(b, k), dim=-1)
    rows = torch.arange(b, device=device) * k + best
    return tokens[rows], norm[rows], lens[rows]


def beam_search(model, input_ids, max_new_tokens: int, num_beams: int = 4,
                length_penalty: float = 1.0, eos_token_id=None,
                cache_dtype: str = "auto"):
    """Beam-search decode (JAX :545): the k beams fold into the batch
    (B = batch * num_beams rows), every layer's dense cache is reordered
    by a gather of the surviving rows at each step, eos ends a beam
    (finished beams extend only with eos, at zero cost), and the best
    beam of each sequence is picked by ``score / len ** length_penalty``.
    Candidates tied in score go to the lowest (beam, token) index, as
    ``jax.lax.top_k`` orders them. Returns [batch, S + max_new_tokens];
    ``num_beams == 1`` is greedy ``generate``."""
    ids = torch.as_tensor(input_ids, device=_model_device(model))
    if max_new_tokens <= 0:
        return ids
    if int(num_beams) == 1:
        return generate(model, ids, max_new_tokens,
                        eos_token_id=eos_token_id, cache_dtype=cache_dtype)
    return _beam_search(model, ids, max_new_tokens, num_beams,
                        length_penalty, eos_token_id, cache_dtype)[0]
