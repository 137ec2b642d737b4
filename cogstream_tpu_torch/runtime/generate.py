"""Prefill + autoregressive decode (port of ``cogstream_tpu/runtime/generate.py``).

The decode loop is a Python loop of single-token forwards. Each step's
K/V is written IN PLACE into the main cache at ``write_index`` and K4
reads the cache directly. The JAX package instead kept generated K/V in
a small side buffer merged once per turn, because XLA rewrote every
scanned cache slice per step; an in-place slice write in PyTorch costs
only the step's own bytes, so the side buffer and its merge are gone.
The resulting cache is the same as the JAX merge's: the prompt's bucket
slots plus one slot per executed decode step, slots beyond untouched.

Prompt lengths are bucketed by callers; padded prompt slots carry
position -1 and are invisible.

Pooled mode (``write_slots``, runtime/pool.py): every row is a session at
its own fill level in a shared cache. The prompt scatters to the row's
slots, and each decode step writes at a per-row device slot that starts
right after the row's last real prompt slot and advances by one per
step; a finished row writes nothing, so the cache equals the JAX side
buffer's per-row merge. ``cache_rows`` addresses a subset of the pool's
rows in place (K3 / K4 ``rows``).

Lookahead (``generate_tokens_lookahead``): prompt-lookup drafts verified
k+1 tokens a forward; the draft and the accept count are worked out on
the host from each verify's argmaxes, one device-to-host copy a step.

On a sharded decoder (``model.tp``) both loops run unchanged on every
rank: the logits are each rank's vocab slice, the greedy token is the
combined global argmax (runtime/sampling.py), so every host decision (the
stop test, lookahead acceptance) reads the same values on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import qwen2
from ..models.qwen2 import KVCache, Qwen2Model
from ..ops.lm_attention import as_cache_rows
from ..ops.quant import QuantLinear, prepare_matmul, slice_output_channels
from ..parallel.mesh import all_reduce
from .sampling import (apply_repetition_penalty, gather_vocab, sample_token,
                       vocab_argmax)

PAD_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def bucket_length(n: int, buckets=PAD_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"sequence length {n} exceeds largest bucket")


class GenerateResult(NamedTuple):
    tokens: torch.Tensor       # [B, max_new_tokens] int64 (eos-padded)
    num_tokens: torch.Tensor   # [B] — tokens generated incl. eos
    cache: KVCache             # the input cache, updated in place


def _sliced_head(lm_head, lid: torch.Tensor, dtype):
    """``h -> h @ W[:, lid]`` for the static ``logit_ids`` support, built
    once before the decode loop. A bf16 head gathers its rows; a quantized
    (int4 or int8) head slices its output channels
    (``slice_output_channels``) and prepares that weight once
    (``prepare_matmul``: a ~20-column slice takes the plain form, decoded
    once, as no GEMV routes it)."""
    if isinstance(lm_head, QuantLinear):
        return prepare_matmul(slice_output_channels(lm_head.qp(), lid), dtype)
    w = lm_head.weight[lid]
    return lambda h: F.linear(h, w)


def _model_sliced_head(model: Qwen2Model, lid: torch.Tensor, dtype):
    """:func:`_sliced_head` of ``model``'s head. A vocab-sharded head
    gathers the columns from the ranks that hold them: each rank fills its
    own ids and zeros elsewhere, and an all-reduce (exact: one term per
    column) gives every rank the whole slice."""
    tp = model.tp
    if tp is None or tp.vocab is None:
        return _sliced_head(model.lm_head, lid, dtype)
    lo, hi = tp.vocab
    cols = torch.nonzero((lid >= lo) & (lid < hi))[:, 0]
    local = (_sliced_head(model.lm_head, lid[cols] - lo, dtype)
             if cols.numel() else None)

    def head(h):
        out = h.new_zeros(h.shape[:-1] + (lid.numel(),))
        if local is not None:
            out[..., cols] = local(h)
        return all_reduce(out, tp.group)
    return head


def _sliced_lora_b(model: Qwen2Model, b: torch.Tensor,
                   lid: torch.Tensor) -> torch.Tensor:
    """An lm_head adapter's ``b`` at the ``logit_ids`` columns. On a
    vocab-sharded head ``b`` holds the rank's vocab slice: each rank fills
    its own ids, and an all-reduce (one term per column) gives every rank
    the whole slice, as :func:`_model_sliced_head`."""
    tp = model.tp
    if tp is None or tp.vocab is None:
        return b[:, lid]
    lo, hi = tp.vocab
    cols = torch.nonzero((lid >= lo) & (lid < hi))[:, 0]
    out = b.new_zeros((b.shape[0], lid.numel()))
    out[:, cols] = b[:, lid[cols] - lo]
    return all_reduce(out, tp.group)


@torch.inference_mode()
def generate_tokens(
    model: Qwen2Model,
    inputs_embeds: torch.Tensor,   # [B, S, H] prompt embeddings (padded)
    positions: torch.Tensor,       # [B, S] int32, -1 on padding
    last_index: torch.Tensor,      # [B] index of the final real prompt token
    cache: KVCache,
    generator: Optional[torch.Generator],
    max_new_tokens: int,
    eos_id: int,
    temperature: float = 0.0,
    top_p: float = 1.0,
    top_k: int = 0,
    repetition_penalty: float = 1.0,
    penalty_ids: Optional[torch.Tensor] = None,   # [B, S] ctx ids (-1 pad)
    vocab_mask: Optional[torch.Tensor] = None,
    adapters=None,
    lora_scale: float = 2.0,
    kv_allowed: Optional[torch.Tensor] = None,    # [B, max_len] bool
    write_slots=None,        # [B, S] host int array: pooled prompt slots
    active=None,             # [B] bool: rows with a real request (pooled)
    cache_rows=None,         # [B] pool row per input row (pooled)
    kv_window: Optional[int] = None,              # read window (slots)
    stop_ids: Optional[tuple] = None,             # grammar-complete ids
    logit_ids: Optional[tuple] = None,            # static sampling support
    extra_eos_ids: Optional[tuple] = None,        # secondary terminators
) -> GenerateResult:
    """Prefill the prompt into ``cache`` at its write index, then decode
    greedily or by sampling until every row emits eos (or a ``stop_ids``
    token) or ``max_new_tokens`` tokens exist.

    ``kv_window`` bounds every read (prefill and decode) to the cache's
    first ``kv_window`` slots; the caller guarantees the prompt and all
    generated tokens land below it. ``logit_ids`` slices the lm_head to a
    static id set once (the selector's ~20 allowed tokens) so no decode
    step reads the full-vocab head; sampling over those columns equals
    sampling over the vocab-masked full logits.

    Pooled mode (``write_slots``, slots >= max_len dropped): each row's
    generated tokens follow its last real prompt slot, ``active=False``
    rows are done from the start, and the terminal token of a row is
    never cached (JAX's fed-token convention). ``cache_rows`` addresses
    those rows of a larger pool cache. The cache's ``write_index`` is
    left as it was.
    """
    B = inputs_embeds.shape[0]
    dev = inputs_embeds.device
    pooled = write_slots is not None
    rows = as_cache_rows(cache_rows, cache.pos.device)
    use_pen = repetition_penalty != 1.0
    # the logits' vocab shard (None: whole logits on every rank)
    vocab = model.tp if logit_ids is None and not use_pen else None

    if logit_ids is not None:
        if repetition_penalty != 1.0:
            raise ValueError("logit_ids + repetition_penalty unsupported")
        if vocab_mask is not None:
            raise ValueError("pass either logit_ids or vocab_mask")
        lid = torch.as_tensor(logit_ids, dtype=torch.int64, device=dev)
        head = _model_sliced_head(model, lid, inputs_embeds.dtype)
        head_lora = [({"a": t["lm_head"]["a"],
                       "b": _sliced_lora_b(model, t["lm_head"]["b"], lid)},
                      g) for t, g in adapters or ()
                     if isinstance(t, dict) and t.get("lm_head") is not None]

        def _logits(h):
            return qwen2.lm_logits(model, h, lora_scale=lora_scale,
                                   head=head, head_lora=head_lora)

        def _to_vocab(idx):
            return lid[idx]
    else:
        def _logits(h):
            # w4a8_decode: an int4 head's per-step vocab read rides the
            # W4A8 GEMV (K7); the penalty needs every rank's vocab
            lg = qwen2.lm_logits(model, h, adapters, lora_scale,
                                 w8a8=model.cfg.w4a8_decode)
            return gather_vocab(lg, model.tp) if use_pen else lg

        def _to_vocab(idx):
            return idx

    # ---- prefill ----------------------------------------------------------
    hidden, cache = qwen2.qwen2_forward(
        model, inputs_embeds, positions, cache, adapters, lora_scale,
        kv_allowed=kv_allowed, kv_window=kv_window, write_slots=write_slots,
        cache_rows=rows)
    batch = torch.arange(B, device=dev)
    last_index = last_index.to(device=dev, dtype=torch.int64)
    logits = _logits(hidden[batch, last_index][:, None])[:, 0]
    V = logits.shape[-1]
    seen = None
    if use_pen:
        seen = torch.zeros((B, V + 1), dtype=torch.bool, device=dev)
        if penalty_ids is not None:
            ids = penalty_ids.to(device=dev, dtype=torch.int64)
            seen[batch[:, None], torch.where(ids >= 0, ids, V)] = True
        seen = seen[:, :V]
        logits = apply_repetition_penalty(logits, seen, repetition_penalty)

    def _map_eos(t):
        # secondary eos ids map to the primary at emission, so every count
        # downstream rides the single `== eos_id` convention
        for s in extra_eos_ids or ():
            t = torch.where(t == s, torch.full_like(t, eos_id), t)
        return t

    def _finished(t):
        d = t == eos_id
        for s in stop_ids or ():
            d = d | (t == s)
        return d

    def _sample(lg):
        return _map_eos(_to_vocab(sample_token(
            lg, generator, temperature, top_p, vocab_mask, top_k=top_k,
            vocab=vocab)))

    cur = _sample(logits)
    if use_pen:
        seen[batch, cur] = True
    pos = positions.to(torch.int64)[batch, last_index] + 1
    tokens = torch.full((B, max_new_tokens), eos_id, dtype=torch.int64,
                        device=dev)
    tokens[:, 0] = cur
    done = _finished(cur)
    if active is not None:
        done = done | ~torch.as_tensor(active, dtype=torch.bool, device=dev)

    slot = None
    if pooled:
        # each row's generated tokens follow its last real prompt slot
        # (positions come from the host in every caller: a small copy)
        ws = np.asarray(write_slots, np.int64)
        real = positions.cpu().numpy() >= 0
        slot0 = np.max(np.where(real, ws, -1), axis=1) + 1
        slot = torch.from_numpy(slot0).to(dev)
    # generated tokens are always visible to later steps (the JAX side
    # buffer was never masked by kv_allowed)
    if kv_allowed is not None:
        if pooled:
            ar = torch.arange(kv_allowed.shape[1], device=dev)[None]
            kv_allowed = kv_allowed | ((ar >= slot[:, None])
                                       & (ar < slot[:, None]
                                          + max_new_tokens))
        else:
            wi = cache.write_index
            kv_allowed = kv_allowed.clone()
            kv_allowed[:, wi:wi + max_new_tokens] = True

    i = 1
    while i < max_new_tokens and not bool(done.all()):
        emb = qwen2.embed(model, cur[:, None])
        step_pos = torch.where(done, torch.full_like(pos, -1), pos)[:, None]
        step_slots = None
        if pooled:
            # a finished row's slot is dropped (nothing written)
            step_slots = torch.where(done, cache.max_len, slot)[:, None]
            slot = slot + 1
        hidden, cache = qwen2.qwen2_forward(
            model, emb, step_pos, cache, adapters, lora_scale,
            kv_allowed=kv_allowed, kv_window=kv_window,
            write_slots=step_slots, cache_rows=rows)
        logits = _logits(hidden)[:, 0]
        if use_pen:
            logits = apply_repetition_penalty(logits, seen,
                                              repetition_penalty)
        nxt = torch.where(done, torch.full_like(cur, eos_id), _sample(logits))
        if use_pen:
            seen[batch, nxt] = True
        tokens[:, i] = nxt
        done = done | _finished(nxt)
        cur = nxt
        pos = pos + 1
        i += 1

    num = torch.sum(torch.cumsum((tokens == eos_id).to(torch.int32), dim=1)
                    == 0, dim=1) + 1
    num = torch.clamp(num, max=max_new_tokens)
    return GenerateResult(tokens, num, cache)


class LookaheadResult(NamedTuple):
    tokens: torch.Tensor       # [1, max_new_tokens] int64 (eos-padded), host
    num_tokens: torch.Tensor   # [1], host
    cache: KVCache             # the input cache, updated in place
    steps: int                 # verify forwards run


def _lookup_draft(hist: np.ndarray, hlen: int, prev: int, cur: int,
                  k: int) -> np.ndarray:
    """The k ids that followed the most recent earlier ``(prev, cur)``
    bigram of the id history, or ``cur`` k times without one. ``hist`` is
    the whole history buffer, stale entries past ``hlen`` included (they
    can be copied, as in JAX); gathers clip to its end and -1 reads 0."""
    L = hist.shape[0]
    idx = np.arange(L - 1)
    m = ((hist[:-1] == prev) & (hist[1:] == cur) & (idx + 1 < hlen)
         & (idx != hlen - 2) & (prev >= 0))
    if not m.any():
        return np.full(k, cur, np.int64)
    j = int(idx[m][-1])
    return np.maximum(hist[np.clip(j + 2 + np.arange(k), 0, L - 1)], 0)


@torch.inference_mode()
def generate_tokens_lookahead(
    model: Qwen2Model,
    inputs_embeds: torch.Tensor,   # [1, S, H] prompt embeddings (padded)
    positions: torch.Tensor,       # [1, S] int32, -1 on padding
    last_index: torch.Tensor,      # [1] index of the final real prompt token
    cache: KVCache,
    prompt_ids,                    # [1, C] ids (-1 pad / media slots)
    max_new_tokens: int,
    eos_id: int,
    lookahead_k: int = 4,
    stop_ids: Optional[tuple] = None,
    adapters=None,
    lora_scale: float = 2.0,
    kv_allowed: Optional[torch.Tensor] = None,    # [1, max_len] bool
    kv_window: Optional[int] = None,              # read window (slots)
    corpus_last=None,              # [1] last real index of prompt_ids
    extra_eos_ids: Optional[tuple] = None,        # secondary terminators
    fixed_draft=None,              # [>= max_new_tokens + k] teacher ids
    fixed_accept: Optional[int] = None,           # exact draft hits a step
) -> LookaheadResult:
    """Greedy decode with prompt-lookup speculative drafting (port of
    ``cogstream_tpu/runtime/generate.py::generate_tokens_lookahead``).

    Each step drafts ``lookahead_k`` ids by matching the last bigram of
    the running id history against its earlier occurrences, then verifies
    ``[cur] + draft`` with one (k+1)-token cached forward (K4 for k+1 <= 8,
    else K3). The k+1 argmaxes come to the host once a step, where the
    accepted count and the next draft are worked out in numpy; the output
    is exactly the vanilla greedy sequence. ``prompt_ids`` is the match
    corpus (``corpus_last`` its last real index, ``last_index`` by
    default); the history buffer mirrors JAX's, stale eos entries past
    its fill level included, so drafts and ``steps`` equal JAX's.

    Rejected slots are reclaimed by rewinding ``cache.write_index``: the
    next verify rewrites every stale slot's position before any layer
    reads it. On exit the cache is left as the vanilla decoder leaves it:
    ``write_index`` after the last fed emission, every position at or
    after it within the read window blanked. ``fixed_draft`` /
    ``fixed_accept`` replace the draft with the teacher's ids, the first
    ``fixed_accept`` of them kept and the rest bit-flipped, so every step
    accepts exactly that many. B = 1, greedy, no repetition penalty;
    ``min(max_len, kv_window)`` must hold S + max_new_tokens + k + 1.
    ``kv_allowed`` goes to every verify unchanged (callers open the
    future slots). Tokens and counts are host tensors.
    """
    B, S, _ = inputs_embeds.shape
    if B != 1:
        raise ValueError("lookahead decode is single-row (B=1)")
    k = int(lookahead_k)
    if k < 1:
        raise ValueError("lookahead_k must be >= 1")
    read = min(cache.max_len, kv_window or cache.max_len)
    need = S + max_new_tokens + k + 1
    if read < need:
        raise ValueError(f"cache window {read} < {need} needed for lookahead"
                         f" (prompt {S} + new {max_new_tokens} + k+1)")
    dev = inputs_embeds.device
    terminals = np.asarray((eos_id,) + tuple(stop_ids or ()), np.int64)

    def _map_eos(t):
        return np.where(np.isin(t, extra_eos_ids or ()), eos_id, t)

    # ---- prefill ----------------------------------------------------------
    hidden, cache = qwen2.qwen2_forward(
        model, inputs_embeds, positions, cache, adapters, lora_scale,
        kv_allowed=kv_allowed, kv_window=kv_window)
    wi_prefill = cache.write_index
    li = int(torch.as_tensor(last_index).reshape(-1)[0])
    logits = qwen2.lm_logits(model, hidden[:, li:li + 1], adapters,
                             lora_scale, w8a8=model.cfg.w4a8_decode)
    first_tok = int(_map_eos(int(vocab_argmax(logits[0, 0], model.tp))))

    ids = np.asarray(torch.as_tensor(prompt_ids).cpu(), np.int64)[0]
    C = ids.shape[0]
    cl = li if corpus_last is None else int(
        torch.as_tensor(corpus_last).reshape(-1)[0])
    L = C + max_new_tokens + k + 1         # id-history buffer
    hist = np.full(L, -1, np.int64)
    hist[:C] = ids
    hist[cl + 1] = first_tok
    buf = max_new_tokens + k + 1           # verify writes may overhang
    tokens = np.full(buf, eos_id, np.int64)
    tokens[0] = first_tok
    teacher = None
    if fixed_draft is not None:
        teacher = np.asarray(torch.as_tensor(fixed_draft).cpu(),
                             np.int64).reshape(-1)

    out_idx, hlen = 1, cl + 2
    prev, cur = int(ids[cl]), first_tok
    pos = int(torch.as_tensor(positions)[0, li]) + 1
    done = first_tok in terminals
    steps = 0
    span = np.arange(k + 1)
    while out_idx < max_new_tokens and not done:
        draft = _lookup_draft(hist, hlen, prev, cur, k)
        if teacher is not None:
            # the teacher's ids (clamped like a dynamic_slice); positions
            # past fixed_accept flip the low bit so verification stops there
            o = min(out_idx, teacher.shape[0] - k)
            tj = teacher[o:o + k]
            draft = np.where(np.arange(k) < int(fixed_accept), tj, tj ^ 1)
        fed = np.concatenate([[cur], draft])
        wi = cache.write_index
        fed_t = torch.from_numpy(fed[None]).to(dev)
        fed_pos = torch.arange(pos, pos + k + 1, dtype=torch.int32,
                               device=dev)[None]
        hidden, cache = qwen2.qwen2_forward(
            model, qwen2.embed(model, fed_t), fed_pos, cache, adapters,
            lora_scale, kv_allowed=kv_allowed, kv_window=kv_window)
        lg = qwen2.lm_logits(model, hidden, adapters, lora_scale,
                             w8a8=model.cfg.w4a8_decode)[0]
        g = _map_eos(vocab_argmax(lg, model.tp).cpu().numpy())  # the sync

        a = int(np.cumprod(fed[1:] == g[:-1]).sum())
        fin = np.isin(g, terminals)
        prior_fin = (np.cumsum(fin) - fin) > 0
        valid = (span <= a) & ~prior_fin
        n_emit = int(valid.sum())
        emit = np.where(valid, g, eos_id)
        tokens[out_idx:out_idx + k + 1] = emit
        hist[hlen:hlen + k + 1] = emit
        done = bool((fin & valid).any())
        # the next write starts right after the 1 + a accepted tokens
        cache.write_index = wi + 1 + a
        out_idx += n_emit
        hlen += n_emit
        prev, cur = int(fed[a]), int(g[a])
        pos += a + 1
        steps += 1

    # exit normalization: prompt + the emissions before the first terminal
    # stay live, as after the vanilla loop (which never feeds a terminal)
    out = tokens[:max_new_tokens]
    num = min(int((np.cumsum(out == eos_id) == 0).sum()) + 1, max_new_tokens)
    fin_out = np.isin(out, terminals)
    wi_final = wi_prefill + (int(np.argmax(fin_out)) if fin_out.any()
                             else num - 1)
    cache.pos[:, wi_final:read] = -1
    cache.write_index = wi_final
    return LookaheadResult(torch.from_numpy(out[None].copy()),
                           torch.tensor([num]), cache, steps)


def decode_new_tokens(tokens, num_tokens, tokenizer, batch_index: int = 0,
                      skip_special_tokens: bool = True) -> str:
    """Host-side: trim at eos and decode."""
    t = torch.as_tensor(tokens)[batch_index].tolist()
    n = int(torch.as_tensor(num_tokens)[batch_index])
    ids = t[:n]
    if ids and ids[-1] == tokenizer.eos_token_id:
        ids = ids[:-1]
    return tokenizer.decode(ids, skip_special_tokens=skip_special_tokens)
