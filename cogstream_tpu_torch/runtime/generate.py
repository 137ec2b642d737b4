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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models import qwen2
from ..models.qwen2 import KVCache, Qwen2Model
from ..ops.quant import Int4Linear, prepare_matmul, slice_output_channels
from .sampling import apply_repetition_penalty, sample_token

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
    once before the decode loop. A bf16 head gathers its rows; an int4
    head slices its output channels (``slice_output_channels``) and
    prepares that weight once (``prepare_matmul``)."""
    if isinstance(lm_head, Int4Linear):
        return prepare_matmul(slice_output_channels(lm_head.qp(), lid), dtype)
    w = lm_head.weight[lid]
    return lambda h: F.linear(h, w)


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
    """
    B = inputs_embeds.shape[0]
    dev = inputs_embeds.device

    if logit_ids is not None:
        if repetition_penalty != 1.0:
            raise ValueError("logit_ids + repetition_penalty unsupported")
        if vocab_mask is not None:
            raise ValueError("pass either logit_ids or vocab_mask")
        lid = torch.as_tensor(logit_ids, dtype=torch.int64, device=dev)
        head = _sliced_head(model.lm_head, lid, inputs_embeds.dtype)
        head_lora = [({"a": t["lm_head"]["a"], "b": t["lm_head"]["b"][:, lid]},
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
            # W4A8 GEMV (K7)
            return qwen2.lm_logits(model, h, adapters, lora_scale,
                                   w8a8=model.cfg.w4a8_decode)

        def _to_vocab(idx):
            return idx

    # ---- prefill ----------------------------------------------------------
    hidden, cache = qwen2.qwen2_forward(
        model, inputs_embeds, positions, cache, adapters, lora_scale,
        kv_allowed=kv_allowed, kv_window=kv_window)
    rows = torch.arange(B, device=dev)
    last_index = last_index.to(device=dev, dtype=torch.int64)
    logits = _logits(hidden[rows, last_index][:, None])[:, 0]
    use_pen = repetition_penalty != 1.0
    V = logits.shape[-1]
    seen = None
    if use_pen:
        seen = torch.zeros((B, V + 1), dtype=torch.bool, device=dev)
        if penalty_ids is not None:
            ids = penalty_ids.to(device=dev, dtype=torch.int64)
            seen[rows[:, None], torch.where(ids >= 0, ids, V)] = True
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
            lg, generator, temperature, top_p, vocab_mask, top_k=top_k)))

    cur = _sample(logits)
    if use_pen:
        seen[rows, cur] = True
    pos = positions.to(torch.int64)[rows, last_index] + 1
    tokens = torch.full((B, max_new_tokens), eos_id, dtype=torch.int64,
                        device=dev)
    tokens[:, 0] = cur
    done = _finished(cur)

    # generated tokens are always visible to later steps (the JAX side
    # buffer was never masked by kv_allowed)
    if kv_allowed is not None:
        wi = cache.write_index
        kv_allowed = kv_allowed.clone()
        kv_allowed[:, wi:wi + max_new_tokens] = True

    i = 1
    while i < max_new_tokens and not bool(done.all()):
        emb = qwen2.embed(model, cur[:, None])
        step_pos = torch.where(done, torch.full_like(pos, -1), pos)[:, None]
        hidden, cache = qwen2.qwen2_forward(
            model, emb, step_pos, cache, adapters, lora_scale,
            kv_allowed=kv_allowed, kv_window=kv_window)
        logits = _logits(hidden)[:, 0]
        if use_pen:
            logits = apply_repetition_penalty(logits, seen,
                                              repetition_penalty)
        nxt = torch.where(done, torch.full_like(cur, eos_id), _sample(logits))
        if use_pen:
            seen[rows, nxt] = True
        tokens[:, i] = nxt
        done = done | _finished(nxt)
        cur = nxt
        pos = pos + 1
        i += 1

    num = torch.sum(torch.cumsum((tokens == eos_id).to(torch.int32), dim=1)
                    == 0, dim=1) + 1
    num = torch.clamp(num, max=max_new_tokens)
    return GenerateResult(tokens, num, cache)


def decode_new_tokens(tokens, num_tokens, tokenizer, batch_index: int = 0,
                      skip_special_tokens: bool = True) -> str:
    """Host-side: trim at eos and decode."""
    t = torch.as_tensor(tokens)[batch_index].tolist()
    n = int(torch.as_tensor(num_tokens)[batch_index])
    ids = t[:n]
    if ids and ids[-1] == tokenizer.eos_token_id:
        ids = ids[:-1]
    return tokenizer.decode(ids, skip_special_tokens=skip_special_tokens)
