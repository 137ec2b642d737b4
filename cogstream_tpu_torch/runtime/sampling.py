"""Token sampling: greedy, temperature, top-k, top-p, repetition penalty
and a static vocab mask (port of ``cogstream_tpu/runtime/sampling.py``).

Randomness comes from a ``torch.Generator`` (Gumbel-max over the warped
logits, the same distribution as ``jax.random.categorical``; the draws
differ from JAX's, so only greedy decoding is compared token-for-token).

A vocab-sharded decoder (parallel/sharding.py) gives each rank the logits
of its vocab slice (``vocab``: a ``TextShard``). Greedy decoding then
combines the shards' (max, argmax) into the global argmax, ties to the
lowest id as ``torch.argmax`` breaks them; sampling all-gathers the logits
and draws from the same generator state on every rank, so every rank
emits the same token.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import all_gather

NEG_INF = -1e30


def gather_vocab(logits: torch.Tensor, vocab) -> torch.Tensor:
    """The whole-vocab logits from each rank's slice (``vocab`` a
    ``TextShard``, or None for whole logits)."""
    if vocab is None or vocab.vocab is None:
        return logits
    return all_gather(logits, vocab.group, dim=-1)


def vocab_argmax(logits: torch.Tensor, vocab=None) -> torch.Tensor:
    """``argmax`` over the last axis as global vocab ids: over the whole
    logits, or combined from each rank's slice (``vocab``): every rank's
    (max, argmax) is gathered, the largest wins, a tie goes to the lowest
    id (the lowest rank, whose slice comes first)."""
    idx = torch.argmax(logits, dim=-1)
    if vocab is None or vocab.vocab is None:
        return idx
    best = torch.gather(logits, -1, idx[..., None]).to(torch.float32)
    gid = (idx + vocab.vocab[0]).to(torch.float32)[..., None]
    both = all_gather(torch.cat([best, gid], dim=-1)[..., None, :],
                      vocab.group, dim=-2)             # [..., tp, 2]
    win = torch.argmax(both[..., 0], dim=-1)           # first max: lowest
    return torch.gather(both[..., 1], -1, win[..., None])[..., 0].to(
        torch.int64)


def build_vocab_mask(vocab_size: int, allowed_ids, device=None) -> torch.Tensor:
    """Boolean [vocab] mask, True = allowed."""
    mask = torch.zeros((vocab_size,), dtype=torch.bool, device=device)
    mask[torch.as_tensor(list(allowed_ids), dtype=torch.int64,
                         device=device)] = True
    return mask


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor semantics: logits of tokens
    already in the context divide by the penalty when positive and
    multiply when negative."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, pen, logits)


def sample_token(logits: torch.Tensor,            # [B, vocab]
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0,
                 top_p: float = 1.0,
                 vocab_mask: Optional[torch.Tensor] = None,
                 top_k: int = 0, vocab=None) -> torch.Tensor:
    """Next token ids [B] int64. temperature == 0 → greedy. Warper order
    matches HF generate: temperature → top-k → top-p. ``vocab``: the
    logits are this rank's vocab slice of a sharded decoder
    (:func:`vocab_argmax`, :func:`gather_vocab`); ``vocab_mask`` is
    always over the whole vocab."""
    sliced = vocab is not None and vocab.vocab is not None
    if sliced and temperature > 0.0:
        logits, vocab, sliced = gather_vocab(logits, vocab), None, False
    logits = logits.to(torch.float32)
    neg = torch.full_like(logits, NEG_INF)
    if vocab_mask is not None:
        if sliced:
            vocab_mask = vocab_mask[vocab.vocab[0]:vocab.vocab[1]]
        logits = torch.where(vocab_mask[None, :], logits, neg)
    if temperature <= 0.0:
        return vocab_argmax(logits, vocab)
    logits = logits / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, neg)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits >= cutoff, logits, neg)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)
