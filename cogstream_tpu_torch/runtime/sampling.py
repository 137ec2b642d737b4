"""Token sampling: greedy, temperature, top-k, top-p, repetition penalty
and a static vocab mask (port of ``cogstream_tpu/runtime/sampling.py``).

Randomness comes from a ``torch.Generator`` (Gumbel-max over the warped
logits, the same distribution as ``jax.random.categorical``; the draws
differ from JAX's, so only greedy decoding is compared token-for-token).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


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
                 top_k: int = 0) -> torch.Tensor:
    """Next token ids [B] int64. temperature == 0 → greedy. Warper order
    matches HF generate: temperature → top-k → top-p."""
    logits = logits.to(torch.float32)
    neg = torch.full_like(logits, NEG_INF)
    if vocab_mask is not None:
        logits = torch.where(vocab_mask[None, :], logits, neg)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
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
