"""Plain attention oracles (port of ``cogstream_tpu/ops/attention.py``).

* ``segment_attention``: block-diagonal (within-segment) bidirectional
  attention for the vision tower — the oracle of K1.
* ``causal_gqa_attention``: causal grouped-query attention over a
  position-tagged KV region — the oracle of K3 and K4.

Both compute in f32 whatever the input dtype (bf16 products are exact
in f32), and a fully masked row outputs 0.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      segment_ids: torch.Tensor,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: [N, H, D]; segment_ids [N] int32 (-1 = padding)."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    qf = q.to(torch.float32) * scale
    logits = torch.einsum("qhd,khd->hqk", qf, k.to(torch.float32))
    same = ((segment_ids[:, None] == segment_ids[None, :])
            & (segment_ids[:, None] >= 0))
    logits = torch.where(same[None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("hqk,khd->qhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def causal_gqa_attention(
    q: torch.Tensor,                 # [B, S, Hq, D]
    k: torch.Tensor,                 # [B, T, Hkv, D]
    v: torch.Tensor,                 # [B, T, Hkv, D]
    q_positions: torch.Tensor,       # [B, S] absolute positions (-1 = pad)
    kv_valid: Optional[torch.Tensor] = None,      # [B, T] bool
    kv_positions: Optional[torch.Tensor] = None,  # [B, T]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal GQA by absolute positions: query s sees slot t iff
    ``q_pos[s] >= kv_pos[t] >= 0`` (and ``kv_valid[t]``)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / float(D) ** 0.5
    if kv_positions is None:
        kv_positions = q_positions
    qg = q.to(torch.float32).reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bshgd,bthd->bhgst", qg,
                          k.to(torch.float32)) * scale
    mask = ((q_positions[:, :, None] >= kv_positions[:, None, :])
            & (kv_positions[:, None, :] >= 0))
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1) * mask[:, None, None]
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.to(torch.float32))
    return out.reshape(B, S, Hq, D).to(q.dtype)
