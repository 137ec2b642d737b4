"""Ring (context-parallel) causal attention over a process group — port
of ``cogstream_tpu/ops/ring_attention.py``.

The sequence is split across the ranks of a group (stage 2's ``sp`` axis):
each rank keeps its K/V shard, folds it into a flash-style online-softmax
carry ``(m, l, acc)``, then passes the shards round the ring with
``parallel/mesh.ppermute`` and folds each arrival, ``n - 1`` rotations in
all, so no rank holds the whole sequence's K/V or scores. Each fold runs
in ``kv_chunk`` pieces, live memory O(S_local * kv_chunk). The arithmetic
is ``ops/attention``'s ``gemm_dtype`` rule: bf16 GEMM operands with f32
products and sums, f32 scores, mask and softmax, P cast to the GEMM dtype
before P·V; K/V travel in their own dtype.

Causality is the absolute-position rule (``q_pos >= kv_pos >= 0``), so
the fold is order-independent and shard boundaries need no special case.
Padding (position -1) sees and is seen by nothing, and a fully masked
query gives zeros. JAX pads each shard to a multiple of ``kv_chunk`` and
sends the padding round the ring; here the last chunk is short instead,
which adds exactly nothing to the carry either way. JAX's ``mark_varying``
(a shard_map typing device) has no counterpart. The ring is XLA in the
JAX package, not Pallas, and plain torch here.

Under autograd each rotation's backward is the reverse hop of the
gradients of the K/V it received, so each rank's gradient of its K/V sums
every rank's use of them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import group_size, ppermute
from .attention import NEG_INF, _bmm_f32, _merge_heads, gemm_dtype


def _fold(m, l, acc, qh, q_positions, kh, vh, kv_positions, scale: float,
          kv_chunk: int, dims):
    """Fold one K/V block (``kh`` [B*Hkv, D, T], ``vh`` [B*Hkv, T, D],
    positions [B, T]) into the carry, ``kv_chunk`` slots at a time."""
    B, Hkv, G, S, D = dims
    T = kh.shape[-1]
    for c0 in range(0, T, kv_chunk):
        c1 = min(T, c0 + kv_chunk)
        C = c1 - c0
        s = (_bmm_f32(qh, kh[:, :, c0:c1]) * scale).reshape(B, Hkv, G, S, C)
        pb = kv_positions[:, c0:c1]
        mask = (q_positions[:, :, None] >= pb[:, None, :]) \
            & (pb[:, None, :] >= 0)
        mask5 = mask[:, None, None]
        s = torch.where(mask5, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe_m = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(m_new),
                             m_new)
        p = torch.exp(s - safe_m[..., None])
        p = torch.where(mask5, p, torch.zeros_like(p))
        alpha = torch.exp(torch.where(m <= NEG_INF / 2,
                                      torch.full_like(m, NEG_INF), m - m_new))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha.reshape(B * Hkv, G * S, 1) + _bmm_f32(
            p.to(qh.dtype).reshape(B * Hkv, G * S, C), vh[:, c0:c1])
        m = m_new
    return m, l, acc


def ring_causal_gqa_attention(
    q: torch.Tensor,               # [B, S_local, Hq, D] this rank's shard
    k: torch.Tensor,               # [B, S_local, Hkv, D]
    v: torch.Tensor,               # [B, S_local, Hkv, D]
    q_positions: torch.Tensor,     # [B, S_local] absolute; -1 = padding
    kv_positions: torch.Tensor,    # [B, S_local]
    group,                         # the ring's process group (None: alone)
    scale: Optional[float] = None,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Fold the local K/V shard, then ``n - 1`` ring rotations (each rank
    passes the block it holds to the next rank of ``group``), each folded
    into the online-softmax carry. Returns [B, S_local, Hq, D] in ``q``'s
    dtype; fully masked (padding) queries give zeros. Every rank of
    ``group`` calls it with the same shapes."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / float(D) ** 0.5
    gd = gemm_dtype(q.dtype)
    dims = (B, Hkv, G, S, D)
    qh = q.to(gd).reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4) \
        .reshape(B * Hkv, G * S, D)
    dev = q.device
    m = torch.full((B, Hkv, G, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B * Hkv, G * S, D), dtype=torch.float32, device=dev)
    kv = (k, v, kv_positions.to(torch.int32))
    for i in range(group_size(group)):
        if i:
            kv = ppermute(kv, group)        # K/V in their own dtype
        kb, vb, pb = kv
        T = kb.shape[1]
        kh = kb.to(gd).permute(0, 2, 3, 1).reshape(B * Hkv, D, T)
        vh = vb.to(gd).permute(0, 2, 1, 3).reshape(B * Hkv, T, D)
        m, l, acc = _fold(m, l, acc, qh, q_positions, kh, vh, pb, scale,
                          min(kv_chunk, S), dims)
    out = acc / l.clamp_min(1e-30).reshape(B * Hkv, G * S, 1)
    return _merge_heads(out, B, S, Hkv, G, q.dtype)
