"""Plain attention oracles (port of ``cogstream_tpu/ops/attention.py``).

* ``segment_attention``: block-diagonal (within-segment) bidirectional
  attention for the vision tower — the oracle of K1. f32 throughout,
  whatever the input dtype, as in JAX.
* ``causal_gqa_attention``: causal grouped-query attention over a
  position-tagged KV region — the training decoder's attention and the
  oracle of K3 and K4. It keeps JAX's ``gemm_dtype`` rule: bf16 / fp16
  inputs stay the GEMM operands with f32 products and sums, the logits,
  softmax and mask are f32, and the probabilities round to the input
  dtype before P·V; f32 inputs compute in f32. Above ``S * T >
  chunk_threshold`` it runs the chunked online softmax
  (:func:`chunked_causal_gqa_attention`), as JAX does.

A fully masked row outputs 0.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def gemm_dtype(dtype: torch.dtype) -> torch.dtype:
    """GEMM operand dtype of the attention products: half-precision
    inputs stay half (f32 accumulation), anything else computes in f32."""
    if dtype in (torch.bfloat16, torch.float16):
        return dtype
    return torch.float32


class _HalfBmmF32(torch.autograd.Function):
    """Half-precision operands, f32 result: ``torch.bmm(a, b,
    out_dtype=torch.float32)``, which has no derivative in PyTorch. The
    backward is JAX's transpose of a dot with ``preferred_element_type``:
    the f32 cotangent meets the other operand (upcast, exact) in an f32
    product, rounded to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` ([N, M, K] x [N, K, P]) as an f32 result from operands of
    ``gemm_dtype``: f32 operands multiply in f32; half operands are GEMM
    operands with f32 products and sums, on the card through the
    half-operand, f32-output product (:class:`_HalfBmmF32`), on the CPU
    (which has no such product) on their f32 upcast, which gives the same
    products exactly."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return _HalfBmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


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


def _heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gd):
    """q [B, S, Hq, D] -> [B*Hkv, G*S, D]; k -> [B*Hkv, D, T]; v ->
    [B*Hkv, T, D], all in ``gd``."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qh = q.to(gd).reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4) \
        .reshape(B * Hkv, G * S, D)
    kh = k.to(gd).permute(0, 2, 3, 1).reshape(B * Hkv, D, T)
    vh = v.to(gd).permute(0, 2, 1, 3).reshape(B * Hkv, T, D)
    return qh, kh, vh


def _merge_heads(o: torch.Tensor, B: int, S: int, Hkv: int, G: int,
                 dtype) -> torch.Tensor:
    """[B*Hkv, G*S, D] f32 -> [B, S, Hq, D] in ``dtype``."""
    D = o.shape[-1]
    return o.reshape(B, Hkv, G, S, D).permute(0, 3, 1, 2, 4) \
        .reshape(B, S, Hkv * G, D).to(dtype)


def causal_gqa_attention(
    q: torch.Tensor,                 # [B, S, Hq, D]
    k: torch.Tensor,                 # [B, T, Hkv, D]
    v: torch.Tensor,                 # [B, T, Hkv, D]
    q_positions: torch.Tensor,       # [B, S] absolute positions (-1 = pad)
    kv_valid: Optional[torch.Tensor] = None,      # [B, T] bool
    kv_positions: Optional[torch.Tensor] = None,  # [B, T]
    scale: Optional[float] = None,
    chunk_threshold: int = 1 << 22,  # S*T above this -> chunked path
) -> torch.Tensor:
    """Causal GQA by absolute positions: query s sees slot t iff
    ``q_pos[s] >= kv_pos[t] >= 0`` (and ``kv_valid[t]``)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if S * T > chunk_threshold:
        return chunked_causal_gqa_attention(
            q, k, v, q_positions, kv_valid, kv_positions, scale)
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / float(D) ** 0.5
    if kv_positions is None:
        kv_positions = q_positions
    gd = gemm_dtype(q.dtype)
    qh, kh, vh = _heads(q, k, v, gd)
    # scale applied to the f32 logits, not the half-precision inputs
    logits = (_bmm_f32(qh, kh) * scale).reshape(B, Hkv, G, S, T)
    mask = ((q_positions[:, :, None] >= kv_positions[:, None, :])
            & (kv_positions[:, None, :] >= 0))
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    # fully masked rows (padded queries) zero out instead of softmax's
    # uniform fallback, as the chunked path's l guard does
    probs = torch.softmax(logits, dim=-1) * mask[:, None, None]
    out = _bmm_f32(probs.to(gd).reshape(B * Hkv, G * S, T), vh)
    return _merge_heads(out, B, S, Hkv, G, q.dtype)


def chunked_causal_gqa_attention(
    q: torch.Tensor,                 # [B, S, Hq, D]
    k: torch.Tensor,                 # [B, T, Hkv, D]
    v: torch.Tensor,                 # [B, T, Hkv, D]
    q_positions: torch.Tensor,       # [B, S]
    kv_valid: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``kv_chunk`` slots,
    carrying (m, l, acc): O(S * kv_chunk) live logits instead of
    O(S * T). JAX's ``lax.scan`` is a loop here; masks, the ``-inf`` guard
    of ``m`` and the ``l`` guard are JAX's."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / float(D) ** 0.5
    if kv_positions is None:
        kv_positions = q_positions
    if kv_valid is None:
        kv_valid = torch.ones((B, T), dtype=torch.bool, device=k.device)
    gd = gemm_dtype(q.dtype)
    qh, kh, vh = _heads(q, k, v, gd)
    dev = q.device
    m = torch.full((B, Hkv, G, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B * Hkv, G * S, D), dtype=torch.float32, device=dev)
    for c0 in range(0, T, kv_chunk):
        c1 = min(T, c0 + kv_chunk)
        C = c1 - c0
        s = (_bmm_f32(qh, kh[:, :, c0:c1]) * scale).reshape(B, Hkv, G, S, C)
        pb = kv_positions[:, c0:c1]
        mask = ((q_positions[:, :, None] >= pb[:, None, :])
                & kv_valid[:, None, c0:c1] & (pb[:, None, :] >= 0))
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
            p.to(gd).reshape(B * Hkv, G * S, C), vh[:, c0:c1])
        m = m_new
    out = acc / l.clamp_min(1e-30).reshape(B * Hkv, G * S, 1)
    return _merge_heads(out, B, S, Hkv, G, q.dtype)
