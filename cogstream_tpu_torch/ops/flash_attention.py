"""Vision varlen attention with fused 2D RoPE: the wrapper of K1
(``csrc/vision_attention.cu``), its plain version, and its host metadata.

Port of ``cogstream_tpu/ops/flash_attention.py::
flash_attention_packed_rope_fusedqkv``. The operand is the fused QKV
GEMM output ``[N, 3*H*D]`` itself — no per-head lane padding. The host
metadata replaces ``FlashRanges`` (and its v5e block-size cost model)
with what the CUDA kernel wants: for each 64-token query tile, the
token range ``[kv_lo, kv_hi)`` covering every segment present in the
tile. Segments are contiguous runs (one frame each), so that range is
exactly the keys the tile can see; ragged tiles that straddle frames
mask per token inside the kernel.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from . import kernels
from .attention import segment_attention
from .rope import apply_vision_rope_cs

BLOCK_Q = 64   # query tile of the CUDA kernel (csrc/common.cuh BR)


def vision_kv_ranges(segment_ids: np.ndarray,
                     block_q: int = BLOCK_Q) -> Tuple[np.ndarray, np.ndarray]:
    """Host: per query tile, the token range [lo, hi) of the segments it
    holds ([0, 0) for an all-pad tile). Segment ids must be
    non-decreasing runs with -1 padding only at the tail."""
    seg = np.asarray(segment_ids, np.int64)
    n = seg.shape[0]
    nq = -(-n // block_q)
    lo = np.zeros((nq,), np.int32)
    hi = np.zeros((nq,), np.int32)
    real = seg[seg >= 0]
    if real.size == 0:
        return lo, hi
    if np.any(np.diff(real) < 0) or np.any(seg[:real.size] < 0):
        raise ValueError("segment ids must be contiguous non-decreasing "
                         "runs with padding (-1) at the tail")
    n_seg = int(real.max()) + 1
    first = np.full((n_seg,), n, np.int64)
    last = np.full((n_seg,), -1, np.int64)
    idx = np.arange(real.size)
    np.minimum.at(first, real, idx)
    np.maximum.at(last, real, idx)
    for i in range(nq):
        blk = seg[i * block_q:(i + 1) * block_q]
        blk = blk[blk >= 0]
        if blk.size:
            lo[i] = first[blk.min()]
            hi[i] = last[blk.max()] + 1
    return lo, hi


def flash_attention_packed_rope_plain(
    qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    seg: torch.Tensor, heads: int, scale: float,
) -> torch.Tensor:
    """Plain version of K1: split the fused QKV, rotate q/k (f32, cast
    back), then segment attention one segment at a time (a segment's
    tokens never see another's, and the per-segment form keeps memory at
    O(sum L_i^2) instead of O(N^2)). Pad rows (seg -1) output 0."""
    N = qkv.shape[0]
    D = qkv.shape[1] // (3 * heads)
    q, k, v = qkv.reshape(N, 3, heads, D).unbind(1)
    cos2, sin2 = cos[:, None, :], sin[:, None, :]
    q = apply_vision_rope_cs(q, cos2, sin2)
    k = apply_vision_rope_cs(k, cos2, sin2)
    out = torch.zeros((N, heads, D), dtype=qkv.dtype, device=qkv.device)
    seg_host = seg.cpu().numpy()
    for s in np.unique(seg_host[seg_host >= 0]):
        idx = torch.from_numpy(np.nonzero(seg_host == s)[0]).to(qkv.device)
        sid = torch.zeros((idx.numel(),), dtype=torch.int32,
                          device=qkv.device)
        out[idx] = segment_attention(q[idx], k[idx], v[idx], sid, scale)
    return out.reshape(N, heads * D)


def flash_attention_packed_rope_fusedqkv(
    qkv: torch.Tensor,            # [N, 3*H*D] fused GEMM output
    cos: torch.Tensor,            # [N, D] f32 per-token rope terms
    sin: torch.Tensor,            # [N, D] f32
    seg: torch.Tensor,            # [N] int32, -1 = pad
    kv_lo: torch.Tensor,          # [ceil(N/64)] int32 (vision_kv_ranges)
    kv_hi: torch.Tensor,          # [ceil(N/64)] int32
    heads: int,
    scale: float = None,
) -> torch.Tensor:
    """Segment attention with 2D RoPE fused in; returns [N, H*D]."""
    N = qkv.shape[0]
    D = qkv.shape[1] // (3 * heads)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if kernels.plain_route(qkv):
        return flash_attention_packed_rope_plain(qkv, cos, sin, seg, heads,
                                                 scale)
    if qkv.shape[1] != 3 * heads * D:
        raise ValueError(f"qkv width {qkv.shape[1]} is not 3*{heads}*D")
    dev = qkv.device
    nq = -(-N // BLOCK_Q)
    kernels.require(qkv, "qkv", dev)
    kernels.require(cos, "cos", dev, torch.float32, (N, D))
    kernels.require(sin, "sin", dev, torch.float32, (N, D))
    kernels.require(seg, "seg", dev, torch.int32, (N,))
    kernels.require(kv_lo, "kv_lo", dev, torch.int32, (nq,))
    kernels.require(kv_hi, "kv_hi", dev, torch.int32, (nq,))
    out = torch.empty((N, heads * D), dtype=qkv.dtype, device=dev)
    if N:
        lib = kernels.library()
        kernels.check(lib.cs_vision_attention(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), seg.data_ptr(),
            kv_lo.data_ptr(), kv_hi.data_ptr(), out.data_ptr(), N, heads, D,
            BLOCK_Q, float(scale), kernels.dtype_code(qkv),
            kernels.stream_ptr(qkv)), "cs_vision_attention")
        flash_attention_packed_rope_fusedqkv.launches += 1
    return out


flash_attention_packed_rope_fusedqkv.launches = 0
