"""Vision varlen attention: the wrappers of K1 (``csrc/vision_attention.cu``,
fused 2D RoPE) and K5 (``csrc/segment_attention.cu``, head-major), their
plain versions, and their host metadata.

Port of ``cogstream_tpu/ops/flash_attention.py::
flash_attention_packed_rope_fusedqkv``. The operand is the fused QKV
GEMM output ``[N, 3*H*D]`` itself — no per-head lane padding. The host
metadata replaces ``FlashRanges`` (and its v5e block-size cost model)
with what the CUDA kernel wants: for each 64-token query tile, the
token range ``[kv_lo, kv_hi)`` covering every segment present in the
tile. Segments are contiguous runs (one frame each), so that range is
exactly the keys the tile can see; ragged tiles that straddle frames
mask per token inside the kernel.

K1 takes two routes on the card, by operand type: bf16 runs the
tensor-core tile (``cs_vision_attention_tc``, head dim a multiple of 8 up
to 128, counted in ``flash_attention_packed_rope_fusedqkv.tc_launches``
as well as ``.launches``), f32 the CUDA-core f32 tile
(``cs_vision_attention``). A bf16 head dim the tile does not take
raises; nothing falls back.

K5 is the port of ``segment_flash_attention`` (``_flash_kernel``), the
head-major ``[N, H, D]`` form without RoPE that the tower's head-major
branch runs (the training path's frozen tower). It takes the same
per-tile token ranges as K1 and the same two routes: bf16 runs K1's
tensor-core kernel with the rotation compiled out
(``cs_segment_attention_tc``, same head dims, counted in
``segment_flash_attention.tc_launches``), f32 the CUDA-core f32 tile
(``cs_segment_attention``). ``kv_block_ranges`` and ``FlashRanges``
are byte-for-byte copies of the JAX host metadata (tests pin them);
the CUDA kernel does not read them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import kernels
from .attention import segment_attention
from .rope import apply_vision_rope_cs

BLOCK_Q = 64   # query tile of the CUDA kernels (csrc/common.cuh BR)
TC_MAX_D = 128  # K1's / K5's tensor-core tile: head dim % 8 == 0, <= 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def kv_block_ranges(
    segment_ids: np.ndarray, block_q: int, block_k: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-side: for each query block, the [start, count) of KV blocks
    holding any segment present in the query block.

    Relies on segment ids being a non-decreasing run sequence (frames are
    serialized contiguously by build_vision_metadata); padding id -1 at
    the tail matches nothing and contributes no KV range.
    """
    seg = np.asarray(segment_ids)
    n = seg.shape[0]
    nq = -(-n // block_q)
    starts = np.full((nq,), 0, np.int32)
    counts = np.full((nq,), 0, np.int32)
    for i in range(nq):
        blk = seg[i * block_q:(i + 1) * block_q]
        real = blk[blk >= 0]
        if real.size == 0:
            starts[i] = 0
            counts[i] = 0
            continue
        lo_seg, hi_seg = int(real.min()), int(real.max())
        # tokens of these segments span [first_tok, last_tok]; padding
        # (-1) sorts as +inf so searchsorted sees a non-decreasing array
        real_all = np.where(seg >= 0, seg, np.iinfo(np.int32).max)
        first_tok = int(np.searchsorted(real_all, lo_seg, side="left"))
        last_tok = int(np.searchsorted(real_all, hi_seg, side="right")) - 1
        b0 = first_tok // block_k
        b1 = last_tok // block_k
        starts[i] = b0
        counts[i] = b1 - b0 + 1
    kmax = int(counts.max()) if nq else 1
    return starts, counts, max(kmax, 1)


class FlashRanges:
    """Host-precomputed per-q-block KV ranges (the cu_seqlens analogue).

    Build once per shape bucket with ``FlashRanges.build`` (host numpy);
    ``kv_start``/``kv_count`` become device arrays inside jit, ``kmax``
    stays a static Python int so the grid shape is fixed.
    """

    def __init__(self, kv_start, kv_count,
                 kmax: int, block_q: int, block_k: int, n_padded: int,
                 aligned: bool = False):
        # kv_start/kv_count may be host numpy or traced device arrays
        # (the metadata is host-built; inside jit it arrives as operands)
        self.kv_start = kv_start
        self.kv_count = kv_count
        self.kmax = int(kmax)
        self.block_q = int(block_q)
        self.block_k = int(block_k)
        # True when the block exactly tiles uniform same-length frames:
        # every block is homogeneous (one frame, or all-pad with
        # kv_count 0) and the kernels skip the per-token segment mask
        self.aligned = bool(aligned)
        self.n_padded = int(n_padded)

    @staticmethod
    def build(segment_ids: np.ndarray,
              block_q: Optional[int] = None,
              block_k: Optional[int] = None) -> "FlashRanges":
        """``block_q=None`` picks the block size that minimizes the
        kernel's total grid steps (nq × kmax) over {128..1024}.

        Block granularity is the dominant cost at scale: each grid step
        is one (BQ, BK) tile program, and per-step overhead dwarfs its
        compute at 128² tiles. For uniform 1024-token frames the search
        lands on 1024 — one whole frame per block, kmax=1 — measured
        3.1x faster than 128² blocks (9.4 vs 29.3 ms/layer at 32×1024
        tokens on v5e; also beats an XLA batched-dense reference at
        12.0 ms). VMEM stays comfortable: 3×(1024×128) bf16 blocks +
        1.5 MB f32 scratch ≈ 2.3 MB of ~16 MB."""
        seg = np.asarray(segment_ids, np.int32)
        n = seg.shape[0]
        if block_q is None:
            cands = [128, 256, 512, 1024]
            # UNIFORM-FRAME candidate: when every segment has the same
            # length L (one video's frames always do) and L is a
            # sublane multiple, an L-sized block tiles the frames
            # EXACTLY — kmax=1, zero cross-frame masked work. Matters
            # whenever L is not a power-of-two multiple of 128: the
            # real streaming resize yields e.g. 24x42 = 1008-patch
            # frames (640x360 source under the 64-frame token budget),
            # where the best power-of-two block (1024) straddles
            # frames at kmax=3 — measured 3x the encode time of the
            # aligned block on v5e. 2048 caps the VMEM footprint
            # (~5 MB tiles+scratch of ~16 MB).
            seg_valid = seg[seg >= 0]
            uniform_L = 0
            if seg_valid.size:
                counts = np.bincount(seg_valid - seg_valid.min())
                counts = counts[counts > 0]
                L = int(counts[0])
                if (counts == L).all() and L % 8 == 0 and L <= 2048:
                    uniform_L = L
                    if L not in cands:
                        cands.append(L)
            best = None
            # Per-step cost model: one grid step costs a fixed overhead
            # plus the tile's MACs. The overhead calibrates to ~512x1024
            # MAC-equivalents from two v5e measurements (128² tiles:
            # 29.3 ms/layer at 256 steps; 1024² tiles: 9.4 ms at 32 —
            # the model predicts 2.8x, measured 3.1x). Raw step count
            # alone mis-ranks mixed tile sizes (a few huge straddling
            # tiles beat many exact ones on steps while doing 3x the
            # masked MACs). Ties keep the SMALLER block, whose tiles
            # carry less padding DMA.
            OVERHEAD_MACS = 512 * 1024
            for b in cands:
                n_pad = _round_up(max(n, b), b)
                seg_pad = np.full((n_pad,), -1, np.int32)
                seg_pad[:n] = seg
                ks, kc, kmax = kv_block_ranges(seg_pad, b, b)
                steps = (n_pad // b) * kmax
                score = steps * (b * b + OVERHEAD_MACS)
                if best is None or score < best[0] or \
                        (score == best[0] and b < best[1]):
                    best = (score, b, ks, kc, kmax, n_pad)
            _, b, ks, kc, kmax, n_pad = best
            return FlashRanges(ks, kc, kmax, b, b, n_pad,
                               aligned=(b == uniform_L))
        block_k = block_k or block_q
        n_pad = _round_up(max(n, block_q), max(block_q, block_k))
        seg_pad = np.full((n_pad,), -1, np.int32)
        seg_pad[:n] = seg
        ks, kc, kmax = kv_block_ranges(seg_pad, block_q, block_k)
        return FlashRanges(ks, kc, kmax, block_q, block_k, n_pad)


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
    code = kernels.dtype_code(qkv)
    tc = qkv.dtype == torch.bfloat16
    if tc and (D % 8 or D > TC_MAX_D):
        raise ValueError(f"cs_vision_attention_tc takes bf16 head dims that "
                         f"are multiples of 8 up to {TC_MAX_D}, got {D}")
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
        args = (qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                seg.data_ptr(), kv_lo.data_ptr(), kv_hi.data_ptr(),
                out.data_ptr(), N, heads, D, BLOCK_Q, float(scale))
        if tc:
            kernels.require_aligned(qkv, cos, sin)
            kernels.check(lib.cs_vision_attention_tc(
                *args, kernels.stream_ptr(qkv)), "cs_vision_attention_tc")
            flash_attention_packed_rope_fusedqkv.tc_launches += 1
        else:
            kernels.check(lib.cs_vision_attention(
                *args, code, kernels.stream_ptr(qkv)), "cs_vision_attention")
        flash_attention_packed_rope_fusedqkv.launches += 1
    return out


flash_attention_packed_rope_fusedqkv.launches = 0     # every K1 launch
flash_attention_packed_rope_fusedqkv.tc_launches = 0  # tensor-core tile


# ---------------------------------------------------------------------------
# K5: head-major segment attention
# ---------------------------------------------------------------------------

def segment_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, segment_ids: torch.Tensor,
                                  scale: float) -> torch.Tensor:
    """Plain version of K5: ``segment_attention`` one segment at a time
    (O(sum L_i^2) memory); pad rows (seg -1) output 0, as the kernel's
    do (``segment_attention`` itself averages V uniformly there)."""
    out = torch.zeros_like(q)
    seg_host = segment_ids.cpu().numpy()
    for s in np.unique(seg_host[seg_host >= 0]):
        idx = torch.from_numpy(np.nonzero(seg_host == s)[0]).to(q.device)
        sid = torch.zeros((idx.numel(),), dtype=torch.int32, device=q.device)
        out[idx] = segment_attention(q[idx], k[idx], v[idx], sid, scale)
    return out


def segment_flash_attention(
    q: torch.Tensor,               # [N, H, D]
    k: torch.Tensor,               # [N, H, D]
    v: torch.Tensor,               # [N, H, D]
    segment_ids: torch.Tensor,     # [N] int32, -1 = pad
    ranges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K5: varlen attention over contiguous segments, [N, H, D] in and
    out. ``ranges`` is (kv_lo, kv_hi), :func:`vision_kv_ranges` of the
    segment ids as int32 tensors on q's device; without it they are
    derived on the host from ``segment_ids``. Forward only: neither
    package has a backward for it, so it raises on inputs that require
    grad while grad mode is on."""
    N, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("segment_flash_attention has no backward; run "
                           "it under torch.no_grad()")
    if kernels.plain_route(q):
        return segment_flash_attention_plain(q, k, v, segment_ids, scale)
    tc = q.dtype == torch.bfloat16
    if tc and (D % 8 or D > TC_MAX_D):
        raise ValueError(f"cs_segment_attention_tc takes bf16 head dims "
                         f"that are multiples of 8 up to {TC_MAX_D}, got {D}")
    dev = q.device
    nq = -(-N // BLOCK_Q)
    if ranges is None:
        ranges = tuple(torch.from_numpy(r).to(dev) for r in
                       vision_kv_ranges(segment_ids.cpu().numpy()))
    kv_lo, kv_hi = ranges
    kernels.require(q, "q", dev)
    kernels.require(k, "k", dev, q.dtype, (N, H, D))
    kernels.require(v, "v", dev, q.dtype, (N, H, D))
    kernels.require(segment_ids, "segment_ids", dev, torch.int32, (N,))
    kernels.require(kv_lo, "kv_lo", dev, torch.int32, (nq,))
    kernels.require(kv_hi, "kv_hi", dev, torch.int32, (nq,))
    code = kernels.dtype_code(q)
    out = torch.empty_like(q)
    if N:
        lib = kernels.library()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                segment_ids.data_ptr(), kv_lo.data_ptr(), kv_hi.data_ptr(),
                out.data_ptr(), N, H, D, BLOCK_Q, float(scale))
        if tc:
            kernels.require_aligned(q, k, v)
            kernels.check(lib.cs_segment_attention_tc(
                *args, kernels.stream_ptr(q)), "cs_segment_attention_tc")
            segment_flash_attention.tc_launches += 1
        else:
            kernels.check(lib.cs_segment_attention(
                *args, code, kernels.stream_ptr(q)), "cs_segment_attention")
        segment_flash_attention.launches += 1
    return out


segment_flash_attention.launches = 0      # every K5 launch
segment_flash_attention.tc_launches = 0   # those on the tensor-core tile
