"""LM attention over the position-tagged KV cache: the wrappers of K3
(prefill) and K4 (decode), both in ``csrc/lm_attention.cu``, and their
plain versions.

Both take two routes on the card, by operand type. bf16 runs the
tensor-core kernels, head dim 64 or 128: K3 ``cs_gqa_prefill_tc``
(counted in ``prefill_flash_attention.tc_launches`` as well as
``.launches``), K4 ``cs_gqa_decode_tc`` (``decode_attention.tc_launches``).
f32 keeps exact f32 products on the CUDA cores, any head dim that is a
multiple of 4 up to 128: K3 ``cs_gqa_prefill_f32``, a register-blocked
f32 tile (each thread 8 x 4 scores by outer products, an O micro-tile in
registers) over blocks of 128 folded rows, or 64 where those would leave
SMs idle (:func:`prefill_f32_rows`); K4 the CUDA-core tile of
``cs_gqa_attention``, then ``cs_gqa_combine`` merges its chunks. A bf16
head dim the tensor-core kernels do not take raises; nothing falls back.

The K/V cache may be in another dtype than q (``kv_dtype``): e4m3 or
e5m2 (the fp8 KV caches) or f16 under either query dtype, f32 under bf16
queries, bf16 under f32 ones. Every route reads the cache's own elements
and converts them to q's compute dtype on chip (the TPU kernels'
``k_ref[0].astype(q.dtype)``): fp8, f16 and bf16 widen exactly, f16 and
f32 under bf16 queries round to nearest even. No converted copy of the
cache is made, so an fp8 cache's K/V bytes read halve against bf16. K4's
tensor-core kernel keeps each kind's own bytes in its tiles and widens
(fp8) or rounds (f16, f32) each MMA fragment in registers just before
its MMA, with warps and split by kind (:func:`decode_plan`); K3's
widens fp8 once a block from byte stages into a bf16 tile and narrows
f16 / f32 as each thread stores its chunks into the bf16 tile
(``csrc/lm_attention.cu``). Under f32 queries K3 lands a cache's bytes a
tile ahead and each thread widens the chunks it copied into the f32
tile; K4 widens each element as it fills its tile. ``.kv_launches`` counts the calls by the
cache's dtype name, ``.fp8_launches`` those over an e4m3 or e5m2 cache.
The plain version converts only the read window it gathers, as the JAX
package's XLA branch does.

K4's bf16 route is one kernel launch per call: no pre-pass (the kernel
reads each key tile's positions itself), no second pass (the last block
merges the splits), no host sync, and no allocation beyond its output —
its split partials and tickets live in a per-device workspace
(:func:`_decode_workspace`) — so a decode step can be captured in a CUDA
graph.

Port of ``cogstream_tpu/ops/lm_attention.py``. All validity is folded
into one int32 per slot (:func:`effective_kv_positions`): the stored
position where the slot is visible, ``SENTINEL`` where it is empty or
masked by ``kv_allowed``. A query at position p sees slot t iff
``p >= eff[t]``; padded queries carry -1 and see nothing.

K4 reads the cache in place: the port writes each decode step's K/V
into the cache before attention (runtime/generate.py), so there is no
side buffer and no separate fresh-K/V stream.

Pooled serving (runtime/pool.py) keeps every session in one row of a
shared ``[B_pool, T, Hkv, D]`` cache. Both wrappers take ``rows``
(:class:`CacheRows`, the JAX kernels' ``rows`` operand): input row b then
reads cache row ``rows[b]``. The kernels move only their K/V base
pointer, so no row is gathered on the card; the plain version gathers.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from . import kernels
from .attention import causal_gqa_attention

SENTINEL = 2 ** 30          # eff position of an invisible KV slot
DECODE_MAX_S = 8            # K4 serves steps of at most this many tokens
DECODE_CHUNK_TILES = 4      # K4 f32 split: 4 x 64 = 256 slots per block
_TILE = 64                  # key tile of the CUDA kernels (common.cuh BK)
TC_HEAD_DIMS = (64, 128)    # head dims of K3's and K4's tensor-core kernels
# K4 tensor-core kernel: m-tiles of 16 folded rows per warp, at most
# (ptxas on sm_90a: <128, 2> 253 registers and <64, 2> 169 without spills;
# <64, 4> spills ~1 KB)
DECODE_TC_MAX_MT = {64: 2, 128: 2}
# K4 tensor-core kernel: warps a block by the cache's K/V code
# (kernels.KV_DTYPE_CODES; csrc dec_warps, which the library's
# cs_decode_tc_warps returns): f32 3, bf16 4, e4m3 8, e5m2 8, f16 4
DECODE_WARPS = {0: 3, 1: 4, 2: 8, 3: 8, 4: 4}
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
_PLAIN_Q_CHUNK = 256        # plain version: query rows per dense block
# K3's f32 tile: rows a block, and the weights of a wave of 128- and
# 64-row blocks (a block's time a wave on the H100: the larger block
# does twice the rows' work with fewer shared-memory loads an FFMA;
# tools/torch_kernel_ab.py times both at the ingest and question
# prefills, PERF.md)
PREFILL_F32_ROWS = (128, 64)
_PREFILL_F32_WAVE = {128: 20, 64: 14}


class CacheRows(NamedTuple):
    """Input row -> cache row map of a pooled call: the indices on the
    host (checked there, so a call never reads them back from the card)
    and their int32 copy on the cache's device, which the kernels read.
    Build it once per forward with :func:`cache_rows`; a CUDA graph
    captures its device pointer."""
    host: Tuple[int, ...]
    dev: torch.Tensor


def cache_rows(rows: Sequence[int], device) -> CacheRows:
    host = tuple(int(r) for r in rows)
    return CacheRows(host, torch.tensor(host, dtype=torch.int32,
                                        device=device))


RowsArg = Optional[Union[CacheRows, Sequence[int]]]


def as_cache_rows(rows: RowsArg, device) -> Optional[CacheRows]:
    """``rows`` as :class:`CacheRows` (a sequence is uploaded once)."""
    if rows is None or isinstance(rows, CacheRows):
        return rows
    return cache_rows(rows, device)


def _check_rows(rows: CacheRows, B: int, B_pool: int) -> None:
    """Host check of a row map: one cache row per input row, unique (two
    input rows never share a cache row), each within [0, B_pool)."""
    if len(rows.host) != B:
        raise ValueError(f"rows has {len(rows.host)} entries for {B} input "
                         "rows")
    if len(set(rows.host)) != B:
        raise ValueError(f"rows {rows.host} are not unique")
    if any(r < 0 or r >= B_pool for r in rows.host):
        raise ValueError(f"rows {rows.host} outside the pool's {B_pool} rows")
    if tuple(rows.dev.shape) != (B,) or rows.dev.dtype != torch.int32:
        raise ValueError("rows.dev must be [B] int32")


def effective_kv_positions(pos: torch.Tensor,
                           allowed: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """[B, T] int32: stored position where the slot is visible, SENTINEL
    where it is empty (pos < 0) or masked by ``allowed``."""
    ok = pos >= 0
    if allowed is not None:
        ok = ok & allowed
    return torch.where(ok, pos, torch.full_like(pos, SENTINEL)).to(
        torch.int32)


def gqa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor, eff_kv_pos: torch.Tensor,
                        scale: Optional[float] = None,
                        rows: RowsArg = None) -> torch.Tensor:
    """Plain version of K3 and K4: dense causal GQA over the first
    ``eff_kv_pos.shape[1]`` slots, in blocks of query rows so the
    [S, T] logits stay bounded at long prefills. With ``rows`` it
    gathers the addressed cache rows first."""
    T = eff_kv_pos.shape[1]
    if rows is not None:
        rows = as_cache_rows(rows, k.device)
        _check_rows(rows, q.shape[0], k.shape[0])
        idx = list(rows.host)
        k, v = k[idx], v[idx]
    # a cache in another dtype: only the gathered read window is converted
    k, v = k[:, :T].to(q.dtype), v[:, :T].to(q.dtype)
    outs = []
    for s0 in range(0, q.shape[1], _PLAIN_Q_CHUNK):
        sl = slice(s0, s0 + _PLAIN_Q_CHUNK)
        outs.append(causal_gqa_attention(
            q[:, sl], k, v, q_positions[:, sl],
            kv_positions=eff_kv_pos, scale=scale))
    return torch.cat(outs, dim=1)


def _check_operands(q, k, v, q_positions, eff_kv_pos,
                    rows: Optional[CacheRows] = None):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    Bk = B
    if rows is not None:
        Bk = k.shape[0]
        _check_rows(rows, B, Bk)
        kernels.require(rows.dev, "rows", dev, torch.int32, (B,))
    kernels.require(q, "q", dev)
    if k.dtype not in kernels.KV_DTYPE_CODES:
        raise TypeError(f"k is {k.dtype}: K3 / K4 take a K/V cache in "
                        f"{', '.join(map(str, kernels.KV_DTYPE_CODES))}")
    kernels.require(k, "k", dev, k.dtype, (Bk, T, Hkv, D))
    kernels.require(v, "v", dev, k.dtype, (Bk, T, Hkv, D))
    kernels.require(q_positions, "q_positions", dev, torch.int32, (B, S))
    kernels.require(eff_kv_pos, "eff_kv_pos", dev, torch.int32)
    if eff_kv_pos.shape[0] != B or eff_kv_pos.shape[1] > T:
        raise ValueError(f"eff_kv_pos {tuple(eff_kv_pos.shape)} does not "
                         f"fit the cache [B={B}, T={T}]")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv}")


def prefill_flash_attention(
    q: torch.Tensor,            # [B, S, Hq, D]
    k: torch.Tensor,            # [B, T, Hkv, D] cache (or new) keys
    v: torch.Tensor,            # [B, T, Hkv, D]
    q_positions: torch.Tensor,  # [B, S] int32, -1 = padding
    eff_kv_pos: torch.Tensor,   # [B, T_read] int32, T_read <= T
    scale: Optional[float] = None,
    rows: RowsArg = None,       # [B] cache row per input row (pooled)
) -> torch.Tensor:
    """K3: causal GQA flash attention over a position-tagged KV region,
    the drop-in for ``causal_gqa_attention`` with validity pre-folded
    into ``eff_kv_pos``. Any T; bf16 (tensor-core tile, head dim 64 or
    128) or f32 queries (the f32 tile, head dim a multiple of 4 up to
    128), k and v (one dtype) in f32, bf16, f16, e4m3 or e5m2. With
    ``rows``, k and v are a [B_pool, T, Hkv, D] pool cache and input row
    b reads its row ``rows[b]``."""
    B, S, Hq, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if kernels.plain_route(q):
        return gqa_attention_plain(q, k, v, q_positions, eff_kv_pos, scale,
                                   rows)
    rows = as_cache_rows(rows, q.device)
    _check_operands(q, k, v, q_positions, eff_kv_pos, rows)
    kernels.dtype_code(q)        # f32 or bf16, else TypeError
    kv_code = kernels.kv_dtype_code(k)
    tc = q.dtype == torch.bfloat16
    if tc and D not in TC_HEAD_DIMS:
        raise ValueError(f"cs_gqa_prefill_tc takes bf16 head dims "
                         f"{TC_HEAD_DIMS}, got {D}")
    T, Hkv = k.shape[1], k.shape[2]
    kv_len = eff_kv_pos.shape[1]
    out = torch.empty_like(q)
    if B * S == 0:
        return out
    n_tiles = -(-kv_len // _TILE)
    # per key tile its smallest and largest eff position ([2, B, n_tiles])
    tile_pos = torch.empty((2, B, n_tiles), dtype=torch.int32,
                           device=q.device)
    lib = kernels.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            eff_kv_pos.data_ptr(), tile_pos.data_ptr(), out.data_ptr())
    rows_ptr = None if rows is None else rows.dev.data_ptr()
    kernels.require_aligned(q, k, v)
    if tc:
        kernels.check(lib.cs_gqa_prefill_tc(
            *ptrs, B, S, Hq, Hkv, D, T, kv_len, float(scale), kv_code,
            rows_ptr, kernels.stream_ptr(q)), "cs_gqa_prefill_tc")
        prefill_flash_attention.tc_launches += 1
    else:
        block_rows = prefill_f32_rows(S * (Hq // Hkv), B, Hkv,
                                      kernels.sm_count(q.device))
        kernels.check(lib.cs_gqa_prefill_f32(
            *ptrs, B, S, Hq, Hkv, D, T, kv_len, block_rows, float(scale),
            kv_code, rows_ptr, kernels.stream_ptr(q)), "cs_gqa_prefill_f32")
    _count(prefill_flash_attention, k.dtype, rows)
    return out


def prefill_f32_rows(R: int, B: int, Hkv: int, sms: int) -> int:
    """Folded rows a block of K3's f32 tile for R = S * G rows per (batch,
    kv head) on ``sms`` SMs (one block an SM): the block size whose
    grid takes the fewest waves, each weighted by a block's time a wave
    (``_PREFILL_F32_WAVE``); a tie goes to 128. A question prefill of a
    few dozen tokens, whose 128-row grid would leave most SMs idle,
    takes 64."""
    def cost(rows):
        blocks = -(-R // rows) * B * Hkv
        return -(-blocks // sms) * _PREFILL_F32_WAVE[rows]
    return min(PREFILL_F32_ROWS, key=cost)


def decode_plan(B: int, Hkv: int, R: int, D: int, kv_len: int, sms: int,
                kv=torch.bfloat16) -> Tuple[int, int, int, int]:
    """Launch plan of K4's tensor-core kernel for R = S * G folded rows
    per kv head over a cache of kind ``kv`` (a torch dtype, or its code in
    ``kernels.KV_DTYPE_CODES``): (m-tiles per warp, row groups, key tiles
    per split, splits). The rows take the fewest m16 tiles (at most
    ``DECODE_TC_MAX_MT[D]`` per block; more rows take more row groups);
    the cache splits so that the blocks about fill the ``sms`` SMs. A
    block has ``DECODE_WARPS[kind]`` warps, each converting its own tiles
    on its chain of latencies, so over every kind but bf16 the split
    rounds up to whole tiles for every warp: the longest warp's chain
    sets the block's time, and fewer splits leave the last block fewer
    partials to merge (f16 on bf16's 4 warps measured 0.93-0.96x its
    time on bf16's split, PERF.md). bf16 keeps the split that fills the
    SMs. K3 has no such plan: the C entry picks its instance (bf16 by
    filling the SMs, the other kinds by weighted waves,
    ``csrc/lm_attention_tc.cuh``)."""
    code = kv if isinstance(kv, int) else kernels.KV_DTYPE_CODES[kv]
    mt = 1
    while mt < DECODE_TC_MAX_MT[D] and 16 * mt < R:
        mt *= 2
    groups = -(-R // (16 * mt))
    n_tiles = -(-kv_len // _TILE)
    per_split = max(1, -(-n_tiles * B * Hkv * groups // sms))
    if code != kernels.KV_DTYPE_CODES[torch.bfloat16]:
        warps = DECODE_WARPS[code]
        per_split = -(-per_split // warps) * warps
    return mt, groups, per_split, -(-n_tiles // per_split)


_decode_ws: dict = {}     # device -> (f32 partials, int32 tickets)
_retired_ws: list = []    # outgrown workspaces, kept for captured graphs


def _decode_workspace(dev: torch.device, n_floats: int,
                      n_tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's split partials and tickets on ``dev``: made at first use with
    the tickets zeroed (the kernel leaves them zero after every launch),
    grown when a larger shape arrives, and otherwise the same tensors on
    every call. An outgrown workspace is kept alive, since a CUDA graph
    captured earlier still launches on its pointers. Calls on one device
    share it, so they must be ordered on one stream."""
    ws = _decode_ws.get(dev)
    if ws is None or ws[0].numel() < n_floats or ws[1].numel() < n_tickets:
        if ws is not None:
            _retired_ws.append(ws)
            n_floats = max(n_floats, ws[0].numel())
            n_tickets = max(n_tickets, ws[1].numel())
        ws = (torch.empty(n_floats, dtype=torch.float32, device=dev),
              torch.zeros(n_tickets, dtype=torch.int32, device=dev))
        _decode_ws[dev] = ws
    return ws


def decode_attention(
    q: torch.Tensor,            # [B, S<=8, Hq, D] this step's queries
    k: torch.Tensor,            # [B, T, Hkv, D] cache, this step written
    v: torch.Tensor,            # [B, T, Hkv, D]
    q_positions: torch.Tensor,  # [B, S] int32, -1 = finished row
    eff_kv_pos: torch.Tensor,   # [B, kv_window] int32
    scale: Optional[float] = None,
    rows: RowsArg = None,       # [B] cache row per input row (pooled)
) -> torch.Tensor:
    """K4: cached decode attention over the first ``kv_window`` slots,
    split over the cache (flash-decoding). bf16 (head dim 64 or 128): one
    launch of the tensor-core kernel, which merges the splits itself; f32:
    the CUDA-core tile, then ``cs_gqa_combine``. k and v as for
    :func:`prefill_flash_attention`, and ``rows``; the split partials and
    tickets stay indexed by the input row."""
    B, S, Hq, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if S > DECODE_MAX_S:
        raise ValueError(f"decode attention takes S <= {DECODE_MAX_S}")
    if kernels.plain_route(q):
        return gqa_attention_plain(q, k, v, q_positions, eff_kv_pos, scale,
                                   rows)
    rows = as_cache_rows(rows, q.device)
    _check_operands(q, k, v, q_positions, eff_kv_pos, rows)
    code, kv_code = kernels.dtype_code(q), kernels.kv_dtype_code(k)
    tc = q.dtype == torch.bfloat16
    if tc and D not in TC_HEAD_DIMS:
        raise ValueError(f"cs_gqa_decode_tc takes bf16 head dims "
                         f"{TC_HEAD_DIMS}, got {D}")
    T, Hkv = k.shape[1], k.shape[2]
    kv_len = eff_kv_pos.shape[1]
    out = torch.empty_like(q)
    if B * S == 0 or kv_len == 0:
        return out.zero_()
    R = S * (Hq // Hkv)
    dev = q.device
    lib = kernels.library()
    stream = kernels.stream_ptr(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            eff_kv_pos.data_ptr())
    rows_ptr = None if rows is None else rows.dev.data_ptr()
    if tc:
        kernels.require_aligned(q, k, v)
        mt, groups, per_split, n_splits = decode_plan(
            B, Hkv, R, D, kv_len, kernels.sm_count(dev), kv_code)
        n_part = B * Hkv * groups * n_splits * 16 * mt   # partial rows
        part, tickets = _decode_workspace(dev, n_part * (2 + D),
                                          B * Hkv * groups)
        ml = part.data_ptr()        # [n_part] (m, l), then [n_part, D] acc
        kernels.check(lib.cs_gqa_decode_tc(
            *ptrs, ml, ml + n_part * 2 * 4, tickets.data_ptr(),
            out.data_ptr(),
            B, S, Hq, Hkv, D, T, kv_len, mt, per_split, n_splits,
            float(scale), kv_code, rows_ptr, stream), "cs_gqa_decode_tc")
        decode_attention.tc_launches += 1
    else:
        n_tiles = -(-kv_len // _TILE)
        n_chunks = -(-n_tiles // DECODE_CHUNK_TILES)
        tile_min = torch.empty((B, n_tiles), dtype=torch.int32, device=dev)
        part_m = torch.empty((B * Hkv, n_chunks, R), dtype=torch.float32,
                             device=dev)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((B * Hkv, n_chunks, R, D), dtype=torch.float32,
                               device=dev)
        kernels.check(lib.cs_gqa_attention(
            *ptrs, tile_min.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), B, S, Hq, Hkv, D, T,
            kv_len, DECODE_CHUNK_TILES, n_chunks, float(scale), code,
            kv_code, rows_ptr, stream), "cs_gqa_attention")
        kernels.check(lib.cs_gqa_combine(
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            out.data_ptr(), B, S, Hq, Hkv, D, n_chunks, code, stream),
            "cs_gqa_combine")
    _count(decode_attention, k.dtype, rows)
    return out


def _count(wrapper, kv_dtype: torch.dtype, rows) -> None:
    """One launch of K3 or K4 (``wrapper``) over a ``kv_dtype`` cache."""
    wrapper.launches += 1
    if rows is not None:
        wrapper.rows_launches += 1
    if kv_dtype in FP8_DTYPES:
        wrapper.fp8_launches += 1
    name = str(kv_dtype).removeprefix("torch.")
    wrapper.kv_launches[name] = wrapper.kv_launches.get(name, 0) + 1


prefill_flash_attention.launches = 0       # every K3 launch
prefill_flash_attention.tc_launches = 0    # those on the tensor-core tile
prefill_flash_attention.rows_launches = 0  # those with a pool row map
prefill_flash_attention.fp8_launches = 0   # those over an e4m3 / e5m2 cache
prefill_flash_attention.kv_launches = {}   # every launch by cache dtype
decode_attention.launches = 0              # every K4 call
decode_attention.tc_launches = 0           # those on the tensor-core kernel
decode_attention.rows_launches = 0         # those with a pool row map
decode_attention.fp8_launches = 0          # those over an e4m3 / e5m2 cache
decode_attention.kv_launches = {}          # every call by cache dtype
