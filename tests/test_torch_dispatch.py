"""Which C entry point each kernel wrapper reaches, checked on the CPU.

The wrappers of K1, K3, K4 and K5 pick their kernel by operand type: bf16
goes to the tensor-core kernels (``cs_vision_attention_tc``,
``cs_gqa_prefill_tc``, ``cs_gqa_decode_tc``, ``cs_segment_attention_tc``),
f32 to the CUDA-core f32 tiles (``cs_vision_attention``,
``cs_gqa_prefill_f32`` with the rows a block of ``prefill_f32_rows``,
decode ``cs_gqa_attention`` then ``cs_gqa_combine``,
``cs_segment_attention``). The stacked int4 GEMVs K8/K9 reach one
``cs_int4_gemv_tc`` call with the split of ``stacked_plan`` and the
per-device workspace; K6 and K10's large bf16 products one
``cs_quant_gemv_sm90`` call with the stream-K grid of ``stream_grid`` and
that workspace (K10's small ones ``cs_int8_gemv``); K7 stays on
``cs_int4_gemv``. Here the kernel
library, the stream, the SM
count and the device route are stubbed, so no card is needed: each test
records the calls a wrapper makes and checks the entry points, the
arguments they get (against the ctypes signatures in ``ops/kernels.py``)
and the launch counters. The kernels' results are checked on the card
(``tests/test_torch_cuda.py``).
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from cogstream_tpu_torch.ops import flash_attention as fa
from cogstream_tpu_torch.ops import kernels
from cogstream_tpu_torch.ops import lm_attention as lma
from cogstream_tpu_torch.ops import quant_gemv as qg


class _Lib:
    """Stands in for the kernel library: records (entry point, args) and
    checks each argument against the entry's ctypes signature."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("cs_"):
            raise AttributeError(name)
        sig = kernels._SIGNATURES[name]

        def entry(*args):
            assert len(args) == len(sig), name
            for a, t in zip(args, sig):
                if t is ctypes.c_void_p:
                    assert a is None or isinstance(a, int), (name, a)
                elif t is ctypes.c_float:
                    assert isinstance(a, float), (name, a)
                else:
                    assert isinstance(a, int) and not isinstance(a, bool), \
                        (name, a)
            self.calls.append((name, args))
            return 0
        return entry

    def names(self):
        return [c[0] for c in self.calls]


@pytest.fixture
def lib(monkeypatch):
    stub = _Lib()
    monkeypatch.setattr(kernels, "library", lambda: stub)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(kernels, "plain_route", lambda t: False)
    monkeypatch.setattr(kernels, "sm_count", lambda dev: 132)
    return stub


def _lm(dtype, B=1, S=20, T=256, D=128, window=None, Hq=28, Hkv=4):
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((B, S, Hq, D)), dtype=dtype)
    k = torch.tensor(rng.standard_normal((B, T, Hkv, D)), dtype=dtype)
    qpos = torch.arange(S, dtype=torch.int32).repeat(B, 1)
    eff = torch.arange(window or T, dtype=torch.int32).repeat(B, 1)
    return q, k, k.clone(), qpos, eff


def _segment(dtype, N=100, H=2, D=72):
    rng = np.random.default_rng(5)
    seg = np.repeat(np.arange(2, dtype=np.int32), N // 2)
    q, k, v = (torch.tensor(rng.standard_normal((N, H, D)), dtype=dtype)
               for _ in range(3))
    ranges = tuple(torch.from_numpy(r) for r in fa.vision_kv_ranges(seg))
    return q, k, v, torch.from_numpy(seg), ranges


def _vision(dtype, N=100, H=2, D=72):
    rng = np.random.default_rng(1)
    seg = np.repeat(np.arange(2, dtype=np.int32), N // 2)
    lo, hi = fa.vision_kv_ranges(seg)
    qkv = torch.tensor(rng.standard_normal((N, 3 * H * D)), dtype=dtype)
    cs = torch.ones((N, D))
    return (qkv, cs, cs, torch.from_numpy(seg), torch.from_numpy(lo),
            torch.from_numpy(hi), H)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,window", [(1, None), (2, 200)])
def test_prefill_bf16_reaches_tensor_core_tile(lib, D, B, window):
    q, k, v, qpos, eff = _lm(torch.bfloat16, B=B, D=D, window=window)
    wrap = lma.prefill_flash_attention
    n0, t0 = wrap.launches, wrap.tc_launches
    out = wrap(q, k, v, qpos, eff)
    assert lib.names() == ["cs_gqa_prefill_tc"]
    args = lib.calls[0][1]
    assert args[6] == out.data_ptr()
    # B, S, Hq, Hkv, D, T_cache, kv_len, then the softmax scale
    assert args[7:14] == (B, 20, 28, 4, D, 256, eff.shape[1])
    assert args[14] == pytest.approx(1 / math.sqrt(D))
    assert (wrap.launches, wrap.tc_launches) == (n0 + 1, t0 + 1)


@pytest.mark.parametrize("D", [128, 64, 16, 72])
@pytest.mark.parametrize("B,window", [(1, None), (2, 200)])
def test_prefill_f32_reaches_cuda_core_tile(lib, B, window, D):
    """f32 prefill: one call of cs_gqa_prefill_f32 (its own pre-pass inside)
    with the pointers, the shape, the rows a block of ``prefill_f32_rows``
    (64 here: 140 folded rows would leave the SMs idle at 128), the scale
    and the cache's K/V code; a tile min / max buffer of [2, B, n_tiles]
    (the pointer checked by size below)."""
    q, k, v, qpos, eff = _lm(torch.float32, B=B, window=window, D=D)
    wrap = lma.prefill_flash_attention
    n0, t0 = wrap.launches, wrap.tc_launches
    out = wrap(q, k, v, qpos, eff)
    assert lib.names() == ["cs_gqa_prefill_f32"]
    args = lib.calls[0][1]
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        qpos.data_ptr(), eff.data_ptr())
    assert isinstance(args[5], int) and args[6] == out.data_ptr()
    # B, S, Hq, Hkv, D, T_cache, kv_len, rows a block
    rows_a_block = lma.prefill_f32_rows(20 * 7, B, 4, 132)
    assert rows_a_block == 64
    assert args[7:15] == (B, 20, 28, 4, D, 256, eff.shape[1], rows_a_block)
    assert args[15] == pytest.approx(1 / math.sqrt(D))
    assert args[16] == kernels.KV_DTYPE_CODES[torch.float32]
    assert args[17] is None
    assert (wrap.launches, wrap.tc_launches) == (n0 + 1, t0)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("S", [1, 9, 32, 100, 1210, 2420, 4384])
@pytest.mark.parametrize("G,Hkv", [(7, 4), (7, 2), (1, 1)])
def test_prefill_f32_rows_cover_every_row(S, G, Hkv, B):
    """The rows a block of K3's f32 tile is one of its two instances, and
    the grid the C entry launches (ceil(R / rows) blocks a batch x kv
    head) covers every folded row with less than one block to spare; the
    7B ingest prefill (4384 tokens, G = 7 over 4 kv heads) takes 128,
    a 32-token question over them 64."""
    R = S * G
    rows = lma.prefill_f32_rows(R, B, Hkv, 132)
    assert rows in lma.PREFILL_F32_ROWS
    grid = -(-R // rows)
    assert grid * rows >= R > (grid - 1) * rows
    if (S, G, Hkv) == (4384, 7, 4):
        assert rows == 128
    if (S, G, Hkv, B) == (32, 7, 4, 1):
        assert rows == 64


@pytest.mark.parametrize("dtype", [torch.float32])
def test_decode_reaches_gqa_attention_and_combine(lib, dtype):
    """f32 decode: the CUDA-core tile's partials, then the combine pass."""
    q, k, v, qpos, eff = _lm(dtype, S=3, T=600, window=520)
    n0 = lma.decode_attention.launches
    t0 = lma.prefill_flash_attention.tc_launches
    d0 = lma.decode_attention.tc_launches
    lma.decode_attention(q, k, v, qpos, eff)
    assert lib.names() == ["cs_gqa_attention", "cs_gqa_combine"]
    args = lib.calls[0][1]
    assert all(isinstance(a, int) for a in args[6:9])   # partials
    n_tiles = -(-520 // 64)
    n_chunks = -(-n_tiles // lma.DECODE_CHUNK_TILES)
    assert args[9:18] == (1, 3, 28, 4, 128, 600, 520,
                          lma.DECODE_CHUNK_TILES, n_chunks)
    assert args[19] == kernels.DTYPE_CODES[dtype]
    assert lib.calls[1][1][4:10] == (1, 3, 28, 4, 128, n_chunks)
    assert lma.decode_attention.launches == n0 + 1
    assert lma.decode_attention.tc_launches == d0
    assert lma.prefill_flash_attention.tc_launches == t0


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,S,T,window", [(1, 1, 600, 520), (1, 3, 600, 520),
                                          (2, 8, 300, 300)])
def test_decode_bf16_reaches_tensor_core_kernel(lib, D, B, S, T, window):
    """bf16 decode: one call of cs_gqa_decode_tc and nothing else (no
    pre-pass, no combine), with the launch plan of ``decode_plan`` and
    the workspace's partials and tickets."""
    q, k, v, qpos, eff = _lm(torch.bfloat16, B=B, S=S, T=T, D=D,
                             window=window)
    n0, d0 = lma.decode_attention.launches, lma.decode_attention.tc_launches
    t0 = lma.prefill_flash_attention.tc_launches
    out = lma.decode_attention(q, k, v, qpos, eff)
    assert lib.names() == ["cs_gqa_decode_tc"]
    args = lib.calls[0][1]
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        qpos.data_ptr(), eff.data_ptr())
    assert args[8] == out.data_ptr()
    assert args[9:16] == (B, S, 28, 4, D, T, window)
    mt, groups, per_split, n_splits = lma.decode_plan(B, 4, S * 7, D,
                                                      window, 132)
    assert args[16:19] == (mt, per_split, n_splits)
    assert args[19] == pytest.approx(1 / math.sqrt(D))
    # the workspace holds every split's partial rows: (m, l), then acc
    part, tickets = lma._decode_ws[q.device]
    rows = B * 4 * groups * n_splits * 16 * mt
    assert args[5] == part.data_ptr()
    assert args[6] == part.data_ptr() + rows * 2 * 4
    assert part.numel() >= rows * (2 + D)
    assert args[7] == tickets.data_ptr()
    assert tickets.numel() >= B * 4 * groups
    assert (lma.decode_attention.launches,
            lma.decode_attention.tc_launches) == (n0 + 1, d0 + 1)
    assert lma.prefill_flash_attention.tc_launches == t0


@pytest.mark.parametrize("kernel,dtype,entry", [
    ("K3", torch.bfloat16, "cs_gqa_prefill_tc"),
    ("K3", torch.float32, "cs_gqa_prefill_f32"),
    ("K4", torch.bfloat16, "cs_gqa_decode_tc"),
    ("K4", torch.float32, "cs_gqa_attention")])
def test_rows_reach_the_entry_point(lib, kernel, dtype, entry):
    """With ``rows`` the wrapper takes a [B_pool, T] cache and passes the
    row map's device pointer (the argument before the stream) to the same
    entry point, counting the call in ``.rows_launches``; without rows it
    passes null. The K4 workspace stays sized by the input rows."""
    S = 20 if kernel == "K3" else 1
    q, k, v, qpos, eff = _lm(dtype, B=2, S=S, T=256)
    pool_k = torch.cat([k, k])                   # 4 pool rows
    wrap = (lma.prefill_flash_attention if kernel == "K3"
            else lma.decode_attention)
    rows = lma.cache_rows([3, 1], q.device)
    r0, n0 = wrap.rows_launches, wrap.launches
    wrap(q, pool_k, pool_k, qpos, eff, rows=rows)
    wrap(q, k, v, qpos, eff)
    assert lib.names()[0] == entry and lib.names()[-1 if kernel == "K3"
                                                   else -2] == entry
    calls = [c for c in lib.calls if c[0] == entry]
    assert calls[0][1][-2] == rows.dev.data_ptr()
    assert calls[1][1][-2] is None
    assert calls[0][1][1] == pool_k.data_ptr()
    assert (wrap.rows_launches, wrap.launches) == (r0 + 1, n0 + 2)
    if entry == "cs_gqa_decode_tc":
        mt, groups, _, n_splits = lma.decode_plan(2, 4, 7, 128, 256, 132)
        part, tickets = lma._decode_ws[q.device]
        assert tickets.numel() >= 2 * 4 * groups


@pytest.mark.parametrize("rows", [None, [3, 1]])
@pytest.mark.parametrize("kernel,dtype,entry,kv_arg", [
    ("K3", torch.bfloat16, "cs_gqa_prefill_tc", 15),
    ("K3", torch.float32, "cs_gqa_prefill_f32", 16),
    ("K4", torch.bfloat16, "cs_gqa_decode_tc", 20),
    ("K4", torch.float32, "cs_gqa_attention", 20)])
def test_fp8_cache_reaches_the_entry_point(lib, kernel, dtype, entry, kv_arg,
                                           rows):
    """An e4m3 cache under a bf16 or f32 query reaches the same entry point
    as the query's own dtype, with the e4m3 K/V code and the cache's own
    K/V pointers (no widened copy), counted in ``.fp8_launches``; a bf16
    cache passes the bf16 code and is not counted there."""
    S = 20 if kernel == "K3" else 1
    B = 2
    q, k, _, qpos, eff = _lm(dtype, B=B, S=S, T=256)
    k8, v8 = k.to(torch.float8_e4m3fn), (-k).to(torch.float8_e4m3fn)
    if rows is not None:
        k8, v8 = torch.cat([k8, k8]), torch.cat([v8, v8])   # 4 pool rows
    wrap = (lma.prefill_flash_attention if kernel == "K3"
            else lma.decode_attention)
    f0, n0 = wrap.fp8_launches, wrap.launches
    wrap(q, k8, v8, qpos, eff, rows=rows)
    call = lib.calls[0]
    assert call[0] == entry
    assert call[1][1:3] == (k8.data_ptr(), v8.data_ptr())
    assert call[1][kv_arg] == kernels.KV_DTYPE_CODES[torch.float8_e4m3fn]
    if entry == "cs_gqa_attention":
        assert call[1][19] == kernels.DTYPE_CODES[torch.float32]
    assert (wrap.fp8_launches, wrap.launches) == (f0 + 1, n0 + 1)
    if entry == "cs_gqa_decode_tc":   # the e4m3 form's launch plan
        mt, _, per_split, n_splits = lma.decode_plan(B, 4, 7, 128, 256, 132,
                                                     torch.float8_e4m3fn)
        assert call[1][16:19] == (mt, per_split, n_splits)
    lib.calls.clear()
    kk = k if rows is None else torch.cat([k, k])
    wrap(q, kk, kk, qpos, eff, rows=rows)
    assert lib.calls[0][1][kv_arg] == kernels.KV_DTYPE_CODES[dtype]
    assert wrap.fp8_launches == f0 + 1
    if entry == "cs_gqa_decode_tc":   # the bf16 form's
        mt, _, per_split, n_splits = lma.decode_plan(B, 4, 7, 128, 256, 132)
        assert lib.calls[0][1][16:19] == (mt, per_split, n_splits)


def test_fp8_cached_decode_forward_passes_the_cache_itself(lib):
    """A bf16 decoder over an e4m3 cache: one decode step's K4 calls get
    each layer's cache slice itself (its data pointer), with the e4m3
    code, and the step's K/V land in the e4m3 cache (layer 0's: the stubbed
    kernels leave the attention output unwritten)."""
    from cogstream_tpu_torch.config import Qwen2Config
    from cogstream_tpu_torch.models import qwen2

    L = 2
    cfg = Qwen2Config(vocab_size=64, hidden_size=256, intermediate_size=64,
                      num_hidden_layers=L, num_attention_heads=4,
                      num_key_value_heads=2, dtype="bfloat16")
    model = qwen2.Qwen2Model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    cache = qwen2.init_kv_cache(cfg, 1, 128, dtype=torch.float8_e4m3fn,
                                device="cpu")
    cache.write_index = 40
    cache.pos[:, :40] = torch.arange(40, dtype=torch.int32)
    emb = torch.randn((1, 1, 256), generator=gen).to(torch.bfloat16)
    qwen2.qwen2_forward(model, emb, torch.full((1, 1), 40), cache)
    assert lib.names() == ["cs_gqa_decode_tc"] * L
    for li, (_, args) in enumerate(lib.calls):
        assert args[1:3] == (cache.k[li].data_ptr(), cache.v[li].data_ptr())
        assert args[20] == kernels.KV_DTYPE_CODES[torch.float8_e4m3fn]
    assert cache.k.dtype == torch.float8_e4m3fn
    assert cache.write_index == 41
    # layer 0's K (written before any stubbed attention output is read)
    written = cache.k[0, 0, 40].float()
    assert torch.isfinite(written).all() and written.abs().sum() > 0


def test_rows_are_checked_on_the_host(lib):
    q, k, v, qpos, eff = _lm(torch.bfloat16, B=2, S=1, T=256)
    pool = torch.cat([k, k])
    for bad in ([1, 1], [0, 4], [2]):
        with pytest.raises(ValueError):
            lma.decode_attention(q, pool, pool, qpos, eff, rows=bad)
    with pytest.raises(ValueError):               # no rows: B must match
        lma.decode_attention(q, pool, pool, qpos, eff)
    assert lib.calls == []


def test_decode_workspace_is_reused(lib, monkeypatch):
    """Two consecutive bf16 decode calls pass the same workspace pointers
    (nothing allocated per call); its tickets start at zero; a larger
    shape grows it and keeps the outgrown one alive."""
    monkeypatch.setattr(lma, "_decode_ws", {})
    monkeypatch.setattr(lma, "_retired_ws", [])
    small = _lm(torch.bfloat16, S=1, T=600, window=520)
    lma.decode_attention(*small)
    lma.decode_attention(*small)
    (_, a), (_, b) = lib.calls
    assert a[5:8] == b[5:8]
    part, tickets = lma._decode_ws[small[0].device]
    assert torch.all(tickets == 0)
    lma.decode_attention(*_lm(torch.bfloat16, B=2, S=8, T=600))
    assert lib.calls[2][1][5:8] != a[5:8]
    assert lma._retired_ws == [(part, tickets)]


def _parent_plan(B, Hkv, R, D, kv_len, sms, kv_bytes):
    """decode_plan as it stood when it chose by element size (1: fp8 rounds
    the split up to whole tiles for 8 warps; else bf16's plan): bf16's,
    e4m3's and e5m2's plans stay these."""
    mt = 1
    while mt < lma.DECODE_TC_MAX_MT[D] and 16 * mt < R:
        mt *= 2
    groups = -(-R // (16 * mt))
    n_tiles = -(-kv_len // 64)
    per_split = max(1, -(-n_tiles * B * Hkv * groups // sms))
    if kv_bytes == 1:
        per_split = -(-per_split // 8) * 8
    return mt, groups, per_split, -(-n_tiles // per_split)


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e4m3fn,
                                torch.float8_e5m2, torch.float16,
                                torch.float32])
@pytest.mark.parametrize("B,Hkv,R,D,kv_len", [
    (1, 4, 7, 128, 9216), (1, 4, 56, 128, 9216), (1, 4, 56, 64, 9216),
    (2, 4, 21, 64, 520), (1, 1, 7, 128, 64), (1, 4, 14, 128, 16384),
    (4, 8, 8, 128, 100)])
def test_decode_plan_covers_rows_and_tiles(B, Hkv, R, D, kv_len, kv):
    """Every folded row sits in one row group, every key tile in one
    split, no split is empty, and the blocks about fill 132 SMs; over
    every other kind than bf16 (fp8 8 warps, f16 4, f32 3) the split is
    the bf16 form's rounded up to a whole tile for each of the block's
    warps, and the rows' plan is the same. The kind is passed as a dtype
    or as its K/V code, to one plan; bf16's, e4m3's and e5m2's plans are
    those of the element-size rule before f16 and f32 had plans of their
    own."""
    code = kernels.KV_DTYPE_CODES[kv]
    mt, groups, per_split, n_splits = lma.decode_plan(B, Hkv, R, D, kv_len,
                                                      132, kv)
    assert lma.decode_plan(B, Hkv, R, D, kv_len, 132, code) == \
        (mt, groups, per_split, n_splits)
    assert mt in (1, 2, 4) and mt <= lma.DECODE_TC_MAX_MT[D]
    assert 16 * mt * groups >= R > 16 * mt * (groups - 1)
    n_tiles = -(-kv_len // 64)
    assert n_splits * per_split >= n_tiles > (n_splits - 1) * per_split
    blocks = B * Hkv * groups * n_splits
    assert blocks <= 132 + B * Hkv * groups
    bf16 = lma.decode_plan(B, Hkv, R, D, kv_len, 132)
    warps = lma.DECODE_WARPS[code]
    if kv != torch.bfloat16:
        assert (mt, groups) == bf16[:2] and per_split % warps == 0
        assert bf16[2] <= per_split < bf16[2] + warps
    else:
        assert (mt, groups, per_split, n_splits) == bf16
        assert per_split == 1 or blocks > 132 // 2
    if kv in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        assert (mt, groups, per_split, n_splits) == _parent_plan(
            B, Hkv, R, D, kv_len, 132, 2 if kv == torch.bfloat16 else 1)


@pytest.mark.parametrize("kv_dtype", [torch.float16, torch.float32])
def test_wide_cache_decode_forward_passes_the_cache_itself(lib, kv_dtype):
    """A bf16 decoder over an f16 or f32 cache: one decode step makes one
    ``cs_gqa_decode_tc`` call a layer, each on that layer's cache slice
    itself (its data pointer: no host-side bf16 copy), with the kind's
    K/V code and the kind's launch plan (``decode_plan`` of the kind), and
    counts the step under the kind in ``.kv_launches``; a ``decode_attention``
    call over that cache passes the same."""
    from cogstream_tpu_torch.config import Qwen2Config
    from cogstream_tpu_torch.models import qwen2

    L = 2
    cfg = Qwen2Config(vocab_size=64, hidden_size=256, intermediate_size=64,
                      num_hidden_layers=L, num_attention_heads=4,
                      num_key_value_heads=2, dtype="bfloat16")
    model = qwen2.Qwen2Model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    cache = qwen2.init_kv_cache(cfg, 1, 128, dtype=kv_dtype, device="cpu")
    cache.write_index = 40
    cache.pos[:, :40] = torch.arange(40, dtype=torch.int32)
    name = str(kv_dtype).removeprefix("torch.")
    wrap = lma.decode_attention
    c0 = wrap.kv_launches.get(name, 0)
    emb = torch.randn((1, 1, 256), generator=gen).to(torch.bfloat16)
    qwen2.qwen2_forward(model, emb, torch.full((1, 1), 40), cache)
    assert lib.names() == ["cs_gqa_decode_tc"] * L
    assert wrap.kv_launches[name] == c0 + L
    code = kernels.KV_DTYPE_CODES[kv_dtype]
    for li, (_, args) in enumerate(lib.calls):
        assert args[1:3] == (cache.k[li].data_ptr(), cache.v[li].data_ptr())
        assert args[20] == code
        B, S, Hq, Hkv, D, T, kv_len = args[9:16]
        mt, _, per_split, n_splits = lma.decode_plan(
            B, Hkv, S * Hq // Hkv, D, kv_len, 132, kv_dtype)
        assert args[16:19] == (mt, per_split, n_splits)
    assert cache.k.dtype == kv_dtype and cache.write_index == 41
    lib.calls.clear()
    q, k, _, qpos, eff = _lm(torch.bfloat16, B=2, S=5, T=600, window=520)
    kc, vc = k.to(kv_dtype), (-k).to(kv_dtype)
    lma.decode_attention(q, kc, vc, qpos, eff)
    (_, args), = lib.calls
    assert args[1:3] == (kc.data_ptr(), vc.data_ptr()) and args[20] == code
    mt, _, per_split, n_splits = lma.decode_plan(2, 4, 35, 128, 520, 132,
                                                 code)
    assert args[16:19] == (mt, per_split, n_splits)


def test_cached_decode_forward_launches_k4_once_per_layer(lib):
    """One bf16 cached decode step of an L-layer decoder (head dim 64)
    makes exactly L K4 calls and no other kernel call: no per-layer
    pre-pass, and no per-forward metadata launch either."""
    from cogstream_tpu_torch.config import Qwen2Config
    from cogstream_tpu_torch.models import qwen2

    L = 3
    cfg = Qwen2Config(vocab_size=64, hidden_size=256, intermediate_size=64,
                      num_hidden_layers=L, num_attention_heads=4,
                      num_key_value_heads=2, dtype="bfloat16")
    assert cfg.head_dim == 64
    model = qwen2.Qwen2Model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    cache = qwen2.init_kv_cache(cfg, 1, 128, device="cpu")
    cache.write_index = 40
    cache.pos[:, :40] = torch.arange(40, dtype=torch.int32)
    n0, d0 = lma.decode_attention.launches, lma.decode_attention.tc_launches
    emb = torch.zeros((1, 1, 256), dtype=torch.bfloat16)
    qwen2.qwen2_forward(model, emb, torch.full((1, 1), 40), cache)
    assert lib.names() == ["cs_gqa_decode_tc"] * L
    assert all(c[1][9:16] == (1, 1, 4, 2, 64, 128, 128) for c in lib.calls)
    assert (lma.decode_attention.launches,
            lma.decode_attention.tc_launches) == (n0 + L, d0 + L)


@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, "cs_segment_attention_tc"),
    (torch.float32, "cs_segment_attention")])
def test_segment_reaches_its_tile(lib, dtype, entry):
    q, k, v, seg, ranges = _segment(dtype)
    wrap = fa.segment_flash_attention
    n0, t0 = wrap.launches, wrap.tc_launches
    with torch.no_grad():
        out = wrap(q, k, v, seg, ranges)
    assert lib.names() == [entry]
    got = lib.calls[0][1]
    assert got[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert got[6] == out.data_ptr()
    # n, heads, d, block_q, scale
    assert got[7:11] == (100, 2, 72, fa.BLOCK_Q)
    assert got[11] == pytest.approx(1 / math.sqrt(72))
    if dtype == torch.float32:
        assert got[12] == kernels.DTYPE_CODES[torch.float32]
    tc = int(dtype == torch.bfloat16)
    assert (wrap.launches, wrap.tc_launches) == (n0 + 1, t0 + tc)


@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, "cs_vision_attention_tc"),
    (torch.float32, "cs_vision_attention")])
def test_vision_reaches_its_tile(lib, dtype, entry):
    args = _vision(dtype)
    wrap = fa.flash_attention_packed_rope_fusedqkv
    n0, t0 = wrap.launches, wrap.tc_launches
    out = wrap(*args)
    assert lib.names() == [entry]
    got = lib.calls[0][1]
    assert got[6] == out.data_ptr()
    # n, heads, d, block_q, scale
    assert got[7:11] == (100, 2, 72, fa.BLOCK_Q)
    assert got[11] == pytest.approx(1 / math.sqrt(72))
    if dtype == torch.float32:
        assert got[12] == kernels.DTYPE_CODES[torch.float32]
    tc = int(dtype == torch.bfloat16)
    assert (wrap.launches, wrap.tc_launches) == (n0 + 1, t0 + tc)


def _wrapper_case(kernel, dtype, D=None):
    """(wrapper, its arguments) of one kernel at a small shape."""
    dims = {} if D is None else {"D": D}
    if kernel == "K3":
        return lma.prefill_flash_attention, _lm(dtype, **dims)
    if kernel == "K4":
        return lma.decode_attention, _lm(dtype, S=3, **dims)
    if kernel == "K5":
        q, k, v, seg, ranges = _segment(dtype, **dims)
        return fa.segment_flash_attention, (q, k, v, seg, ranges)
    return fa.flash_attention_packed_rope_fusedqkv, _vision(dtype, **dims)


@pytest.mark.parametrize("rows", [None, [3, 1]])
@pytest.mark.parametrize("kernel,dtype,entry,kv_arg", [
    ("K3", torch.bfloat16, "cs_gqa_prefill_tc", 15),
    ("K3", torch.float32, "cs_gqa_prefill_f32", 16),
    ("K4", torch.bfloat16, "cs_gqa_decode_tc", 20),
    ("K4", torch.float32, "cs_gqa_attention", 20)])
@pytest.mark.parametrize("kv_dtype", [torch.float8_e5m2, torch.float16,
                                      "other"])
def test_kv_cache_dtype_reaches_the_entry_point(lib, kernel, dtype, entry,
                                                kv_arg, rows, kv_dtype):
    """An e5m2 or f16 cache under either query dtype, and an f32 cache under
    bf16 queries or a bf16 one under f32 ("other"), reach the query dtype's
    entry point with their K/V code (csrc/common.cuh) and the cache's own
    K/V pointers (no converted copy), counted in ``.kv_launches`` under
    the cache's dtype and, for e5m2, in ``.fp8_launches``. K4's launch
    plan is the kind's (``decode_plan(..., kv)``): an e5m2 cache takes
    e4m3's (whole tiles for its 8 warps)."""
    if kv_dtype == "other":
        kv_dtype = torch.float32 if dtype == torch.bfloat16 else \
            torch.bfloat16
    S = 20 if kernel == "K3" else 1
    B = 2
    q, k, _, qpos, eff = _lm(dtype, B=B, S=S, T=256)
    kc, vc = k.to(kv_dtype), (-k).to(kv_dtype)
    if rows is not None:
        kc, vc = torch.cat([kc, kc]), torch.cat([vc, vc])   # 4 pool rows
    wrap = (lma.prefill_flash_attention if kernel == "K3"
            else lma.decode_attention)
    name = str(kv_dtype).removeprefix("torch.")
    f0, n0 = wrap.fp8_launches, wrap.launches
    c0 = wrap.kv_launches.get(name, 0)
    wrap(q, kc, vc, qpos, eff, rows=rows)
    call = lib.calls[0]
    assert call[0] == entry
    assert call[1][1:3] == (kc.data_ptr(), vc.data_ptr())
    assert call[1][kv_arg] == kernels.KV_DTYPE_CODES[kv_dtype]
    assert call[1][kv_arg] == {torch.float32: 0, torch.bfloat16: 1,
                               torch.float8_e5m2: 3,
                               torch.float16: 4}[kv_dtype]
    if entry == "cs_gqa_attention":
        assert call[1][19] == kernels.DTYPE_CODES[torch.float32]
    fp8 = kv_dtype == torch.float8_e5m2
    assert (wrap.fp8_launches, wrap.launches) == (f0 + fp8, n0 + 1)
    assert wrap.kv_launches[name] == c0 + 1
    if entry == "cs_gqa_decode_tc":   # the kind's plan
        mt, _, per_split, n_splits = lma.decode_plan(
            B, 4, 7, 128, 256, 132, kv_dtype)
        assert call[1][16:19] == (mt, per_split, n_splits)
        if fp8:   # e5m2 takes e4m3's
            assert lma.decode_plan(B, 4, 7, 128, 256, 132, kv_dtype) == \
                lma.decode_plan(B, 4, 7, 128, 256, 132, torch.float8_e4m3fn)


@pytest.mark.parametrize("kernel,D", [("K3", 96), ("K3", 32), ("K1", 76),
                                      ("K1", 136), ("K4", 96), ("K4", 32),
                                      ("K5", 76), ("K5", 136)])
def test_unsupported_bf16_head_dim_raises_before_any_call(lib, kernel, D):
    entry = {"K3": "cs_gqa_prefill_tc", "K4": "cs_gqa_decode_tc",
             "K5": "cs_segment_attention_tc",
             "K1": "cs_vision_attention_tc"}[kernel]
    wrap, args = _wrapper_case(kernel, torch.bfloat16, D)
    n0, t0 = wrap.launches, wrap.tc_launches
    with pytest.raises(ValueError, match=entry):
        with torch.no_grad():
            wrap(*args)
    assert lib.calls == []
    assert (wrap.launches, wrap.tc_launches) == (n0, t0)


@pytest.mark.parametrize("kernel,q_dtype,k_dtype,v_dtype,match", [
    pytest.param(k, torch.float16, None, None, "float32 or bfloat16", id=k)
    for k in ("K3", "K1", "K4", "K5")] + [
    # K/V caches K3 / K4 do not take: no float cache dtype (float64, int8),
    # and k / v of mixed dtypes
    pytest.param(k, torch.bfloat16, kd, vd, m, id=f"{k}-{i}")
    for k in ("K3", "K4")
    for i, (kd, vd, m) in enumerate((
        (torch.float64, torch.float64, "float8_e5m2"),
        (torch.float8_e4m3fn, torch.bfloat16, "v is"),
        (torch.bfloat16, torch.float8_e4m3fn, "v is"),
        (torch.int8, torch.int8, "float8_e5m2")))])
def test_other_dtypes_raise_before_any_call(lib, kernel, q_dtype, k_dtype,
                                            v_dtype, match):
    wrap, args = _wrapper_case(kernel, q_dtype)
    if k_dtype is not None:
        q, k, v, qpos, eff = args
        args = (q, k.to(k_dtype), v.to(v_dtype), qpos, eff)
    with pytest.raises(TypeError, match=match):
        with torch.no_grad():
            wrap(*args)
    assert lib.calls == []


# ---------------------------------------------------------------------------
# int4 GEMVs: K8/K9 on the tensor-core kernel, K6/K7 on the CUDA-core one
# ---------------------------------------------------------------------------

def _stacked(m, L=3, half=1792, dout=512, w4a8=False):
    rng = np.random.default_rng(m)
    q4 = torch.tensor(rng.integers(-128, 128, (L, half, dout)),
                      dtype=torch.int8)
    scale = torch.ones((L, dout))
    layer = torch.tensor([L - 1], dtype=torch.int32)
    if w4a8:
        x = torch.tensor(rng.integers(-127, 128, (m, 2 * half)),
                         dtype=torch.int8)
        return qg.gemv_k9, (x, torch.ones((m, 2)), q4, scale, layer)
    x = torch.tensor(rng.standard_normal((m, 2 * half)), dtype=torch.bfloat16)
    return qg.gemv_k8, (x, q4, scale, layer)


@pytest.mark.parametrize("m", [1, 9, 40, 64])
@pytest.mark.parametrize("w4a8", [False, True])
@pytest.mark.parametrize("half,dout", [(1792, 512), (9472, 3584), (256, 128)])
def test_stacked_gemv_is_one_tensor_core_launch(lib, monkeypatch, m, w4a8,
                                                half, dout):
    """K8/K9: one ``cs_int4_gemv_tc`` call per wrapper call (no combine
    pass), with the split of :func:`stacked_plan`; split calls get the
    per-device workspace, sized for their partials, and one ticket per
    128-column tile; a single split gets none."""
    monkeypatch.setattr(qg, "_tc_ws", {})
    wrap, args = _stacked(m, half=half, dout=dout, w4a8=w4a8)
    n0 = wrap.launches
    out = wrap(*args, torch.bfloat16)
    assert lib.names() == ["cs_int4_gemv_tc"]
    a = lib.calls[0][1]
    rows, splits = qg.stacked_plan(m, half, dout, w4a8, 132)
    assert a[3] == half * dout and a[5] == dout and a[7] == out.data_ptr()
    assert a[10:17] == (m, half, dout, rows, splits, 2 if w4a8 else 0,
                        kernels.DTYPE_CODES[torch.bfloat16])
    if splits > 1:
        part, tickets = qg._tc_ws[out.device]
        assert (a[8], a[9]) == (part.data_ptr(), tickets.data_ptr())
        assert part.numel() >= splits * (2 if w4a8 else 1) * m * dout
        assert tickets.numel() >= dout // 128 and not tickets.any()
    else:
        assert (a[8], a[9]) == (None, None)
    assert wrap.launches == n0 + 1 and out.shape == (m, dout)


@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17, 40, 64])
@pytest.mark.parametrize("half,dout", [(1792, 18944), (9472, 3584),
                                       (1792, 512), (128, 128)])
@pytest.mark.parametrize("w4a8", [False, True])
def test_stacked_plan_covers_the_rows(m, half, dout, w4a8):
    """Every split is a whole number of 128-row stages, the splits cover
    the packed rows exactly once (the last may be shorter), and a block's
    staged activations stay inside its shared-memory budget."""
    rows, splits = qg.stacked_plan(m, half, dout, w4a8, 132)
    assert rows % 128 == 0 and rows <= half
    assert splits * rows >= half > (splits - 1) * rows
    xrows = -(-m // 8) * 8
    x_bytes = 2 * xrows * qg._tc_x_stride(rows, w4a8)
    assert rows == 128 or x_bytes <= qg._TC_X_BUDGET


def test_stacked_gemv_workspace_is_reused(lib, monkeypatch):
    """Calls reuse one workspace (no allocation beyond the output); a
    larger call grows it and keeps the outgrown one alive for graphs."""
    monkeypatch.setattr(qg, "_tc_ws", {})
    monkeypatch.setattr(qg, "_retired_tc_ws", [])
    wrap, small = _stacked(1)
    wrap(*small, torch.float32)
    wrap(*small, torch.float32)
    assert lib.calls[0][1][8:10] == lib.calls[1][1][8:10]
    first = qg._tc_ws[small[0].device]
    _, big = _stacked(40)
    wrap(*big, torch.float32)
    assert qg._retired_tc_ws == [first]
    assert lib.calls[2][1][8] != lib.calls[0][1][8]


def test_stacked_gemv_raises_before_any_call(lib):
    """Operands the tensor-core kernel does not take raise before any
    launch: m > 64, a dout off the 128-column tile, a float layer."""
    wrap, (x, q4, scale, layer) = _stacked(65)
    with pytest.raises(ValueError, match="m <= 64"):
        wrap(x, q4, scale, layer, torch.float32)
    wrap, (x, q4, scale, layer) = _stacked(1, dout=136)
    with pytest.raises(ValueError, match="cs_int4_gemv_tc"):
        wrap(x, q4, scale, layer, torch.float32)
    wrap, (x, q4, scale, layer) = _stacked(1)
    with pytest.raises(TypeError, match="layer"):
        wrap(x, q4, scale, layer.float(), torch.float32)
    assert lib.calls == []


@pytest.mark.parametrize("w4a8", [False, True])
def test_2d_gemv_keeps_the_cuda_core_kernel(lib, monkeypatch, w4a8):
    """K7 (the lm_head's 2D weight, int8 activations) stays on the
    CUDA-core ``cs_int4_gemv``; K6 reaches ``cs_quant_gemv_sm90`` as one
    launch: the packed rows as k, the stream-K grid, the codebook only for
    the cubic form, and the per-device workspace with a ticket per tile
    and consumer warpgroup."""
    monkeypatch.setattr(qg, "_tc_ws", {})
    rng = np.random.default_rng(0)
    q4 = torch.tensor(rng.integers(-128, 128, (256, 1024)), dtype=torch.int8)
    scale = torch.ones(1024)
    if w4a8:
        x = torch.tensor(rng.integers(-127, 128, (1, 512)), dtype=torch.int8)
        qg.gemv_k7(x, torch.ones((1, 2)), q4, scale, torch.float32)
        assert lib.names() == ["cs_int4_gemv"]
        return
    x = torch.tensor(rng.standard_normal((1, 512)), dtype=torch.bfloat16)
    n0 = qg.gemv_k6.launches
    code = torch.tensor([1.0, 0.0])
    for cubic in (False, True):
        out = qg.gemv_k6(x, q4, scale, code, cubic, torch.float32)
        a = lib.calls[-1][1]
        grid = qg.stream_grid(*qg.sm90_units(256, 1024), 132)
        assert qg.sm90_units(256, 1024) == (4, 2)
        part, tickets = qg._tc_ws[out.device]
        assert a[1] == q4.data_ptr() and (a[2], a[4], a[5]) == (1, 0, None)
        assert a[6] == (code.data_ptr() if cubic else None)
        assert (a[7], a[8], a[9]) == (out.data_ptr(), part.data_ptr(),
                                      tickets.data_ptr())
        assert a[10:16] == (1, 256, 1024, grid, int(cubic),
                            kernels.DTYPE_CODES[torch.float32])
        assert part.numel() >= qg.sm90_workspace_words(grid, 1)
        assert tickets.numel() >= 2 * 1024 // 128 and not tickets.any()
    assert lib.names() == ["cs_quant_gemv_sm90"] * 2
    assert qg.gemv_k6.launches == n0 + 2


@pytest.mark.parametrize("k,dout", [(1792, 152064), (1792, 76032),
                                    (1792, 38016), (3584, 18944),
                                    (18944, 3584), (9472, 3584), (128, 128),
                                    (256, 1024), (640, 384), (3584, 512)])
@pytest.mark.parametrize("sms", [132, 114, 7, 1])
def test_stream_plan_covers_every_unit_once(k, dout, sms):
    """K6 / K10's stream-K schedule: the grid is at most one block per SM
    (one wave) and at most one block per unit; every (column tile, k
    stage) unit is covered by exactly one block, each block's segments
    are contiguous runs of one tile's stages in tile order, and a block
    splits at most its first and its last tile with other blocks (the two
    partial-sum slots the kernel gives each block). The units cover every
    column and every k: 256-column tiles (a half tile where 256 does not
    divide dout) of 128-row stages (K6: packed rows; K10: k)."""
    n_tiles, n_stages = qg.sm90_units(k, dout)
    assert n_tiles * 256 >= dout > (n_tiles - 1) * 256
    assert n_stages * 128 == k
    grid = qg.stream_grid(n_tiles, n_stages, sms)
    assert 1 <= grid <= min(sms, n_tiles * n_stages)
    seen = {}
    segs = qg.stream_segments(grid, n_tiles, n_stages)
    assert len(segs) == grid
    for b, block in enumerate(segs):
        assert block, "every block has work"
        partial = [i for i, (t, s0, s1) in enumerate(block)
                   if (s0, s1) != (0, n_stages)]
        assert set(partial) <= {0, len(block) - 1}
        for t, s0, s1 in block:
            assert 0 <= t < n_tiles and 0 <= s0 < s1 <= n_stages
            for s in range(s0, s1):
                assert (t, s) not in seen
                seen[(t, s)] = b
        tiles = [t for t, _, _ in block]
        assert tiles == sorted(set(tiles))
    assert len(seen) == n_tiles * n_stages
    # the units per block differ by at most one: every SM streams the
    # same bytes
    sizes = [sum(s1 - s0 for _, s0, s1 in block) for block in segs]
    assert max(sizes) - min(sizes) <= 1


def test_sm90_gemv_workspace_is_reused(lib, monkeypatch):
    """K6 and K10 calls on one device reuse one workspace (no allocation
    beyond the output); a call that needs more partial sums grows it,
    keeping the outgrown one alive for captured graphs."""
    from cogstream_tpu_torch.ops import int8_gemv as ig

    monkeypatch.setattr(qg, "_tc_ws", {})
    monkeypatch.setattr(qg, "_retired_tc_ws", [])
    monkeypatch.setattr(ig, "SM90_MIN_PRODUCT", -1)
    rng = np.random.default_rng(1)
    q4 = torch.tensor(rng.integers(-128, 128, (256, 512)), dtype=torch.int8)
    x = torch.tensor(rng.standard_normal((1, 512)), dtype=torch.bfloat16)
    code = torch.tensor([1.0, 0.0])
    xi, q, scale, layer = _int8(1)
    ig.gemv_k10(xi, q, scale, layer, torch.bfloat16)
    qg.gemv_k6(x, q4, torch.ones(512), code, False, torch.bfloat16)
    qg.gemv_k6(x, q4, torch.ones(512), code, True, torch.bfloat16)
    assert lib.calls[0][1][8:10] == lib.calls[1][1][8:10] == \
        lib.calls[2][1][8:10]
    first = qg._tc_ws[x.device]
    xi, q, scale, layer = _int8(64)
    ig.gemv_k10(xi, q, scale, layer, torch.bfloat16)
    assert qg._retired_tc_ws == [first]
    assert lib.calls[3][1][8] != lib.calls[0][1][8]
    ig.gemv_k10(xi, q, scale, layer, torch.bfloat16)
    assert lib.calls[4][1][8:10] == lib.calls[3][1][8:10]


def _int8(m, L=3, din=1792, dout=512, dtype=torch.bfloat16, stacked=True):
    from cogstream_tpu_torch.ops.quant import column_major

    rng = np.random.default_rng(m)
    shape = (L, din, dout) if stacked else (din, dout)
    q = column_major(torch.tensor(rng.integers(-127, 128, shape),
                                  dtype=torch.int8))
    scale = torch.ones(shape[:-2] + (dout,))
    layer = torch.tensor([L - 1], dtype=torch.int32) if stacked else None
    x = torch.tensor(rng.standard_normal((m, din)), dtype=dtype)
    return x, q, scale, layer


@pytest.mark.parametrize("m", [1, 9, 40, 64])
@pytest.mark.parametrize("din,dout", [(1792, 512), (18944, 3584),
                                      (256, 128)])
@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("sm90", [False, True])
def test_int8_gemv_is_one_tensor_core_launch(lib, monkeypatch, m, din, dout,
                                            stacked, sm90):
    """K10 in bf16: one call per wrapper call, on the kernel
    ``takes_sm90`` picks by the product's size (``sm90`` forces either
    side of its threshold): ``cs_quant_gemv_sm90`` (the INT8 variant, din
    as k, the stream-K grid of ``stream_grid``) or ``cs_int8_gemv`` (K8's
    split model, ``stacked_plan`` at one activation row per weight row),
    both with the shared per-device workspace; the stacked form passes its
    layer pointer, layer count or stride and scale stride, the 2D form
    (the lm_head) no pointer."""
    from cogstream_tpu_torch.ops import int8_gemv as ig

    monkeypatch.setattr(qg, "_tc_ws", {})
    monkeypatch.setattr(ig, "SM90_MIN_PRODUCT", -1 if sm90 else 1 << 62)
    x, q, scale, layer = _int8(m, din=din, dout=dout, stacked=stacked)
    n0, t0 = ig.gemv_k10.launches, ig.gemv_k10.tc_launches
    s0 = ig.gemv_k10.sm90_launches
    out = ig.gemv_k10(x, q, scale, layer, torch.bfloat16)
    a = lib.calls[0][1]
    assert a[0] == x.data_ptr() and a[1] == q.data_ptr()
    if sm90:
        assert lib.names() == ["cs_quant_gemv_sm90"]
        grid = qg.stream_grid(*qg.sm90_units(din, dout), 132)
        assert qg.sm90_units(din, dout) == (-(-dout // 256), din // 128)
        assert a[7] == out.data_ptr() and a[6] is None
        assert (a[2], a[4]) == ((q.shape[0], dout) if stacked else (1, 0))
        assert (a[5] is None) == (not stacked)
        assert a[10:16] == (m, din, dout, grid, qg.INT8,
                            kernels.DTYPE_CODES[torch.bfloat16])
        part, tickets = qg._tc_ws[out.device]
        assert (a[8], a[9]) == (part.data_ptr(), tickets.data_ptr())
        assert part.numel() >= qg.sm90_workspace_words(grid, m)
        assert tickets.numel() >= 2 * dout // 128 and not tickets.any()
    else:
        assert lib.names() == ["cs_int8_gemv"]
        rows, splits = qg.stacked_plan(m, din, dout, False, 132, x_halves=1)
        assert a[6] == out.data_ptr()
        assert (a[2], a[4]) == ((din * dout, dout) if stacked else (0, 0))
        assert (a[5] is None) == (not stacked)
        assert a[9:16] == (m, din, dout, rows, splits,
                           kernels.DTYPE_CODES[torch.bfloat16],
                           kernels.DTYPE_CODES[torch.bfloat16])
        if splits > 1:
            part, tickets = qg._tc_ws[out.device]
            assert (a[7], a[8]) == (part.data_ptr(), tickets.data_ptr())
            assert part.numel() >= splits * m * dout
        else:
            assert (a[7], a[8]) == (None, None)
    assert (ig.gemv_k10.launches, ig.gemv_k10.tc_launches,
            ig.gemv_k10.sm90_launches) == (n0 + 1, t0 + 1, s0 + sm90)


def test_int8_gemv_kernel_by_product_size():
    """``takes_sm90``: a decode step's projections at m = 1 (7B: q / k /
    v / o, gate / up / down) and q / k / v / o at a lookahead verify (m =
    5) stay on the mma.sync kernel; gate / up / down from m = 5 on, q / o
    at m = 64 and the lm_head at m = 1 take the persistent one."""
    from cogstream_tpu_torch.ops import int8_gemv as ig

    for din, dout in ((3584, 3584), (3584, 512), (3584, 18944),
                      (18944, 3584)):
        assert not ig.takes_sm90(1, din, dout)
    for din, dout in ((3584, 3584), (3584, 512)):
        assert not ig.takes_sm90(5, din, dout)
    for din, dout in ((3584, 18944), (18944, 3584)):
        assert ig.takes_sm90(5, din, dout)
    assert ig.takes_sm90(64, 3584, 3584)
    assert ig.takes_sm90(1, 3584, 152064)


def test_int8_gemv_f32_takes_the_cuda_core_route(lib):
    """f32 activations reach the same entry with the f32 code, no split
    and no workspace (the CUDA-core kernel); any din and dout."""
    from cogstream_tpu_torch.ops import int8_gemv as ig

    x, q, scale, layer = _int8(5, din=200, dout=72, dtype=torch.float32)
    t0 = ig.gemv_k10.tc_launches
    ig.gemv_k10(x, q, scale, layer, torch.float32)
    a = lib.calls[0][1]
    assert lib.names() == ["cs_int8_gemv"] and a[7:9] == (None, None)
    assert a[12:16] == (1, 1, 0, 0) and ig.gemv_k10.tc_launches == t0


def test_int8_gemv_raises_before_any_call(lib):
    """Operands K10 does not take raise before any launch: m > 64, a
    bf16 dout off the 128-column tile, a row-major weight, a float layer."""
    from cogstream_tpu_torch.ops import int8_gemv as ig

    x, q, scale, layer = _int8(65)
    with pytest.raises(ValueError, match="m <= 64"):
        ig.gemv_k10(x, q, scale, layer, torch.float32)
    x, q, scale, layer = _int8(1, dout=136)
    with pytest.raises(ValueError, match="multiples of 128"):
        ig.gemv_k10(x, q, scale, layer, torch.float32)
    x, q, scale, layer = _int8(1)
    with pytest.raises(ValueError, match="column-major"):
        ig.gemv_k10(x, q.contiguous(), scale, layer, torch.float32)
    with pytest.raises(TypeError, match="layer"):
        ig.gemv_k10(x, q, scale, layer.float(), torch.float32)
    assert lib.calls == []


def test_int8_route_is_k8s():
    """K10 routes exactly where K8 routes: m <= 64 and shapes that block
    into 128-multiples (``quant_gemv._pick_blocks``); a stacked weight only
    with its layer index."""
    from cogstream_tpu_torch.ops import int8_gemv as ig

    for din in (128, 200, 256, 3584, 18944):
        for dout in (20, 128, 136, 3584, 152064):
            qp = {"q": torch.zeros((din, dout), dtype=torch.int8),
                  "scale": torch.ones(dout)}
            for m in (1, 64, 65):
                want = m <= 64 and din % 128 == 0 and dout % 128 == 0
                assert ig.gemv_viable(qp, m) == want, (din, dout, m)
    st = {"q": torch.zeros((2, 256, 128), dtype=torch.int8),
          "scale": torch.ones((2, 128))}
    assert not ig.gemv_viable(st, 1)
    assert ig.gemv_viable({**st, "layer": torch.zeros(1, dtype=torch.int32)},
                          1)


def _int8_decoder(L=2):
    from cogstream_tpu_torch.config import Qwen2Config
    from cogstream_tpu_torch.models import qwen2
    from cogstream_tpu_torch.ops.quant import quantize_text_

    cfg = Qwen2Config(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=L, num_attention_heads=4,
                      num_key_value_heads=2, dtype="bfloat16")
    model = qwen2.Qwen2Model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return cfg, quantize_text_(model, bits=8)


@pytest.mark.parametrize("S,w8a8_prefill,k10", [
    (1, False, True), (1, True, True), (20, False, True), (20, True, False),
    (70, False, False)])
def test_int8_decoder_routes_k10(lib, monkeypatch, S, w8a8_prefill, k10):
    """A cached forward of an int8 decoder: K10 takes all 7 projections of
    every layer (the stacked store + layer index) where m <= 64, unless
    the JAX gate sends the step to the W8A8 product (w8a8_prefill at
    S >= 16: ``_int_mm``, counted in ``quant.int8_mm.calls``); at m > 64
    the plain form. The lm_head takes K10 at one row."""
    import dataclasses

    from cogstream_tpu_torch.models import qwen2
    from cogstream_tpu_torch.ops import int8_gemv as ig
    from cogstream_tpu_torch.ops import quant

    L = 2
    cfg, model = _int8_decoder(L)
    monkeypatch.setattr(model, "cfg", dataclasses.replace(
        cfg, w8a8_prefill=w8a8_prefill))
    cache = qwen2.init_kv_cache(cfg, 1, 128, device="cpu")
    n0 = ig.gemv_k10.launches
    mm0 = quant.int8_mm.calls.get("decoder", 0)
    emb = torch.zeros((1, S, 256), dtype=torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32)[None]
    h, _ = qwen2.qwen2_forward(model, emb, pos, cache)
    assert lib.names().count("cs_int8_gemv") == (7 * L if k10 else 0)
    assert ig.gemv_k10.launches - n0 == (7 * L if k10 else 0)
    w8 = w8a8_prefill and S >= 16
    assert quant.int8_mm.calls.get("decoder", 0) - mm0 == (7 * L if w8 else 0)
    lib.calls.clear()
    qwen2.lm_logits(model, h[:, -1:])
    assert lib.names() == ["cs_int8_gemv"]
