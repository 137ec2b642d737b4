"""The port's CUDA kernels (K1-K10) against their plain PyTorch versions,
on the card: the bf16 tensor-core kernels of K1, K3, K4 and K5 and the
f32 CUDA-core tiles beside them; K3 and K4 reading a pool cache through
``rows``; a tiny pool card against CPU; the int4 GEMVs K6-K9 (K6 and K10 in bf16 on one persistent kernel, their
repeats and graph replays), the int8 GEMV K10 and the W8A8 product's ``torch._int_mm`` at few rows, and a row shard's f32-summed product under autograd. Marked ``cuda``: without a CUDA device every test skips.

On a machine with a card (and no JAX, so the repo's conftest cannot be
imported there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs are seeded numpy draws; each comparison is in float32 for the f32
kernels and in bf16 for the bf16 ones, with the tolerance stated where
it is asserted.
"""

import gc

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=torch.float32):
    return torch.as_tensor(a).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("N,H", [(37, 1152), (512, 128), (8, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_kernel(dev, N, H, dtype):
    from cogstream_tpu_torch.ops.layernorm import layernorm, layernorm_plain

    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((N, H)) * 3 + 1, dev, dtype)
    sc = _t(rng.standard_normal(H), dev)
    b = _t(rng.standard_normal(H), dev)
    got = layernorm(x, sc, b, 1e-6).float()
    ref = layernorm_plain(x, sc, b, 1e-6).float()
    # f32: summation order only; bf16: one output rounding (2^-8 rel)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("lengths,pad,D", [
    ((64, 64), 0, 72), ((50, 77, 13), 20, 72), ((130,), 0, 72),
    ((1008, 1008, 1008), 60, 72), ((300, 200), 12, 40),
    ((300, 200), 12, 64), ((300, 200), 12, 128), ((300, 200), 12, 16),
    ((1008, 1008), 24, 128), ((1008, 1008), 24, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vision_attention_kernel(dev, lengths, pad, D, dtype):
    """K1 against its plain version: bf16 on the tensor-core tile (frames
    of 1008 straddle its 256-row blocks; D = 72 and 40 pad the Q.K^T
    depth to 80 and 48), f32 on the register-blocked f32 tile (frames of
    1008 straddle its 128-row blocks, 64-row ones at D = 128; D = 72, 40
    and 16 pad its head dim to 80, 64 and 32); pad rows exactly 0."""
    from cogstream_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(1)
    H = 3
    seg = np.concatenate([np.full(L, i, np.int32)
                          for i, L in enumerate(lengths)]
                         + [np.full(pad, -1, np.int32)])
    N = seg.shape[0]
    qkv = _t(rng.standard_normal((N, 3 * H * D)), dev, dtype)
    ang = rng.uniform(0, 6, (N, D // 2))
    cos = _t(np.cos(np.concatenate([ang, ang], 1)), dev)
    sin = _t(np.sin(np.concatenate([ang, ang], 1)), dev)
    lo, hi = fa.vision_kv_ranges(seg)
    segt = _t(seg, dev, torch.int32)
    wrap = fa.flash_attention_packed_rope_fusedqkv
    n0, t0 = wrap.launches, wrap.tc_launches
    got = wrap(qkv, cos, sin, segt, _t(lo, dev, torch.int32),
               _t(hi, dev, torch.int32), H).float()
    assert wrap.launches == n0 + 1
    assert wrap.tc_launches == t0 + (dtype == torch.bfloat16)
    ref = fa.flash_attention_packed_rope_plain(
        qkv, cos, sin, segt, H, 1 / np.sqrt(D)).float()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, ref, atol=tol, rtol=tol)
    assert torch.all(got[N - pad:] == 0)


@pytest.mark.parametrize("lengths,pad", [((64, 64), 0), ((50, 77, 13), 20),
                                         ((1008, 1008, 1008), 0),
                                         ((130,), 60)])
@pytest.mark.parametrize("D", [72, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_attention_kernel(dev, lengths, pad, D, dtype):
    """K5 against its plain version: bf16 on the tensor-core tile (D = 72
    pads the Q.K^T depth to 80; frames of 1008 straddle its 256-row
    blocks), f32 on the CUDA-core tile; valid rows within f32 summation
    order (f32) or one bf16 rounding of each side (bf16); pad rows 0."""
    from cogstream_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(4)
    H = 3
    seg = np.concatenate([np.full(L, i, np.int32)
                          for i, L in enumerate(lengths)]
                         + [np.full(pad, -1, np.int32)])
    N = seg.shape[0]
    q, k, v = (_t(rng.standard_normal((N, H, D)), dev, dtype)
               for _ in range(3))
    segt = _t(seg, dev, torch.int32)
    wrap = fa.segment_flash_attention
    n0, t0 = wrap.launches, wrap.tc_launches
    with torch.no_grad():
        got = wrap(q, k, v, segt).float()
    assert wrap.launches == n0 + 1
    assert wrap.tc_launches == t0 + (dtype == torch.bfloat16)
    ref = fa.segment_flash_attention_plain(q, k, v, segt,
                                           1 / np.sqrt(D)).float()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, ref, atol=tol, rtol=tol)
    assert torch.all(got[N - pad:] == 0)


@pytest.mark.parametrize("lengths,pad,D", [((130, 70), 8, 36),
                                           ((1008, 300), 20, 44)])
def test_vision_attention_f32_rotates_single_pairs(dev, lengths, pad, D):
    """K1's f32 route at head dims whose half is not a multiple of 4 (its
    rotation pairs then move as single floats, not 16-byte chunks), held
    to its plain version within f32 summation order (2e-5); pad rows 0.
    (The bf16 tile takes multiples of 8 only.)"""
    from cogstream_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(D)
    H = 2
    seg = np.concatenate([np.full(L, i, np.int32)
                          for i, L in enumerate(lengths)]
                         + [np.full(pad, -1, np.int32)])
    N = seg.shape[0]
    qkv = _t(rng.standard_normal((N, 3 * H * D)), dev)
    ang = rng.uniform(0, 6, (N, D // 2))
    cos = _t(np.cos(np.concatenate([ang, ang], 1)), dev)
    sin = _t(np.sin(np.concatenate([ang, ang], 1)), dev)
    lo, hi = fa.vision_kv_ranges(seg)
    segt = _t(seg, dev, torch.int32)
    wrap = fa.flash_attention_packed_rope_fusedqkv
    n0 = wrap.launches
    got = wrap(qkv, cos, sin, segt, _t(lo, dev, torch.int32),
               _t(hi, dev, torch.int32), H)
    assert wrap.launches == n0 + 1
    ref = fa.flash_attention_packed_rope_plain(qkv, cos, sin, segt, H,
                                               1 / np.sqrt(D))
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
    assert torch.all(got[N - pad:] == 0)


def test_segment_attention_never_falls_back(dev):
    """A CUDA tensor launches K5 or raises: a head dim the kernel does not
    take raises instead of running the plain version."""
    from cogstream_tpu_torch.ops import flash_attention as fa

    q = torch.zeros((64, 2, 130), device=dev)
    seg = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="cs_segment_attention"):
        fa.segment_flash_attention(q, q, q, seg)


@pytest.mark.parametrize("kernel", ["K3", "K1", "K4", "K5"])
def test_tensor_core_tiles_never_fall_back(dev, kernel):
    """bf16 CUDA operands run the tensor-core kernel or raise: a head dim
    it does not take (96 for K3 and K4, 76 for K1 and K5) raises, naming
    the C entry point, instead of running the CUDA-core tile."""
    from cogstream_tpu_torch.ops import flash_attention as fa
    from cogstream_tpu_torch.ops import lm_attention as lma

    bf = torch.bfloat16
    if kernel == "K4":
        q = torch.zeros((1, 1, 4, 96), device=dev, dtype=bf)
        k = torch.zeros((1, 128, 2, 96), device=dev, dtype=bf)
        pos = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        eff = torch.zeros((1, 128), dtype=torch.int32, device=dev)
        n0 = lma.decode_attention.launches
        with pytest.raises(ValueError, match="cs_gqa_decode_tc"):
            lma.decode_attention(q, k, k, pos, eff)
        assert lma.decode_attention.launches == n0
    elif kernel == "K5":
        q = torch.zeros((64, 2, 76), device=dev, dtype=bf)
        seg = torch.zeros(64, dtype=torch.int32, device=dev)
        n0 = fa.segment_flash_attention.launches
        with pytest.raises(ValueError, match="cs_segment_attention_tc"):
            fa.segment_flash_attention(q, q, q, seg)
        assert fa.segment_flash_attention.launches == n0
    elif kernel == "K3":
        q = torch.zeros((1, 64, 4, 96), device=dev, dtype=bf)
        k = torch.zeros((1, 128, 2, 96), device=dev, dtype=bf)
        pos = torch.zeros((1, 64), dtype=torch.int32, device=dev)
        eff = torch.zeros((1, 128), dtype=torch.int32, device=dev)
        n0 = lma.prefill_flash_attention.launches
        with pytest.raises(ValueError, match="cs_gqa_prefill_tc"):
            lma.prefill_flash_attention(q, k, k, pos, eff)
        assert lma.prefill_flash_attention.launches == n0
    else:
        D = 76
        qkv = torch.zeros((64, 3 * 2 * D), device=dev, dtype=bf)
        cs = torch.zeros((64, D), device=dev)
        seg = torch.zeros(64, dtype=torch.int32, device=dev)
        r = torch.zeros(1, dtype=torch.int32, device=dev)
        n0 = fa.flash_attention_packed_rope_fusedqkv.launches
        with pytest.raises(ValueError, match="cs_vision_attention_tc"):
            fa.flash_attention_packed_rope_fusedqkv(qkv, cs, cs, seg, r, r, 2)
        assert fa.flash_attention_packed_rope_fusedqkv.launches == n0


def _lm_case(rng, dev, dtype, B, S, T, Hq, Hkv, fill, D=128,
             dead_row=False):
    """Random q/k/v and a cache filled to ``fill`` + S slots with one
    position hole, a random 70% kv_allowed, the last query padded; with
    ``dead_row`` query 0 sits at position 0, whose slot is disallowed,
    so it sees nothing."""
    from cogstream_tpu_torch.ops.lm_attention import effective_kv_positions

    k = _t(rng.standard_normal((B, T, Hkv, D)), dev, dtype)
    v = _t(rng.standard_normal((B, T, Hkv, D)), dev, dtype)
    q = _t(rng.standard_normal((B, S, Hq, D)), dev, dtype)
    pos = np.full((B, T), -1, np.int32)
    qpos = np.full((B, S), -1, np.int32)
    for b in range(B):
        pos[b, :fill + S] = np.arange(fill + S)
        pos[b, fill // 3] = -1
        qpos[b, :S - 1] = fill + np.arange(S - 1)   # last query padded
    allowed = rng.random((B, T)) > 0.3
    if dead_row:
        qpos[:, 0] = 0
        allowed[pos == 0] = False
    eff = effective_kv_positions(_t(pos, dev, torch.int32),
                                 _t(allowed, dev, torch.bool))
    return q, k, v, _t(qpos, dev, torch.int32), eff


@pytest.mark.parametrize("B,S,T,Hq,Hkv,fill,window,D", [
    (1, 100, 300, 28, 4, 150, None, 128),
    (2, 70, 1000, 4, 2, 0, None, 128),
    (1, 9, 4100, 7, 1, 3000, None, 128),
    (1, 1000, 2100, 28, 4, 1000, None, 128),
    (2, 100, 2048, 28, 4, 1000, 1130, 128),
    (1, 9, 700, 28, 4, 500, 515, 128),
    (1, 300, 1500, 28, 4, 700, 1100, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel(dev, B, S, T, Hq, Hkv, fill, window, D, dtype):
    """K3 against its plain version: bf16 on the tensor-core tile (head
    dim 128 and 64), f32 on the CUDA-core tile. G = 7 with S = 9, 100, 300
    and 1000 (64- and 128-row tiles straddle tokens), B = 2, a read
    window shorter than the cache and not a multiple of the key tile
    (1130, 515, 1100), position holes; the padded query and the query
    that sees nothing output exactly 0."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(2)
    q, k, v, qpos, eff = _lm_case(rng, dev, dtype, B, S, T, Hq, Hkv, fill,
                                  D=D, dead_row=True)
    if window is not None:
        eff = eff[:, :window].contiguous()
    wrap = lma.prefill_flash_attention
    n0, t0 = wrap.launches, wrap.tc_launches
    got = wrap(q, k, v, qpos, eff).float()
    assert wrap.launches == n0 + 1
    assert wrap.tc_launches == t0 + (dtype == torch.bfloat16)
    ref = lma.gqa_attention_plain(q, k, v, qpos, eff).float()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, ref, atol=tol, rtol=tol)
    assert torch.all(got[:, -1] == 0)        # padded query row → 0
    assert torch.all(got[:, 0] == 0)         # nothing visible → 0


# cache kinds of K3's f32-query route
F32_ROUTE_CACHES = [torch.float32, torch.bfloat16, torch.float16,
                    torch.float8_e4m3fn, torch.float8_e5m2]


@pytest.mark.parametrize("block_rows", [128, 64])
@pytest.mark.parametrize("rows", [None, [3, 1]])
@pytest.mark.parametrize("S", [1, 9, 32, 100, 1210, 2420])
@pytest.mark.parametrize("D", [128, 64, 16])
@pytest.mark.parametrize("kv_dtype", F32_ROUTE_CACHES,
                         ids=lambda d: str(d).removeprefix("torch."))
def test_prefill_f32_route_over_every_cache(monkeypatch, dev, kv_dtype, D,
                                            S, rows, block_rows):
    """K3's f32 route (cs_gqa_prefill_f32, the register-blocked f32 tile)
    over each cache kind against its plain version on the same values,
    within f32 summation order (2e-5), in blocks of 128 and of 64 rows
    (``prefill_f32_rows`` pinned). Read windows of 1000 and 3400 slots
    end in a ragged tile; slots 64..127 are all disallowed (a tile no row
    sees) and 128..191 all visible (a tile every row but the padded and
    the blind one sees wholly); with ``rows`` a 4-row pool is read in
    place, bit-identical to a contiguous copy of the addressed rows. The
    padded query row is exactly 0, and query 0 (S >= 3), which sees
    nothing. Counted under the cache's dtype, not on the tensor cores."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    monkeypatch.setattr(lma, "prefill_f32_rows", lambda *a: block_rows)
    rng = np.random.default_rng(S * 10 + D + len(rows or ()) + 5)
    B = 1 if rows is None else len(rows)
    T, window = (4000, 3400) if S > 1000 else (1100, 1000)
    q, _, _, qpos, eff = _decode_case(rng, dev, B, S, 7, D, T, window, 900,
                                      whole_tile=True)
    q = _t(rng.standard_normal(tuple(q.shape)), dev)
    Bk = 2 * B if rows is not None else B      # 4 pool rows with rows
    kc = _t(rng.standard_normal((Bk, T, 2, D)), dev).to(kv_dtype)
    vc = _t(rng.standard_normal((Bk, T, 2, D)), dev).to(kv_dtype)
    kw = {} if rows is None else dict(rows=lma.cache_rows(rows, dev))
    wrap = lma.prefill_flash_attention
    name = str(kv_dtype).removeprefix("torch.")
    n0, t0 = wrap.launches, wrap.tc_launches
    c0 = wrap.kv_launches.get(name, 0)
    got = wrap(q, kc, vc, qpos, eff, **kw)
    assert (wrap.launches, wrap.tc_launches, wrap.kv_launches[name]) == (
        n0 + 1, t0, c0 + 1)
    ref = lma.gqa_attention_plain(q, kc, vc, qpos, eff, rows=rows)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
    if S >= 2:
        assert torch.all(got[:, -1] == 0)
    if S >= 3:
        assert torch.all(got[:, 0] == 0)
    if rows is not None:
        assert torch.equal(got, wrap(q, kc[rows].contiguous(),
                                     vc[rows].contiguous(), qpos, eff))


@pytest.mark.parametrize("S,T,window,fill", [(1, 2048, 1024, 700),
                                             (4, 9000, 9000, 8000),
                                             (1, 300, 130, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel(dev, S, T, window, fill, dtype):
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(3)
    q, k, v, qpos, eff = _lm_case(rng, dev, dtype, 1, S, T, 28, 4, fill)
    eff = eff[:, :window].contiguous()
    got = lma.decode_attention(q, k, v, qpos, eff).float()
    ref = lma.gqa_attention_plain(q, k, v, qpos, eff).float()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, ref, atol=tol, rtol=tol)


def _decode_case(rng, dev, B, S, G, D, T, window, fill, whole_tile=False):
    """A bf16 decode step over a ``window``-slot read of a T-slot cache
    holding ``fill`` history slots plus the step's S: position holes, a
    random 70% kv_allowed, the slots 64..127 all disallowed (a wholly
    masked key tile); with S >= 2 the last query is padded (-1), with
    S >= 3 query 0 sits at position 0, whose slot is disallowed, so it
    sees nothing. With ``whole_tile`` the slots 128..191 hold no hole and
    are all allowed: a key tile every other row sees wholly."""
    from cogstream_tpu_torch.ops.lm_attention import effective_kv_positions

    Hkv = 2
    bf = torch.bfloat16
    k = _t(rng.standard_normal((B, T, Hkv, D)), dev, bf)
    v = _t(rng.standard_normal((B, T, Hkv, D)), dev, bf)
    q = _t(rng.standard_normal((B, S, Hkv * G, D)), dev, bf)
    pos = np.full((B, T), -1, np.int32)
    qpos = np.zeros((B, S), np.int32)
    for b in range(B):
        pos[b, :fill + S] = np.arange(fill + S)
        holes = rng.choice(fill, 5, replace=False)
        if whole_tile:
            holes = holes[(holes < 128) | (holes >= 192)]
        pos[b, holes] = -1
        qpos[b] = fill + np.arange(S)
    allowed = rng.random((B, T)) > 0.3
    allowed[:, 64:128] = False
    if whole_tile:
        allowed[:, 128:192] = True
    if S >= 2:
        qpos[:, -1] = -1
    if S >= 3:
        qpos[:, 0] = 0
        allowed[pos == 0] = False
    eff = effective_kv_positions(_t(pos, dev, torch.int32),
                                 _t(allowed, dev, torch.bool))
    return q, k, v, _t(qpos, dev, torch.int32), eff[:, :window].contiguous()


def _row_ulps(got, ref, ulps):
    """Every output row (one head of one query) within ``ulps`` bf16 ulps
    of its own max |ref|; rows that are 0 in ref must be exactly 0."""
    g = got.float().reshape(-1, got.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    row_max = r.abs().amax(1, keepdim=True)
    bound = ulps * torch.exp2(
        torch.floor(torch.log2(row_max.clamp_min(1e-30))) - 7)
    assert torch.all((g - r).abs() <= bound), \
        ((g - r).abs() / bound).max().item()
    assert torch.all(g[row_max[:, 0] == 0] == 0)


def _two_ulps(got, ref):
    """Every output row (one head of one query) within 2 bf16 ulps of its
    own max |ref|; rows that are 0 in ref must be exactly 0."""
    g = got.float().reshape(-1, got.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    row_max = r.abs().amax(1, keepdim=True)
    bound = 2 * torch.exp2(torch.floor(torch.log2(row_max.clamp_min(1e-30)))
                           - 7)
    assert torch.all((g - r).abs() <= bound), \
        ((g - r).abs() / bound).max().item()
    assert torch.all(g[row_max[:, 0] == 0] == 0)


@pytest.mark.parametrize("S", [1, 2, 3, 8])
@pytest.mark.parametrize("G", [7, 2])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B", [1, 2])
def test_decode_tensor_core_kernel(dev, S, G, D, B):
    """K4's bf16 tensor-core kernel against its plain version: a 1000-slot
    read window (a ragged last tile) of a 1100-slot cache holding 900
    history slots, kv_allowed holes, a wholly masked tile, the padded
    query and the query that sees nothing exactly 0; every row within 2
    bf16 ulps of its max |ref|. Two calls give the same bits."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(S * 100 + G * 10 + D + B)
    q, k, v, qpos, eff = _decode_case(rng, dev, B, S, G, D, 1100, 1000, 900)
    wrap = lma.decode_attention
    n0, t0 = wrap.launches, wrap.tc_launches
    got = wrap(q, k, v, qpos, eff)
    assert (wrap.launches, wrap.tc_launches) == (n0 + 1, t0 + 1)
    ref = lma.gqa_attention_plain(q, k, v, qpos, eff)
    _two_ulps(got, ref)
    if S >= 2:
        assert torch.all(got[:, -1] == 0)        # padded query row → 0
    if S >= 3:
        assert torch.all(got[:, 0] == 0)         # nothing visible → 0
    assert torch.equal(wrap(q, k, v, qpos, eff), got)


@pytest.mark.parametrize("S", [5, 8, 9])
def test_verify_step_attention(dev, S):
    """A lookahead verify step at the 7B attention shapes (28 / 4 heads of
    128, bf16): S = k+1 queries at consecutive positions whose K/V sit in
    the cache's next S slots, over a 9216-slot window holding 9000 history
    slots with holes and a 70% kv_allowed. S <= 8 (k <= 7) takes K4's
    tensor-core kernel, S = 9 (k = 8) K3's, as ``qwen2_forward`` routes
    them; every row within 2 bf16 ulps of the plain version's max |ref|,
    and query i sees the step's slots up to its own."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(S)
    T, W, fill, Hq, Hkv, D = 9216 + 64, 9216, 9000, 28, 4, 128
    bf = torch.bfloat16
    k = _t(rng.standard_normal((1, T, Hkv, D)), dev, bf)
    v = _t(rng.standard_normal((1, T, Hkv, D)), dev, bf)
    q = _t(rng.standard_normal((1, S, Hq, D)), dev, bf)
    pos = np.full((1, T), -1, np.int32)
    pos[0, :fill + S] = np.arange(fill + S)
    pos[0, rng.choice(fill, 300, replace=False)] = -1
    allowed = rng.random((1, T)) > 0.3
    allowed[0, fill:] = True
    eff = lma.effective_kv_positions(_t(pos, dev, torch.int32),
                                     _t(allowed, dev, torch.bool))
    eff = eff[:, :W].contiguous()
    qpos = _t(np.arange(fill, fill + S)[None], dev, torch.int32)
    wrap = (lma.decode_attention if S <= lma.DECODE_MAX_S
            else lma.prefill_flash_attention)
    n0, t0 = wrap.launches, wrap.tc_launches
    got = wrap(q, k, v, qpos, eff)
    assert (wrap.launches, wrap.tc_launches) == (n0 + 1, t0 + 1)
    ref = lma.gqa_attention_plain(q, k, v, qpos, eff)
    _two_ulps(got, ref)
    # causality inside the step: dropping the last query's slot changes
    # only the last query's rows
    eff2 = eff.clone()
    eff2[0, fill + S - 1] = lma.SENTINEL
    got2 = wrap(q, k, v, qpos, eff2)
    assert torch.equal(got2[:, :S - 1], got[:, :S - 1])
    assert not torch.equal(got2[:, S - 1], got[:, S - 1])


@pytest.mark.parametrize("k", [2, 8])
def test_lookahead_card_matches_cpu(dev, k):
    """``generate_tokens_lookahead`` on a tiny f32 decoder on the card (K4
    verifies at k = 2, K3 at k = 8) and on the CPU: the same tokens and
    verify steps, the same positions and write index, K/V within 1e-4."""
    import copy

    from cogstream_tpu_torch.config import CogReasonerConfig
    from cogstream_tpu_torch.models import qwen2
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.ops import lm_attention as lma
    from cogstream_tpu_torch.runtime.generate import generate_tokens_lookahead

    cfg = CogReasonerConfig.tiny()
    cpu = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu").text
    cfg = cfg.text
    ids = np.random.default_rng(k).integers(3, 200, (1, 20))
    out = []
    for model in (cpu, copy.deepcopy(cpu).to(dev)):
        d = model.embed_tokens.device
        cache = qwen2.init_kv_cache(cfg, 1, 128, device=d)
        wrap = (lma.decode_attention if k + 1 <= lma.DECODE_MAX_S
                else lma.prefill_flash_attention)
        n0 = wrap.launches
        r = generate_tokens_lookahead(
            model, qwen2.embed(model, torch.as_tensor(ids, device=d)),
            torch.arange(20, dtype=torch.int32, device=d)[None],
            torch.tensor([19], device=d), cache, ids, 32, 2, lookahead_k=k)
        out.append((r, wrap.launches - n0))
    (ref, _), (got, launched) = out
    assert launched >= got.steps > 0
    assert torch.equal(got.tokens, ref.tokens) and got.steps == ref.steps
    assert got.cache.write_index == ref.cache.write_index
    assert torch.equal(got.cache.pos.cpu(), ref.cache.pos)
    live = ref.cache.pos[0] >= 0
    for a, b in ((got.cache.k, ref.cache.k), (got.cache.v, ref.cache.v)):
        torch.testing.assert_close(a.cpu()[:, :, live], b[:, :, live],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S,window", [(1, 9216), (4, 3000)])
def test_decode_tensor_core_kernel_replays_in_a_graph(dev, S, window):
    """One K4 call captured in a CUDA graph, then replayed after q and
    eff were rewritten in place, equals the eager call on the new values
    bit for bit (no host sync, no workspace allocation in the call)."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(window)
    q, k, v, qpos, eff = _decode_case(rng, dev, 1, S, 7, 128, 16384, window,
                                      window - 300)
    q2, _, _, _, eff2 = _decode_case(rng, dev, 1, S, 7, 128, 16384, window,
                                     window - 200)
    lma.decode_attention(q, k, v, qpos, eff)      # workspace made here
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = lma.decode_attention(q, k, v, qpos, eff)
    q.copy_(q2)
    eff.copy_(eff2)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, lma.decode_attention(q, k, v, qpos, eff))
    _two_ulps(out, lma.gqa_attention_plain(q, k, v, qpos, eff))


@pytest.mark.parametrize("rows", [[2], [3, 1]])
@pytest.mark.parametrize("kernel,S", [("K3", 100), ("K4", 1), ("K4", 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_read_the_pool_in_place(dev, rows, kernel, S, dtype):
    """K3 and K4 with ``rows`` on a 4-row pool cache: bit-identical to
    the same kernel on a contiguous copy of the addressed rows, counted
    in ``.rows_launches``, and (bf16) within 2 bf16 ulps of the plain
    version per row."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(len(rows) * 10 + S)
    B, T, Hkv, G, D = len(rows), 1100, 2, 7, 128
    k = _t(rng.standard_normal((4, T, Hkv, D)), dev, dtype)
    v = _t(rng.standard_normal((4, T, Hkv, D)), dev, dtype)
    q = _t(rng.standard_normal((B, S, Hkv * G, D)), dev, dtype)
    fill = 900
    pos = np.full((B, T), -1, np.int32)
    pos[:, :fill + S] = np.arange(fill + S)
    pos[:, rng.choice(fill, 5, replace=False)] = -1
    qpos = _t(np.tile(fill + np.arange(S), (B, 1)), dev, torch.int32)
    eff = lma.effective_kv_positions(_t(pos, dev, torch.int32))[:, :1000]
    eff = eff.contiguous()
    wrap = (lma.prefill_flash_attention if kernel == "K3"
            else lma.decode_attention)
    kc, vc = k[rows].contiguous(), v[rows].contiguous()
    want = wrap(q, kc, vc, qpos, eff)
    n0, r0 = wrap.launches, wrap.rows_launches
    got = wrap(q, k, v, qpos, eff, rows=lma.cache_rows(rows, dev))
    assert (wrap.launches, wrap.rows_launches) == (n0 + 1, r0 + 1)
    assert torch.equal(got, want)
    if dtype == torch.bfloat16:
        _two_ulps(got, lma.gqa_attention_plain(q, k, v, qpos, eff,
                                               rows=rows))


def test_rows_decode_replays_in_a_graph(dev):
    """One K4 call with ``rows`` captured in a CUDA graph and replayed
    after q was rewritten equals the eager call bit for bit."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(11)
    q, k, v, qpos, eff = _decode_case(rng, dev, 2, 1, 7, 128, 4096, 3000,
                                      2700)
    pool_k = torch.cat([k, k.flip(0)])          # 4 rows
    pool_v = torch.cat([v, v.flip(0)])
    rows = lma.cache_rows([3, 1], dev)
    lma.decode_attention(q, pool_k, pool_v, qpos, eff, rows=rows)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = lma.decode_attention(q, pool_k, pool_v, qpos, eff, rows=rows)
    q.copy_(q.flip(0))
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, lma.decode_attention(q, k, v, qpos, eff))


def test_pool_card_matches_cpu(dev):
    """A tiny f32 ``SessionPool`` (3 rows: ingest_batch, ask_batch AC then
    FCC, a solo pooled ask, ask_stream) on the card (K1-K4, K3 / K4 with
    ``rows``) and on the CPU: the same greedy tokens, selections, slot
    ranges and cache positions."""
    import copy

    from cogstream_tpu_torch.config import CogReasonerConfig
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.ops import lm_attention as lma
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.pool import SessionPool

    cfg = CogReasonerConfig.tiny()
    cpu_model = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    tok = ByteTokenizer(image_token_id=cfg.image_token_index)
    rng = np.random.default_rng(0)
    pvs = [rng.normal(size=(3 * 4 * 4, 3 * 14 * 14)).astype(np.float32)
           for _ in range(3)]
    outs = []
    r0 = lma.decode_attention.rows_launches
    for model in (cpu_model, copy.deepcopy(cpu_model).to(dev)):
        pool = SessionPool(model, cfg, tok, n_rows=3, max_len=1024)
        for _ in range(3):
            pool.open()
        pool.ingest_batch([(b, pvs[b], (3, 4, 4), 2, [0.0, 1.0, 2.0])
                           for b in range(3)])
        res = [pool.ask_batch([(b, f"what {b}?") for b in range(3)],
                              mode=m, max_new_tokens=8) for m in ("AC", "FCC")]
        res.append(pool.ask(1, "and then?", mode="FCC", max_new_tokens=8))
        res.append(list(pool.sessions[2].ask_stream(
            "more?", mode="AC", max_new_tokens=8, chunk=3)))
        outs.append((res, [[(r.kind, r.start, r.end) for r in s.ranges]
                           for s in pool.sessions.values()],
                     pool.cache.pos.cpu()))
    assert lma.decode_attention.rows_launches > r0
    assert outs[0][0] == outs[1][0] and outs[0][1] == outs[1][1]
    assert torch.equal(outs[0][2], outs[1][2])


def _int4_weights(rng, dev, shape, cubic=False):
    """Random rank-1 int4 storage of ``shape`` = [L,] din/2, dout (bytes
    drawn over all 256 values, so every nibble occurs)."""
    from cogstream_tpu_torch.ops.quant import CUBIC_A, CUBIC_C

    *lead, half, dout = shape
    qp = {"q4": _t(rng.integers(-128, 128, shape), dev, torch.int8),
          "scale": _t(rng.uniform(0.5, 2.0, (*lead, dout)) / 64, dev),
          "rscale": _t(rng.uniform(0.5, 2.0, (*lead, 2 * half)), dev)}
    code = [CUBIC_A, CUBIC_C] if cubic else [1.0 / 7.0]
    qp["code"] = _t(np.tile(code, (*lead, 1)), dev)
    return qp


def _rowwise(got, ref, rtol):
    """Every row within ``rtol`` of its own max |ref|."""
    g, r = got.float(), ref.float()
    bound = rtol * r.abs().amax(-1, keepdim=True)
    assert torch.all((g - r).abs() <= bound), \
        ((g - r).abs() / bound).max().item()


@pytest.mark.parametrize("half,dout", [(128, 384), (896, 512), (256, 4096)])
@pytest.mark.parametrize("m", [1, 5, 8, 13, 40, 64])
@pytest.mark.parametrize("variant", ["K6", "K6_cubic", "K7"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_gemv_2d_kernel(dev, half, dout, m, variant, dtype):
    """K6/K7 against their plain versions: ragged m-tiles (5, 13, 40),
    split-K shapes (dout 384 and 512: two column blocks)."""
    from cogstream_tpu_torch.ops import quant_gemv as qg

    rng = np.random.default_rng(m + dout)
    qp = _int4_weights(rng, dev, (half, dout), cubic=variant == "K6_cubic")
    x = _t(rng.standard_normal((m, 2 * half)), dev, dtype)
    w4a8 = variant == "K7"
    n0 = (qg.gemv_k7 if w4a8 else qg.gemv_k6).launches
    got = qg.int4_rank1_gemv(x, qp, dtype, w4a8=w4a8)
    ref = qg.int4_rank1_gemv_plain(x, qp, dtype, w4a8=w4a8)
    assert (qg.gemv_k7 if w4a8 else qg.gemv_k6).launches == n0 + 1
    assert got.shape == (m, dout) and got.dtype == dtype
    if w4a8 and dtype == torch.float32:
        # exact integer sums and the same epilogue roundings
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    elif dtype == torch.float32:
        _rowwise(got, ref, 1e-5)      # f32 summation order only
    else:
        _rowwise(got, ref, 2 ** -7)   # + one bf16 rounding on each side


@pytest.mark.parametrize("L,half,dout", [(3, 128, 512), (4, 1792, 256),
                                         (2, 640, 1024)])
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17, 40, 64])
@pytest.mark.parametrize("w4a8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_gemv_stacked_kernel(dev, L, half, dout, m, w4a8, dtype):
    """K8/K9 (the tensor-core kernel) read their layer from a device int32
    pointer: every layer, L - 1 included, against the plain version of
    that layer's slice, one launch per call. m covers one to eight n8
    tiles, ragged ones included; half = 128 runs one K split, the others
    several (stacked_plan). K9 at f32 out is exact (integer sums, the
    same epilogue roundings); K8 within 1e-5 of each row's max |ref| (f32
    sums in another order), and bf16 out within 2^-7 (one rounding on
    each side)."""
    from cogstream_tpu_torch.ops import quant_gemv as qg

    rng = np.random.default_rng(L * m + dout)
    qp = _int4_weights(rng, dev, (L, half, dout))
    x = _t(rng.standard_normal((m, 2 * half)), dev)
    ids = torch.arange(L, dtype=torch.int32, device=dev)
    wrap = qg.gemv_k9 if w4a8 else qg.gemv_k8
    for layer in range(L):
        n0 = wrap.launches
        got = qg.int4_rank1_gemv_stacked(x, qp, ids[layer:layer + 1], dtype,
                                         w4a8=w4a8)
        assert wrap.launches == n0 + 1
        assert got.shape == (m, dout) and got.dtype == dtype
        ref = qg.int4_rank1_gemv_stacked_plain(x, qp, ids[layer:layer + 1],
                                               dtype, w4a8=w4a8)
        if w4a8 and dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=0, rtol=0)
        else:
            _rowwise(got, ref, 1e-5 if dtype == torch.float32 else 2 ** -7)
        if layer == L - 1:   # the last layer differs from its neighbour
            other = qg.int4_rank1_gemv_stacked_plain(
                x, qp, ids[layer - 1:layer], dtype, w4a8=w4a8)
            assert not torch.allclose(got, other)


def _stacked_call(qg, dev, rng, m, w4a8, L=4, half=1792, dout=2048):
    """A K8/K9 call on prepared operands (gate_proj-like, split K)."""
    qp = _int4_weights(rng, dev, (L, half, dout))
    xs = _t(rng.standard_normal((m, 2 * half)), dev)
    layer = torch.tensor([1], dtype=torch.int32, device=dev)
    if w4a8:
        xq, sx = qg._int8_halves(xs, half)
        return (lambda: qg.gemv_k9(xq, sx, qp["q4"], qp["scale"], layer,
                                   torch.float32)), (xq, sx, layer, qp)
    xb = xs.to(torch.bfloat16)
    return (lambda: qg.gemv_k8(xb, qp["q4"], qp["scale"], layer,
                               torch.float32)), (xb, None, layer, qp)


@pytest.mark.parametrize("m", [1, 40])
@pytest.mark.parametrize("w4a8", [False, True])
def test_int4_gemv_stacked_repeats_and_replays(dev, m, w4a8):
    """K8/K9 split K through the workspace: two calls give the same bits;
    once the workspace exists a call allocates its output alone; one call
    captured in a CUDA graph, replayed after x (and sx) and the layer
    index were rewritten in place, equals the eager call on the new
    values bit for bit."""
    from cogstream_tpu_torch.ops import quant_gemv as qg

    rng = np.random.default_rng(m + 10 * w4a8)
    call, (x, sx, layer, qp) = _stacked_call(qg, dev, rng, m, w4a8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert qg.stacked_plan(m, 1792, 2048, w4a8, sms)[1] > 1
    first = call()
    # garbage of earlier tests, collected mid-call, would free memory
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    again = call()
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    grown = torch.cuda.memory_allocated(dev) - before
    assert grown == -(-again.numel() * 4 // 512) * 512   # the output only
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    x2 = rng.standard_normal(tuple(x.shape))
    if w4a8:
        xq2, sx2 = qg._int8_halves(_t(x2, dev), 1792)
        x.copy_(xq2)
        sx.copy_(sx2)
    else:
        x.copy_(_t(x2, dev, torch.bfloat16))
    layer.fill_(3)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())
    ref = (qg._plain_w4a8(x, sx, qp["q4"][3], qp["scale"][3], torch.float32)
           if w4a8 else qg._plain_bf16(x, qp["q4"][3], qp["scale"][3], None,
                                       False, torch.float32))
    if w4a8:
        torch.testing.assert_close(out, ref, atol=0, rtol=0)
    else:
        _rowwise(out, ref, 1e-5)


def test_int4_gemv_cuda_never_falls_back(dev):
    """A CUDA tensor launches its kernel or raises: an unsupported shape
    (dout not a multiple of 8 reaches the launcher only when called
    directly) raises instead of running the plain version."""
    from cogstream_tpu_torch.ops import quant_gemv as qg

    rng = np.random.default_rng(0)
    q4 = _t(rng.integers(-128, 128, (128, 132)), dev, torch.int8)
    x = _t(rng.standard_normal((1, 256)), dev, torch.bfloat16)
    with pytest.raises(ValueError, match="dout % 8"):
        qg.gemv_k6(x, q4, torch.ones(132, device=dev),
                   torch.zeros(2, device=dev), False, torch.float32)


@pytest.mark.parametrize("mode", ["AC", "FCC"])
def test_engine_turn_card_matches_cpu(dev, mode, tmp_path, monkeypatch):
    """``CogReasonerEngine.chat`` on a tiny f32 config with the events on
    (two static scenes per segment, so k-means finds the scenes whatever
    its generator draws): the card (K1-K4) and the CPU (plain versions)
    give the same selection and greedy tokens."""
    import copy
    import dataclasses

    import cogstream_tpu_torch.runtime.engine as eng_mod
    from cogstream_tpu_torch.config import CogReasonerConfig, CompressionConfig
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer

    cfg = dataclasses.replace(
        CogReasonerConfig.tiny(),
        compression=CompressionConfig(frames_per_event=2,
                                      keyframes_per_event=1,
                                      min_events_for_compression=2))
    rng = np.random.default_rng(0)
    dirs = []
    for i in range(2):
        d = tmp_path / f"seg{i}"
        d.mkdir()
        scenes = [rng.integers(0, 256, (56, 84, 3), dtype=np.uint8)
                  for _ in range(2)]
        for k in range(4):
            np.save(d / f"{k:03d}.npy", scenes[k // 2])
        dirs.append(str(d))

    def video(d):
        return {"role": "stream", "content": [{"type": "video", "video": {
            "video_path": d, "fps": 1, "max_frames": 8}}]}

    conv = [video(dirs[0]), {"role": "user", "content": "what first?"},
            {"role": "assistant", "content": "a pattern."}, video(dirs[1]),
            {"role": "user", "content": "and then?"}]
    seen = []
    orig = eng_mod.decode_new_tokens

    def capture(tokens, num, tok, *a, **k):
        seen.append(tokens[0, :int(num[0])].tolist())
        return orig(tokens, num, tok, *a, **k)

    monkeypatch.setattr(eng_mod, "decode_new_tokens", capture)
    cpu_model = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    tok = ByteTokenizer(image_token_id=cfg.image_token_index)
    turns = [eng_mod.CogReasonerEngine(m, cfg, tok).chat(
        conv, mode=mode, max_new_tokens=8) for m in (cpu_model, gpu_model)]
    assert turns[0].selection == turns[1].selection
    assert seen[0] == seen[1] and len(seen) == 2


def _int8_weights(rng, dev, shape):
    """Random int8 storage of ``shape`` = [L,] din, dout, column-major as
    the port holds it (every byte value but -128 occurs), with scales of
    the magnitude a real fit gives."""
    from cogstream_tpu_torch.ops.quant import column_major

    *lead, din, dout = shape
    return {"q": column_major(_t(rng.integers(-127, 128, shape), dev,
                                 torch.int8)),
            "scale": _t(rng.uniform(0.5, 2.0, (*lead, dout)) / 512, dev)}


@pytest.mark.parametrize("L,din,dout", [(3, 256, 384), (4, 1792, 256),
                                        (2, 640, 1024), (0, 3584, 512)])
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17, 40, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_gemv_kernel(dev, L, din, dout, m, dtype):
    """K10 against its plain version, ``x @ (q * scale)`` rounded to x's
    dtype: stacked weights read their layer from a device int32 pointer
    (every layer, against that layer's slice; the last one differs from
    its neighbour), L = 0 is the 2D form (the lm_head's). m covers one to
    eight n8 tiles, ragged ones included; din = 256 runs one K split, the
    others several. bf16 (the tensor-core kernel): every row within 2
    bf16 ulps of its max |ref| (2^-7: the same bf16 weights, f32 sums in
    another order, one rounding of the output on each side); f32 (the
    CUDA-core kernel, no weight rounding): 1e-5."""
    from cogstream_tpu_torch.ops import int8_gemv as ig

    rng = np.random.default_rng(m + din + dout)
    qp = _int8_weights(rng, dev, (L, din, dout) if L else (din, dout))
    x = _t(rng.standard_normal((m, din)), dev, dtype)
    ids = torch.arange(max(L, 1), dtype=torch.int32, device=dev)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for layer in range(max(L, 1)):
        w = {**qp, "layer": ids[layer:layer + 1]} if L else qp
        n0, t0 = ig.gemv_k10.launches, ig.gemv_k10.tc_launches
        got = ig.int8_gemv(x, w, dtype)
        assert ig.gemv_k10.launches == n0 + 1
        assert ig.gemv_k10.tc_launches == t0 + (dtype == torch.bfloat16)
        assert got.shape == (m, dout) and got.dtype == dtype
        _rowwise(got, ig.int8_gemv_plain(x, w, dtype), tol)
        if L and layer == L - 1:
            other = ig.int8_gemv_plain(
                x, {**qp, "layer": ids[layer - 1:layer]}, dtype)
            assert not torch.allclose(got, other)


@pytest.mark.parametrize("m", [1, 40])
def test_int8_gemv_repeats_and_replays(dev, m):
    """K10 splits K through the shared workspace: two calls give the same
    bits; one call captured in a CUDA graph, replayed after x and the
    layer index were rewritten in place, equals the eager call on the new
    values bit for bit."""
    from cogstream_tpu_torch.ops import int8_gemv as ig
    from cogstream_tpu_torch.ops import quant_gemv as qg

    rng = np.random.default_rng(m)
    L, din, dout = 4, 3584, 2048
    qp = _int8_weights(rng, dev, (L, din, dout))
    x = _t(rng.standard_normal((m, din)), dev, torch.bfloat16)
    layer = torch.tensor([1], dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if ig.takes_sm90(m, din, dout):
        # some tile is split between blocks (its sums meet in the workspace)
        tiles, stages = qg.sm90_units(din, dout)
        grid = qg.stream_grid(tiles, stages, sms)
        assert any(s1 - s0 < stages for block in
                   qg.stream_segments(grid, tiles, stages)
                   for _, s0, s1 in block)
    else:
        assert qg.stacked_plan(m, din, dout, False, sms, x_halves=1)[1] > 1

    def call():
        return ig.gemv_k10(x, qp["q"], qp["scale"], layer, torch.bfloat16)

    first = call()
    assert torch.equal(first, call())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    x.copy_(_t(rng.standard_normal((m, din)), dev, torch.bfloat16))
    layer.fill_(3)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())
    _rowwise(out, ig.int8_gemv_plain(x, {**qp, "layer": layer},
                                     torch.bfloat16), 2 ** -7)


def _sm90_call(kernel, m, shape, rng, dev):
    """A K6 (uniform or cubic) or K10 call through its wrapper, on prepared
    operands of ``shape`` (K6: [half, dout]; K10: [L, din, dout] with
    layer 1, or [din, dout]), bf16 in and out, with its plain reference on
    the current values and the tensors a graph replay rewrites."""
    from cogstream_tpu_torch.ops import int8_gemv as ig
    from cogstream_tpu_torch.ops import quant_gemv as qg

    if kernel == "K10":
        qp = _int8_weights(rng, dev, shape)
        x = _t(rng.standard_normal((m, shape[-2])), dev, torch.bfloat16)
        layer = torch.tensor([1], dtype=torch.int32, device=dev)
        w = {**qp, "layer": layer} if len(shape) == 3 else qp
        return ((lambda: ig.int8_gemv(x, w, torch.bfloat16)),
                (lambda: ig.int8_gemv_plain(x, w, torch.bfloat16)),
                x, layer, ig.gemv_k10)
    qp = _int4_weights(rng, dev, shape, cubic=kernel == "K6_cubic")
    x = _t(rng.standard_normal((m, 2 * shape[0])), dev, torch.bfloat16)
    return ((lambda: qg.int4_rank1_gemv(x, qp, torch.bfloat16)),
            (lambda: qg.int4_rank1_gemv_plain(x, qp, torch.bfloat16)),
            x, None, qg.gemv_k6)


@pytest.mark.parametrize("kernel,shape", [
    ("K6", (1792, 76032)), ("K6_cubic", (1792, 76032)), ("K6", (896, 384)),
    ("K10", (3, 3584, 2048)), ("K10", (2, 18944, 512)), ("K10", (3584, 4096))])
@pytest.mark.parametrize("m", [1, 5, 40, 64])
def test_sm90_gemv_repeats_and_replays(dev, monkeypatch, kernel, shape, m):
    """K6 and K10's persistent kernel (K10 forced onto it at every size) on
    the 2D, the stacked (K10) and the
    column-shard shapes (a vocab shard of the 7B lm_head: [1792, 76032]):
    every row within 2 bf16 ulps of its max |ref| of the plain version
    (2^-7: the same bf16 weights, f32 sums in another order, one rounding
    on each side); two calls give the same bits; one call captured in a
    CUDA graph, replayed after x (and the layer index) were rewritten in
    place, equals the eager call on the new values bit for bit; one launch
    per call."""
    from cogstream_tpu_torch.ops import int8_gemv as ig

    monkeypatch.setattr(ig, "SM90_MIN_PRODUCT", -1)
    rng = np.random.default_rng(m + sum(shape))
    call, plain, x, layer, wrap = _sm90_call(kernel, m, shape, rng, dev)
    n0 = wrap.launches
    first = call()
    assert wrap.launches == n0 + 1 and first.shape == (m, shape[-1])
    _rowwise(first, plain(), 2 ** -7)
    assert torch.equal(first, call())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    x.copy_(_t(rng.standard_normal(tuple(x.shape)), dev, torch.bfloat16))
    if layer is not None:
        layer.fill_(shape[0] - 1)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())
    _rowwise(out, plain(), 2 ** -7)


def test_int8_gemv_cuda_never_falls_back(dev):
    """A CUDA tensor launches K10 or raises: a bf16 call on a shape the
    tensor-core kernel cannot tile (reachable only by calling the wrapper
    directly; the route never sends it) raises."""
    from cogstream_tpu_torch.ops import int8_gemv as ig

    rng = np.random.default_rng(0)
    qp = _int8_weights(rng, dev, (192, 256))
    x = _t(rng.standard_normal((1, 192)), dev, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 128"):
        ig.gemv_k10(x, qp["q"], qp["scale"], None, torch.bfloat16)
    # a row-major weight (not the layout the port holds) raises too
    with pytest.raises(ValueError, match="column-major"):
        ig.gemv_k10(_t(rng.standard_normal((1, 256)), dev, torch.bfloat16),
                    _t(rng.integers(-127, 128, (256, 128)), dev, torch.int8),
                    qp["scale"][:128].contiguous(), None, torch.bfloat16)


@pytest.mark.parametrize("m", [1, 16, 17, 64])
def test_int_mm_small_rows(dev, m):
    """The W8A8 product's int8 GEMM (``torch._int_mm``) at the row counts
    the card's build refuses (16 and fewer: the activations are padded
    with zero rows, which quantize to 0, and sliced off) and above:
    exact against the integer product, and the int8 W8A8 product equals
    the same formula on the CPU bit for bit."""
    from cogstream_tpu_torch.ops import quant

    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    qp = quant.quantize_int8(torch.as_tensor(
        rng.standard_normal((256, 384)), dtype=torch.float32))
    xq, sx = quant.quantize_int8_act(torch.as_tensor(x))
    ref = xq.long() @ qp["q"].long()
    got = quant.int8_mm(xq.to(dev), qp["q"].to(dev))
    assert got.dtype == torch.int32 and torch.equal(got.cpu().long(), ref)
    cpu = quant.quantized_matmul(torch.as_tensor(x), qp, w8a8=True)
    card = quant.quantized_matmul(torch.as_tensor(x).to(dev),
                                  {k: v.to(dev) for k, v in qp.items()},
                                  w8a8=True)
    assert torch.equal(card.cpu(), cpu)


# ---------------------------------------------------------------------------
# the fp8 KV cache: the cast, K3 / K4 over e4m3 K/V, a tiny fp8 session
# ---------------------------------------------------------------------------

def test_e4m3_cast_on_the_card_equals_the_cpu(dev):
    """torch's CUDA cast to e4m3 writes the CPU cast's byte for every one
    of the 65536 bf16 bit patterns and for f32 draws over e4m3's range,
    its subnormals and past 448 (the tiny f32 decoder writes f32 keys);
    the port's cache cast (``qwen2.to_cache``) on the card equals it on the
    CPU (NaN inputs: NaN on both) and saturates past 464 to +-448,
    whatever torch's own cast does there."""
    from cogstream_tpu_torch.models.qwen2 import to_cache

    f8 = torch.float8_e4m3fn
    bits = torch.from_numpy(np.arange(1 << 16, dtype=np.uint16).view(
        np.int16)).view(torch.bfloat16)
    rng = np.random.default_rng(0)
    f32 = torch.from_numpy((rng.standard_normal(1 << 20) * 10.0 ** rng.uniform(
        -4, 3, 1 << 20)).astype(np.float32))
    for x in (bits, f32):
        assert torch.equal(x.to(dev).to(f8).cpu().view(torch.uint8),
                           x.to(f8).view(torch.uint8))
        card = to_cache(x.to(dev), f8).cpu()
        nan = torch.isnan(x)
        # NaN stays NaN (the clamp may flip its sign bit)
        assert torch.equal(card.view(torch.uint8)[~nan],
                           to_cache(x, f8).view(torch.uint8)[~nan])
        assert torch.isnan(card[nan].float()).all()
        big = ~nan & (x.float().abs() > 464)
        assert torch.equal(card[big].float(), x[big].float().sign() * 448)


@pytest.mark.parametrize("rows", [None, [3, 1]])
@pytest.mark.parametrize("kernel,S", [("K3", 100), ("K3", 1210),
                                      ("K3", 2420), ("K4", 1),
                                      ("K4", 5), ("K4", 8)])
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 64),
                                     (torch.float32, 128)])
def test_fp8_cache_kernels(dev, rows, kernel, S, dtype, D):
    """K3 and K4 over an e4m3 cache against their plain versions on the
    same bytes: bf16 queries on the tensor-core kernels (each row within 2
    bf16 ulps of its max |ref|), f32 on the CUDA-core tile (f32 summation
    order, 2e-5); with ``rows`` reading a 4-row e4m3 pool, bit-identical
    to a contiguous copy of the addressed rows. Counted in
    ``.fp8_launches``; the padded query outputs 0. Read windows of 1000
    and 3400 slots end in ragged tiles. K3 over e4m3 runs each of its
    three instances (cs_gqa_prefill_tc's weighted waves on 132 SMs): at S
    = 100 the 4-warp one (64 rows a block), at S = 1210 (8470 folded rows)
    the 8-warp 2-m-tile one (256 rows; with ``rows``, 2 inputs, the 8-warp
    1-m-tile one, 128 rows), at S = 2420 the 128-row one (with ``rows``
    the 256-row one)."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(S * 10 + D + len(rows or ()))
    B = 1 if rows is None else len(rows)
    T, window = (4000, 3400) if S > 1000 else (1100, 1000)
    q, k, v, qpos, eff = _decode_case(rng, dev, B, S, 7, D, T, window, 900)
    if kernel == "K3" and dtype == torch.bfloat16:
        # the rows a block of the e4m3 instance (2 kv heads): the fewest
        # waves of one block an SM, weighted 17 : 11 : 10
        assert _k3_rows_a_block(dev, torch.float8_e4m3fn, S, B) == {
            100: 64, 1210: 256 if B == 1 else 128,
            2420: 128 if B == 1 else 256}[S]
    q = q.to(dtype)
    f8 = torch.float8_e4m3fn
    k8, v8 = k.to(f8), v.to(f8)
    wrap = (lma.prefill_flash_attention if kernel == "K3"
            else lma.decode_attention)
    kw = {}
    if rows is not None:
        k8 = torch.cat([k8, k8.flip(0)]).contiguous()     # 4 pool rows
        v8 = torch.cat([v8, v8.flip(0)]).contiguous()
        kw = dict(rows=lma.cache_rows(rows, dev))
    n0, f0 = wrap.launches, wrap.fp8_launches
    got = wrap(q, k8, v8, qpos, eff, **kw)
    assert (wrap.launches, wrap.fp8_launches) == (n0 + 1, f0 + 1)
    ref = lma.gqa_attention_plain(q, k8, v8, qpos, eff, rows=rows)
    if dtype == torch.bfloat16:
        _two_ulps(got, ref)
    else:
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
    if S >= 2:
        assert torch.all(got[:, -1] == 0)
    if rows is not None:
        assert torch.equal(got, wrap(q, k8[rows].contiguous(),
                                     v8[rows].contiguous(), qpos, eff))


def test_fp8_decode_replays_in_a_graph(dev):
    """One K4 call over an e4m3 cache captured in a CUDA graph, replayed
    after q and eff were rewritten in place, equals the eager call bit for
    bit; two eager calls give the same bits."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(12)
    q, k, v, qpos, eff = _decode_case(rng, dev, 1, 1, 7, 128, 16384, 9216,
                                      8900)
    q2, _, _, _, eff2 = _decode_case(rng, dev, 1, 1, 7, 128, 16384, 9216,
                                     9000)
    k8, v8 = k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)
    first = lma.decode_attention(q, k8, v8, qpos, eff)
    assert torch.equal(first, lma.decode_attention(q, k8, v8, qpos, eff))
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = lma.decode_attention(q, k8, v8, qpos, eff)
    q.copy_(q2)
    eff.copy_(eff2)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, lma.decode_attention(q, k8, v8, qpos, eff))
    _two_ulps(out, lma.gqa_attention_plain(q, k8, v8, qpos, eff))


def test_decode_warps_match_the_library(dev):
    """decode_plan's warps a block over each cache kind (DECODE_WARPS) are
    the ones the built K4 kernel launches with: bf16 and f16 4, e4m3 and
    e5m2 8, f32 3."""
    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops import lm_attention as lma

    lib = kernels.library()
    codes = kernels.KV_DTYPE_CODES
    assert sorted(lma.DECODE_WARPS) == sorted(codes.values())
    for code in codes.values():
        assert lib.cs_decode_tc_warps(code) == lma.DECODE_WARPS[code]
    assert [lma.DECODE_WARPS[codes[t]] for t in (
        torch.bfloat16, torch.float16, torch.float8_e4m3fn,
        torch.float8_e5m2, torch.float32)] == [4, 4, 8, 8, 3]


def test_fp8_session_card_matches_cpu(dev):
    """The tiny f32 session over an e4m3 cache (ingest, AC, ingest, FCC) on
    the card (K3 / K4's f32 tile reading e4m3) and on the CPU: the same
    greedy tokens, selections, slot ranges and positions; the cache bytes
    where pos >= 0 equal in at least 99.5% of elements, the rest one e4m3
    step apart (a ~1e-6 difference of the f32 keys flips a rounding only
    next to a tie, and a flip moves later layers' keys by ~1e-3 of the
    row, which flips a few more: tests/test_torch_fp8kv.py's pool)."""
    import copy

    from cogstream_tpu_torch.config import CogReasonerConfig
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.ops import lm_attention as lma
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.session import StreamingSession

    cfg = CogReasonerConfig.tiny()
    cpu_model = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    tok = ByteTokenizer(image_token_id=cfg.image_token_index)
    pv = np.random.default_rng(0).normal(size=(48, 588)).astype(np.float32)
    outs = []
    f0 = lma.decode_attention.fp8_launches + \
        lma.prefill_flash_attention.fp8_launches
    for model in (cpu_model, copy.deepcopy(cpu_model).to(dev)):
        sess = StreamingSession(model, cfg, tok, max_len=1024,
                                kv_dtype=torch.float8_e4m3fn)
        res = []
        for stamps, q, mode in (([0.0, 1.0, 2.0], "what is it?", "AC"),
                                ([3.0, 4.0, 5.0], "and now?", "FCC")):
            sess.append_stream_segment(pv, (3, 4, 4), 2, timestamps=stamps)
            r = sess.ask(q, mode=mode, max_new_tokens=8)
            res.append((r["tokens"], r["selection"]))
        c = sess.cache
        outs.append((res, [(r.kind, r.start, r.end) for r in sess.ranges],
                     c.pos.cpu(), c.k.cpu().view(torch.uint8),
                     c.v.cpu().view(torch.uint8)))
    assert lma.decode_attention.fp8_launches + \
        lma.prefill_flash_attention.fp8_launches > f0
    (ref, ref_r, pos, rk, rv), (got, got_r, gpos, gk, gv) = outs
    assert got == ref and got_r == ref_r and torch.equal(gpos, pos)
    live = pos[0] >= 0
    for a, b in ((gk, rk), (gv, rv)):
        a, b = a[:, 0, live].int(), b[:, 0, live].int()
        assert (a == b).float().mean().item() >= 0.995
        ordinal = [torch.where(x >= 128, 128 - x, x) for x in (a, b)]
        assert (ordinal[0] - ordinal[1]).abs().max().item() <= 1


@pytest.mark.parametrize("kernel,S", [("K3", 16), ("K4", 1), ("K4", 8)])
@pytest.mark.parametrize("operand", ["V", "K"])
def test_e4m3_widening_is_exact(dev, kernel, S, operand):
    """All 256 e4m3 byte values (NaN included) through the tensor-core
    kernels' widening, bit for bit (NaN where the byte is NaN).

    V: the V of the one visible slot, q = 0: every output head equals its
    kv head's V row widened by torch. K: the K row of slot 0 (head h, dim
    d holds byte 128 h + d) beside a zero K at slot 1, each folded query
    row r one-hot at dim r % 128, so each score is one product: the output
    equals the bf16 kernel's on the widened cache (K3 with 16 queries of 8
    heads, K4 with 8 of 16: 128 rows a kv head, every dim probed; the NaN
    bytes in kv heads of their own, _k_widening_is_exact)."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    wrap = (lma.prefill_flash_attention if kernel == "K3"
            else lma.decode_attention)
    if operand == "K":
        _k_widening_is_exact(dev, wrap, S)
        return
    _, T, Hkv, G, D = 1, 200, 2, 7, 128
    f8 = torch.float8_e4m3fn
    vb = torch.zeros((1, T, Hkv, D), dtype=torch.uint8)
    vb[0, 0] = torch.arange(256, dtype=torch.uint8).reshape(Hkv, D)
    v8 = vb.to(dev).view(f8)
    k8 = torch.zeros_like(vb).to(dev).view(f8)
    q = torch.zeros((1, S, Hkv * G, D), dtype=torch.bfloat16, device=dev)
    eff = torch.full((1, T), lma.SENTINEL, dtype=torch.int32, device=dev)
    eff[0, 0] = 0
    qpos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    out = wrap(q, k8, v8, qpos, eff).float().cpu()
    want = v8[0, 0].to(torch.bfloat16).float().cpu()       # [Hkv, D]
    want = want.repeat_interleave(G, 0)[None, None].expand(1, S, -1, -1)
    torch.testing.assert_close(out, want, rtol=0, atol=0, equal_nan=True)


def _k_widening_is_exact(dev, wrap, S, f8=torch.float8_e4m3fn):
    """The K case of test_e4m3_widening_is_exact (and of e5m2's). Kv heads
    0 and 1 hold every finite byte (byte 128 h + d at dim d; the others
    zeroed), heads 2 and 3 only the NaN bytes 0x7f and 0xff (at dim 127):
    a NaN anywhere in a key's row makes every score of that row NaN (0 x
    NaN), in both kernels."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    T, Hkv, D = 200, 4, 128
    G = 128 // S
    bf = torch.bfloat16
    kb = torch.zeros((1, T, Hkv, D), dtype=torch.uint8)
    every = torch.arange(256, dtype=torch.uint8)
    every[~torch.isfinite(every.view(f8).float())] = 0
    kb[0, 0, :2] = every.reshape(2, D)
    kb[0, 0, 2, 127], kb[0, 0, 3, 127] = 0x7F, 0xFF
    k8 = kb.to(dev).view(f8)
    rng = np.random.default_rng(3)
    v8 = _t(rng.standard_normal((1, T, Hkv, D)), dev, bf).to(f8)
    q = torch.zeros((1, S, Hkv, G, D), dtype=bf)
    r = torch.arange(S * G)
    q[0, r // G, :, r % G, r % D] = 1.0
    q = q.reshape(1, S, Hkv * G, D).to(dev)
    eff = torch.full((1, T), lma.SENTINEL, dtype=torch.int32, device=dev)
    eff[0, :2] = torch.tensor([0, 1], dtype=torch.int32)
    qpos = torch.arange(1, S + 1, dtype=torch.int32, device=dev)[None]
    n0 = wrap.fp8_launches
    out = wrap(q, k8, v8, qpos, eff).float().cpu()
    assert wrap.fp8_launches == n0 + 1
    ref = wrap(q, k8.to(bf), v8.to(bf), qpos, eff).float().cpu()
    nan = torch.isnan(ref).reshape(S, Hkv, G, D)
    assert nan[:, 2:].all() and not nan[:, :2].any()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(out[~torch.isnan(ref)], ref[~torch.isnan(ref)])


def test_row_parallel_product_has_the_layer_gradient(dev):
    """``ops/quant._mm_wide`` (a row shard's bf16 product with f32 sums,
    ``torch.mm(out_dtype=)``) under autograd on the card: the output is
    the f32-summed product, and the input's gradient through the rounded
    output equals ``F.linear``'s (the whole layer's backward) bit for
    bit."""
    import torch.nn.functional as F

    from cogstream_tpu_torch.ops.quant import _mm_wide

    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((3, 5, 256)), dev, torch.bfloat16)
    w = _t(rng.standard_normal((96, 256)) / 16, dev, torch.bfloat16)
    g = _t(rng.standard_normal((3, 5, 96)), dev, torch.bfloat16)
    xa = x.clone().requires_grad_(True)
    y = _mm_wide(xa, w)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x.float() @ w.float().t(), atol=1e-3,
                               rtol=1e-3)
    dx, = torch.autograd.grad(y.to(torch.bfloat16), xa, g)
    xb = x.clone().requires_grad_(True)
    ref, = torch.autograd.grad(F.linear(xb, w), xb, g)
    assert torch.equal(dx, ref)


PPERMUTE_RANK = """
import sys, torch, torch.distributed as dist
sys.path.insert(0, {repo!r})
from cogstream_tpu_torch.parallel.mesh import COLLECTIVE_BYTES, ppermute
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
dev = torch.device("cuda", 0)
out = {{}}
for dtype in (torch.float32, torch.bfloat16):
    for shift in (1, -1):
        x = torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(
            rank)).to(dev, dtype).requires_grad_(True)
        w = torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(
            10 + rank)).to(dev, dtype)
        y = ppermute(x, dist.group.WORLD, shift)
        (y * w).sum().backward()
        out[(str(dtype), shift)] = (y.detach().cpu(), x.grad.cpu(),
                                    y.device.type, x.grad.device.type)
out["bytes"] = COLLECTIVE_BYTES["ppermute"]
torch.save(out, {path!r} + f"/r{{rank}}.pt")
dist.destroy_process_group()
"""


def test_ppermute_of_cuda_tensors_over_a_gloo_pair(dev, tmp_path):
    """``ppermute`` of f32 and bf16 CUDA tensors between two ranks that
    share the card over gloo (its host route), with shift +1 and -1: each
    rank receives the other's tensor bit for bit, on the card, and the
    backward's reverse hop gives each rank the gradient the other rank
    computed for the received tensor, bit for bit."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = PPERMUTE_RANK.format(repo=repo, port=port, path=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)])
             for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    got = [torch.load(tmp_path / f"r{r}.pt") for r in range(2)]
    for dtype in (torch.float32, torch.bfloat16):
        for shift in (1, -1):
            for r in range(2):
                y, gx, ydev, gdev = got[r][(str(dtype), shift)]
                x_other = torch.randn(3, 5, 7, generator=torch.Generator()
                                      .manual_seed(1 - r)).to(dtype)
                w_other = torch.randn(3, 5, 7, generator=torch.Generator()
                                      .manual_seed(11 - r)).to(dtype)
                assert ydev == gdev == "cuda" and y.dtype == dtype
                assert torch.equal(y, x_other)
                assert torch.equal(gx, w_other)
    # two hops a call (forward and backward) of 105 elements
    assert got[0]["bytes"] == 2 * 2 * 105 * (4 + 2)


# ---------------------------------------------------------------------------
# the other KV cache dtypes: e5m2, f16, an f32 cache under bf16 queries, a
# bf16 one under f32 queries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype,top", [(torch.float8_e5m2, 57344.0),
                                          (torch.float16, 65504.0)])
def test_cache_cast_on_the_card_equals_the_cpu(dev, kv_dtype, top):
    """The port's cache cast (``qwen2.to_cache``) into e5m2 / f16 on the
    card equals it on the CPU for all 65536 bf16 bit patterns and f32 draws
    (NaN to NaN), and nothing it writes is inf: past the clamp it writes
    the largest value (ROADMAP Queue 3)."""
    from cogstream_tpu_torch.models.qwen2 import to_cache

    bits = torch.from_numpy(np.arange(1 << 16, dtype=np.uint16).view(
        np.int16)).view(torch.bfloat16)
    rng = np.random.default_rng(0)
    f32 = torch.from_numpy((rng.standard_normal(1 << 20) * 10.0 ** rng.uniform(
        -8, 6, 1 << 20)).astype(np.float32))
    for x in (bits, f32):
        card = to_cache(x.to(dev), kv_dtype).cpu().float()
        cpu = to_cache(x, kv_dtype).float()
        nan = torch.isnan(x)
        assert torch.equal(card[~nan], cpu[~nan])
        assert torch.isnan(card[nan]).all()
        assert not torch.isinf(card).any()
        assert card[~nan].abs().max().item() <= top


# (query dtype, cache dtype): every route of K3 / K4 over another cache
KV_ROUTES = [pytest.param(torch.bfloat16, torch.float8_e5m2, id="bf16-e5m2"),
             pytest.param(torch.bfloat16, torch.float16, id="bf16-f16"),
             pytest.param(torch.bfloat16, torch.float32, id="bf16-f32"),
             pytest.param(torch.float32, torch.bfloat16, id="f32-bf16"),
             pytest.param(torch.float32, torch.float8_e5m2, id="f32-e5m2"),
             pytest.param(torch.float32, torch.float16, id="f32-f16")]


@pytest.mark.parametrize("rows", [None, [3, 1]])
@pytest.mark.parametrize("kernel,S", [("K3", 100), ("K3", 1210),
                                      ("K3", 2420), ("K4", 1),
                                      ("K4", 5), ("K4", 8)])
@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("q_dtype,kv_dtype", KV_ROUTES)
def test_kv_dtype_cache_kernels(dev, rows, kernel, S, D, q_dtype, kv_dtype):
    """K3 and K4 over a ``kv_dtype`` cache against their plain versions on
    the same values (test_fp8_cache_kernels' cases): bf16 queries on the
    tensor-core kernels, each row within 2 bf16 ulps of its max |ref|
    (every K3 instance the kind has: e5m2 and f16 e4m3's three, f32 its
    two 8-warp ones), f32 queries on the f32 tiles (2e-5); with
    ``rows``
    reading a 4-row pool, bit-identical to a contiguous copy. Counted in
    ``.kv_launches`` under the cache's dtype; the padded query outputs 0."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(S * 10 + D + len(rows or ()) + 7)
    B = 1 if rows is None else len(rows)
    T, window = (4000, 3400) if S > 1000 else (1100, 1000)
    q, k, v, qpos, eff = _decode_case(rng, dev, B, S, 7, D, T, window, 900)
    q = q.to(q_dtype)
    kc, vc = k.float().to(kv_dtype), v.float().to(kv_dtype)
    wrap = (lma.prefill_flash_attention if kernel == "K3"
            else lma.decode_attention)
    kw = {}
    if rows is not None:
        kc = torch.cat([kc, kc.flip(0)]).contiguous()     # 4 pool rows
        vc = torch.cat([vc, vc.flip(0)]).contiguous()
        kw = dict(rows=lma.cache_rows(rows, dev))
    name = str(kv_dtype).removeprefix("torch.")
    n0, c0 = wrap.launches, wrap.kv_launches.get(name, 0)
    got = wrap(q, kc, vc, qpos, eff, **kw)
    assert (wrap.launches, wrap.kv_launches[name]) == (n0 + 1, c0 + 1)
    ref = lma.gqa_attention_plain(q, kc, vc, qpos, eff, rows=rows)
    if q_dtype == torch.bfloat16:
        _two_ulps(got, ref)
    else:
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
    if S >= 2:
        assert torch.all(got[:, -1] == 0)
    if rows is not None:
        assert torch.equal(got, wrap(q, kc[rows].contiguous(),
                                     vc[rows].contiguous(), qpos, eff))


@pytest.mark.parametrize("kv_dtype", [torch.float8_e5m2, torch.float16,
                                      torch.float32])
def test_kv_dtype_decode_replays_in_a_graph(dev, kv_dtype):
    """One K4 call over an e5m2, f16 or f32 cache (bf16 queries) captured
    in a CUDA graph, replayed after q and eff were rewritten in place,
    equals the eager call bit for bit; two eager calls give the same
    bits; within 2 bf16 ulps of the plain version."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(13)
    q, k, v, qpos, eff = _decode_case(rng, dev, 1, 1, 7, 128, 16384, 9216,
                                      8900)
    q2, _, _, _, eff2 = _decode_case(rng, dev, 1, 1, 7, 128, 16384, 9216,
                                     9000)
    kc, vc = k.float().to(kv_dtype), v.float().to(kv_dtype)
    first = lma.decode_attention(q, kc, vc, qpos, eff)
    assert torch.equal(first, lma.decode_attention(q, kc, vc, qpos, eff))
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = lma.decode_attention(q, kc, vc, qpos, eff)
    q.copy_(q2)
    eff.copy_(eff2)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, lma.decode_attention(q, kc, vc, qpos, eff))
    _two_ulps(out, lma.gqa_attention_plain(q, kc, vc, qpos, eff))


# rows a block of each K3 instance over a cache in another dtype than q
# and its weight (a block's time a wave) in cs_gqa_prefill_tc's
# fewest-waves rule, by cache kind
K3_WEIGHTS = {torch.float8_e4m3fn: ((256, 17), (128, 11), (64, 10)),
              torch.float16: ((256, 17), (128, 11), (64, 10)),
              torch.float32: ((256, 20), (128, 14))}


def _k3_rows_a_block(dev, kv_dtype, S, B, G=7, Hkv=2):
    """The rows a block of the K3 instance dispatch_prefill_tc picks: over
    bf16 128 unless that leaves SMs idle, then 64; over another cache
    (fp8, f16, f32) the fewest waves of one block an SM, weighted."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if kv_dtype == torch.bfloat16:
        return 128 if -(-S * G // 128) * B * Hkv >= sms else 64
    cost = {n: -(-(-(-S * G // n) * B * Hkv) // sms) * w
            for n, w in K3_WEIGHTS[kv_dtype]}   # f32: no 64-row instance
    return min(cost, key=lambda n: (cost[n], -n))


def _one_ulp_apart(got, want):
    """Each element of two bf16 tensors within one bf16 ulp of the larger
    magnitude of the two (equal where both are 0)."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    assert torch.all((g - w).abs() <= ulp), ((g - w).abs() / ulp).max()


@pytest.mark.parametrize("rows", [None, [3, 1]])
@pytest.mark.parametrize("S", [100, 600, 1210, 2420])
@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("kv_dtype", [torch.float16, torch.float32])
def test_rounded_cache_prefill_equals_the_bf16_kernel(dev, rows, S, D,
                                                      kv_dtype):
    """K3 over an f16 or f32 cache (bf16 queries) against the bf16 kernel
    over the cache rounded to bf16: the same rounding (round to nearest
    even, K4's narrowing as each thread stores its chunks into the bf16
    tile), the same body, the same key order, so bit for bit equal where
    both launch blocks of as many rows. The cache holds f32 normal draws
    cast to the kind (not bf16 values: every element rounds), with
    subnormals and values on bf16's rounding ties (at the draws' scale) in
    V; the read windows of 1000 and 3400 slots end in a ragged tile and
    the slots 64..127 are all masked (_decode_case). Both pick their
    instance by weighted waves (the mirror below): f16 64 rows a block at
    S = 100 and 600 (128 with ``rows``), 256 at S = 1210 (128 with
    ``rows``) and 128 at S = 2420 (256 with ``rows``), as many as bf16 but
    at S = 1210 and at 2420 with ``rows``; f32 128 at S = 100 and 600 and
    256 at S = 1210 and 2420, as many as bf16 at S = 600 with ``rows``. A
    larger block walks the tiles that any of its rows sees, and a tile
    that a row sees nothing of rescales that row's sums by exp2 of a
    rounding residue (1, or 1 -+ an f32 ulp), so there each element is
    held within one bf16 ulp of the bf16 kernel's. With ``rows`` the cache
    is a 4-row pool. Both within 2 bf16 ulps of the plain version."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(S * 10 + D + len(rows or ()) + 23)
    B = 1 if rows is None else len(rows)
    T, window = (4000, 3400) if S > 500 else (1100, 1000)
    q, _, _, qpos, eff = _decode_case(rng, dev, B, S, 7, D, T, window, 900)
    assert _k3_rows_a_block(dev, kv_dtype, S, B) == {
        (torch.float16, 100): 64, (torch.float16, 600): 64 * B,
        (torch.float16, 1210): 256 // B, (torch.float16, 2420): 128 * B,
        (torch.float32, 100): 128, (torch.float32, 600): 128,
        (torch.float32, 1210): 256, (torch.float32, 2420): 256}[kv_dtype, S]
    kc = _t(rng.standard_normal((B, T, 2, D)), dev).to(kv_dtype)
    v32 = rng.standard_normal((B, T, 2, D)).astype(np.float32)
    if kv_dtype == torch.float16:
        special = np.array([2.0 ** -24, 3 * 2.0 ** -24, 2.0 ** -14,
                            -(2.0 ** -20), 1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8,
                            -(1 + 2.0 ** -8), 3 + 2.0 ** -7], np.float32)
    else:
        hi = rng.integers(0x3E00, 0x4080, 64, dtype=np.uint32) << 16
        special = (hi | 0x8000).view(np.float32)  # bf16 ties in [1/8, 4)
    v32[:, 130:130 + special.size // 8, 0, :8] = special.reshape(-1, 8)
    vc = _t(v32, dev).to(kv_dtype)
    kw = {}
    if rows is not None:
        kc = torch.cat([kc, kc.flip(0)]).contiguous()     # 4 pool rows
        vc = torch.cat([vc, vc.flip(0)]).contiguous()
        kw = dict(rows=lma.cache_rows(rows, dev))
    wrap = lma.prefill_flash_attention
    name = str(kv_dtype).removeprefix("torch.")
    n0, c0 = wrap.tc_launches, wrap.kv_launches.get(name, 0)
    got = wrap(q, kc, vc, qpos, eff, **kw)
    assert (wrap.tc_launches, wrap.kv_launches[name]) == (n0 + 1, c0 + 1)
    bf = torch.bfloat16
    want = wrap(q, kc.to(bf), vc.to(bf), qpos, eff, **kw)
    if (_k3_rows_a_block(dev, kv_dtype, S, B)
            == _k3_rows_a_block(dev, bf, S, B)):
        assert torch.equal(got, want)
    else:
        _one_ulp_apart(got, want)
    _two_ulps(got, lma.gqa_attention_plain(q, kc, vc, qpos, eff, rows=rows))
    assert torch.all(got[:, -1] == 0)


def _wide_cache(rng, dev, kv_dtype, B, T, D, Hkv=2):
    """K and V of a [B, T, Hkv, D] cache of kind kv_dtype (f16 or f32)
    from f32 normal draws (not bf16 values: every element rounds), with
    subnormals and values on bf16's rounding ties (at the draws' scale) in
    V's slots 130.. of head 0 (where T holds them)."""
    kc = _t(rng.standard_normal((B, T, Hkv, D)), dev).to(kv_dtype)
    v32 = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    if kv_dtype == torch.float16:
        special = np.array([2.0 ** -24, 3 * 2.0 ** -24, 2.0 ** -14,
                            -(2.0 ** -20), 1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8,
                            -(1 + 2.0 ** -8), 3 + 2.0 ** -7], np.float32)
    else:
        hi = rng.integers(0x3E00, 0x4080, 64, dtype=np.uint32) << 16
        special = (hi | 0x8000).view(np.float32)  # bf16 ties in [1/8, 4)
    if T >= 130 + special.size // 8:
        v32[:, 130:130 + special.size // 8, 0, :8] = special.reshape(-1, 8)
    return kc, _t(v32, dev).to(kv_dtype)


@pytest.mark.parametrize("window", [64, 1000, 16384])
@pytest.mark.parametrize("B,rows", [(1, None), (2, None), (2, [3, 1])])
@pytest.mark.parametrize("S", [1, 5, 8])
@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("kv_dtype", [torch.float16, torch.float32])
def test_rounded_cache_decode_equals_the_bf16_kernel(monkeypatch, dev, window,
                                                     B, rows, S, D, kv_dtype):
    """K4 over an f16 or f32 cache (bf16 queries) against the bf16 kernel
    over the cache rounded to bf16: the same rounding (round to nearest
    even, B fragments rounded in registers before their MMA) and the same
    products and sums, so bit for bit equal where the kind runs bf16's
    plan (its warps and split). f16 has bf16's 4 warps: on bf16's split
    (decode_plan made to give it) it is bit-equal. On the kind's own plan
    (f16 whole tiles a warp, f32 3 warps) a warp's online softmax sees
    other tiles before a given one, so P is rounded to bf16 against
    another running max: a row that averages thousands of slots moves by
    a part of a bf16 ulp of its own max |out|, not of each element (one
    near 0 moves by many of its own ulps). There each row is held within
    one bf16 ulp of its max |bf16 kernel| (_row_ulps), half the plain
    version's rule; where the two plans cut the same tiles, bit for bit.
    The cache holds f32 normal draws cast to the kind with subnormals and
    bf16 ties in V (_wide_cache); read windows of 64 (one tile), 1000 (a
    ragged last tile, the slots 64..127 all masked: _decode_case) and
    16384 slots; with ``rows`` a 4-row pool. Both within 2 bf16 ulps of
    the plain version; the padded query is 0; two calls give the same
    bits."""
    from cogstream_tpu_torch.ops import kernels
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(S * 10 + D + B + len(rows or ()) + window)
    T, fill = {64: (64, 50), 1000: (1100, 900), 16384: (16384, 16000)}[
        window]
    q, _, _, qpos, eff = _decode_case(rng, dev, B, S, 7, D, T, window, fill)
    kc, vc = _wide_cache(rng, dev, kv_dtype, B, T, D)
    kw = {}
    if rows is not None:
        kc = torch.cat([kc, kc.flip(0)]).contiguous()     # 4 pool rows
        vc = torch.cat([vc, vc.flip(0)]).contiguous()
        kw = dict(rows=lma.cache_rows(rows, dev))
    wrap = lma.decode_attention
    name = str(kv_dtype).removeprefix("torch.")
    n0, c0 = wrap.tc_launches, wrap.kv_launches.get(name, 0)
    got = wrap(q, kc, vc, qpos, eff, **kw)
    assert (wrap.tc_launches, wrap.kv_launches[name]) == (n0 + 1, c0 + 1)
    bf = torch.bfloat16
    want = wrap(q, kc.to(bf), vc.to(bf), qpos, eff, **kw)
    code = kernels.KV_DTYPE_CODES[kv_dtype]
    sms = kernels.sm_count(dev)
    plan, bf16_plan = (lma.decode_plan(B, 2, S * 7, D, window, sms, kind)
                       for kind in (kv_dtype, bf))
    same_warps = lma.DECODE_WARPS[code] == lma.DECODE_WARPS[1]
    assert same_warps == (kv_dtype == torch.float16)
    n_tiles = -(-window // 64)
    if same_warps and min(plan[2], n_tiles) == min(bf16_plan[2], n_tiles):
        assert torch.equal(got, want)
    else:
        _row_ulps(got, want, 1)
    _two_ulps(got, lma.gqa_attention_plain(q, kc, vc, qpos, eff, rows=rows))
    if S >= 2:
        assert torch.all(got[:, -1] == 0)
    assert torch.equal(got, wrap(q, kc, vc, qpos, eff, **kw))
    if same_warps:   # on bf16's split: bf16's bits
        parts = lma.decode_plan
        monkeypatch.setattr(lma, "decode_plan", lambda *a: parts(*a[:6]))
        assert torch.equal(wrap(q, kc, vc, qpos, eff, **kw), want)


@pytest.mark.parametrize("kernel,S", [("K3", 16), ("K4", 1), ("K4", 8)])
@pytest.mark.parametrize("operand", ["V", "K"])
def test_e5m2_widening_is_exact(dev, kernel, S, operand):
    """test_e4m3_widening_is_exact over e5m2: all 256 byte values as the
    one visible V row widen exactly (inf to inf, NaN to NaN), and every
    finite byte as K (one product a score) equals the bf16 kernel on the
    widened cache bit for bit, NaN where a NaN byte is."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    f8 = torch.float8_e5m2
    wrap = (lma.prefill_flash_attention if kernel == "K3"
            else lma.decode_attention)
    if operand == "K":
        _k_widening_is_exact(dev, wrap, S, f8)
        return
    T, Hkv, G, D = 200, 2, 7, 128
    vb = torch.zeros((1, T, Hkv, D), dtype=torch.uint8)
    vb[0, 0] = torch.arange(256, dtype=torch.uint8).reshape(Hkv, D)
    v8 = vb.to(dev).view(f8)
    k8 = torch.zeros_like(vb).to(dev).view(f8)
    q = torch.zeros((1, S, Hkv * G, D), dtype=torch.bfloat16, device=dev)
    eff = torch.full((1, T), lma.SENTINEL, dtype=torch.int32, device=dev)
    eff[0, 0] = 0
    qpos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    out = wrap(q, k8, v8, qpos, eff).float().cpu()
    want = v8[0, 0].to(torch.bfloat16).float().cpu()       # [Hkv, D]
    want = want.repeat_interleave(G, 0)[None, None].expand(1, S, -1, -1)
    torch.testing.assert_close(out, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("model_dtype,kv_dtype", [
    ("float32", torch.float8_e5m2), ("float32", torch.bfloat16),
    ("float32", torch.float16)])
def test_kv_dtype_session_card_matches_cpu(dev, model_dtype, kv_dtype):
    """The tiny f32 session (test_fp8_session_card_matches_cpu's turns)
    over an e5m2, bf16 or f16 cache on the card (the f32 CUDA-core tile
    reading that cache) and on the CPU: the same greedy tokens,
    selections, slot ranges and positions; the cache where pos >= 0 equal
    in at least 99.5% of elements (f16: 99%), each element within one step
    of the cache dtype at its (layer, token, kv head) row's max |ref|. A
    ~1e-6 difference of the f32 keys flips a rounding only next to a tie,
    and a flip moves later layers' keys by a sliver of the row: the finer
    the format the more flips, and the more of its steps such a sliver is
    at a small element (f16's share read 99.35% on an H100, and some small
    elements more than one step of their own apart)."""
    import copy
    import dataclasses

    from cogstream_tpu_torch.config import CogReasonerConfig
    from cogstream_tpu_torch.models.cogreasoner import init_cogreasoner_params
    from cogstream_tpu_torch.ops import lm_attention as lma
    from cogstream_tpu_torch.processor.tokenizer import ByteTokenizer
    from cogstream_tpu_torch.runtime.session import StreamingSession

    cfg = CogReasonerConfig.tiny()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, dtype=model_dtype))
    cpu_model = init_cogreasoner_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    tok = ByteTokenizer(image_token_id=cfg.image_token_index)
    pv = np.random.default_rng(0).normal(size=(48, 588)).astype(np.float32)
    name = str(kv_dtype).removeprefix("torch.")
    c0 = lma.decode_attention.kv_launches.get(name, 0)
    outs = []
    for model in (cpu_model, copy.deepcopy(cpu_model).to(dev)):
        sess = StreamingSession(model, cfg, tok, max_len=1024,
                                kv_dtype=kv_dtype)
        res = []
        for stamps, q, mode in (([0.0, 1.0, 2.0], "what is it?", "AC"),
                                ([3.0, 4.0, 5.0], "and now?", "FCC")):
            sess.append_stream_segment(pv, (3, 4, 4), 2, timestamps=stamps)
            r = sess.ask(q, mode=mode, max_new_tokens=8)
            res.append((r["tokens"], r["selection"]))
        c = sess.cache
        outs.append((res, [(r.kind, r.start, r.end) for r in sess.ranges],
                     c.pos.cpu(), c.k.cpu().float(), c.v.cpu().float()))
    assert lma.decode_attention.kv_launches.get(name, 0) > c0
    (ref, ref_r, pos, rk, rv), (got, got_r, gpos, gk, gv) = outs
    assert got == ref and got_r == ref_r and torch.equal(gpos, pos)
    live = pos[0] >= 0
    # mantissa bits, smallest normal exponent: a step at |x| is
    # 2^(max(floor(log2 |x|), emin) - bits)
    bits, emin = {torch.float8_e5m2: (2, -14), torch.bfloat16: (7, -126),
                  torch.float16: (10, -14)}[kv_dtype]
    share = 0.99 if kv_dtype == torch.float16 else 0.995
    for a, b in ((gk, rk), (gv, rv)):
        a, b = a[:, 0, live], b[:, 0, live]
        assert (a == b).float().mean().item() >= share
        row_max = b.abs().amax(-1, keepdim=True)
        step = torch.exp2(torch.floor(torch.log2(row_max)).clamp_min(emin)
                          - bits)
        assert torch.all((a - b).abs() <= step)
