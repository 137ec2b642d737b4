"""The port's CUDA kernels (K1-K10) against their plain PyTorch versions,
on the card: the bf16 tensor-core kernels of K1, K3, K4 and K5 and the
f32 CUDA-core tiles beside them; K3 and K4 reading a pool cache through
``rows``; a tiny pool card against CPU; the int4 GEMVs K6-K9 (K6 and K10 in bf16 on one persistent kernel, their
repeats and graph replays), the int8 GEMV K10 and the W8A8 product's ``torch._int_mm`` at few rows. Marked ``cuda``: without a CUDA device every test skips.

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
    ((300, 200), 12, 64), ((300, 200), 12, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vision_attention_kernel(dev, lengths, pad, D, dtype):
    """K1 against its plain version: bf16 on the tensor-core tile (frames
    of 1008 straddle its 256-row blocks; D = 72 and 40 pad the Q.K^T
    depth to 80 and 48), f32 on the CUDA-core tile; pad rows exactly 0."""
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


def _decode_case(rng, dev, B, S, G, D, T, window, fill):
    """A bf16 decode step over a ``window``-slot read of a T-slot cache
    holding ``fill`` history slots plus the step's S: position holes, a
    random 70% kv_allowed, the slots 64..127 all disallowed (a wholly
    masked key tile); with S >= 2 the last query is padded (-1), with
    S >= 3 query 0 sits at position 0, whose slot is disallowed, so it
    sees nothing."""
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
        pos[b, rng.choice(fill, 5, replace=False)] = -1
        qpos[b] = fill + np.arange(S)
    allowed = rng.random((B, T)) > 0.3
    allowed[:, 64:128] = False
    if S >= 2:
        qpos[:, -1] = -1
    if S >= 3:
        qpos[:, 0] = 0
        allowed[pos == 0] = False
    eff = effective_kv_positions(_t(pos, dev, torch.int32),
                                 _t(allowed, dev, torch.bool))
    return q, k, v, _t(qpos, dev, torch.int32), eff[:, :window].contiguous()


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
@pytest.mark.parametrize("kernel,S", [("K3", 100), ("K4", 1), ("K4", 5),
                                      ("K4", 8)])
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 64),
                                     (torch.float32, 128)])
def test_fp8_cache_kernels(dev, rows, kernel, S, dtype, D):
    """K3 and K4 over an e4m3 cache against their plain versions on the
    same bytes: bf16 queries on the tensor-core kernels (each row within 2
    bf16 ulps of its max |ref|), f32 on the CUDA-core tile (f32 summation
    order, 2e-5); with ``rows`` reading a 4-row e4m3 pool, bit-identical
    to a contiguous copy of the addressed rows. Counted in
    ``.fp8_launches``; the padded query outputs 0."""
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(S * 10 + D + len(rows or ()))
    B = 1 if rows is None else len(rows)
    q, k, v, qpos, eff = _decode_case(rng, dev, B, S, 7, D, 1100, 1000, 900)
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
def test_e4m3_widening_is_exact(dev, kernel, S):
    """All 256 e4m3 byte values (NaN included) as the V of the one visible
    slot, q = 0: every output head equals its kv head's V row widened by
    torch, bit for bit (NaN where the byte is NaN): the tensor-core
    kernels' widening, its bit path and its NaN path."""
    from cogstream_tpu_torch.ops import lm_attention as lma

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
    wrap = (lma.prefill_flash_attention if kernel == "K3"
            else lma.decode_attention)
    out = wrap(q, k8, v8, qpos, eff).float().cpu()
    want = v8[0, 0].to(torch.bfloat16).float().cpu()       # [Hkv, D]
    want = want.repeat_interleave(G, 0)[None, None].expand(1, S, -1, -1)
    torch.testing.assert_close(out, want, rtol=0, atol=0, equal_nan=True)
