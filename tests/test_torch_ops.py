"""The PyTorch port's ops against the JAX package, on the CPU.

On the CPU every kernel wrapper of the port runs its plain PyTorch
version; here each plain version is held to the JAX Pallas kernel it
replaces, run in interpret mode exactly as the JAX package's own tests
run it, and to the JAX reference oracle. Inputs are seeded numpy draws
fed to both sides. f32 at atol = rtol = 1e-5, but for the bf16 cases of
``causal_gqa_attention``, whose bound is stated with them.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogstream_tpu.ops import attention as jatt
from cogstream_tpu.ops import flash_attention as jfa
from cogstream_tpu.ops import layernorm as jln
from cogstream_tpu.ops import lm_attention as jlma
from cogstream_tpu.ops import rope as jrope
from cogstream_tpu_torch.ops import attention as tatt
from cogstream_tpu_torch.ops import flash_attention as tfa
from cogstream_tpu_torch.ops import layernorm as tln
from cogstream_tpu_torch.ops import lm_attention as tlma
from cogstream_tpu_torch.ops import rope as trope

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype))


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

def test_rope_1d():
    rng = np.random.default_rng(0)
    pos = rng.integers(-1, 2048, (2, 9)).astype(np.int32)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    ja = jrope.rope_angles(jnp.maximum(jnp.asarray(pos), 0), 16, 1e6)
    ta = trope.rope_angles(_t(pos).clamp(min=0), 16, 1e6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(
        trope.apply_rope(_t(x), ta).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), ja)), **TOL)


def test_rope_2d_vision():
    rng = np.random.default_rng(1)
    pos = jrope.grid_position_ids(2, 6, 4, 2)
    x = rng.standard_normal((pos.shape[0], 3, 16)).astype(np.float32)
    ja = jrope.vision_rope_angles(jnp.asarray(pos), 16)
    ta = trope.vision_rope_angles(_t(pos), 16)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    for j, t in zip(jrope.vision_rope_cos_sin(ja),
                    trope.vision_rope_cos_sin(ta)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    np.testing.assert_allclose(
        trope.apply_vision_rope(_t(x), ta).numpy(),
        np.asarray(jrope.apply_vision_rope(jnp.asarray(x), ja)), **TOL)


# ---------------------------------------------------------------------------
# K2 layernorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,H", [(16, 128), (24, 32)])
def test_layernorm_plain_vs_pallas(N, H):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((N, H)) * 2 + 0.5).astype(np.float32)
    sc = rng.standard_normal(H).astype(np.float32)
    b = rng.standard_normal(H).astype(np.float32)
    ref = jln.pallas_layernorm(jnp.asarray(x), jnp.asarray(sc),
                               jnp.asarray(b), 1e-6, interpret=True)
    got = tln.layernorm(_t(x), _t(sc), _t(b), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# K1 vision attention with fused rope
# ---------------------------------------------------------------------------

def _k1_case(rng, lengths, pad, H=2, D=16):
    seg = np.concatenate([np.full(L, i, np.int32)
                          for i, L in enumerate(lengths)]
                         + [np.full(pad, -1, np.int32)])
    N = seg.shape[0]
    qkv = rng.standard_normal((N, 3 * H * D)).astype(np.float32)
    pos = rng.integers(0, 30, (N, 2)).astype(np.int32)
    ang = np.asarray(jrope.vision_rope_angles(jnp.asarray(pos), D))
    cos2, sin2 = (np.asarray(a)[:, 0] for a in
                  jrope.vision_rope_cos_sin(jnp.asarray(ang)))
    return seg, qkv, ang, cos2, sin2


@pytest.mark.parametrize("lengths,pad", [((40, 40, 40), 0),
                                         ((50, 77, 13), 20)])
def test_vision_attention_plain_vs_pallas(lengths, pad):
    rng = np.random.default_rng(3)
    H, D = 2, 16
    seg, qkv, ang, cos, sin = _k1_case(rng, lengths, pad, H, D)
    N = seg.shape[0]
    got = tfa.flash_attention_packed_rope_fusedqkv(
        _t(qkv), _t(cos), _t(sin), _t(seg), *map(
            _t, tfa.vision_kv_ranges(seg)), heads=H).numpy()

    # JAX Pallas kernel (interpret): 128-lane per-head padding, padded rows
    fr = jfa.FlashRanges.build(seg)
    Np, Dp = fr.n_padded, 128
    qkv_p = np.zeros((Np, 3, H, Dp), np.float32)
    qkv_p[:N, :, :, :D] = qkv.reshape(N, 3, H, D)
    cs_p = np.zeros((Np, Dp), np.float32)
    sn_p = np.zeros((Np, Dp), np.float32)
    cs_p[:N, :D], sn_p[:N, :D] = cos, sin
    perm = np.zeros((Dp, Dp), np.float32)
    perm[:D, :D] = np.asarray(jrope.rope_half_permutation(D))
    seg_p = np.full((1, Np), -1, np.int32)
    seg_p[0, :N] = seg
    out = jfa.flash_attention_packed_rope_fusedqkv(
        jnp.asarray(qkv_p.reshape(Np, 3 * H * Dp)), jnp.asarray(cs_p),
        jnp.asarray(sn_p), jnp.asarray(perm), jnp.asarray(seg_p),
        jnp.asarray(fr.kv_start), jnp.asarray(fr.kv_count), H, Dp,
        fr.block_q, fr.block_k, fr.kmax, 1.0 / math.sqrt(D), True,
        aligned=fr.aligned)
    ref = np.asarray(out).reshape(Np, H, Dp)[:N, :, :D].reshape(N, H * D)
    np.testing.assert_allclose(got, ref, **TOL)

    # and the JAX oracle: rope, then segment attention
    q, k, v = (jnp.asarray(a) for a in
               np.split(qkv.reshape(N, 3, H, D), 3, axis=1))
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    ja = jnp.asarray(ang)
    oracle = jatt.segment_attention(jrope.apply_vision_rope(q, ja),
                                    jrope.apply_vision_rope(k, ja), v,
                                    jnp.asarray(seg))
    real = N - pad
    np.testing.assert_allclose(got[:real],
                               np.asarray(oracle).reshape(N, -1)[:real],
                               **TOL)
    assert np.all(got[real:] == 0)


# ---------------------------------------------------------------------------
# K5 head-major segment attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths,total", [
    ([64, 64], 128),                       # block-aligned
    ([100, 57, 200, 43], 428),             # ragged, straddling blocks
    ([300], 300),
    ([136] * 16, None),                    # aligned whole-frame blocks
    ([136] * 6, 1024),                     # padded tail
])
def test_segment_attention_plain_vs_pallas(lengths, total):
    """K5's plain version against the JAX ``segment_flash_attention``
    (Pallas ``_flash_kernel``, interpret mode) on the valid rows; pad
    rows output 0 (the kernel's masked rows), where the JAX oracle
    ``segment_attention`` would average V uniformly."""
    rng = np.random.default_rng(7)
    seg = np.concatenate([np.full(L, i, np.int32)
                          for i, L in enumerate(lengths)])
    real = seg.shape[0]
    if total is not None and total > real:
        seg = np.concatenate([seg, np.full(total - real, -1, np.int32)])
    N, H, D = seg.shape[0], 2, 24
    q, k, v = (rng.standard_normal((N, H, D)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jfa.segment_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg, interpret=True))
    got = tfa.segment_flash_attention(_t(q), _t(k), _t(v), _t(seg)).numpy()
    np.testing.assert_allclose(got[:real], ref[:real], **TOL)
    assert np.all(got[real:] == 0)
    oracle = np.asarray(jatt.segment_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg)))
    np.testing.assert_allclose(got[:real], oracle[:real], **TOL)


def test_segment_attention_has_no_backward():
    """K5 is forward-only in both packages: it raises on inputs that
    require grad under grad mode, and runs under no_grad."""
    seg = torch.zeros(8, dtype=torch.int32)
    q = torch.randn(8, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.segment_flash_attention(q, q, q, seg)
    with torch.no_grad():
        assert tfa.segment_flash_attention(q, q, q, seg).shape == q.shape


# ---------------------------------------------------------------------------
# K3 prefill
# ---------------------------------------------------------------------------

def _cache(rng, B, T, Hkv, D, fill):
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    pos = np.full((B, T), -1, np.int32)
    pos[:, :fill] = np.arange(fill)
    pos[:, fill // 3] = -1                 # position holes
    pos[:, fill // 2] = -1
    return k, v, pos


@pytest.mark.parametrize("T", [1024, 300])
def test_prefill_plain_vs_pallas(T):
    rng = np.random.default_rng(4)
    B, S, Hq, Hkv, D, fill = 1, 128, 4, 2, 128, 150
    k, v, pos = _cache(rng, B, T, Hkv, D, fill)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    qpos = np.full((B, S), -1, np.int32)
    real = S - 17                            # padded tail queries
    qpos[:, :real] = fill + np.arange(real)
    pos[:, fill:fill + real] = qpos[:, :real]
    allowed = rng.random((B, T)) > 0.3
    allowed[:, fill:] = True
    # a real query whose every visible slot is disallowed → row of zeros
    qpos[:, real - 1] = 5
    allowed[:, :6] = False
    eff_j = jlma.effective_kv_positions(jnp.asarray(pos),
                                        jnp.asarray(allowed))
    eff_t = tlma.effective_kv_positions(_t(pos), _t(allowed))
    np.testing.assert_array_equal(eff_t.numpy(), np.asarray(eff_j))
    got = tlma.prefill_flash_attention(_t(q), _t(k), _t(v), _t(qpos),
                                       eff_t).numpy()
    ref_xla = jatt.causal_gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos),
        kv_valid=jnp.asarray((pos >= 0) & allowed),
        kv_positions=jnp.asarray(pos))
    np.testing.assert_allclose(got, np.asarray(ref_xla), **TOL)
    if T % 128 == 0:
        ref = jlma.prefill_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(qpos), eff_j, interpret=True)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    assert np.all(got[:, real:] == 0) and np.all(got[:, real - 1] == 0)


# ---------------------------------------------------------------------------
# K4 decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,Hq,Hkv,done", [(1, 4, 2, False), (4, 7, 1, False),
                                           (1, 4, 2, True)])
def test_decode_plain_vs_pallas(S, Hq, Hkv, done):
    """The JAX kernel folds main cache ⊕ side buffer ⊕ fresh K/V; the
    port writes in place, so the same slots form ONE cache here."""
    rng = np.random.default_rng(5)
    B, T, Ts, D, fill, side_fill = 1, 2048, 32, 128, 700, 5
    mk, mv, mpos = _cache(rng, B, T, Hkv, D, fill)
    sk = rng.standard_normal((B, Ts, Hkv, D)).astype(np.float32)
    sv = rng.standard_normal((B, Ts, Hkv, D)).astype(np.float32)
    spos = np.full((B, Ts), -1, np.int32)
    spos[:, :side_fill] = fill + np.arange(side_fill)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kn = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    step = np.full((B, S), -1, np.int32) if done else \
        (fill + side_fill + np.arange(S, dtype=np.int32))[None]
    allowed = rng.random((B, T)) > 0.3

    eff_m = jlma.effective_kv_positions(jnp.asarray(mpos),
                                        jnp.asarray(allowed))
    eff_s = jlma.effective_kv_positions(jnp.asarray(spos))
    ref = jlma.decode_splash_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(mk[None]), jnp.asarray(mv[None]),
        jnp.asarray(sk[None]), jnp.asarray(sv[None]), jnp.int32(0),
        jnp.asarray(step), jnp.repeat(eff_m, Hkv, axis=1),
        jnp.repeat(eff_s, Hkv, axis=1), interpret=True)

    kc = np.concatenate([mk, sk, kn], axis=1)
    vc = np.concatenate([mv, sv, vn], axis=1)
    pc = np.concatenate([mpos, spos, step], axis=1)
    ac = np.concatenate([allowed, np.ones((B, Ts + S), bool)], axis=1)
    eff = tlma.effective_kv_positions(_t(pc), _t(ac))
    got = tlma.decode_attention(_t(q), _t(kc), _t(vc), _t(step), eff).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    if done:
        assert np.all(got == 0)


# ---------------------------------------------------------------------------
# causal_gqa_attention in bf16: JAX's gemm_dtype rule, dense and chunked
# ---------------------------------------------------------------------------

def _gqa_case(rng, B, S, Hq, Hkv, D, pad=3):
    """Training-forward operands (S == T, kv positions = q positions):
    seeded q/k/v in f32 and positions with the last ``pad`` queries of
    each row padded (-1)."""
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[:, S - pad:] = -1
    return q, k, v, pos


def _gqa_both(q, k, v, pos, dtype, **kw):
    """JAX's and the port's causal_gqa_attention on the same operands in
    ``dtype`` (both round the f32 draws to nearest even), as f32 numpy."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jatt.causal_gqa_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(pos),
        kv_valid=jnp.asarray(pos >= 0), kv_positions=jnp.asarray(pos), **kw)
    got = tatt.causal_gqa_attention(
        *(_t(a).to(dtype) for a in (q, k, v)), _t(pos),
        kv_valid=_t(pos >= 0), kv_positions=_t(pos), **kw)
    return got.float().numpy(), np.asarray(ref.astype(jnp.float32))


def _all_f32_form(q, k, v, pos):
    """The port's form before the gemm_dtype rule: q, k, v and the
    probabilities in f32 for every input dtype (the control)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, S, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) / math.sqrt(D)
    mask = (pos[:, :, None] >= pos[:, None, :]) & (pos[:, None, :] >= 0)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, tatt.NEG_INF))
    probs = torch.softmax(logits, dim=-1) * mask[:, None, None]
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def _bf16_agreement(got, ref):
    """(share of equal elements, worst |got - ref| in bf16 ulps of its
    row's max |ref|, a row being one head of one query)."""
    D = got.shape[-1]
    g, r = got.reshape(-1, D), ref.reshape(-1, D)
    row_max = np.abs(r).max(1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(np.maximum(row_max, 1e-30))) - 7)
    return float(np.mean(g == r)), float((np.abs(g - r) / ulp).max())


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(2, 64, 4, 2, 32),
                                          (1, 256, 8, 2, 64)])
def test_causal_gqa_bf16_dense_matches_jax(B, S, Hq, Hkv, D):
    """bf16 dense branch: bf16 GEMM operands, f32 logits and softmax,
    probabilities rounded to bf16 before P.V, as JAX's gemm_dtype rule.
    The port equals JAX in >= 99.9% of the elements and is everywhere
    within 2 bf16 ulps of its row's max |ref| (f32 sums in another order
    can flip one output rounding); padded queries are exactly 0. The
    control: the all-f32 form misses the 99.9% (~30% of the elements
    differ)."""
    rng = np.random.default_rng(B * S + D)
    q, k, v, pos = _gqa_case(rng, B, S, Hq, Hkv, D)
    got, ref = _gqa_both(q, k, v, pos, torch.bfloat16)
    same, ulps = _bf16_agreement(got, ref)
    assert same >= 0.999 and ulps <= 2, (same, ulps)
    assert np.all(got[:, -3:] == 0) and np.all(ref[:, -3:] == 0)
    old = _all_f32_form(*(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                        _t(pos)).float().numpy()
    assert _bf16_agreement(old, ref)[0] < 0.99


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_causal_gqa_chunked_matches_jax(dtype):
    """The chunked online-softmax branch (kv_chunk 1024, reached through
    ``chunk_threshold`` at one kv head: S = T = 1300, two chunks) against
    JAX's chunked branch: bf16 to the dense bound (>= 99.9% equal, 2
    ulps of the row max), f32 within 1e-5; padded queries exactly 0."""
    rng = np.random.default_rng(11)
    q, k, v, pos = _gqa_case(rng, 1, 1300, 2, 1, 16, pad=5)
    got, ref = _gqa_both(q, k, v, pos, dtype, chunk_threshold=1 << 16)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, **TOL)
        dense = tatt.causal_gqa_attention(
            _t(q), _t(k), _t(v), _t(pos), kv_valid=_t(pos >= 0),
            kv_positions=_t(pos)).numpy()
        np.testing.assert_allclose(got, dense, **TOL)
    else:
        same, ulps = _bf16_agreement(got, ref)
        assert same >= 0.999 and ulps <= 2, (same, ulps)
    assert np.all(got[:, -5:] == 0) and np.all(ref[:, -5:] == 0)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_sampling_rules():
    from cogstream_tpu.runtime import sampling as jsamp
    from cogstream_tpu_torch.runtime import sampling as tsamp

    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 3
    seen = rng.random((3, 50)) > 0.7
    np.testing.assert_allclose(
        tsamp.apply_repetition_penalty(_t(logits), _t(seen), 1.3).numpy(),
        np.asarray(jsamp.apply_repetition_penalty(
            jnp.asarray(logits), jnp.asarray(seen), 1.3)), **TOL)
    allowed = [3, 7, 11, 40]
    jm = jsamp.build_vocab_mask(50, allowed)
    tm = tsamp.build_vocab_mask(50, allowed)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    greedy = np.asarray(jsamp.sample_token(jnp.asarray(logits),
                                           jax.random.PRNGKey(0),
                                           vocab_mask=jm))
    np.testing.assert_array_equal(
        tsamp.sample_token(_t(logits), vocab_mask=tm).numpy(), greedy)
    # top-k 1 and a vanishing top-p keep only the argmax
    g = torch.Generator().manual_seed(0)
    arg = logits.argmax(-1)
    for kw in (dict(top_k=1), dict(top_p=1e-6)):
        got = tsamp.sample_token(_t(logits), g, temperature=0.7, **kw)
        np.testing.assert_array_equal(got.numpy(), arg)
    # sampled draws stay inside the top-k support
    top3 = np.argsort(-logits, -1)[:, :3]
    for _ in range(20):
        got = tsamp.sample_token(_t(logits), g, temperature=1.0,
                                 top_k=3).numpy()
        assert all(got[b] in top3[b] for b in range(3))
