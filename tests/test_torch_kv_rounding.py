"""K3 over an f16 or f32 KV cache under bf16 queries is the bf16 kernel
over the cache rounded to bf16, on the CPU.

The JAX kernel (``cogstream_tpu/ops/lm_attention.py::_prefill_kernel``)
rounds each K / V tile to the queries' dtype (``k_ref[0].astype(q.dtype)``)
and runs its bf16 body; the port's tensor-core K3 rounds each 16-byte
chunk where it lands (``csrc/tc_tile.cuh``: ``chunk_to_bf16``, f16 -> f32
exactly, then ``cvt.rn.bf16x2.f32``) and runs the unchanged bf16 body, so
on the card its output equals the bf16 kernel's over ``cache.to(bf16)``
bit for bit (``tests/test_torch_cuda.py``). What that rests on is held
here:

* the rounding: torch's ``.to(torch.bfloat16)`` (what the card test and
  the plain version use), round to nearest even on the f32 bits (what
  ``cvt.rn`` does) and JAX's ``astype(jnp.bfloat16)`` agree on every f16
  bit pattern and on f32 values at bf16's rounding ties, beside them,
  subnormal, at the largest finite values and past them (NaN only as
  NaN);
* the plain K3 over such a cache (f16's largest values and subnormals,
  f32 ties) equals the plain K3 over the cache rounded to bf16 bit for
  bit;
* JAX's kernel (interpret mode, the JAX package's own CPU route) over the
  cache equals JAX's kernel over the cache rounded by ``astype`` bit for
  bit, and the port's plain K3 lies within 2 bf16 ulps of each output
  row's max |ref| of it (the rule of ``tests/test_torch_fp8kv.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogstream_tpu.ops import lm_attention as jlma
from cogstream_tpu_torch.ops import lm_attention as tlma

F16 = torch.float16
F32 = torch.float32


def _rne_bf16_bits(x32: np.ndarray) -> np.ndarray:
    """bf16 bits of f32 values by round to nearest even (cvt.rn.bf16.f32)."""
    u = x32.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _f32_specials() -> np.ndarray:
    """f32 values on bf16's rounding ties (low 16 bits 0x8000), one unit of
    f32 beside them, subnormals, the largest finite values and zeros."""
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 0x7F7F, 4096, dtype=np.uint32) << 16
    sign = rng.integers(0, 2, 4096, dtype=np.uint32) << 31
    tie = hi | 0x8000 | sign
    bits = np.concatenate([
        tie, tie - 1, tie + 1,
        np.arange(1, 1 << 12, dtype=np.uint32),          # subnormals
        np.array([0x007FFFFF, 0x00800000, 0x7F7FFFFF, 0xFF7FFFFF,
                  0x7F7F8000, 0x7F7F7FFF, 0x00000000, 0x80000000],
                 np.uint32)])
    return bits.view(np.float32)


@pytest.mark.parametrize("kv_dtype", [F16, F32])
def test_bf16_rounding_is_round_to_nearest_even(kv_dtype):
    """torch's and JAX's rounding to bf16 equal round to nearest even on
    the f32 bits: every f16 bit pattern, and f32 ties and specials."""
    if kv_dtype == F16:
        x = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    else:
        x = _f32_specials()
    nan = np.isnan(x)
    want = _rne_bf16_bits(x.astype(np.float32))
    got_t = torch.from_numpy(x.copy()).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)
    got_j = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    for got in (got_t, got_j):
        np.testing.assert_array_equal(got[~nan], want[~nan])
        assert np.isnan(got[nan].view(jnp.bfloat16).astype(np.float32)).all()
    if kv_dtype == F16:   # f16's largest finite value rounds to 2^16
        assert want[x == np.float16(65504)][0] == 0x4780
        assert (np.abs(x.astype(np.float32)) < 2.0 ** -14).sum() > 2000
    else:                 # every tie to an even bf16, about half upward
        assert (want[:4096] & 1 == 0).all()
        up = want[:4096] != x[:4096].view(np.uint32) >> 16
        assert 0.3 < up.mean() < 0.7


def _case(rng, kv_dtype, B=1, S=16, T=256, Hq=4, Hkv=2, D=64, fill=160):
    """q (bf16), a K / V cache in ``kv_dtype`` holding normal draws with
    the dtype's special values written over some slots, q positions and
    eff: slots past fill + S empty, a few holes, the tile 64..127 all
    masked, the last query padded."""
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    if kv_dtype == F16:
        special = np.array([65504, -65504, 2.0 ** -24, 3 * 2.0 ** -24,
                            2.0 ** -14, 1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8,
                            -(1 + 2.0 ** -8)], np.float32)
        k[0, 5, 0, :8] = special / 4096     # bounded scores
        v[0, 5, 0, :8] = special
    else:
        special = _f32_specials()[:4096]
        special = special[np.abs(special) < 1e4]
        k.reshape(-1)[:special.size] = special    # the first ~18 slots
        v.reshape(-1)[:special.size] = special[::-1]
    pos = np.full((B, T), -1, np.int32)
    pos[:, :fill + S] = np.arange(fill + S)
    pos[:, rng.choice(fill, 6, replace=False)] = -1
    pos[:, 64:128] = -1
    qpos = np.broadcast_to(fill + np.arange(S, dtype=np.int32),
                           (B, S)).copy()
    qpos[:, -1] = -1
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kc = torch.from_numpy(k).to(kv_dtype)
    vc = torch.from_numpy(v).to(kv_dtype)
    return q, kc, vc, qpos, pos


@pytest.mark.parametrize("kv_dtype", [F16, F32])
def test_plain_prefill_over_a_cache_equals_it_rounded(kv_dtype):
    """The plain K3 (bf16 queries) over an f16 / f32 cache equals the
    plain K3 over that cache rounded to bf16, bit for bit."""
    q, kc, vc, qpos, pos = _case(np.random.default_rng(31), kv_dtype)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    eff = tlma.effective_kv_positions(torch.from_numpy(pos))
    qp = torch.from_numpy(qpos)
    got = tlma.prefill_flash_attention(qt, kc, vc, qp, eff)
    want = tlma.prefill_flash_attention(qt, kc.to(torch.bfloat16),
                                        vc.to(torch.bfloat16), qp, eff)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert torch.all(got[:, -1] == 0)


def _row_rule(got, ref, width):
    g = np.asarray(got, np.float32).reshape(-1, width)
    r = np.asarray(ref, np.float32).reshape(-1, width)
    err = np.abs(g - r).max(1)
    row_max = np.maximum(np.abs(r).max(1), 1e-30)
    return float((err / (2 * np.exp2(np.floor(np.log2(row_max)) - 7))).max())


@pytest.mark.parametrize("kv_dtype", [F16, F32])
def test_jax_prefill_kernel_rounds_the_cache(kv_dtype):
    """JAX's ``_prefill_kernel`` (interpret mode) over an f16 / f32 cache
    equals it over the cache rounded by ``astype(bfloat16)`` bit for bit,
    and the port's plain K3 over the same cache agrees with it by the
    2-ulp row rule."""
    q, kc, vc, qpos, pos = _case(np.random.default_rng(37), kv_dtype)
    kj, vj = jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy())
    qj = jnp.asarray(q, jnp.bfloat16)
    effj = jlma.effective_kv_positions(jnp.asarray(pos))
    ref = jlma.prefill_flash_attention(qj, kj, vj, jnp.asarray(qpos), effj,
                                       interpret=True)
    ref_r = jlma.prefill_flash_attention(
        qj, kj.astype(jnp.bfloat16), vj.astype(jnp.bfloat16),
        jnp.asarray(qpos), effj, interpret=True)
    ref32 = np.asarray(ref, np.float32)
    np.testing.assert_array_equal(ref32, np.asarray(ref_r, np.float32))
    assert np.isfinite(ref32).all()
    out = tlma.prefill_flash_attention(
        torch.from_numpy(q).to(torch.bfloat16), kc, vc,
        torch.from_numpy(qpos),
        tlma.effective_kv_positions(torch.from_numpy(pos)))
    assert _row_rule(out.float().numpy(), ref32, q.shape[-1]) <= 1.0
