"""The port's CUDA kernels (K1-K4, K6-K9) against their plain PyTorch versions,
on the card. Marked ``cuda``: without a CUDA device every test skips.

On a machine with a card (and no JAX, so the repo's conftest cannot be
imported there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs are seeded numpy draws; each comparison is in float32 for the f32
kernels and in bf16 for the bf16 ones, with the tolerance stated where
it is asserted.
"""

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


@pytest.mark.parametrize("lengths,pad", [((64, 64), 0), ((50, 77, 13), 20),
                                         ((130,), 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vision_attention_kernel(dev, lengths, pad, dtype):
    from cogstream_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(1)
    H, D = 3, 72
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
    got = fa.flash_attention_packed_rope_fusedqkv(
        qkv, cos, sin, segt, _t(lo, dev, torch.int32),
        _t(hi, dev, torch.int32), H).float()
    ref = fa.flash_attention_packed_rope_plain(
        qkv, cos, sin, segt, H, 1 / np.sqrt(D)).float()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, ref, atol=tol, rtol=tol)
    assert torch.all(got[N - pad:] == 0)


def _lm_case(rng, dev, dtype, B, S, T, Hq, Hkv, fill, D=128):
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
    eff = effective_kv_positions(_t(pos, dev, torch.int32),
                                 _t(allowed, dev, torch.bool))
    return q, k, v, _t(qpos, dev, torch.int32), eff


@pytest.mark.parametrize("B,S,T,Hq,Hkv,fill", [
    (1, 100, 300, 28, 4, 150), (2, 70, 1000, 4, 2, 0),
    (1, 9, 4100, 7, 1, 3000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel(dev, B, S, T, Hq, Hkv, fill, dtype):
    from cogstream_tpu_torch.ops import lm_attention as lma

    rng = np.random.default_rng(2)
    q, k, v, qpos, eff = _lm_case(rng, dev, dtype, B, S, T, Hq, Hkv, fill)
    got = lma.prefill_flash_attention(q, k, v, qpos, eff).float()
    ref = lma.gqa_attention_plain(q, k, v, qpos, eff).float()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, ref, atol=tol, rtol=tol)
    assert torch.all(got[:, -1] == 0)        # padded query row → 0


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
@pytest.mark.parametrize("m", [1, 7, 33])
@pytest.mark.parametrize("w4a8", [False, True])
def test_int4_gemv_stacked_kernel(dev, L, half, dout, m, w4a8):
    """K8/K9 read their layer from a device int32 pointer: every layer,
    L - 1 included, against the plain version of that layer's slice."""
    from cogstream_tpu_torch.ops import quant_gemv as qg

    rng = np.random.default_rng(L * m)
    qp = _int4_weights(rng, dev, (L, half, dout))
    x = _t(rng.standard_normal((m, 2 * half)), dev)
    ids = torch.arange(L, dtype=torch.int32, device=dev)
    for layer in range(L):
        got = qg.int4_rank1_gemv_stacked(x, qp, ids[layer:layer + 1],
                                         torch.float32, w4a8=w4a8)
        ref = qg.int4_rank1_gemv_stacked_plain(x, qp, ids[layer:layer + 1],
                                               torch.float32, w4a8=w4a8)
        if w4a8:
            torch.testing.assert_close(got, ref, atol=0, rtol=0)
        else:
            _rowwise(got, ref, 1e-5)
        if layer == L - 1:   # the last layer differs from its neighbour
            other = qg.int4_rank1_gemv_stacked_plain(
                x, qp, ids[layer - 1:layer], torch.float32, w4a8=w4a8)
            assert not torch.allclose(got, other)


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
