"""Which C entry point each attention wrapper reaches, checked on the CPU.

The wrappers of K1, K3 and K4 pick their kernel by operand type: bf16
goes to the tensor-core tiles (``cs_vision_attention_tc``,
``cs_gqa_prefill_tc``), f32 to the CUDA-core f32 tiles
(``cs_vision_attention``, ``cs_gqa_attention``), and decode to
``cs_gqa_attention`` then ``cs_gqa_combine`` whatever the type. Here the
kernel library, the stream and the device route are stubbed, so no card
is needed: each test records the calls a wrapper makes and checks the
entry points, the arguments they get (against the ctypes signatures in
``ops/kernels.py``) and the launch counters. The kernels' results are
checked on the card (``tests/test_torch_cuda.py``).
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from cogstream_tpu_torch.ops import flash_attention as fa
from cogstream_tpu_torch.ops import kernels
from cogstream_tpu_torch.ops import lm_attention as lma


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
    return stub


def _lm(dtype, B=1, S=20, T=256, D=128, window=None, Hq=28, Hkv=4):
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((B, S, Hq, D)), dtype=dtype)
    k = torch.tensor(rng.standard_normal((B, T, Hkv, D)), dtype=dtype)
    qpos = torch.arange(S, dtype=torch.int32).repeat(B, 1)
    eff = torch.arange(window or T, dtype=torch.int32).repeat(B, 1)
    return q, k, k.clone(), qpos, eff


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


@pytest.mark.parametrize("B,window", [(1, None), (2, 200)])
def test_prefill_f32_reaches_cuda_core_tile(lib, B, window):
    q, k, v, qpos, eff = _lm(torch.float32, B=B, window=window)
    wrap = lma.prefill_flash_attention
    n0, t0 = wrap.launches, wrap.tc_launches
    wrap(q, k, v, qpos, eff)
    assert lib.names() == ["cs_gqa_attention"]
    args = lib.calls[0][1]
    assert args[7:10] == (None, None, None)      # no partials: K3's form
    n_tiles = -(-eff.shape[1] // 64)
    # B, S, Hq, Hkv, D, T_cache, kv_len, chunk_tiles, n_chunks
    assert args[10:19] == (B, 20, 28, 4, 128, 256, eff.shape[1], n_tiles, 1)
    assert args[20] == kernels.DTYPE_CODES[torch.float32]
    assert (wrap.launches, wrap.tc_launches) == (n0 + 1, t0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_reaches_gqa_attention_and_combine(lib, dtype):
    q, k, v, qpos, eff = _lm(dtype, S=3, T=600, window=520)
    n0 = lma.decode_attention.launches
    t0 = lma.prefill_flash_attention.tc_launches
    lma.decode_attention(q, k, v, qpos, eff)
    assert lib.names() == ["cs_gqa_attention", "cs_gqa_combine"]
    args = lib.calls[0][1]
    assert all(isinstance(a, int) for a in args[7:10])   # partials
    n_tiles = -(-520 // 64)
    n_chunks = -(-n_tiles // lma.DECODE_CHUNK_TILES)
    assert args[10:19] == (1, 3, 28, 4, 128, 600, 520,
                           lma.DECODE_CHUNK_TILES, n_chunks)
    assert args[20] == kernels.DTYPE_CODES[dtype]
    assert lib.calls[1][1][4:10] == (1, 3, 28, 4, 128, n_chunks)
    assert lma.decode_attention.launches == n0 + 1
    assert lma.prefill_flash_attention.tc_launches == t0


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


@pytest.mark.parametrize("kernel,D", [("K3", 96), ("K3", 32), ("K1", 76),
                                      ("K1", 136)])
def test_unsupported_bf16_head_dim_raises_before_any_call(lib, kernel, D):
    if kernel == "K3":
        wrap, entry = lma.prefill_flash_attention, "cs_gqa_prefill_tc"
        args = _lm(torch.bfloat16, D=D)
    else:
        wrap, entry = (fa.flash_attention_packed_rope_fusedqkv,
                       "cs_vision_attention_tc")
        args = _vision(torch.bfloat16, D=D)
    n0, t0 = wrap.launches, wrap.tc_launches
    with pytest.raises(ValueError, match=entry):
        wrap(*args)
    assert lib.calls == []
    assert (wrap.launches, wrap.tc_launches) == (n0, t0)


@pytest.mark.parametrize("kernel", ["K3", "K1"])
def test_other_dtypes_raise_before_any_call(lib, kernel):
    if kernel == "K3":
        wrap, args = lma.prefill_flash_attention, _lm(torch.float16)
    else:
        wrap, args = (fa.flash_attention_packed_rope_fusedqkv,
                      _vision(torch.float16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wrap(*args)
    assert lib.calls == []
