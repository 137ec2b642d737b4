"""Fused-unpack 4-bit GEMV for the rank-1 serving scheme: the wrappers of
K6-K9 (``csrc/int4_gemv.cu``) and their plain versions. Port of
``cogstream_tpu/ops/quant_gemv.py``.

A rank-1 int4 weight (ops/quant.py ``quantize_int4_rank1``) is
``w[p, o] = code(nib[p, o]) * rscale[p] * scale[o]`` with the nibbles
packed two to a byte in the split-halves layout. Every wrapper does the
same three steps as the JAX wrapper:

1. outside the kernel, ``rscale`` (and, for the stacked form, the
   uniform code slope) multiplies into the activations in f32, which then
   round to bf16 (bf16-dot variants) or quantize per row AND per half to
   int8 (W4A8 variants, ``sx [m, 2]``);
2. the kernel unpacks the nibbles, dots them with the activations
   (f32 sums of exact bf16 products, or exact int32 sums), and
3. applies the column scale once, as the epilogue.

Where the codebook slope ``code[0]`` folds differs by form, as in JAX:
the 2D wrappers (K6, K7) fold it into the column scale, the stacked ones
(K8, K9) into the activations before rounding.

The four kernels:

* K6 ``gemv_k6``: 2D weight, bf16-dot, uniform or cubic codebook
  (``s * (A + C * s^2)`` rounded to bf16, as the TPU kernel's bf16 dot
  operand); replaces ``_gemv_kernel``;
* K7 ``gemv_k7``: 2D weight, int8 activations; ``_gemv_kernel_w4a8``;
* K8 ``gemv_k8``: stacked ``[L, din/2, dout]`` weights and a layer index
  read on the device; ``_gemv_kernel_idx``;
* K9 ``gemv_k9``: K8 with int8 activations; ``_gemv_kernel_idx_w4a8``.

Each launcher runs its plain version for a CPU tensor and launches its
kernel for a CUDA tensor; there is no other route. ``*_plain`` wrappers
run the plain version on any device (the card checks compare against
them). The plain W4A8 form sums in f32, which is exact here: |x| <= 127,
|w| <= 7 and din/2 <= 9472 keep every sum below 2^24 (TF32 must be off).

The route decision (``gemv_viable``/``gemv_viable_stacked``) is the JAX
package's, copied: the kernel path and the materializing path round
differently, so the port must take the kernel exactly where JAX does.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from . import kernels

# the JAX package's block policy, kept only for the route decision: a
# shape routes to the kernel iff it blocks into 128-multiples there
_BLOCK_BUDGET = 3 * 2 ** 20
_BK_CAP = 4736

# csrc/int4_gemv.cu variants and tiling
UNIFORM, CUBIC, W4A8 = 0, 1, 2
_BN = 256               # output columns per block
_MIN_SPLIT_ROWS = 64    # packed rows a K split covers at least


def _largest_divisor(n: int, target: int, floor: int) -> Optional[int]:
    """Largest d <= target with d | n, d a multiple of ``floor``."""
    d = (min(target, n) // floor) * floor
    while d >= floor:
        if n % d == 0:
            return d
        d -= floor
    return None


@functools.lru_cache(maxsize=None)
def _pick_blocks(half: int, dout: int):
    """The JAX kernel's block sizes; None when the shape cannot block
    (not 128-multiple divisible), which keeps it off the kernel route."""
    bk = _largest_divisor(half, _BK_CAP, 128)
    if bk is None:
        return None
    bn_target = max(512, (_BLOCK_BUDGET // bk) // 128 * 128)
    bn = _largest_divisor(dout, bn_target, 128)
    if bn is None:
        return None
    return bk, bn


def gemv_viable(qp: Dict[str, torch.Tensor], m: int, m_max: int = 64) -> bool:
    """The 2D route: a 2D rank-1 weight, blockable shapes, ``m <= 64``."""
    packed = qp.get("q4")
    if packed is None or "rscale" not in qp or packed.ndim != 2:
        return False
    if m > m_max:
        return False
    return _pick_blocks(*packed.shape) is not None


def gemv_viable_stacked(qp: Dict[str, torch.Tensor], m: int,
                        m_max: int = 64) -> bool:
    """The indexed route: stacked ``[L, half, dout]`` rank-1 UNIFORM
    weights at ``m <= 64`` with blockable shapes."""
    packed = qp.get("q4")
    if packed is None or "rscale" not in qp or packed.ndim != 3:
        return False
    if qp["code"].shape[-1] != 1 or m > m_max:
        return False
    return _pick_blocks(packed.shape[1], packed.shape[2]) is not None


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def _int8_halves(xs: torch.Tensor, half: int):
    """``xs`` [m, din] f32 → (xq int8 [m, din], sx f32 [m, 2]): each half
    of each row quantized with its own absmax, as the JAX wrapper's
    ``q8`` on each half (round half to even, ``sx = absmax / 127``)."""
    m = xs.shape[0]
    v = xs.reshape(m, 2, half)
    ax = v.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6)
    q = torch.round(v * (ax.new_tensor(127.0) / ax)).clamp(-127, 127)
    return q.to(torch.int8).reshape(m, 2 * half), (ax * (1.0 / 127.0))[..., 0]


# ---------------------------------------------------------------------------
# plain versions (one 2D weight; the stacked plain forms slice the layer)
# ---------------------------------------------------------------------------

def _nibbles(q4: torch.Tensor):
    lo = (q4 << 4) >> 4
    return lo.to(torch.float32), (q4 >> 4).to(torch.float32)


def _plain_bf16(xb, q4, scale, code, cubic: bool, out_dtype):
    """K6/K8 plain: nibbles (through the cubic codebook, rounded to bf16)
    dotted with bf16 activations in f32, then the column scale."""
    half = q4.shape[0]
    lo, hi = _nibbles(q4)
    if cubic:
        a, c = code[0], code[1]
        lo = (lo * (a + c * (lo * lo))).to(torch.bfloat16).float()
        hi = (hi * (a + c * (hi * hi))).to(torch.bfloat16).float()
    x = xb.float()
    y = x[:, :half] @ lo + x[:, half:] @ hi
    return (y * scale).to(out_dtype)


def _plain_w4a8(xq, sx, q4, scale, out_dtype):
    """K7/K9 plain: int8 x int4 sums (exact in f32), per-half row scales,
    then the column scale. The row-scale step is one fused multiply-add,
    ``fma(acc_lo, sx_lo, acc_hi * sx_hi)``, as XLA compiles the JAX
    epilogue and as the kernel computes it; here in f64, where
    ``acc_lo * sx_lo`` (< 2^48) is exact, so only the add rounds (a
    double rounding could differ from the fused one in the last bit, at
    odds of about 2^-29)."""
    half = q4.shape[0]
    lo, hi = _nibbles(q4)
    x = xq.float()
    yl, yh = x[:, :half] @ lo, x[:, half:] @ hi
    y = (yl.double() * sx[:, 0:1].double()
         + (yh * sx[:, 1:2]).double()).float()
    return (y * scale).to(out_dtype)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

_sm_count: Dict[int, int] = {}


def _splits(dev: torch.device, n_blocks: int, half: int):
    """(rows per split, splits): split K until the grid holds about two
    blocks per SM (k_proj/v_proj's 512 columns give two column blocks)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    want = -(-2 * _sm_count[idx] // n_blocks)
    want = max(1, min(want, half // _MIN_SPLIT_ROWS))
    rows = -(-half // want)
    return rows, -(-half // rows)


def _launch(variant: int, x, sx, q4, scale, layer, code, out_dtype):
    """One K6-K9 launch: ``x`` [m, din] (bf16, or int8 for W4A8), ``q4``
    [half, dout] or stacked [L, half, dout] with ``layer`` an int32 [1]
    on the device, ``scale`` [dout] or [L, dout] f32."""
    dev = x.device
    stacked = q4.ndim == 3
    half, dout = q4.shape[-2:]
    m = x.shape[0]
    kernels.require(x, "x", dev, torch.int8 if variant == W4A8
                    else torch.bfloat16, (m, 2 * half))
    kernels.require(q4, "q4", dev, torch.int8)
    kernels.require(scale, "scale", dev, torch.float32,
                    (q4.shape[0], dout) if stacked else (dout,))
    if variant == W4A8:
        kernels.require(sx, "sx", dev, torch.float32, (m, 2))
    if variant == CUBIC:
        kernels.require(code, "code", dev, torch.float32, (2,))
    if stacked:
        kernels.require(layer, "layer", dev, torch.int32, (1,))
    if dout % 8:
        raise ValueError(f"int4 GEMV needs dout % 8 == 0, got {dout}")
    if m > 64:
        raise ValueError(f"int4 GEMV serves m <= 64, got {m}")
    out = torch.empty((m, dout), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    mt = 1 if m == 1 else 4 if variant == W4A8 else 8   # the kernel's m-tile
    n_blocks = -(-m // mt) * -(-dout // _BN)
    rows, splits = _splits(dev, n_blocks, half)
    part = None
    if splits > 1:   # f32 partials, or int32 lo/hi partials for W4A8
        part = torch.empty((splits * (2 if variant == W4A8 else 1), m, dout),
                           dtype=torch.int32 if variant == W4A8
                           else torch.float32, device=dev)
    lib = kernels.library()
    kernels.check(lib.cs_int4_gemv(
        x.data_ptr(), sx.data_ptr() if variant == W4A8 else None,
        q4.data_ptr(), half * dout if stacked else 0, scale.data_ptr(),
        dout if stacked else 0, layer.data_ptr() if stacked else None,
        code.data_ptr() if variant == CUBIC else None, out.data_ptr(),
        None if part is None else part.data_ptr(), m, half, dout, rows,
        splits, variant, kernels.dtype_code(out), kernels.stream_ptr(x)),
        "cs_int4_gemv")
    return out


def gemv_k6(xb, q4, scale, code, cubic: bool, out_dtype):
    """K6: 2D bf16-dot GEMV (uniform: raw nibbles, the slope already in
    ``scale``; cubic: the codebook from ``code = [A, C]``)."""
    if kernels.plain_route(xb):
        return _plain_bf16(xb, q4, scale, code, cubic, out_dtype)
    out = _launch(CUBIC if cubic else UNIFORM, xb, None, q4, scale, None,
                  code, out_dtype)
    gemv_k6.launches += 1
    return out


def gemv_k7(xq, sx, q4, scale, out_dtype):
    """K7: 2D W4A8 GEMV."""
    if kernels.plain_route(xq):
        return _plain_w4a8(xq, sx, q4, scale, out_dtype)
    out = _launch(W4A8, xq, sx, q4, scale, None, None, out_dtype)
    gemv_k7.launches += 1
    return out


def _layer_slice(q4, scale, layer):
    return q4.index_select(0, layer)[0], scale.index_select(0, layer)[0]


def gemv_k8(xb, q4, scale, layer, out_dtype):
    """K8: stacked bf16-dot GEMV over layer ``layer`` (device int32 [1])."""
    if kernels.plain_route(xb):
        return _plain_bf16(xb, *_layer_slice(q4, scale, layer), None, False,
                           out_dtype)
    out = _launch(UNIFORM, xb, None, q4, scale, layer, None, out_dtype)
    gemv_k8.launches += 1
    return out


def gemv_k9(xq, sx, q4, scale, layer, out_dtype):
    """K9: stacked W4A8 GEMV over layer ``layer``."""
    if kernels.plain_route(xq):
        return _plain_w4a8(xq, sx, *_layer_slice(q4, scale, layer), out_dtype)
    out = _launch(W4A8, xq, sx, q4, scale, layer, None, out_dtype)
    gemv_k9.launches += 1
    return out


for _fn in (gemv_k6, gemv_k7, gemv_k8, gemv_k9):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# wrappers (the JAX functions' signatures)
# ---------------------------------------------------------------------------

def _gemv_2d(x, qp, out_dtype, w4a8, plain: bool):
    dtype = out_dtype or x.dtype
    packed, scale = qp["q4"], qp["scale"]
    uniform = qp["code"].shape[-1] == 1     # the scheme tag
    half, dout = packed.shape
    din = 2 * half
    if _pick_blocks(half, dout) is None:
        raise ValueError(f"unblockable int4 shape {(din, dout)}")
    *lead, _ = x.shape
    xs = x.reshape(-1, din).to(torch.float32) \
        * qp["rscale"].to(torch.float32)[None, :]
    sc = scale.to(torch.float32)
    if uniform or w4a8:
        # the uniform slope (code[0], e.g. 1/7) folds into the column
        # scale; the kernel dots the raw nibbles
        sc = sc * qp["code"][0]
    if w4a8:
        xq, sx = _int8_halves(xs, half)
        y = (_plain_w4a8(xq, sx, packed, sc, dtype) if plain
             else gemv_k7(xq, sx, packed, sc, dtype))
    else:
        code = qp["code"].to(torch.float32).reshape(-1)
        if code.shape[0] == 1:                  # uniform: C = 0
            code = torch.cat([code, code.new_zeros(1)])
        xb = xs.to(torch.bfloat16)
        y = (_plain_bf16(xb, packed, sc, code, not uniform, dtype) if plain
             else gemv_k6(xb, packed, sc, code, not uniform, dtype))
    return y.reshape(*lead, dout)


def int4_rank1_gemv(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                    out_dtype=None, *, w4a8: bool = False) -> torch.Tensor:
    """``x @ W`` for a 2D rank-1 int4 weight: K6 (uniform or cubic, by
    the scheme tag), or K7 with ``w4a8``."""
    return _gemv_2d(x, qp, out_dtype, w4a8, plain=False)


def int4_rank1_gemv_plain(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                          out_dtype=None, *, w4a8: bool = False) -> torch.Tensor:
    """:func:`int4_rank1_gemv` through the plain version, on any device."""
    return _gemv_2d(x, qp, out_dtype, w4a8, plain=True)


def _gemv_stacked(x, qp, layer, out_dtype, w4a8, plain: bool):
    dtype = out_dtype or x.dtype
    packed, scale = qp["q4"], qp["scale"]
    L, half, dout = packed.shape
    din = 2 * half
    if _pick_blocks(half, dout) is None:
        raise ValueError(f"unblockable int4 shape {(din, dout)}")
    *lead, _ = x.shape
    # rscale and the uniform code slope fold into the activations
    r = qp["rscale"].index_select(0, layer).to(torch.float32) \
        * qp["code"].index_select(0, layer)[:, :1]
    xs = x.reshape(-1, din).to(torch.float32) * r
    if w4a8:
        xq, sx = _int8_halves(xs, half)
        if plain:
            y = _plain_w4a8(xq, sx, *_layer_slice(packed, scale, layer),
                            dtype)
        else:
            y = gemv_k9(xq, sx, packed, scale, layer, dtype)
    else:
        xb = xs.to(torch.bfloat16)
        if plain:
            y = _plain_bf16(xb, *_layer_slice(packed, scale, layer), None,
                            False, dtype)
        else:
            y = gemv_k8(xb, packed, scale, layer, dtype)
    return y.reshape(*lead, dout)


def int4_rank1_gemv_stacked(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                            layer: torch.Tensor, out_dtype=None, *,
                            w4a8: bool = False) -> torch.Tensor:
    """``x @ W[layer]`` for stacked rank-1 UNIFORM weights: K8, or K9 with
    ``w4a8``. ``layer`` is an int32 [1] tensor on the weights' device (a
    view into the decoder's ``arange(L)``), read by the kernel itself."""
    return _gemv_stacked(x, qp, layer, out_dtype, w4a8, plain=False)


def int4_rank1_gemv_stacked_plain(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                                  layer: torch.Tensor, out_dtype=None, *,
                                  w4a8: bool = False) -> torch.Tensor:
    """:func:`int4_rank1_gemv_stacked` through the plain version."""
    return _gemv_stacked(x, qp, layer, out_dtype, w4a8, plain=True)
