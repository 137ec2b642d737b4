"""Fused-unpack 4-bit GEMV for the rank-1 serving scheme: the wrappers of
K6 (``csrc/quant_gemv_sm90.cu``: a persistent stream-K grid, a bulk-copy
ring and warpgroup MMAs, shared with K10), K7 (``csrc/int4_gemv.cu``, CUDA
cores) and K8/K9 (``csrc/int4_gemv_tc.cu``, tensor cores), and their plain
versions. K6, K8, K9 and K10 are one launch per call whose K splits meet
through a per-device workspace, so a call allocates only its output and
can be captured in a CUDA graph. Port of
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

On a row-parallel shard (``rows``, a ``quant.RowShard``) the W4A8 forms
quantize each packed half at the scale of the GLOBAL half of the row it
lies in (a MAX all-reduce of the ranks' partial absmaxes: the shard is
packed in its own pairing, whose halves are parts of one global half),
launch K7 / K9 with f32 output, and sum those partials over the group
before the one rounding; a column shard runs them unchanged.

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

Under autograd each wrapper keeps its kernel as the forward and takes the
transpose of the 2D XLA form as its backward (``dx = g @ W_deq^T`` per
packed half, ``quant.split_matmul_vjp``): the gradient a LoRA adapter
below a frozen int4 layer needs; the weights get none.

The route decision (``gemv_viable``/``gemv_viable_stacked``) is the JAX
package's, copied: the kernel path and the materializing path round
differently, so the port must take the kernel exactly where JAX does.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

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

def _int8_halves(xs: torch.Tensor, half: int,
                 ax: Optional[torch.Tensor] = None):
    """``xs`` [m, din] f32 → (xq int8 [m, din], sx f32 [m, 2]): each half
    of each row quantized with its own absmax, as the JAX wrapper's
    ``q8`` on each half (round half to even, ``sx = absmax / 127``).
    ``ax`` [m, 2]: the absmax each half takes instead (a row shard's
    global halves, ``quant.RowShard.absmax``)."""
    m = xs.shape[0]
    v = xs.reshape(m, 2, half)
    ax = (v.abs().amax(dim=-1) if ax is None else ax)[..., None]
    ax = ax.clamp(min=1e-6)
    q = torch.round(v * (ax.new_tensor(127.0) / ax)).clamp(-127, 127)
    return q.to(torch.int8).reshape(m, 2 * half), (ax * (1.0 / 127.0))[..., 0]


def _shard_halves(xs: torch.Tensor, half: int, rows):
    """:func:`_int8_halves` of a row shard's activations: each local half
    at the scale of the global half it lies in."""
    return _int8_halves(xs, half, rows.absmax(xs)[:, list(rows.halves())])


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

def _splits(dev: torch.device, n_blocks: int, half: int):
    """K6/K7 (rows per split, splits): split K until the grid holds about
    two blocks per SM (few column blocks leave SMs idle otherwise)."""
    want = -(-2 * kernels.sm_count(dev) // n_blocks)
    want = max(1, min(want, half // _MIN_SPLIT_ROWS))
    rows = -(-half // want)
    return rows, -(-half // rows)


def _check_operands(variant: int, x, sx, q4, scale, layer, code):
    """Validate one launch's operands: ``x`` [m, din] (bf16, or int8 for
    W4A8), ``q4`` [half, dout] or stacked [L, half, dout] with ``layer``
    an int32 [1] on the device, ``scale`` [dout] or [L, dout] f32."""
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


def _launch(variant: int, x, sx, q4, scale, code, out_dtype):
    """One ``cs_int4_gemv`` launch (``csrc/int4_gemv.cu``, K7's kernel) on
    a 2D weight."""
    _check_operands(variant, x, sx, q4, scale, None, code)
    dev = x.device
    half, dout = q4.shape
    m = x.shape[0]
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
        q4.data_ptr(), 0, scale.data_ptr(), 0, None,
        code.data_ptr() if variant == CUBIC else None, out.data_ptr(),
        None if part is None else part.data_ptr(), m, half, dout, rows,
        splits, variant, kernels.dtype_code(out), kernels.stream_ptr(x)),
        "cs_int4_gemv")
    return out


# csrc/int4_gemv_tc.cu (K8/K9): 256 threads and 128 output columns per
# block, a 4-stage ring of 128 packed rows x 128 columns, the block's
# activations staged
_TC_BN = 128
_TC_KT = 128
_TC_RING = 4 * _TC_KT * _TC_BN
_TC_X_BUDGET = 96 * 1024      # staged activation bytes a block may hold
_TC_SMEM_TWO = 113 * 1024     # shared memory that leaves two blocks per SM
_HBM_BYTES_PER_US = 3.35e6    # one H100's device-memory rate
_L2_ROUND_US = 0.5            # one round of dependent L2 loads, loaded
_BLOCK_US = 2.0               # a block's fixed time: first loads, epilogue


def _tc_x_stride(rows: int, w4a8: bool) -> int:
    """csrc/int4_gemv_tc.cu ``x_stride``: bytes per staged activation row."""
    return -(-rows * (1 if w4a8 else 2) // 128) * 128 + 32


@functools.lru_cache(maxsize=None)
def stacked_plan(m: int, half: int, dout: int, w4a8: bool,
                 sms: int, x_halves: int = 2) -> Tuple[int, int]:
    """(packed rows per split, splits) of one K8/K9 launch: the grid is
    (dout / 128 column tiles) x splits, each block streaming its split's
    rows in 128-row stages. A model of the call's time picks the split:
    waves of blocks over the SMs (two per SM where the registers and the
    shared memory allow: m <= 16), each wave paying a block's fixed time
    and streaming its blocks' weights at the card's device-memory rate
    (plus a third of that for their staged activations, read from L2);
    with splits, the partials written and read back through
    L2 (at about twice that rate) and the last blocks' rounds of
    dependent L2 loads (8 splits x 4 rows a round). So every SM streams
    about the same bytes and no wave is left mostly empty. Ties take fewer
    splits. Cached: a decode step asks it for the same few shapes 196
    times. K10's mma.sync kernel (ops/int8_gemv.py, the products too
    small for the persistent kernel), whose ring stages hold 128 int8 rows
    where K8's hold 128 packed rows, plans with it too: ``half`` is then
    its din and ``x_halves`` 1 (one activation row per weight row)."""
    nh, es = (2, 1) if w4a8 else (1, 2)
    xrows = -(-m // 8) * 8
    tiles = dout // _TC_BN
    n_stages = half // _TC_KT
    best = None
    for per in range(1, n_stages + 1):
        splits = -(-n_stages // per)
        if -(-n_stages // splits) != per:
            continue                   # the same grid as a smaller per
        rows = per * _TC_KT
        x_bytes = x_halves * xrows * _tc_x_stride(rows, w4a8)
        if x_bytes > _TC_X_BUDGET and per > 1:
            continue
        two = xrows <= 16 and _TC_RING + x_bytes <= _TC_SMEM_TWO
        slots = sms * (2 if two else 1)
        waves = -(-tiles * splits // slots)
        us = waves * (_BLOCK_US + slots * (rows * _TC_BN + x_halves * m
                                           * rows * es / 3)
                      / _HBM_BYTES_PER_US)
        if splits > 1:
            us += splits * nh * m * dout * 4 / _HBM_BYTES_PER_US
            us += -(-splits // 8) * -(-m // 4) * _L2_ROUND_US
        if best is None or (us, splits) < best[0]:
            best = ((us, splits), rows, splits)
    return best[1], best[2]


_tc_ws: dict = {}       # device -> (int32 partials, int32 tickets)
_retired_tc_ws: list = []   # outgrown workspaces, kept for captured graphs


def _tc_workspace(dev: torch.device, n_words: int,
                  n_tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split partials of K6 and K8-K10 (4-byte words: f32, or int32
    for K9) and their tickets on ``dev``: made at first use with the tickets
    zeroed (the kernel leaves them zero after every launch), grown when a
    larger call arrives, and otherwise the same tensors on every call, so
    a call allocates nothing but its output. An outgrown workspace is
    kept alive, since a CUDA graph captured earlier still launches on its
    pointers. Calls on one device share it, so they must be ordered on
    one stream."""
    ws = _tc_ws.get(dev)
    if ws is None or ws[0].numel() < n_words or ws[1].numel() < n_tickets:
        if ws is not None:
            _retired_tc_ws.append(ws)
            n_words = max(n_words, ws[0].numel())
            n_tickets = max(n_tickets, ws[1].numel())
        ws = (torch.empty(n_words, dtype=torch.int32, device=dev),
              torch.zeros(n_tickets, dtype=torch.int32, device=dev))
        _tc_ws[dev] = ws
    return ws


def _launch_stacked(variant: int, x, sx, q4, scale, layer, out_dtype):
    """One K8/K9 launch (``cs_int4_gemv_tc``): one kernel, which sums its
    K splits itself through the workspace."""
    _check_operands(variant, x, sx, q4, scale, layer, None)
    dev = x.device
    half, dout = q4.shape[1:]
    m = x.shape[0]
    if half % _TC_KT or dout % _TC_BN:
        raise ValueError(f"cs_int4_gemv_tc needs half and dout multiples of "
                         f"{_TC_KT}, got {(half, dout)}")
    out = torch.empty((m, dout), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    w4a8 = variant == W4A8
    rows, splits = stacked_plan(m, half, dout, w4a8, kernels.sm_count(dev))
    part = tickets = None
    if splits > 1:
        part, tickets = _tc_workspace(dev, splits * (2 if w4a8 else 1) * m
                                      * dout, dout // _TC_BN)
    kernels.check(kernels.library().cs_int4_gemv_tc(
        x.data_ptr(), sx.data_ptr() if w4a8 else None, q4.data_ptr(),
        half * dout, scale.data_ptr(), dout, layer.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), m, half, dout,
        rows, splits, variant, kernels.dtype_code(out),
        kernels.stream_ptr(x)), "cs_int4_gemv_tc")
    return out


# csrc/quant_gemv_sm90.cu (K6, K10): a tile is 256 output columns, a
# stage two 128 x 128-byte TMA boxes of it (128 packed rows for K6, 128 k
# for K10); one block per SM
SM90_BOX = 128
INT8 = 3                # its variant code for K10


def sm90_n(m: int) -> int:
    """The MMA width of ``m`` activation rows: the kernel's instance."""
    return next(n for n in (8, 16, 32, 40, 64) if m <= n)


def sm90_units(k: int, dout: int) -> Tuple[int, int]:
    """(column tiles, k stages) of one K6 / K10 call: tiles of 256 columns
    (the last may be half) and stages of 128 rows (K6: packed rows, k the
    packed row count; K10: k = din)."""
    return -(-dout // (2 * SM90_BOX)), k // SM90_BOX


def stream_grid(n_tiles: int, n_stages: int, sms: int) -> int:
    """Blocks of one K6 / K10 launch: one per SM (a block takes most of
    an SM's shared memory, so this is one wave), fewer only when there
    are fewer (tile, stage) units than SMs."""
    return min(sms, n_tiles * n_stages)


def stream_segments(grid: int, n_tiles: int, n_stages: int):
    """The stream-K schedule ``csrc/quant_gemv_sm90.cu`` runs: block ``b``
    takes units ``[b U / grid, (b + 1) U / grid)`` of the ``U = n_tiles *
    n_stages`` (tile, k stage) units in tile-major order, i.e. for each
    block a list of (tile, first stage, end stage) segments."""
    units = n_tiles * n_stages
    out = []
    for b in range(grid):
        u, u1 = b * units // grid, (b + 1) * units // grid
        segs = []
        while u < u1:
            t, s0 = divmod(u, n_stages)
            s1 = min(n_stages, s0 + u1 - u)
            segs.append((t, s0, s1))
            u += s1 - s0
        out.append(segs)
    return out


def sm90_workspace_words(grid: int, m: int) -> int:
    """f32 words of K6 / K10's partial sums: per block, its first and last
    segment's sums for each of the two consumer warpgroups, up to 128
    columns x ``sm90_n(m)`` rows each."""
    return grid * 2 * 2 * 128 * sm90_n(m)


def _launch_sm90(variant: int, x, q, layers: int, scale,
                 scale_stride: int, layer, code, k: int, dout: int,
                 out_dtype):
    """One ``cs_quant_gemv_sm90`` launch (K6: ``variant`` UNIFORM / CUBIC,
    ``k`` the packed rows; K10: INT8, ``k`` = din and ``layers`` stacked
    layers) on checked operands: one kernel, which sums its split tiles
    itself through the per-device workspace. The kernel reads the weights
    through a TMA tensor map that the library encodes once per weight
    tensor and caches."""
    dev = x.device
    m = x.shape[0]
    if k % SM90_BOX or dout % SM90_BOX:
        raise ValueError(f"cs_quant_gemv_sm90 needs k and dout multiples of "
                         f"128, got {(k, dout)}")
    kernels.require_aligned(x, q, scale)
    out = torch.empty((m, dout), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    grid = stream_grid(*sm90_units(k, dout), kernels.sm_count(dev))
    part, tickets = _tc_workspace(dev, sm90_workspace_words(grid, m),
                                  2 * dout // SM90_BOX)
    kernels.check(kernels.library().cs_quant_gemv_sm90(
        x.data_ptr(), q.data_ptr(), layers, scale.data_ptr(),
        scale_stride, None if layer is None else layer.data_ptr(),
        None if code is None else code.data_ptr(), out.data_ptr(),
        part.data_ptr(), tickets.data_ptr(), m, k, dout, grid, variant,
        kernels.dtype_code(out), kernels.stream_ptr(x)),
        "cs_quant_gemv_sm90")
    return out


def gemv_k6(xb, q4, scale, code, cubic: bool, out_dtype):
    """K6: 2D bf16-dot GEMV (uniform: raw nibbles, the slope already in
    ``scale``; cubic: the codebook from ``code = [A, C]``)."""
    if kernels.plain_route(xb):
        return _plain_bf16(xb, q4, scale, code, cubic, out_dtype)
    variant = CUBIC if cubic else UNIFORM
    _check_operands(variant, xb, None, q4, scale, None, code)
    half, dout = q4.shape
    out = _launch_sm90(variant, xb, q4, 1, scale, 0, None,
                       code if cubic else None, half, dout, out_dtype)
    gemv_k6.launches += 1
    return out


def gemv_k7(xq, sx, q4, scale, out_dtype):
    """K7: 2D W4A8 GEMV."""
    if kernels.plain_route(xq):
        return _plain_w4a8(xq, sx, q4, scale, out_dtype)
    out = _launch(W4A8, xq, sx, q4, scale, None, out_dtype)
    gemv_k7.launches += 1
    return out


def _layer_slice(q4, scale, layer):
    return q4.index_select(0, layer)[0], scale.index_select(0, layer)[0]


def gemv_k8(xb, q4, scale, layer, out_dtype):
    """K8: stacked bf16-dot GEMV over layer ``layer`` (device int32 [1])."""
    if kernels.plain_route(xb):
        return _plain_bf16(xb, *_layer_slice(q4, scale, layer), None, False,
                           out_dtype)
    out = _launch_stacked(UNIFORM, xb, None, q4, scale, layer, out_dtype)
    gemv_k8.launches += 1
    gemv_k8.multirow_launches += xb.shape[0] > 1
    return out


def gemv_k9(xq, sx, q4, scale, layer, out_dtype):
    """K9: stacked W4A8 GEMV over layer ``layer``."""
    if kernels.plain_route(xq):
        return _plain_w4a8(xq, sx, *_layer_slice(q4, scale, layer), out_dtype)
    out = _launch_stacked(W4A8, xq, sx, q4, scale, layer, out_dtype)
    gemv_k9.launches += 1
    gemv_k9.multirow_launches += xq.shape[0] > 1
    return out


for _fn in (gemv_k6, gemv_k7, gemv_k8, gemv_k9):
    _fn.launches = 0              # every launch
for _fn in (gemv_k8, gemv_k9):
    _fn.multirow_launches = 0     # those at 1 < m <= 64 (prefills)


# ---------------------------------------------------------------------------
# wrappers (the JAX functions' signatures)
# ---------------------------------------------------------------------------

def _gemv_2d(x, qp, out_dtype, w4a8, plain: bool, rows=None):
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
    if w4a8 and rows is not None:
        # a row shard: global-half scales, the f32 partials summed over
        # the group, then one rounding
        from ..parallel.mesh import all_reduce

        xq, sx = _shard_halves(xs, half, rows)
        f32 = torch.float32
        y = all_reduce(_plain_w4a8(xq, sx, packed, sc, f32) if plain
                       else gemv_k7(xq, sx, packed, sc, f32),
                       rows.group).to(dtype)
    elif w4a8:
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


def _rank1_vjp(qp: Dict[str, torch.Tensor], x_dtype):
    """The backward of every rank-1 GEMV: the transpose of the 2D XLA
    form JAX differentiates (``quant.split_matmul`` over the layer's
    weight); W4A8's activation rounding passes straight through."""
    from .quant import _layer_of, materialize_split, split_matmul_vjp

    def vjp(g):
        w = _layer_of(qp) if "layer" in qp else qp
        return split_matmul_vjp(g, materialize_split(w, g.dtype), x_dtype)
    return vjp


def int4_rank1_gemv(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                    out_dtype=None, *, w4a8: bool = False,
                    rows=None) -> torch.Tensor:
    """``x @ W`` for a 2D rank-1 int4 weight: K6 (uniform or cubic, by
    the scheme tag), or K7 with ``w4a8``. Under autograd the backward is
    the transpose of the 2D XLA form (:func:`_rank1_vjp`). ``rows`` (a
    ``quant.RowShard``, with ``w4a8``): ``x`` and ``qp`` hold a row
    shard; each half takes its global half's scale, and the product is
    the whole one, summed over the shard's group."""
    from .quant import frozen_product

    return frozen_product(
        x, lambda t: _gemv_2d(t, qp, out_dtype, w4a8, plain=False,
                              rows=rows),
        _rank1_vjp(qp, x.dtype))


def int4_rank1_gemv_plain(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                          out_dtype=None, *, w4a8: bool = False,
                          rows=None) -> torch.Tensor:
    """:func:`int4_rank1_gemv` through the plain version, on any device."""
    return _gemv_2d(x, qp, out_dtype, w4a8, plain=True, rows=rows)


def _gemv_stacked(x, qp, layer, out_dtype, w4a8, plain: bool, rows=None):
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
        # a row shard: global-half scales, f32 partials summed over the
        # group, then one rounding
        xq, sx = (_int8_halves(xs, half) if rows is None
                  else _shard_halves(xs, half, rows))
        part = dtype if rows is None else torch.float32
        if plain:
            y = _plain_w4a8(xq, sx, *_layer_slice(packed, scale, layer),
                            part)
        else:
            y = gemv_k9(xq, sx, packed, scale, layer, part)
        if rows is not None:
            from ..parallel.mesh import all_reduce

            y = all_reduce(y, rows.group).to(dtype)
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
                            w4a8: bool = False, rows=None) -> torch.Tensor:
    """``x @ W[layer]`` for stacked rank-1 UNIFORM weights: K8, or K9 with
    ``w4a8``. ``layer`` is an int32 [1] tensor on the weights' device (a
    view into the decoder's ``arange(L)``), read by the kernel itself.
    Under autograd the backward is that of the layer's 2D form
    (:func:`_rank1_vjp`). ``rows``: a row shard, as
    :func:`int4_rank1_gemv` takes it."""
    from .quant import frozen_product

    return frozen_product(
        x, lambda t: _gemv_stacked(t, qp, layer, out_dtype, w4a8,
                                   plain=False, rows=rows),
        _rank1_vjp({**qp, "layer": layer}, x.dtype))


def int4_rank1_gemv_stacked_plain(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                                  layer: torch.Tensor, out_dtype=None, *,
                                  w4a8: bool = False,
                                  rows=None) -> torch.Tensor:
    """:func:`int4_rank1_gemv_stacked` through the plain version."""
    return _gemv_stacked(x, qp, layer, out_dtype, w4a8, plain=True,
                         rows=rows)
