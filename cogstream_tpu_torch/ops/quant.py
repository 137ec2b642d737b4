"""Weight quantization — port of ``cogstream_tpu/ops/quant.py``.

Quantized weights are plain dicts of tensors in the JAX layout ``[...,
din, dout]`` (never transposed to ``nn.Linear``'s ``[out, in]``); the
packed dtype and the keys tag the scheme, as in the JAX package:

* **int8** (``quantize_int8``): ``q`` int8 ``[..., din, dout]`` and a
  per-column ``scale`` f32 ``[..., dout]`` (``max|w| / 127``);
* **rank-1 int4**, the serving scheme (``quantize_int4_rank1``): ``q4``
  int8 ``[..., din/2, dout]``, two signed nibbles per byte in the
  SPLIT-HALVES layout (the low nibble of packed row ``p`` holds row ``p``,
  the high nibble row ``p + din/2``), column ``scale`` ``[..., dout]``, row
  ``rscale`` ``[..., din]`` and ``code`` ``[..., 1]`` (uniform, value =
  s/7) or ``[..., 2]`` (cubic codebook, value = s·(A + C·s²));
  ``w ≈ code(nib) · rscale[p] · scale[o]``;
* **group-wise int4 / NF4** (``quantize_int4``): ``q4`` split-halves with
  one ``scale`` per ``group_size`` rows (``[..., din/G, dout]``); int8
  bytes hold uniform nibbles in [-7, 7], uint8 bytes NF4 codebook indices
  0..15 whose values are the degree-7 polynomial ``POLY_NF4_CODE``.

:class:`QuantWeight` keeps one such dict on a module (stacked ``[L,
...]`` per decoder projection site, or 2D for the head and the vision
tower's GEMMs) and :class:`QuantLinear` (alias ``Int4Linear``) is one
projection over it.

``quantized_matmul`` dispatches as the JAX function does; on the card
the routes are:

* rank-1 uniform int4 at decode-sized M (``m <= 64``, 128-divisible
  shapes): the fused-unpack GEMVs (ops/quant_gemv.py, K6-K9); with
  ``w8a8`` the W4A8 ones; at larger M with ``w8a8`` the W4A8 prefill
  branch (int8 activations against the unpacked nibbles in
  ``torch._int_mm``);
* int8 at the same M: K10 (ops/int8_gemv.py), the fused dequant XLA does
  inside the JAX function; with ``w8a8`` (at any M) the W8A8 product:
  per-row int8 activations, ``torch._int_mm``, the rank-1 epilogue, and a
  straight-through gradient (``_W8A8STE``);
* everything else the materializing form, ``x @ dequantize(...)``, which
  on the card is ``torch.matmul`` as the JAX package leaves it to XLA.

Each kernel route rounds differently from the materializing form, so the
route decision is part of the numerics and copies the JAX package's.

Row-parallel products (a tensor-parallel shard of o_proj, down_proj, the
tower's o / fc2 or the projector's second linear; parallel/sharding.py)
take ``reduce``, the model axis's process group: the local product is
all-reduced before the bias. The W8A8 form takes the activation absmax over
the WHOLE row (a MAX all-reduce of the local ones) and all-reduces the
int32 sums before the rank-1 epilogue, so the arithmetic is the unsharded
one. The W4A8 forms of a rank-1 int4 row shard (:class:`RowShard`: its
rows of the whole input) quantize each packed half with the absmax of the
GLOBAL half of the row it lies in (MAXed over the group: a row shard is
repacked to its own pairing, so its local halves are parts of one global
half), then all-reduce the int32 sums of each global half (prefill) or the
GEMV's f32 partials (K7 / K9) before rounding. The quantizers take the
same groups, so a shard quantizes to the slice of the whole weight's
quantization.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce
from ..parallel.mesh import group_size as ranks_in

# QLoRA's NF4 codebook: the 16 quantiles of N(0,1) scaled to [-1, 1]
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367,
    -0.39491748809814453, -0.28444138169288635, -0.18477343022823334,
    -0.09105003625154495, 0.0, 0.07958029955625534,
    0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
    0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0)


def _fit_nf4_poly():
    """Degree-7 fit of NF4_CODE over the nibble index u ∈ [0, 15], held to
    ±1 at the endpoints (line(u) + u(u-15)·q(u), q least squares), in
    float64: the JAX package's fit, so the codebook is bit-equal."""
    import numpy.polynomial.polynomial as npp

    u = np.arange(16, dtype=np.float64)
    nf4 = np.asarray(NF4_CODE, np.float64)
    line = -1.0 + (2.0 / 15.0) * u
    w = u * (u - 15.0)
    basis = np.stack([w * u ** k for k in range(6)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, nf4 - line, rcond=None)
    full = npp.polyadd(np.array([-1.0, 2.0 / 15.0]),
                       npp.polymul(np.array([0.0, -15.0, 1.0]), coef))
    return full[::-1]                       # descending, for Horner


_NF4_POLY = _fit_nf4_poly()
POLY_NF4_CODE = tuple(np.polyval(_NF4_POLY, np.arange(16)).tolist())

# rank-1 cubic codebook: value(s) = s·(A + C·s²), value(±7) = ±1
CUBIC_A = 0.065
CUBIC_C = (1.0 - 7.0 * CUBIC_A) / 343.0
CUBIC_CODE = tuple(
    float(s * (CUBIC_A + CUBIC_C * s * s)) for s in range(-7, 8))

# decoder projection sites that hold quantized kernels, in layer order
GEMV_SITES = (("attn", "q_proj"), ("attn", "k_proj"), ("attn", "v_proj"),
              ("attn", "o_proj"), ("mlp", "gate_proj"), ("mlp", "up_proj"),
              ("mlp", "down_proj"))

# rows of a codebook search held at once: the [rows, dout, levels]
# distance tensor is the memory peak (at 7B width an unblocked NF4 search
# of one [3584, 18944] weight would hold 4.3 GB)
_CODE_ROWS = 64


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

def quantize_int8(w: torch.Tensor, row_group=None) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 over the last axis. ``row_group``:
    ``w`` holds this rank's rows of a row-parallel weight, and the column
    absmax is taken over every rank's rows."""
    wf = w.to(torch.float32)
    scale = all_reduce(wf.abs().amax(dim=-2, keepdim=True), row_group,
                       "max") / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.squeeze(-2)}


def column_major(q: torch.Tensor) -> torch.Tensor:
    """``q`` [..., din, dout] with each matrix stored column-major (a
    transposed view of a contiguous [..., dout, din]; no copy if it is
    already): the layout of a held int8 weight, which ``torch._int_mm``
    takes on its fast path on the card (PERF.md) and K10 streams."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def empty_stack(L: int, qp: Dict[str, torch.Tensor]) -> Dict:
    """Uninitialized ``[L, ...]`` storage for ``L`` layers of weights like
    ``qp`` (an int8 ``q`` column-major), filled a layer at a time."""
    return {k: column_major(torch.empty(
        (L,) + tuple(v.shape[:-2]) + (v.shape[-1], v.shape[-2]),
        dtype=v.dtype, device=v.device).transpose(-1, -2)) if k == "q"
        else torch.empty((L,) + tuple(v.shape), dtype=v.dtype,
                         device=v.device) for k, v in qp.items()}


def dequantize_int8(qp: Dict[str, torch.Tensor],
                    dtype=torch.bfloat16) -> torch.Tensor:
    return (qp["q"].to(torch.float32)
            * qp["scale"][..., None, :]).to(dtype)


def _pack_split(vals: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """[..., din, dout] 4-bit values (low 4 bits significant) → [...,
    din/2, dout] bytes in the split-halves layout, stored as ``dtype``
    (int8: uniform nibbles; uint8: NF4 indices)."""
    din = vals.shape[-2]
    lo = vals[..., : din // 2, :].to(torch.uint8) & 0xF
    hi = vals[..., din // 2:, :].to(torch.uint8) & 0xF
    return (lo | (hi << 4)).view(dtype)


def _unpack_halves(packed: torch.Tensor):
    """Packed bytes → (lo_half, hi_half), each [..., din/2, dout]: int8
    bytes give sign-extended nibbles in [-8, 7], uint8 bytes NF4 indices
    in [0, 15] (logical shifts)."""
    if packed.dtype == torch.uint8:
        return packed & 0xF, packed >> 4
    return (packed << 4) >> 4, packed >> 4


def _nf4_poly_eval(u: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of the polynomial codebook at u ∈ [0, 15] (f32)."""
    acc = torch.full(u.shape, float(np.float32(_NF4_POLY[0])),
                     dtype=torch.float32, device=u.device)
    for c in _NF4_POLY[1:]:
        acc = acc * u + float(np.float32(c))
    return acc


def _nearest_code(norm: torch.Tensor, code) -> torch.Tensor:
    """Index of the nearest codebook entry (first on ties, as
    ``jnp.argmin``) of each element of ``norm`` [..., din, dout], a block
    of din rows at a time."""
    levels = torch.tensor(code, dtype=torch.float32, device=norm.device)
    idx = torch.empty(norm.shape, dtype=torch.uint8, device=norm.device)
    for p0 in range(0, norm.shape[-2], _CODE_ROWS):
        blk = norm[..., p0:p0 + _CODE_ROWS, :]
        idx[..., p0:p0 + _CODE_ROWS, :] = torch.argmin(
            (blk[..., None] - levels).abs(), dim=-1).to(torch.uint8)
    return idx


def quantize_int4(w: torch.Tensor, group_size: int = 64,
                  nf4: bool = True) -> Dict[str, torch.Tensor]:
    """Group-wise 4-bit quantization over the din axis: each ``group_size``
    rows share an absmax scale. ``nf4=True`` snaps each normalized weight
    to the nearest polynomial NF4 level (uint8 indices); ``nf4=False`` is
    uniform int4 in [-7, 7] (int8 nibbles). Same f32 operations as the JAX
    function, so the bytes agree."""
    wf = w.to(torch.float32)
    *lead, din, dout = wf.shape
    if din % group_size or din % 2:
        raise ValueError(
            f"group_size={group_size} and 2 must divide din={din}")
    g = wf.reshape(*lead, din // group_size, group_size, dout)
    absmax = torch.clamp(g.abs().amax(dim=-2, keepdim=True), min=1e-8)
    if nf4:
        norm = (g / absmax).reshape(wf.shape)       # [-1, 1]
        idx = _nearest_code(norm, POLY_NF4_CODE)
        return {"q4": _pack_split(idx, torch.uint8),
                "scale": absmax.squeeze(-2)}
    scale = absmax / 7.0
    q = torch.clamp(torch.round(g / scale), -7, 7).to(torch.int8)
    return {"q4": _pack_split(q.reshape(wf.shape)),
            "scale": scale.squeeze(-2)}


def quantize_int4_rank1(w: torch.Tensor, nf4: bool = True,
                        iters: int = 8, row_group=None,
                        col_group=None) -> Dict[str, torch.Tensor]:
    """4-bit with rank-1 (row ⊗ column) scales, over ``w`` in the JAX
    layout ``[..., din, dout]``. ``nf4=True`` snaps to the cubic
    codebook (``code = [A, C]``), ``nf4=False`` is uniform (``code =
    [1/7]``). Same f32 operations in the same order as the JAX function,
    so the bytes agree. On a tensor-parallel shard, ``row_group`` (rows
    split) or ``col_group`` (columns split) takes each absmax over every
    rank's part, so the shard packs the slice of the whole weight's
    quantization (a row shard in its own split-halves pairing)."""
    wf = w.to(torch.float32)
    *lead, din, dout = wf.shape
    if din % 2:
        raise ValueError(f"din={din} must be even")
    aw = wf.abs()

    def row_max(a):          # over dout, per row
        return all_reduce(a.amax(dim=-1, keepdim=True), col_group, "max")

    def col_max(a):          # over din, per column
        return all_reduce(a.amax(dim=-2, keepdim=True), row_group, "max")

    r = torch.clamp(row_max(aw), min=1e-8)
    c = None
    for _ in range(iters):
        c = torch.clamp(col_max(aw / r), min=1e-8)
        r = torch.clamp(row_max(aw / c), min=1e-8)
    del aw
    norm = wf / (r * c)                             # ⊆ [-1, 1]
    if nf4:
        q = (_nearest_code(norm, CUBIC_CODE).to(torch.int16) - 7).to(
            torch.int8)
        coefs = (CUBIC_A, CUBIC_C)
    else:
        q = torch.clamp(torch.round(norm * 7.0), -7, 7).to(torch.int8)
        coefs = (1.0 / 7.0,)
    del norm
    code_arr = torch.tensor(coefs, dtype=torch.float32,
                            device=wf.device).expand(*lead, len(coefs))
    return {"q4": _pack_split(q), "scale": c.squeeze(-2),
            "rscale": r.squeeze(-1), "code": code_arr.contiguous()}


def _decode_half(nib: torch.Tensor, scale_half: torch.Tensor,
                 dtype) -> torch.Tensor:
    """One unpacked half [din/2, dout] of a group-wise weight and its
    group scales [n/2, dout] → dequantized [din/2, dout] in ``dtype``."""
    half, dout = nib.shape
    n2 = scale_half.shape[0]
    vals = (_nf4_poly_eval(nib.to(torch.float32)) if nib.dtype == torch.uint8
            else nib.to(torch.float32))
    vals = vals.reshape(n2, half // n2, dout) * scale_half[:, None, :]
    return vals.to(dtype).reshape(half, dout)


def dequantize_int4(qp: Dict[str, torch.Tensor],
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Materializing unpack + rescale of any 4-bit weight (rank-1 or
    group-wise; groups need not align with the packed halves)."""
    lo, hi = _unpack_halves(qp["q4"])
    nib = torch.cat([lo, hi], dim=-2)
    scale = qp["scale"]
    if "rscale" in qp:                              # rank-1 scheme
        s = nib.to(torch.float32)
        a = qp["code"][..., 0:1, None]
        if qp["code"].shape[-1] == 1:               # uniform (scheme tag)
            vals = s * a
        else:
            cc = qp["code"][..., 1:2, None]
            vals = s * (a + cc * (s * s))
        w = vals * qp["rscale"][..., :, None] * scale[..., None, :]
        return w.to(dtype)
    vals = (_nf4_poly_eval(nib.to(torch.float32)) if nib.dtype == torch.uint8
            else nib.to(torch.float32))
    *lead, din, dout = vals.shape
    n = scale.shape[-2]
    g = vals.reshape(*lead, n, din // n, dout) * scale[..., :, None, :]
    return g.reshape(*lead, din, dout).to(dtype)


def dequantize(qp: Dict[str, torch.Tensor], dtype=torch.bfloat16):
    """Dispatch on the stored scheme."""
    if "q4" in qp:
        return dequantize_int4(qp, dtype)
    return dequantize_int8(qp, dtype)


def is_quantized(p: Any) -> bool:
    return isinstance(p, dict) and ("q" in p or "q4" in p) and "scale" in p


def materialize_kernel(kern: Any, dtype) -> torch.Tensor:
    """A weight leaf as a dense ``dtype`` tensor, stored plain or
    quantized."""
    if isinstance(kern, dict):
        return dequantize(kern, dtype)
    return kern.to(dtype)


def quantize_int8_act(x: torch.Tensor, reduce=None):
    """Dynamic per-row symmetric int8 activations: ``(q, scale)`` with
    ``x ≈ q * scale``, scale ``[..., 1]`` f32. Rounds half to even, like
    ``jnp.round``. ``reduce``: ``x`` holds this rank's channels of each
    row, and the absmax is the whole row's."""
    xf = x.to(torch.float32)
    ax = torch.clamp(all_reduce(xf.abs().amax(dim=-1, keepdim=True), reduce,
                                "max"), min=1e-6)
    # a true division (``127.0 / ax`` on a tensor is reciprocal * 127)
    q = torch.clamp(torch.round(xf * (ax.new_tensor(127.0) / ax)),
                    -127, 127).to(torch.int8)
    return q, ax * (1.0 / 127.0)


class RowShard(NamedTuple):
    """A row-parallel shard's place in the whole input: rows [lo, hi) of
    ``width``, split over the process group ``group``. The W4A8 forms
    read it (:func:`int4_matmul`): the shard is packed in its own
    split-halves pairing, each of its two local halves a part of one
    GLOBAL half of the row, whose int8 scale it must use."""

    width: int
    lo: int
    hi: int
    group: Any

    def halves(self) -> Tuple[int, int]:
        """The global half (0: rows [0, width / 2), 1: the others) that
        each local packed half lies in. A local half that straddles the
        two raises: one int8 scale per local half cannot express it."""
        mid, g = self.lo + (self.hi - self.lo) // 2, []
        for a, b in ((self.lo, mid), (mid, self.hi)):
            h = 2 * a // self.width
            if 2 * (b - 1) // self.width != h:
                raise ValueError(
                    f"row shard [{self.lo}, {self.hi}) of {self.width}: its "
                    "packed halves straddle the input's halves")
            g.append(h)
        return g[0], g[1]

    def absmax(self, xs: torch.Tensor) -> torch.Tensor:
        """``xs`` [m, hi - lo] f32 (the activations of this shard's rows,
        rscale folded) -> [m, 2] f32: each GLOBAL half's absmax over the
        whole row, MAXed over the group."""
        g = self.halves()
        half = xs.shape[-1] // 2
        ax = xs.reshape(xs.shape[0], 2, half).abs().amax(dim=-1)
        full = ax.new_zeros(ax.shape)
        for j in (0, 1):
            full[:, g[j]] = torch.maximum(full[:, g[j]], ax[:, j])
        return all_reduce(full, self.group, "max")


def quantize_kernel(w: torch.Tensor, bits: int, group_size: int = 64,
                    nf4: bool = True, rank1: bool = False, row_group=None,
                    col_group=None) -> Dict:
    """One ``[..., din, dout]`` weight in ``quantize_tree``'s scheme:
    ``bits=8`` per-channel int8; ``bits=4`` group-wise NF4 / int4, or
    rank-1 with ``rank1``, falling back to int8 where the 4-bit scheme
    cannot take din (not divisible by the group, or odd), as in JAX.
    ``row_group`` / ``col_group``: ``w`` is a tensor-parallel shard (rows
    or columns split), quantized as its slice of the whole weight, byte
    for byte (group-wise: a row shard must hold whole groups,
    :func:`check_group_shard`, else ``ValueError``)."""
    if bits == 8:
        return quantize_int8(w, row_group)
    if not rank1 and row_group is not None:
        # the whole weight's rows; int8 where the whole falls back to it
        whole = w.shape[-2] * ranks_in(row_group)
        if whole % group_size or whole % 2:
            return quantize_int8(w, row_group)
        check_group_shard(w.shape[-2], group_size)
    try:
        if rank1:
            return quantize_int4_rank1(w, nf4=nf4, row_group=row_group,
                                       col_group=col_group)
        # groups run along din: a column shard's are whole, and so are an
        # aligned row shard's, so the shard's own quantization is the
        # slice of the whole one (its halves packed to its own pairing)
        return quantize_int4(w, group_size=group_size, nf4=nf4)
    except ValueError:
        return quantize_int8(w, row_group)


def check_group_shard(rows: int, group_size: int) -> None:
    """A group-wise row shard of ``rows`` rows (one of equal contiguous
    blocks) quantizes as its slice of the whole weight only when its
    bounds fall on group boundaries and it packs into two halves."""
    if rows % group_size or rows % 2:
        raise ValueError(
            f"a row shard of {rows} rows does not hold whole groups of "
            f"{group_size} (or an even count): quantize the weight whole, "
            "then shard it")


def quantize_tree(params: Any, predicate=None, bits: int = 8,
                  group_size: int = 64, nf4: bool = True,
                  rank1: bool = False) -> Any:
    """Replace every ``kernel`` leaf of a plain dict / list tree of
    tensors with its quantized form (``bits`` 8, or 4: group-wise /
    NF4, or rank-1 with ``rank1``); ``predicate(parent_key)`` may veto a
    kernel. A 4-bit kernel whose din the scheme cannot take (not
    divisible by the group, or odd) falls back to int8, as in JAX."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def quant(w):
        return quantize_kernel(w, bits, group_size, nf4, rank1)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: (quant(v) if k == "kernel" and (
                predicate is None or predicate(name)) else walk(v, k))
                for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return node
    return walk(params)


# ---------------------------------------------------------------------------
# int8 x int8 products
# ---------------------------------------------------------------------------

# rows below which torch._int_mm refuses a CUDA call: such a call pads
# its activations with zero rows (they quantize to 0) and slices them off
_INT_MM_MIN_ROWS = 17


def int8_mm(xq: torch.Tensor, w: torch.Tensor,
            site: str = "decoder") -> torch.Tensor:
    """``xq @ w`` with int8 operands and exact int32 sums
    (``torch._int_mm``, the GEMM the JAX package leaves to XLA as
    ``dot_general(..., preferred_element_type=int32)``). Counted per
    ``site`` in ``int8_mm.calls``."""
    m = xq.shape[0]
    if xq.is_cuda and m < _INT_MM_MIN_ROWS:
        pad = xq.new_zeros((_INT_MM_MIN_ROWS - m, xq.shape[1]))
        y = torch._int_mm(torch.cat([xq, pad]), w)[:m]
    else:
        y = torch._int_mm(xq, w)
    int8_mm.calls[site] = int8_mm.calls.get(site, 0) + 1
    return y


int8_mm.calls = {}


def int8_act_matmul(xq: torch.Tensor, sx: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor, out_dtype=torch.bfloat16,
                    site: str = "decoder", reduce=None) -> torch.Tensor:
    """``(xq·sx) @ (q·scale)`` with both operands int8: exact int32 sums,
    then the rank-1 epilogue in the JAX order, ``y·sx·scale``. ``reduce``:
    a row-parallel shard's int32 partial sums are all-reduced before the
    epilogue."""
    y = all_reduce(int8_mm(xq, q, site), reduce)
    return (y.to(torch.float32) * sx * scale[None, :]).to(out_dtype)


class _W8A8STE(torch.autograd.Function):
    """W8A8 matmul with a straight-through activation gradient (the JAX
    ``_w8a8_matmul_ste``): the primal is the serving W8A8 path bit for
    bit; the backward treats the activation round as identity, ``dx = g
    @ W_deq^T`` with ``W_deq = (q·scale)`` in g's dtype; the frozen int8
    weights get no gradient. ``x`` is 2D.

    On model-axis shards (JAX's GSPMD partition of the same function):

    * a row shard (o_proj, down_proj: ``reduce`` is the model group) holds
      this rank's input channels. The forward takes the whole row's absmax
      (a MAX over the group) and all-reduces the int32 sums before the
      epilogue, so every rank's output is the whole product's bits. Its
      ``dx = g @ W_local^T`` (g whole on every rank) is this rank's
      channels of the whole ``dx``, and nothing is reduced;
    * a column shard (q / k / v, gate / up: ``reduce`` None) holds whole
      rows of ``x`` (its input enters through ``parallel.mesh.
      copy_to_model``) and this rank's output channels: the forward is
      local, and ``dx`` is this rank's partial sum, which
      ``copy_to_model``'s backward all-reduces.

    The collectives run in ``forward``, where autograd is off, on the
    absmax and the int32 sums, fresh tensors that nothing saves (an
    in-place all-reduce of a saved tensor gives a wrong gradient and no
    error). Under ``torch.utils.checkpoint`` the recomputed forward runs
    the same collectives in the same order on every rank."""

    @staticmethod
    def forward(ctx, x, q, scale, reduce=None):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        xq, sx = quantize_int8_act(x, reduce)
        return int8_act_matmul(xq, sx, q, scale, x.dtype, reduce=reduce)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        w = (q.to(torch.float32) * scale[..., None, :]).to(g.dtype)
        return (g @ w.t()).to(ctx.x_dtype), None, None, None


# ---------------------------------------------------------------------------
# matmuls
# ---------------------------------------------------------------------------

def _layer_of(qp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A stacked weight's layer ``qp["layer"]`` as a 2D weight dict, as the
    JAX decode scan hands such weights to ``dense`` (an int8 ``q`` stays
    column-major)."""
    layer = qp["layer"]
    out = {k: v.index_select(0, layer)[0] for k, v in qp.items()
           if k not in ("layer", "q")}
    if "q" in qp:
        out["q"] = qp["q"].transpose(-1, -2).index_select(0, layer)[0].t()
    return out


def materialize_split(qp: Dict[str, torch.Tensor], dtype) -> Dict:
    """The weight half of the materializing 2D rank-1 form: each packed
    half decoded to ``nibble·code·scale`` rounded to ``dtype``. Kept apart
    so a weight used at every step (the sliced selector head) decodes
    once."""
    uniform = qp["code"].shape[-1] == 1
    a = qp["code"][0]
    cc = None if uniform else qp["code"][1]
    scale = qp["scale"]

    def cubic(nib):
        s = nib.to(torch.float32)
        return s * a if uniform else s * (a + cc * (s * s))

    lo, hi = _unpack_halves(qp["q4"])
    return {"wl": (cubic(lo) * scale[None, :]).to(dtype),
            "wh": (cubic(hi) * scale[None, :]).to(dtype),
            "rscale": qp["rscale"]}


def split_matmul(x: torch.Tensor, prep: Dict) -> torch.Tensor:
    """``x @ W`` for a :func:`materialize_split` weight: the activations
    take ``rscale`` in f32 and round to the weights' dtype."""
    wl, wh, r = prep["wl"], prep["wh"], prep["rscale"]
    half, dout = wl.shape
    dtype = wl.dtype
    *bx, din = x.shape
    x2 = x.reshape(-1, din).to(torch.float32)
    xl = (x2[:, :half] * r[None, :half]).to(dtype)
    xh = (x2[:, half:] * r[None, half:]).to(dtype)
    return (xl @ wl + xh @ wh).reshape(*bx, dout)


def split_matmul_vjp(g: torch.Tensor, prep: Dict,
                     x_dtype: torch.dtype) -> torch.Tensor:
    """The transpose of :func:`split_matmul` (JAX's rule for its 2D rank-1
    XLA form): each half's ``g @ w_half^T`` in the weights' dtype, times
    that half's ``rscale`` in f32, then cast to the activations' dtype."""
    wl, wh, r = prep["wl"], prep["wh"], prep["rscale"]
    half = wl.shape[0]
    g = g.to(wl.dtype)
    dl = (g @ wl.t()).to(torch.float32) * r[:half]
    dh = (g @ wh.t()).to(torch.float32) * r[half:]
    return torch.cat([dl, dh], dim=-1).to(x_dtype)


class _FrozenProduct(torch.autograd.Function):
    """``forward(x)`` (a GEMV kernel's launch over frozen quantized
    weights) with ``vjp(g)`` as its backward: the weights get no gradient,
    ``x`` gets ``vjp(g)`` in its own dtype."""

    @staticmethod
    def forward(ctx, x, forward, vjp):
        ctx.vjp, ctx.x_dtype = vjp, x.dtype
        return forward(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.vjp(g).to(ctx.x_dtype), None, None


def frozen_product(x: torch.Tensor, forward, vjp) -> torch.Tensor:
    """``forward(x)`` under autograd with the backward ``vjp``: how each
    GEMV kernel (K6-K10) gets a gradient. The forward is the kernel
    itself, on every route; the backward is the transpose rule JAX applies
    to the XLA form the kernel stands for, ``dx = g @ W_deq^T``."""
    return _FrozenProduct.apply(x, forward, vjp)


def _w4a8_prefill(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                  dtype, shard: Optional[RowShard] = None) -> torch.Tensor:
    """The W4A8 prefill branch (uniform rank-1, off the GEMV route): the
    unpacked nibbles ARE int8 values in [-7, 7], so each half's
    rscale-folded activations quantize per row and meet them in the int8
    GEMM; the uniform slope folds into the column scale.

    ``shard``: ``x`` and ``qp`` hold a row shard. Each local half
    quantizes with its global half's scale (:meth:`RowShard.absmax`), the
    int32 sums are added up per global half over the group, and every
    rank applies the epilogue to the whole sums: the unsharded
    arithmetic, bit for bit."""
    packed, scale = qp["q4"], qp["scale"]
    half, dout = packed.shape
    r = qp["rscale"]
    *bx, din = x.shape
    xs = x.reshape(-1, din).to(torch.float32) * r[None, :]

    def half_mm(xs, nib):
        xq, sx = quantize_int8_act(xs)
        return int8_mm(xq, nib).to(torch.float32) * sx

    # the nibbles unpacked column-major, the int8 GEMM's fast layout
    lo, hi = (h.t() for h in _unpack_halves(packed.t().contiguous()))
    if shard is None:
        yl = half_mm(xs[:, :half], lo)
        yh = half_mm(xs[:, half:], hi)
    else:
        from .quant_gemv import _int8_halves

        ax = shard.absmax(xs)
        g = shard.halves()
        xq, _ = _int8_halves(xs, half, ax[:, list(g)])
        sums = torch.zeros((2, xs.shape[0], dout), dtype=torch.int32,
                           device=x.device)
        sums[g[0]] += int8_mm(xq[:, :half], lo)
        sums[g[1]] += int8_mm(xq[:, half:], hi)
        sums = all_reduce(sums, shard.group)
        sx = ax.clamp(min=1e-6) * (1.0 / 127.0)
        yl = sums[0].to(torch.float32) * sx[:, 0:1]
        yh = sums[1].to(torch.float32) * sx[:, 1:2]
    y = (yl + yh) * (scale[None, :] * qp["code"][0])
    return y.to(dtype).reshape(*bx, dout)


def _group_matmul(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                  dtype) -> torch.Tensor:
    """The group-wise 2D form (halves holding whole groups): each half
    decodes to ``dtype`` by its own group scales and meets its half of
    the activations."""
    packed, scale = qp["q4"], qp["scale"]
    half, dout = packed.shape
    n2 = scale.shape[0] // 2
    lo, hi = _unpack_halves(packed)
    wl = _decode_half(lo, scale[:n2], dtype)
    wh = _decode_half(hi, scale[n2:], dtype)
    *bx, din = x.shape
    x2 = x.reshape(-1, din)
    return (x2[:, :half] @ wl + x2[:, half:] @ wh).reshape(*bx, dout)


def int4_matmul(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                out_dtype=None, act_int8: bool = False, reduce=None,
                rows: Optional[RowShard] = None) -> torch.Tensor:
    """``x @ W`` for a 4-bit weight, routed as the JAX function routes.
    ``qp`` is 2D, or stacked ``[L, ...]`` with a ``"layer"`` entry (int32
    ``[1]`` on W's device) for the indexed form; a stacked weight off the
    indexed route takes its layer's 2D slice, as the JAX decode scan hands
    such weights to ``dense``, so it rounds exactly as the 2D route does.

    Rank-1: the fused GEMV (K6-K9) where it routes; with ``act_int8`` on
    uniform weights off that route, the W4A8 prefill branch; else the
    materializing split form. Group-wise / NF4: the split form when the
    halves hold whole groups, else ``x @ dequantize_int4``.

    ``reduce``: a row-parallel shard, its product all-reduced over that
    group. Its W4A8 forms need ``rows`` (the shard's :class:`RowShard`):
    they take each half's int8 scale over the whole row and reduce their
    own sums; without ``rows`` each rank's halves quantize alone."""
    from .quant_gemv import (gemv_viable, gemv_viable_stacked,
                             int4_rank1_gemv, int4_rank1_gemv_stacked)

    dtype = out_dtype or x.dtype
    m = x.numel() // x.shape[-1]
    rank1 = "rscale" in qp
    uniform = rank1 and qp["code"].shape[-1] == 1
    shard = rows if reduce is not None and act_int8 and uniform else None
    if reduce is not None and shard is None:
        return all_reduce(int4_matmul(x, qp, dtype, act_int8), reduce)
    if qp["q4"].ndim == 3 and "layer" in qp:
        if uniform and gemv_viable_stacked(qp, m):
            return int4_rank1_gemv_stacked(x, qp, qp["layer"], dtype,
                                           w4a8=act_int8, rows=shard)
        qp = _layer_of(qp)
    if qp["q4"].ndim != 2:
        y = x @ dequantize_int4(qp, dtype)
        return y if shard is None else all_reduce(y, shard.group)
    if rank1:
        if uniform and gemv_viable(qp, m):
            return int4_rank1_gemv(x, qp, dtype, w4a8=act_int8, rows=shard)
        if act_int8 and uniform:
            return _w4a8_prefill(x, qp, dtype, shard)
        return split_matmul(x, materialize_split(qp, dtype))
    half = qp["q4"].shape[0]
    n = qp["scale"].shape[0]
    if n % 2 or half % (2 * half // n):
        return x @ dequantize_int4(qp, dtype)
    return _group_matmul(x, qp, dtype)


def int8_matmul(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                out_dtype=None, w8a8: bool = False,
                reduce=None) -> torch.Tensor:
    """``x @ W`` for an int8 weight (2D, or stacked with ``"layer"``):
    with ``w8a8`` the W8A8 product at any M (straight-through under
    autograd), else K10 where it routes (``m <= 64``), else the
    materializing form. ``reduce``: a row-parallel shard, all-reduced
    (the W8A8 form inside, before its epilogue)."""
    from .int8_gemv import gemv_viable, int8_gemv

    dtype = out_dtype or x.dtype
    m = x.numel() // x.shape[-1]
    if not w8a8 and gemv_viable(qp, m):
        return all_reduce(int8_gemv(x, qp, dtype), reduce)
    if qp["q"].ndim == 3 and "layer" in qp:
        qp = _layer_of(qp)
    if w8a8:
        lead = x.shape[:-1]
        y = _W8A8STE.apply(x.reshape(-1, x.shape[-1]).to(dtype), qp["q"],
                           qp["scale"], reduce)
        return y.reshape(*lead, y.shape[-1])
    return all_reduce(x @ dequantize_int8(qp, dtype), reduce)


def quantized_matmul(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                     out_dtype=None, w8a8: bool = False, reduce=None,
                     rows: Optional[RowShard] = None) -> torch.Tensor:
    """``x @ W`` for any quantized weight dict. ``w8a8`` reaches the int4
    GEMV route (W4A8, K7/K9) and the W4A8 prefill branch on uniform
    rank-1 weights, and the W8A8 product on int8 weights. ``reduce``: a
    row-parallel shard's product, all-reduced over that group; ``rows``
    its :class:`RowShard`, which the int4 W4A8 forms read."""
    dtype = out_dtype or x.dtype
    if "q4" in qp:
        return int4_matmul(x, qp, dtype, act_int8=w8a8, reduce=reduce,
                           rows=rows)
    return int8_matmul(x, qp, dtype, w8a8=w8a8, reduce=reduce)


def prepare_matmul(qp: Dict[str, torch.Tensor], dtype):
    """``x -> x @ W`` for a 2D weight used at every decode step (the
    sliced selector head). A weight the GEMVs can take routes per call
    through :func:`quantized_matmul`; any other (the ~20-column sliced
    head, as in JAX) always takes the materializing form, so it decodes
    once here and no step dequantizes it."""
    from . import int8_gemv
    from .quant_gemv import gemv_viable

    if "q" in qp:
        if int8_gemv.gemv_viable(qp, 1):
            return lambda x: int8_matmul(x, qp, dtype)
        w = dequantize_int8(qp, dtype)
        return lambda x: x @ w
    if qp["code"].shape[-1] == 1 and gemv_viable(qp, 1):
        return lambda x: int4_matmul(x, qp, dtype)
    prep = materialize_split(qp, dtype)
    return lambda x: split_matmul(x, prep)


def slice_output_channels(p, ids: torch.Tensor):
    """Restrict a weight (plain ``[din, dout]`` tensor or quantized dict)
    to a subset of its output channels (the last axis); din-indexed
    leaves (``rscale``, ``code``, the packing) are untouched."""
    if not isinstance(p, dict):
        return p.index_select(-1, ids)
    out = dict(p)
    for k in ("q", "q4", "scale"):
        if k in out:
            out[k] = out[k].index_select(-1, ids)
    return out


def quantized_bytes(module: nn.Module) -> int:
    """Device bytes of a (possibly quantized) module's parameters and
    buffers, each shared tensor once."""
    tensors = list(module.parameters()) + list(module.buffers())
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

_KEYS = ("q", "q4", "scale", "rscale", "code")


class QuantWeight(nn.Module):
    """A quantized weight dict kept as buffers: 2D (the head, a vision
    GEMM) or stacked over layers (one per decoder projection site, the
    JAX tree's layout; an int8 ``q`` held column-major, :func:`column_major`). A stacked weight also holds ``layer_ids =
    arange(L)`` on its device: the indexed kernels (K8/K9, K10) read their
    layer through a pointer into it, so selecting a layer needs no host
    sync and no copy."""

    def __init__(self, qp: Dict[str, torch.Tensor]):
        super().__init__()
        self.fields = tuple(k for k in _KEYS if k in qp)
        for k in self.fields:
            self.register_buffer(k, column_major(qp[k]) if k == "q"
                                 else qp[k].contiguous())
        packed = qp["q4"] if "q4" in qp else qp["q"]
        if packed.ndim == 3:
            self.register_buffer("layer_ids", torch.arange(
                packed.shape[0], dtype=torch.int32, device=packed.device))

    @property
    def scheme(self) -> str:
        return "int8" if "q" in self.fields else "int4"

    def qp(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.fields}


class QuantLinear(nn.Module):
    """One projection over a :class:`QuantWeight` — layer ``layer`` of a
    stacked store, or the whole of a 2D one — plus its bias (kept in its
    dtype)."""

    def __init__(self, store: QuantWeight, layer: Optional[int] = None,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.store = store
        self.layer = layer
        self.bias = None if bias is None else nn.Parameter(
            bias.detach(), requires_grad=False)

    def qp(self, indexed: bool = False) -> Dict:
        """The weight dict: the stacked store plus this layer's index for
        the indexed form (cached forwards, as the JAX decode scan's
        ``_split_stacked_gemv``), else this layer's 2D slice (views, no
        copy)."""
        qp = self.store.qp()
        if self.layer is None:
            return qp
        if indexed:
            return {**qp, "layer":
                    self.store.layer_ids[self.layer:self.layer + 1]}
        return {k: v[self.layer] for k, v in qp.items()}

    def forward(self, x: torch.Tensor, w8a8: bool = False,
                indexed: bool = False) -> torch.Tensor:
        y = quantized_matmul(x, self.qp(indexed), x.dtype, w8a8=w8a8)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


# the name of the rank-1 int4 mode's projection, which came first
Int4Linear = QuantLinear


def materialized_linear(lin: nn.Module, x: torch.Tensor,
                        reduce=None) -> torch.Tensor:
    """``x @ W + b`` as the JAX vision tower and projector compute a dense
    layer (``x @ materialize_kernel(kernel, x.dtype) + bias``): a
    ``QuantLinear``'s weight, any scheme, dequantizes in ``x``'s dtype and
    meets ``x`` in one matmul (never the split or GEMV forms the decoder
    routes through); an ``nn.Linear`` is itself. ``reduce``: row-parallel,
    the product all-reduced before the bias."""
    if reduce is not None:
        if isinstance(lin, QuantLinear):
            y = x @ materialize_kernel(lin.qp(), x.dtype)
            return _add_bias(all_reduce(y, reduce), lin)
        return _reduce_wide(_mm_wide(x, lin.weight), lin, reduce, x.dtype)
    if not isinstance(lin, QuantLinear):
        return lin(x)
    y = x @ materialize_kernel(lin.qp(), x.dtype)
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


def _add_bias(y: torch.Tensor, lin: nn.Module) -> torch.Tensor:
    return y if lin.bias is None else y + lin.bias.to(y.dtype)


class _WideMm(torch.autograd.Function):
    """``x @ w.T`` of half operands with f32 sums
    (``torch.mm(out_dtype=)``, which has no derivative in torch 2.11)
    under autograd. Backward: ``dx = g @ w`` in the weights' dtype, which
    is exact for ``g``: the product's consumer rounds it to that dtype, so
    its gradient arrives as that dtype's values (what the whole layer's
    backward computes); the frozen weight gets none."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(w)
        ctx.x_dtype = x2.dtype
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        w, = ctx.saved_tensors
        return torch.mm(g.to(w.dtype), w).to(ctx.x_dtype), None


def _mm_wide(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` (``w`` an ``nn.Linear`` weight) with a bf16 / f16
    product's f32 sums kept in f32 (``torch.mm(out_dtype=)`` on the card,
    :class:`_WideMm` under autograd, the exact upcast on the CPU): a
    row-parallel partial sum, rounded only after the reduce, as the whole
    GEMM rounds once."""
    if x.dtype not in (torch.bfloat16, torch.float16) or w.dtype != x.dtype:
        return F.linear(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    if not x.is_cuda:
        y = x2.float() @ w.t().float()
    elif torch.is_grad_enabled() and x.requires_grad:
        y = _WideMm.apply(x2, w)
    else:
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[0])


def _reduce_wide(y: torch.Tensor, lin: nn.Module, reduce,
                 dtype) -> torch.Tensor:
    """The partial sums ``y`` all-reduced, the bias added, then one
    rounding to ``dtype``."""
    return _add_bias(all_reduce(y, reduce), lin).to(dtype)


def row_parallel_linear(lin: nn.Module, x: torch.Tensor, reduce,
                        w8a8: bool = False, indexed: bool = False,
                        rows: Optional[RowShard] = None) -> torch.Tensor:
    """A row-parallel shard of a decoder projection: ``x`` holds this
    rank's input channels and ``lin`` the matching rows of the weight.
    The local product (the routes of ``QuantLinear``; a bf16 GEMM's f32
    sums kept in f32, :func:`_mm_wide`) is all-reduced, then the bias is
    added once. ``rows``: the shard's :class:`RowShard` (int4 W4A8)."""
    if isinstance(lin, QuantLinear):
        return _add_bias(quantized_matmul(x, lin.qp(indexed), x.dtype,
                                          w8a8=w8a8, reduce=reduce,
                                          rows=rows), lin)
    return _reduce_wide(_mm_wide(x, lin.weight), lin, reduce, x.dtype)


def install_quantized_(model, stores: Dict[str, Dict[str, torch.Tensor]],
                       head: Dict[str, torch.Tensor]):
    """Put quantized weights into a port ``Qwen2Model`` IN PLACE:
    ``stores`` maps each projection name (q_proj ... down_proj) to its
    stacked weight dict, ``head`` is the lm_head's 2D dict. The stores
    live in ``model.int4`` or ``model.int8`` (by the head's scheme); each
    new projection keeps the replaced module's bias; the replaced
    ``nn.Linear``s are dropped, so their weights are freed."""
    table = nn.ModuleDict({n: QuantWeight(qp) for n, qp in stores.items()})
    setattr(model, "int8" if "q" in head else "int4", table)
    for grp, name in GEMV_SITES:
        for li, layer in enumerate(model.layers):
            mods = getattr(layer, grp)
            mods[name] = QuantLinear(table[name], li,
                                     getattr(mods[name], "bias", None))
    model.lm_head = QuantLinear(QuantWeight(head))
    return model


def site_groups(model, name: str):
    """(row_group, col_group) of a decoder projection site (or "lm_head")
    of a sharded ``Qwen2Model``: the model-axis group on the dim its plan
    splits, (None, None) for a whole decoder or a replicated site."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return None, None
    if name == "lm_head":
        return None, tp.vocab_group
    split = tp.attn_split if name.endswith(("q_proj", "k_proj", "v_proj",
                                            "o_proj")) else tp.mlp is not None
    g = tp.group if split else None
    return (g, None) if name in ("o_proj", "down_proj") else (None, g)


def _quantize_decoder_(model, quant):
    """Every decoder projection of a port ``Qwen2Model`` and its lm_head
    through ``quant`` (a bf16 ``[din, dout]`` weight and the site's
    (row_group, col_group), :func:`site_groups` -> a quantized dict), IN
    PLACE, one weight at a time: each bf16 weight is freed once it is
    quantized, so the peak is the bf16 model plus one weight's f32
    temporaries."""
    L = len(model.layers)
    stores = {}
    for grp, name in GEMV_SITES:
        stack = None
        for li, layer in enumerate(model.layers):
            lin = getattr(layer, grp)[name]
            qp = quant(lin.weight.t(), *site_groups(model, name))
            if stack is None:
                stack = empty_stack(L, qp)
            for key in stack:
                stack[key][li] = qp[key]
            lin.weight = None            # frees the bf16 weight now
            del lin, qp
        stores[name] = stack
    head = quant(model.lm_head.weight.t(), *site_groups(model, "lm_head"))
    model.lm_head.weight = None
    return install_quantized_(model, stores, head)


@torch.no_grad()
def quantize_text_(model, bits: int = 4):
    """Quantize a port ``Qwen2Model`` IN PLACE, every decoder projection
    and the lm_head: ``bits=4`` rank-1 uniform int4 (the scheme K6-K9
    route; the JAX serve path's ``quantize_tree(params["text"], bits=4,
    rank1=True, nf4=False)``), ``bits=8`` per-channel int8 (K10;
    ``quantize_tree(params["text"], bits=8)``). Embeddings, norms and
    biases stay as they are. Each bf16 weight is freed once quantized, so
    the peak is the bf16 model plus one weight's f32 temporaries. Returns
    ``model``."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return _quantize_decoder_(model, lambda w, rg, cg: quantize_kernel(
        w, bits, nf4=False, rank1=True, row_group=rg, col_group=cg))


@torch.no_grad()
def quantize_cogreasoner_(model, bits: int, nf4: bool = True,
                          group_size: int = 64):
    """Quantize a whole port ``CogReasoner`` IN PLACE, as the JAX
    ``quantize_tree(params, bits=bits, nf4=nf4)`` quantizes the whole tree
    (the QLoRA base of stage-2 ``--quantize-base``): the 7 decoder
    projections and the lm_head, every vision-tower GEMM (the patch
    embedding included) and the projector's linears. ``bits=4`` is
    group-wise (``group_size`` rows of din to a scale) NF4, or uniform
    int4 with ``nf4=False``; ``bits=8`` per-channel int8; a weight whose
    din the group does not divide falls back to int8 (at 7B the patch
    embedding, din 588, and every tower fc2, din 4304). Each scale is per
    output column, so the fused vision QKV quantizes exactly as JAX's q /
    k / v dicts concatenated along dout. Embeddings, norms and biases stay
    as they are; each bf16 weight is freed once it is quantized. On a
    model sharded for a mesh, int8 gives each rank the slice of the whole
    model's quantization (a row-parallel weight's column absmax is MAXed
    over its group), and so does group-wise 4-bit, whose groups run along
    din (a row-parallel shard that does not hold whole groups raises
    ``ValueError``: quantize whole, then shard). Returns ``model``."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def quant(w, row_group=None, col_group=None):
        return quantize_kernel(w, bits, group_size, nf4, row_group=row_group,
                               col_group=col_group)

    def swap(owner, name: str, row_group=None):
        lin = getattr(owner, name)
        setattr(owner, name, QuantLinear(QuantWeight(quant(
            lin.weight.t(), row_group)), bias=lin.bias))
        lin.weight = None

    # a sharded model's row-parallel GEMMs take each column's scale over
    # the whole column (their shards' row groups)
    vt, pt = model.vision.tp, model.projector.tp
    rows = {"o": vt is not None and vt.attn_split,
            "fc2": vt is not None and vt.mlp is not None}
    _quantize_decoder_(model.text, quant)
    swap(model.vision, "patch_embed")
    for layer in model.vision.layers:
        for name in ("qkv", "o", "fc1", "fc2"):
            swap(layer, name, vt.group if rows.get(name) else None)
    for i in range(len(model.projector.layers)):
        split = pt is not None and pt.hidden is not None and i == 1
        swap(model.projector.layers, str(i),    # ModuleList entries by name
             pt.group if split else None)
    return model
