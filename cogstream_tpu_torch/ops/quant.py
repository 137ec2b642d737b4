"""Weight quantization for serving — port of the rank-1 int4 serving
subset of ``cogstream_tpu/ops/quant.py``.

The serving scheme is rank-1 int4 (``quantize_int4_rank1``): a weight
``w[p, o]`` (JAX layout ``[din, dout]``) is stored as

* ``q4``: int8 ``[..., din/2, dout]``, two signed nibbles per byte in the
  SPLIT-HALVES layout — the low nibble of packed row ``p`` holds row
  ``p``, the high nibble row ``p + din/2``;
* ``scale`` f32 ``[..., dout]`` (column) and ``rscale`` f32 ``[..., din]``
  (row) scales, fit by alternating absmax normalization;
* ``code`` f32 ``[..., 1]`` (uniform: value = s/7) or ``[..., 2]`` (cubic
  codebook value = s·(A + C·s²)). The length of its last axis is the
  scheme tag the dispatch keys on.

``w ≈ code(nib) · rscale[p] · scale[o]``. Quantized weights are plain
dicts of tensors, as in the JAX package; :class:`Int4Weight` keeps one
on a module (stacked ``[L, ...]`` per projection site, or 2D for the
head) and :class:`Int4Linear` is one layer's projection over it.

``int4_matmul`` routes exactly where the JAX package routes: uniform
rank-1 weights at decode-sized M (``m <= 64``) with 128-divisible shapes
go to the fused-unpack GEMV (ops/quant_gemv.py: K6/K7 for 2D weights,
K8/K9 for stacked weights with a layer index); everything else takes the
materializing form below, which on the card is ``torch.matmul`` as the
JAX package leaves it to XLA. The two forms round differently (the
kernel rounds ``x·rscale`` to bf16 and keeps the nibbles exact; the
materializing form rounds ``nibble·slope·scale`` to bf16), so the route
decision is part of the numerics.

Not in this port yet (ROADMAP Queue 1 #4): group-wise int4 / NF4, the
W8A8 prefill branch, the W8A8 straight-through estimator and the vision
tower's ``encoder_int8``; asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

QUEUE_MSG = "not ported yet (ROADMAP Queue 1 #4)"

# rank-1 cubic codebook: value(s) = s·(A + C·s²), value(±7) = ±1
CUBIC_A = 0.065
CUBIC_C = (1.0 - 7.0 * CUBIC_A) / 343.0
CUBIC_CODE = tuple(
    float(s * (CUBIC_A + CUBIC_C * s * s)) for s in range(-7, 8))

# decoder projection sites that hold quantized kernels, in layer order
GEMV_SITES = (("attn", "q_proj"), ("attn", "k_proj"), ("attn", "v_proj"),
              ("attn", "o_proj"), ("mlp", "gate_proj"), ("mlp", "up_proj"),
              ("mlp", "down_proj"))

_CUBIC_ROWS = 64      # rows of the cubic codebook search held at once


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 over the last axis."""
    wf = w.to(torch.float32)
    scale = wf.abs().amax(dim=-2, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.squeeze(-2)}


def dequantize_int8(qp: Dict[str, torch.Tensor],
                    dtype=torch.bfloat16) -> torch.Tensor:
    return (qp["q"].to(torch.float32)
            * qp["scale"][..., None, :]).to(dtype)


def _pack_split(vals: torch.Tensor) -> torch.Tensor:
    """[..., din, dout] 4-bit values (low 4 bits significant) → [...,
    din/2, dout] bytes in the split-halves layout (int8 storage)."""
    din = vals.shape[-2]
    lo = vals[..., : din // 2, :].to(torch.uint8) & 0xF
    hi = vals[..., din // 2:, :].to(torch.uint8) & 0xF
    return (lo | (hi << 4)).view(torch.int8)


def _unpack_halves(packed: torch.Tensor):
    """int8 packed bytes → (lo_half, hi_half) sign-extended nibbles in
    [-8, 7], each [..., din/2, dout] int8."""
    if packed.dtype != torch.int8:
        raise NotImplementedError(f"{packed.dtype} nibbles (NF4 codebook "
                                  f"indices) are {QUEUE_MSG}")
    return (packed << 4) >> 4, packed >> 4


def quantize_int4_rank1(w: torch.Tensor, nf4: bool = True,
                        iters: int = 8) -> Dict[str, torch.Tensor]:
    """4-bit with rank-1 (row ⊗ column) scales, over ``w`` in the JAX
    layout ``[..., din, dout]``. ``nf4=True`` snaps to the cubic
    codebook (``code = [A, C]``), ``nf4=False`` is uniform (``code =
    [1/7]``). Same f32 operations in the same order as the JAX function,
    so the bytes agree."""
    wf = w.to(torch.float32)
    *lead, din, dout = wf.shape
    if din % 2:
        raise ValueError(f"din={din} must be even")
    aw = wf.abs()
    r = torch.clamp(aw.amax(dim=-1, keepdim=True), min=1e-8)
    c = None
    for _ in range(iters):
        c = torch.clamp((aw / r).amax(dim=-2, keepdim=True), min=1e-8)
        r = torch.clamp((aw / c).amax(dim=-1, keepdim=True), min=1e-8)
    del aw
    norm = wf / (r * c)                             # ⊆ [-1, 1]
    if nf4:
        code = torch.tensor(CUBIC_CODE, dtype=torch.float32,
                            device=wf.device)
        q = torch.empty(norm.shape, dtype=torch.int8, device=wf.device)
        # argmin over the 15 levels, a block of rows at a time (the
        # [rows, dout, 15] distance tensor is the memory peak)
        for p0 in range(0, din, _CUBIC_ROWS):
            blk = norm[..., p0:p0 + _CUBIC_ROWS, :]
            idx = torch.argmin((blk[..., None] - code).abs(), dim=-1)
            q[..., p0:p0 + _CUBIC_ROWS, :] = (idx - 7).to(torch.int8)
        coefs = (CUBIC_A, CUBIC_C)
    else:
        q = torch.clamp(torch.round(norm * 7.0), -7, 7).to(torch.int8)
        coefs = (1.0 / 7.0,)
    del norm
    code_arr = torch.tensor(coefs, dtype=torch.float32,
                            device=wf.device).expand(*lead, len(coefs))
    return {"q4": _pack_split(q), "scale": c.squeeze(-2),
            "rscale": r.squeeze(-1), "code": code_arr.contiguous()}


def dequantize_int4(qp: Dict[str, torch.Tensor],
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Materializing unpack + rescale of a rank-1 weight (the rank-1
    branch of the JAX function)."""
    if "rscale" not in qp:
        raise NotImplementedError(f"group-wise int4 / NF4 is {QUEUE_MSG}")
    lo, hi = _unpack_halves(qp["q4"])
    s = torch.cat([lo, hi], dim=-2).to(torch.float32)
    a = qp["code"][..., 0:1, None]
    if qp["code"].shape[-1] == 1:                   # uniform (scheme tag)
        vals = s * a
    else:
        cc = qp["code"][..., 1:2, None]
        vals = s * (a + cc * (s * s))
    w = vals * qp["rscale"][..., :, None] * qp["scale"][..., None, :]
    return w.to(dtype)


def quantize_int8_act(x: torch.Tensor):
    """Dynamic per-row symmetric int8 activations: ``(q, scale)`` with
    ``x ≈ q * scale``, scale ``[..., 1]`` f32. Rounds half to even, like
    ``jnp.round``."""
    xf = x.to(torch.float32)
    ax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6)
    # a true division (``127.0 / ax`` on a tensor is reciprocal * 127)
    q = torch.clamp(torch.round(xf * (ax.new_tensor(127.0) / ax)),
                    -127, 127).to(torch.int8)
    return q, ax * (1.0 / 127.0)


# ---------------------------------------------------------------------------
# matmuls
# ---------------------------------------------------------------------------

def materialize_split(qp: Dict[str, torch.Tensor], dtype) -> Dict:
    """The weight half of the materializing 2D form: each packed half
    decoded to ``nibble·code·scale`` rounded to ``dtype``. Kept apart so
    a weight used at every step (the sliced selector head) decodes
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


def int4_matmul(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                out_dtype=None, act_int8: bool = False) -> torch.Tensor:
    """``x @ W`` for a rank-1 int4 weight: the fused GEMV where the JAX
    package routes it (see the module docstring), else the materializing
    form. ``qp`` is 2D, or stacked ``[L, ...]`` with a ``"layer"`` entry
    (int32 ``[1]`` on W's device) for the indexed form. A stacked weight
    off the indexed route takes its layer's 2D slice, as the JAX decode
    scan hands such weights to ``dense`` (``qwen2._split_stacked_gemv``),
    so it rounds exactly as the 2D route does."""
    from .quant_gemv import (gemv_viable, gemv_viable_stacked,
                             int4_rank1_gemv, int4_rank1_gemv_stacked)

    if "rscale" not in qp:
        raise NotImplementedError(f"group-wise int4 / NF4 is {QUEUE_MSG}")
    dtype = out_dtype or x.dtype
    m = x.numel() // x.shape[-1]
    uniform = qp["code"].shape[-1] == 1
    if qp["q4"].ndim == 3 and "layer" in qp:
        layer = qp["layer"]
        if uniform and gemv_viable_stacked(qp, m):
            return int4_rank1_gemv_stacked(x, qp, layer, dtype,
                                           w4a8=act_int8)
        qp = {k: v.index_select(0, layer)[0] for k, v in qp.items()
              if k != "layer"}
    if qp["q4"].ndim != 2:
        return x @ dequantize_int4(qp, dtype)
    if uniform and gemv_viable(qp, m):
        return int4_rank1_gemv(x, qp, dtype, w4a8=act_int8)
    if act_int8 and uniform:
        raise NotImplementedError(f"the W4A8 prefill branch is {QUEUE_MSG}")
    return split_matmul(x, materialize_split(qp, dtype))


def prepare_matmul(qp: Dict[str, torch.Tensor], dtype):
    """``x -> x @ W`` for a 2D rank-1 weight used at every decode step
    (the sliced selector head). A weight the GEMV can take routes per
    call through :func:`int4_matmul`; any other (the ~20-column sliced
    head, K < 128, as in JAX) always takes the materializing form, so its
    halves decode once here and no step unpacks them."""
    from .quant_gemv import gemv_viable

    if qp["code"].shape[-1] == 1 and gemv_viable(qp, 1):
        return lambda x: int4_matmul(x, qp, dtype)
    prep = materialize_split(qp, dtype)
    return lambda x: split_matmul(x, prep)


def quantized_matmul(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                     out_dtype=None, w8a8: bool = False) -> torch.Tensor:
    """``x @ W`` for any quantized weight dict. ``w8a8`` reaches the
    int4 GEMV route only (the W4A8 kernels K7/K9)."""
    dtype = out_dtype or x.dtype
    if "q4" in qp:
        return int4_matmul(x, qp, dtype, act_int8=w8a8)
    if w8a8:
        raise NotImplementedError(f"W8A8 int8 matmuls are {QUEUE_MSG}")
    return x @ dequantize_int8(qp, dtype)


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

class Int4Weight(nn.Module):
    """A rank-1 int4 weight kept as buffers: 2D (``q4 [din/2, dout]``,
    the head) or stacked over layers (``q4 [L, din/2, dout]``, one per
    decoder projection site, the JAX tree's layout — never transposed to
    ``nn.Linear``'s ``[out, in]``). A stacked weight also holds
    ``layer_ids = arange(L)`` on its device: the indexed kernels K8/K9
    read their layer through a pointer into it, so selecting a layer
    needs no host sync and no copy."""

    def __init__(self, qp: Dict[str, torch.Tensor]):
        super().__init__()
        for k in ("q4", "scale", "rscale", "code"):
            self.register_buffer(k, qp[k].contiguous())
        if self.q4.ndim == 3:
            self.register_buffer("layer_ids", torch.arange(
                self.q4.shape[0], dtype=torch.int32, device=self.q4.device))

    def qp(self) -> Dict[str, torch.Tensor]:
        return {"q4": self.q4, "scale": self.scale, "rscale": self.rscale,
                "code": self.code}


class Int4Linear(nn.Module):
    """One projection over an :class:`Int4Weight` — layer ``layer`` of a
    stacked store, or the whole of a 2D one — plus its bias (kept in the
    model's dtype)."""

    def __init__(self, store: Int4Weight, layer: Optional[int] = None,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.store = store
        self.layer = layer
        self.bias = None if bias is None else nn.Parameter(
            bias.detach(), requires_grad=False)

    def qp(self, indexed: bool = False) -> Dict:
        """The weight dict: the stacked store plus this layer's index for
        the indexed form (cached forwards, as the JAX decode scan's
        ``_split_stacked_gemv``; ``int4_matmul`` routes it), else this
        layer's 2D slice (views, no copy)."""
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


def install_int4_(model, stores: Dict[str, Dict[str, torch.Tensor]],
                  head: Dict[str, torch.Tensor]):
    """Put rank-1 int4 weights into a port ``Qwen2Model`` IN PLACE:
    ``stores`` maps each projection name (q_proj ... down_proj) to its
    stacked weight dict, ``head`` is the lm_head's 2D dict. Each new
    projection keeps the replaced module's bias; the replaced
    ``nn.Linear``s are dropped, so their weights are freed."""
    model.int4 = nn.ModuleDict({n: Int4Weight(qp) for n, qp in stores.items()})
    for grp, name in GEMV_SITES:
        for li, layer in enumerate(model.layers):
            mods = getattr(layer, grp)
            mods[name] = Int4Linear(model.int4[name], li,
                                    getattr(mods[name], "bias", None))
    model.lm_head = Int4Linear(Int4Weight(head))
    return model


@torch.no_grad()
def quantize_text_(model, bits: int = 4):
    """Quantize a port ``Qwen2Model`` IN PLACE: every decoder projection
    and the lm_head become rank-1 uniform int4 (the scheme the GEMV
    kernels route), the counterpart of ``quantize_tree(params["text"],
    bits=4, rank1=True, nf4=False)`` in the JAX serve path.
    Embeddings, norms and biases stay as they are. Each bf16 weight is
    freed once quantized, so the peak is the bf16 model plus one
    weight's f32 temporaries. Returns ``model``."""
    if bits != 4:
        raise NotImplementedError(f"int{bits} weight-only serving is {QUEUE_MSG}")
    L = len(model.layers)
    stores = {}
    for grp, name in GEMV_SITES:
        lin0 = getattr(model.layers[0], grp)[name]
        dout, din = lin0.weight.shape
        dev = lin0.weight.device
        stack = {"q4": torch.empty((L, din // 2, dout), dtype=torch.int8,
                                   device=dev),
                 "scale": torch.empty((L, dout), device=dev),
                 "rscale": torch.empty((L, din), device=dev),
                 "code": torch.empty((L, 1), device=dev)}
        for li, layer in enumerate(model.layers):
            lin = getattr(layer, grp)[name]
            qp = quantize_int4_rank1(lin.weight.t(), nf4=False)
            for key in stack:
                stack[key][li] = qp[key]
            lin.weight = None            # frees the bf16 weight now
            del lin, qp
        stores[name] = stack
    head = quantize_int4_rank1(model.lm_head.weight.t(), nf4=False)
    model.lm_head.weight = None
    return install_int4_(model, stores, head)
