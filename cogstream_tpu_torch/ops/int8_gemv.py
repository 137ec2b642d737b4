"""K10: the weight-only int8 GEMV (``csrc/int8_gemv.cu``) and its plain
version.

An int8 weight (ops/quant.py ``quantize_int8``) is ``q`` int8 ``[din,
dout]`` (stacked ``[L, din, dout]`` per decoder projection site) with a
per-column f32 ``scale``; a held one is stored column-major
(``quant.column_major``), the layout K10 streams and ``torch._int_mm``
takes on its fast path. The JAX package has no Pallas kernel for it: XLA
fuses ``(q * scale).astype(dtype)`` into the consuming dot
(``cogstream_tpu/ops/quant.py`` ``quantized_matmul``), so a decode step
reads one byte per weight. K10 is that fusion on the card: each weight is
rounded as XLA rounds it, ``bf16(f32(q) * scale[o])``, and dotted with the
activations in f32 sums. Its plain version is the materializing form,
``x @ dequantize_int8(qp, x.dtype)``, which is also the CPU route.
Under autograd (a LoRA turn on a frozen int8 base, m <= 64) the wrapper's
backward is the transpose of that form, ``dx = g @ W_deq^T``.

The route is K8's (``ops/quant_gemv.py`` ``gemv_viable``): decode-sized
``m <= 64`` with shapes that block into 128-multiples. bf16 activations
run the tensor-core kernel (one launch per call, its K splits summed
through a per-device workspace, so a call allocates only its output and
can be captured in a CUDA graph); f32 activations run a CUDA-core kernel
without bf16 rounding. For a CUDA tensor the wrapper launches or raises;
there is no fallback.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import kernels
from .quant import frozen_product
from .quant_gemv import _pick_blocks, _tc_workspace, stacked_plan


def gemv_viable(qp: Dict[str, torch.Tensor], m: int, m_max: int = 64) -> bool:
    """K10's route: an int8 weight (2D, or stacked with a ``"layer"``
    entry), ``m <= 64``, din and dout blockable as K8's route requires."""
    q = qp.get("q")
    if q is None or q.ndim not in (2, 3) or m > m_max:
        return False
    if q.ndim == 3 and "layer" not in qp:
        return False
    return _pick_blocks(*q.shape[-2:]) is not None


def _layer_slice(q, scale, layer):
    if layer is None:
        return q, scale
    return q.index_select(0, layer)[0], scale.index_select(0, layer)[0]


def _plain(x, q, scale, layer, out_dtype):
    """``x @ W`` with ``W = (q * scale)`` rounded to ``x``'s dtype (the
    JAX expression), then cast to ``out_dtype``."""
    q, scale = _layer_slice(q, scale, layer)
    w = (q.to(torch.float32) * scale[None, :]).to(x.dtype)
    return (x @ w).to(out_dtype)


def _launch(x, q, scale, layer, out_dtype):
    """One ``cs_int8_gemv`` launch: ``x`` [m, din] f32 or bf16, ``q``
    [din, dout] or [L, din, dout] (each matrix column-major) with
    ``layer`` an int32 [1] on the device, ``scale`` [dout] or [L, dout]
    f32."""
    dev = x.device
    stacked = q.ndim == 3
    din, dout = q.shape[-2:]
    m = x.shape[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8 GEMV takes f32 or bf16 activations, got "
                        f"{x.dtype}")
    kernels.require(x, "x", dev, None, (m, din))
    kernels.require(q.transpose(-1, -2), "q (column-major)", dev,
                    torch.int8)
    kernels.require(scale, "scale", dev, torch.float32,
                    (q.shape[0], dout) if stacked else (dout,))
    if stacked:
        kernels.require(layer, "layer", dev, torch.int32, (1,))
    if m > 64:
        raise ValueError(f"int8 GEMV serves m <= 64, got {m}")
    out = torch.empty((m, dout), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    tc = x.dtype == torch.bfloat16
    rows = splits = 1
    part = tickets = None
    if tc:
        if din % 128 or dout % 128:
            raise ValueError(f"cs_int8_gemv needs din and dout multiples of "
                             f"128, got {(din, dout)}")
        kernels.require_aligned(x, q, scale)
        rows, splits = stacked_plan(m, din, dout, False,
                                    kernels.sm_count(dev), x_halves=1)
        if splits > 1:
            part, tickets = _tc_workspace(dev, splits * m * dout, dout // 128)
    kernels.check(kernels.library().cs_int8_gemv(
        x.data_ptr(), q.data_ptr(), din * dout if stacked else 0,
        scale.data_ptr(), dout if stacked else 0,
        layer.data_ptr() if stacked else None, out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), m, din, dout, rows,
        splits, kernels.dtype_code(x), kernels.dtype_code(out),
        kernels.stream_ptr(x)), "cs_int8_gemv")
    gemv_k10.tc_launches += tc
    return out


def gemv_k10(x, q, scale, layer, out_dtype):
    """K10 on prepared operands: ``x`` [m, din], ``q``/``scale`` 2D (with
    ``layer`` None) or stacked with ``layer`` an int32 [1] on the device."""
    if kernels.plain_route(x):
        return _plain(x, q, scale, layer, out_dtype)
    out = _launch(x, q, scale, layer, out_dtype)
    gemv_k10.launches += 1
    return out


gemv_k10.launches = 0       # every launch
gemv_k10.tc_launches = 0    # those on the tensor-core kernel (bf16)


def _gemv(x, qp, out_dtype, plain: bool):
    dtype = out_dtype or x.dtype
    q, scale = qp["q"], qp["scale"]
    layer = qp.get("layer") if q.ndim == 3 else None
    *lead, din = x.shape
    x2 = x.reshape(-1, din)
    y = (_plain(x2, q, scale, layer, dtype) if plain
         else gemv_k10(x2.contiguous(), q, scale, layer, dtype))
    return y.reshape(*lead, q.shape[-1])


def int8_gemv(x: torch.Tensor, qp: Dict[str, torch.Tensor],
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ W`` through K10 for an int8 weight dict: 2D, or stacked
    ``[L, din, dout]`` with ``"layer"`` (an int32 [1] view of the
    decoder's ``layer_ids``, read by the kernel itself). Under autograd
    the backward is JAX's transpose of its dequant matmul, ``dx = g @
    W_deq^T`` with ``W_deq = q * scale`` rounded to g's dtype; the frozen
    weights get no gradient."""
    q, scale = qp["q"], qp["scale"]
    layer = qp.get("layer") if q.ndim == 3 else None

    def vjp(g):
        ql, sl = _layer_slice(q, scale, layer)
        return g @ (ql.to(torch.float32) * sl[None, :]).to(g.dtype).t()

    return frozen_product(x, lambda t: _gemv(t, qp, out_dtype, plain=False),
                          vjp)


def int8_gemv_plain(x: torch.Tensor, qp: Dict[str, torch.Tensor],
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`int8_gemv` through the plain version, on any device."""
    return _gemv(x, qp, out_dtype, plain=True)
