"""SigLIP-style vision tower (port of ``cogstream_tpu/models/vision_encoder.py``).

27 pre-LN layers (hidden 1152, 16 heads of 72, gelu-tanh MLP 4304) over
a flat ``[N, hidden]`` token stream of patch rows; each frame is one
attention segment; a merge-window mean downsamples at the end.

Per layer on a CUDA device: K2 LayerNorm → ONE fused QKV GEMM (weights
concatenated once at load, ``[3*H*D, hidden]``) → K1 segment attention
reading q/k/v straight out of that GEMM output with the 2D RoPE fused
in → o-projection → K2 LayerNorm → MLP. The plain GEMMs are
``torch.nn.functional.linear``. The TPU-only 128-lane per-head weight
padding has no counterpart here.

``vision_encoder_core`` keeps the JAX branch structure: with the packed
ranges (``kv_lo``/``kv_hi``) it runs the serving path above; without
them ``use_pallas=True`` runs the head-major branch (q/k/v sliced from
the fused QKV output, 2D RoPE as its own pass, then K5 on a CUDA device)
— the branch the training path's frozen tower takes — and
``use_pallas=False`` the plain ``segment_attention`` (CPU and tests).

The W8A8 tower (``quantize_vision_w8a8``, the serving ``encoder_int8``
mode) holds every GEMM but the patch embedding as int8 ``QuantLinear``s.
The packed path runs the fused-QKV and o GEMMs W8A8 (per-row int8
activations, ``torch._int_mm``, bias added in f32 before the cast) only
when all four attention weights are int8, and the MLP only when fc1 and
fc2 both are (``is_w8``); the head-major branch keeps weight-only
attention and a W8A8 MLP, as JAX's does. JAX pads each head of the packed
path to 128 lanes with zero weights and unit scales, which leaves every
per-column scale and per-row activation absmax as it is unpadded: the
port quantizes the unpadded GEMMs and gets the same numbers.

A tower quantized whole (``ops/quant.quantize_cogreasoner_``, the QLoRA
base) holds every GEMM, the patch embedding included, as a ``QuantLinear``
of its scheme (group-wise NF4 / int4, with int8 where the group does not
divide din, or all int8). Every GEMM that does not take the W8A8 rule
above runs weight-only as JAX's ``_dense`` does, ``x @ materialize_kernel(W)
+ b`` (``quant.materialized_linear``). The rule keys on the weights as
JAX's ``_is_w8`` does, so an all-int8 base (``--quantize-base int8``) runs
its attention (packed path) and MLP W8A8 here as it does there; an NF4
base, whose fc2 alone falls back to int8, stays weight-only.

A tower sharded for a mesh (parallel/sharding.py; its plan in ``tower.tp``)
holds its rank's heads, each of q, k and v sliced per head in the fused QKV
weight, so K1 reads its local heads out of the one local GEMM output; the o
and fc2 GEMMs are row-parallel (all-reduced, then the bias). A W8A8
row-parallel GEMM takes the activation absmax of the whole row and
all-reduces its int32 sums before the epilogue.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import VisionEncoderConfig
from ..ops.attention import segment_attention
from ..ops.flash_attention import (flash_attention_packed_rope_fusedqkv,
                                   segment_flash_attention, vision_kv_ranges)
from ..ops.layernorm import layernorm
from ..ops.quant import (QuantLinear, QuantWeight, int8_act_matmul,
                         materialized_linear, quantize_int8,
                         quantize_int8_act)
from ..ops.rope import (apply_vision_rope_cs, grid_position_ids,
                        vision_rope_angles, vision_rope_cos_sin)


def linear(din: int, dout: int, device, dtype, bias: bool = True) -> nn.Linear:
    """An nn.Linear with uninitialized storage (weights come from the
    bridge or ``init_cogreasoner_params``) on ``device``: the card unless
    the caller names another."""
    return nn.utils.skip_init(nn.Linear, din, dout, bias=bias,
                              device=default_device(device), dtype=dtype)


def default_device(device=None) -> torch.device:
    """The device a model constructor allocates on: ``device`` if given, else the
    CUDA card. There is no CPU fallback: without a card the allocation
    fails, and CPU callers pass ``device="cpu"``."""
    return torch.device("cuda" if device is None else device)


class LayerNormParams(nn.Module):
    """f32 scale/bias of a LayerNorm applied through ``ops.layernorm``."""

    def __init__(self, hidden: int, device=None):
        super().__init__()
        device = default_device(device)
        self.scale = nn.Parameter(torch.ones(hidden, device=device))
        self.bias = nn.Parameter(torch.zeros(hidden, device=device))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return layernorm(x, self.scale, self.bias, eps)


class VisionLayer(nn.Module):
    def __init__(self, cfg: VisionEncoderConfig, device, dtype):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.ln1 = LayerNormParams(H, device)
        self.ln2 = LayerNormParams(H, device)
        self.qkv = linear(H, 3 * H, device, dtype)   # rows: q | k | v
        self.o = linear(H, H, device, dtype)
        self.fc1 = linear(H, I, device, dtype)
        self.fc2 = linear(I, H, device, dtype)


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionEncoderConfig, device=None, dtype=None):
        super().__init__()
        dtype = dtype or cfg.torch_dtype
        device = default_device(device)
        self.cfg = cfg
        patch_dim = cfg.num_channels * cfg.patch_size ** 2
        self.patch_embed = linear(patch_dim, cfg.hidden_size, device, dtype)
        self.layers = nn.ModuleList(VisionLayer(cfg, device, dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.post_ln = LayerNormParams(cfg.hidden_size, device)
        # the tensor-parallel plan of a sharded tower
        # (parallel/sharding.TowerShard), None for the whole tower
        self.tp = None

    @property
    def dtype(self) -> torch.dtype:
        lin = self.patch_embed     # a QuantLinear keeps its bias's dtype
        return lin.weight.dtype if isinstance(lin, nn.Linear) \
            else lin.bias.dtype

    @property
    def int8(self) -> bool:
        """The W8A8 serving copy (``quantize_vision_w8a8``)."""
        return is_w8(self.layers[0].qkv) if len(self.layers) else False


class VisionMetadata(NamedTuple):
    """Host-precomputed per-batch metadata for the tower."""

    pos_ids: np.ndarray          # [N, 2]
    segment_ids: np.ndarray      # [N] (-1 = pad)
    merge_group_ids: np.ndarray  # [N] output token per input token
    num_out_tokens: int
    kv_lo: np.ndarray            # [ceil(N/64)] K1 key range per q tile
    kv_hi: np.ndarray


def build_vision_metadata(grid_sizes: np.ndarray, merge_sizes: np.ndarray,
                          pad_to: Optional[int] = None) -> VisionMetadata:
    """Positions, frame-segment ids and merge groups in patchify order;
    each frame is its own attention segment."""
    pos_list, seg_list, grp_list = [], [], []
    seg = 0
    out_tokens = 0
    for (t, gh, gw), ms in zip(np.asarray(grid_sizes), np.asarray(merge_sizes)):
        t, gh, gw, ms = int(t), int(gh), int(gw), int(ms)
        pos_list.append(grid_position_ids(t, gh, gw, ms))
        seg_list.append(np.repeat(np.arange(seg, seg + t, dtype=np.int32),
                                  gh * gw))
        seg += t
        n_groups = t * (gh // ms) * (gw // ms)
        grp_list.append(np.repeat(np.arange(out_tokens, out_tokens + n_groups,
                                            dtype=np.int32), ms * ms))
        out_tokens += n_groups
    if pos_list:
        pos = np.concatenate(pos_list)
        segs = np.concatenate(seg_list)
        grps = np.concatenate(grp_list)
    else:
        pos = np.zeros((0, 2), np.int32)
        segs = np.zeros((0,), np.int32)
        grps = np.zeros((0,), np.int32)
    n = pos.shape[0]
    if pad_to is not None and pad_to > n:
        pad = pad_to - n
        pos = np.concatenate([pos, np.zeros((pad, 2), np.int32)])
        segs = np.concatenate([segs, np.full((pad,), -1, np.int32)])
        grps = np.concatenate([grps, np.full((pad,), -1, np.int32)])
    kv_lo, kv_hi = vision_kv_ranges(segs)
    return VisionMetadata(pos, segs, grps, out_tokens, kv_lo, kv_hi)


def int8_linear(qp, bias: Optional[torch.Tensor]) -> QuantLinear:
    """A 2D int8 GEMM (``q`` [din, dout], ``scale`` [dout]) with its bias."""
    return QuantLinear(QuantWeight(qp), bias=bias)


def is_w8(lin: nn.Module) -> bool:
    """An int8 GEMM (the W8A8 serving form); int4 weights are not."""
    return isinstance(lin, QuantLinear) and lin.store.scheme == "int8"


def _w8a8(x: torch.Tensor, lin: QuantLinear, out_dtype=None,
          reduce=None) -> torch.Tensor:
    """``x @ W + b`` with per-row int8 activations: the int32 product's
    epilogue and the bias in f32, one cast at the end (JAX
    ``_attn_block_packed`` / ``_mlp_block``). ``reduce``: row-parallel
    (whole-row absmax, int32 sums all-reduced before the epilogue)."""
    xq, sx = quantize_int8_act(x, reduce)
    y = int8_act_matmul(xq, sx, lin.store.q, lin.store.scale, torch.float32,
                        site="tower", reduce=reduce) \
        + lin.bias.to(torch.float32)
    return y.to(out_dtype or x.dtype)


def _row_reduce(tower: "VisionTower", part: str):
    """The group a row-parallel GEMM of a sharded tower reduces over
    (``part`` "attn" for o, "mlp" for fc2), or None."""
    tp = tower.tp
    if tp is None:
        return None
    split = tp.attn_split if part == "attn" else tp.mlp is not None
    return tp.group if split else None


def _mlp(layer: "VisionLayer", h: torch.Tensor, reduce=None) -> torch.Tensor:
    """fc1 → gelu-tanh → fc2; W8A8 when fc1 and fc2 are both int8, else
    weight-only (JAX ``_mlp_block``)."""
    if is_w8(layer.fc1) and is_w8(layer.fc2):
        a = F.gelu(_w8a8(h, layer.fc1, torch.float32), approximate="tanh")
        return _w8a8(a.to(h.dtype), layer.fc2, reduce=reduce)
    a = F.gelu(materialized_linear(layer.fc1, h), approximate="tanh")
    return materialized_linear(layer.fc2, a, reduce)


@torch.no_grad()
def quantize_vision_w8a8(tower: VisionTower) -> VisionTower:
    """An int8 copy of ``tower`` for W8A8 serving: every GEMM but the
    patch embedding becomes per-output-channel int8 (the JAX
    ``quantize_tree(bits=8, predicate=name != "patch_embed")``; the fused
    QKV quantizes per column, which is the q / k / v quantizations side by
    side). Norms, the patch embedding and the biases are shared with
    ``tower``, which is left as it is. A sharded tower's copy keeps its
    plan, its row-parallel GEMMs scaled over every rank's rows."""
    out = VisionTower(tower.cfg, device="meta", dtype=tower.dtype)
    out.patch_embed, out.post_ln = tower.patch_embed, tower.post_ln
    out.tp = tower.tp
    rows = {"o": _row_reduce(tower, "attn"), "fc2": _row_reduce(tower, "mlp")}
    for mine, src in zip(out.layers, tower.layers):
        mine.ln1, mine.ln2 = src.ln1, src.ln2
        for name in ("qkv", "o", "fc1", "fc2"):
            lin = getattr(src, name)
            setattr(mine, name, int8_linear(
                quantize_int8(lin.weight.t(), rows.get(name)), lin.bias))
    return out


def _attn_head_major(layer: VisionLayer, h: torch.Tensor, cos2, sin2,
                     segment_ids: torch.Tensor, ranges, H: int, D: int,
                     scale: float, use_pallas: bool,
                     reduce=None) -> torch.Tensor:
    """The JAX ``_attn_block``: q/k/v projections (slices of the fused QKV
    output), 2D RoPE on q and k, attention, o-projection."""
    N = h.shape[0]
    q, k, v = materialized_linear(layer.qkv, h).reshape(N, 3, H, D).unbind(1)
    q = apply_vision_rope_cs(q, cos2, sin2)
    k = apply_vision_rope_cs(k, cos2, sin2)
    v = v.contiguous()
    if use_pallas:
        out = segment_flash_attention(q, k, v, segment_ids, ranges, scale)
    else:
        out = segment_attention(q, k, v, segment_ids, scale)
    return materialized_linear(layer.o, out.reshape(N, H * D), reduce)


def vision_encoder_core(
    tower: VisionTower,
    pixel_values: torch.Tensor,    # [N, C*ps*ps] uint8 or float
    pos_ids: torch.Tensor,         # [N, 2] int32
    segment_ids: torch.Tensor,     # [N] int32, -1 = pad
    merge_group_ids: torch.Tensor, # [N] int32
    num_out_tokens: int,
    kv_lo: Optional[torch.Tensor] = None,   # [ceil(N/64)] int32
    kv_hi: Optional[torch.Tensor] = None,
    use_pallas: bool = True,
) -> torch.Tensor:
    """Patch rows → merged features [num_out_tokens, hidden].

    With ``kv_lo``/``kv_hi`` (the packed ranges) the serving path runs
    (K1, fused RoPE); without them the head-major branch: K5 where
    ``use_pallas`` (its plain version on the CPU), else the plain
    ``segment_attention``."""
    cfg = tower.cfg
    dtype = tower.dtype
    dev = pixel_values.device
    H, D = cfg.num_attention_heads, cfg.head_dim
    if tower.tp is not None:
        H = len(tower.tp.heads)
    red_attn, red_mlp = _row_reduce(tower, "attn"), _row_reduce(tower, "mlp")
    n = pixel_values.shape[0]
    if pixel_values.dtype == torch.uint8:
        # raw uint8 rows normalize on the device with the host pipeline's
        # op order (rescale, -mean, /std, all f32)
        mean = torch.tensor(cfg.image_mean, dtype=torch.float32,
                            device=dev)[:, None]
        std = torch.tensor(cfg.image_std, dtype=torch.float32,
                           device=dev)[:, None]
        xf = pixel_values.reshape(n, cfg.num_channels, -1).to(torch.float32)
        xf = (xf * torch.tensor(cfg.rescale_factor, dtype=torch.float32,
                                device=dev) - mean) / std
        pixel_values = xf.reshape(n, -1)
    x = materialized_linear(tower.patch_embed, pixel_values.to(dtype))
    cos2, sin2 = vision_rope_cos_sin(vision_rope_angles(pos_ids, D))
    scale = 1.0 / math.sqrt(D)
    eps = cfg.layer_norm_eps
    packed = kv_lo is not None
    if packed:
        cos, sin = cos2[:, 0].contiguous(), sin2[:, 0].contiguous()
    elif use_pallas:
        # K5's per-tile key ranges, once per forward (host metadata)
        ranges = tuple(torch.from_numpy(r).to(dev) for r in
                       vision_kv_ranges(segment_ids.cpu().numpy()))
    else:
        ranges = None
    for layer in tower.layers:
        h = layer.ln1(x, eps)
        if packed:
            w8 = all(is_w8(getattr(layer, n)) for n in ("qkv", "o"))
            qkv = _w8a8(h, layer.qkv) if w8 else \
                materialized_linear(layer.qkv, h)
            out = flash_attention_packed_rope_fusedqkv(
                qkv, cos, sin, segment_ids, kv_lo, kv_hi, H, scale)
            attn = _w8a8(out, layer.o, reduce=red_attn) if w8 else \
                materialized_linear(layer.o, out, red_attn)
        else:
            attn = _attn_head_major(layer, h, cos2, sin2, segment_ids,
                                    ranges, H, D, scale, use_pallas,
                                    red_attn)
        x = x + attn
        x = x + _mlp(layer, layer.ln2(x, eps), red_mlp)
    x = tower.post_ln(x, eps)

    # merge-window mean (exact bilinear downsample for integer factors)
    valid = (merge_group_ids >= 0).to(torch.float32)[:, None]
    gid = merge_group_ids.clamp(min=0).to(torch.int64)
    sums = torch.zeros((num_out_tokens, x.shape[1]), dtype=torch.float32,
                       device=dev).index_add_(0, gid, x.to(torch.float32) * valid)
    counts = torch.zeros((num_out_tokens, 1), dtype=torch.float32,
                         device=dev).index_add_(0, gid, valid)
    return (sums / counts.clamp(min=1.0)).to(dtype)


def vision_encoder_forward(tower: VisionTower, pixel_values,
                           grid_sizes: np.ndarray, merge_sizes: np.ndarray,
                           pad_to: Optional[int] = None) -> torch.Tensor:
    """Metadata on the host, tower on ``pixel_values``' device (the
    tower's device for host arrays). Returns [sum(t*gh*gw/ms^2), hidden]."""
    meta = build_vision_metadata(grid_sizes, merge_sizes, pad_to=pad_to)
    dev = tower.post_ln.scale.device
    pv = torch.as_tensor(pixel_values).to(dev)
    n = meta.pos_ids.shape[0]
    if pv.shape[0] < n:   # pad pixel rows to the bucket
        pv = torch.cat([pv, pv.new_zeros((n - pv.shape[0], pv.shape[1]))])

    def dev_i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    return vision_encoder_core(
        tower, pv, dev_i32(meta.pos_ids), dev_i32(meta.segment_ids),
        dev_i32(meta.merge_group_ids), meta.num_out_tokens,
        dev_i32(meta.kv_lo), dev_i32(meta.kv_hi))
