"""Qwen2 decoder (GQA) — port of ``cogstream_tpu/models/qwen2.py``.

Per-layer ``nn.Module``s (no stacked ``[L]`` leaves, no scan), a
position-tagged KV cache, gated LoRA deltas, and three forward modes:

* cache-free: causal attention over the S new tokens only;
* prefill into the cache: K/V written at ``write_index``, attention over
  the cache (K3);
* cached decode (S <= 8): the step's K/V written in place, attention
  over the cache's first ``kv_window`` slots (K4).

Pooled serving (runtime/pool.py) shares one ``[B_pool, max_len]`` cache
between sessions: ``write_slots`` scatters each input row's K/V and
positions to its own slots (slots >= ``max_len`` are dropped), and
``cache_rows`` maps the input rows onto pool rows, which K3 and K4 read
in place through their ``rows`` operand.

Those three run under ``torch.inference_mode``. Training has its own
grad-enabled cache-free forward, :func:`qwen2_forward_train`: attention
is the plain ``causal_gqa_attention`` (as in the JAX cache-free scan; K3
has no backward in either package), with per-layer recomputation
(``remat``) and LoRA dropout on the adapter input only. On a quantized
base (QLoRA) its projections and the lm_head run through ``QuantLinear``
under autograd (each GEMV kernel carries JAX's transpose rule as its
backward), with the LoRA deltas added after them. It also runs a stage's
layers without the final norm (a GPipe stage, parallel/pipeline.py) and
takes an ``attn_override``: the sequence-parallel ring of
:func:`qwen2_forward_sp` (ops/ring_attention.py).

The cache is updated IN PLACE (the JAX package rebinds a donated
buffer); ``qwen2_forward`` returns the same object.

Tensor parallelism (parallel/sharding.py): a decoder sharded for a mesh
carries its plan in ``model.tp`` and holds only its rank's q / kv heads,
intermediate channels and vocab slice. ``qwen2_forward`` then runs the
local heads (K3 / K4 on the local cache) and all-reduces after o_proj and
after down_proj; ``embed`` looks up the local vocab rows and all-reduces;
``lm_logits`` returns the local vocab slice (runtime/sampling.py combines
the slices). An int4 decoder under a mesh decodes weight-only, as the JAX
package's mesh session does (its Pallas GEMV and hence W4A8 are
single-chip only).

A model quantized by ``ops/quant.py`` (``quantize_text_``, the bridge
from a quantized JAX tree, or a quantized checkpoint load) holds every
projection as a ``QuantLinear`` over per-site stacked storage (int8,
rank-1 int4, or group-wise int4 / NF4). ``dense`` then dispatches like
the JAX ``dense`` (``quantized_matmul``): cached forwards hand the
stacked weight plus a layer index to the indexed kernels (K8/K9 for
int4, K10 for int8) where they route, as the JAX decode scan does; the
cache-free forward uses each layer's 2D slice, as the JAX cache-free scan
does. The W8A8 / W4A8 switch is JAX's, per call on S: ``w8 =
(w8a8_prefill and S >= 16) or (w4a8_decode and S < 16)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..config import Qwen2Config
from ..ops.attention import causal_gqa_attention
from ..ops.lm_attention import (DECODE_MAX_S, FP8_DTYPES, CacheRows,
                                as_cache_rows, decode_attention,
                                effective_kv_positions,
                                prefill_flash_attention)
from ..ops.quant import QuantLinear, RowShard, row_parallel_linear
from ..ops.rope import apply_rope, rope_angles
from ..parallel.mesh import all_reduce, copy_to_model
from .vision_encoder import default_device, linear

# (adapter tree, gate) pairs. An adapter tree is {"layers": [per-layer
# {"attn": {"q_proj": {"a": [din, r], "b": [r, dout]}, ...}, "mlp":
# {...}}], optional "lm_head": {"a", "b"}} (models/bridge.py).
Adapters = Optional[Sequence[Tuple[Dict, float]]]

ATTN_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj")
MLP_PROJ = ("gate_proj", "up_proj", "down_proj")


class Qwen2Layer(nn.Module):
    def __init__(self, cfg: Qwen2Config, device, dtype):
        super().__init__()
        H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
        kv_out = cfg.num_key_value_heads * D
        self.input_norm = nn.Parameter(torch.ones(H, device=device))
        self.post_attn_norm = nn.Parameter(torch.ones(H, device=device))
        # Qwen2: q/k/v carry bias, o does not
        self.attn = nn.ModuleDict(dict(
            q_proj=linear(H, H, device, dtype),
            k_proj=linear(H, kv_out, device, dtype),
            v_proj=linear(H, kv_out, device, dtype),
            o_proj=linear(H, H, device, dtype, bias=False)))
        self.mlp = nn.ModuleDict(dict(
            gate_proj=linear(H, I, device, dtype, bias=False),
            up_proj=linear(H, I, device, dtype, bias=False),
            down_proj=linear(I, H, device, dtype, bias=False)))


class Qwen2Model(nn.Module):
    def __init__(self, cfg: Qwen2Config, device=None, dtype=None):
        super().__init__()
        dtype = dtype or cfg.torch_dtype
        device = default_device(device)
        self.cfg = cfg
        H = cfg.hidden_size
        self.embed_tokens = nn.Parameter(torch.empty(
            cfg.vocab_size, H, device=device, dtype=dtype))
        self.layers = nn.ModuleList(Qwen2Layer(cfg, device, dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(H, device=device))
        self.lm_head = linear(H, cfg.vocab_size, device, dtype, bias=False)
        # the tensor-parallel plan of a sharded decoder
        # (parallel/sharding.TextShard), None for the whole model
        self.tp = None

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.dtype

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclass
class KVCache:
    k: torch.Tensor       # [L, B, max_len, Hkv, D]
    v: torch.Tensor       # [L, B, max_len, Hkv, D]
    pos: torch.Tensor     # [B, max_len] int32; -1 = empty/invalidated
    write_index: int      # next free slot (host int: every fill is known)

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_kv_cache(cfg: Qwen2Config, batch: int, max_len: int, dtype=None,
                  device=None, kv_heads: Optional[int] = None) -> KVCache:
    """An empty cache; ``dtype`` defaults to the model's. Another float
    dtype (``torch.float8_e4m3fn`` / ``float8_e5m2``: the fp8 KV caches;
    f16, or f32 / bf16 under the other model dtype) takes writes cast
    into it (:func:`to_cache`), and K3 / K4 read its own elements.
    ``kv_heads`` is a sharded decoder's local kv head count
    (:func:`local_kv_heads`), the config's by default."""
    dtype = dtype or cfg.torch_dtype
    device = default_device(device)
    shape = (cfg.num_hidden_layers, batch, max_len,
             kv_heads or cfg.num_key_value_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, max_len), -1, dtype=torch.int32,
                       device=device),
        write_index=0)


# the largest finite value of each cache dtype whose cast overflows
CACHE_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0,
             torch.float16: 65504.0}


def saturate(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` ready to be cast into a cache of ``dtype``: clamped to the
    dtype's largest finite value (:data:`CACHE_MAX`: +-448 for e4m3,
    +-57344 for e5m2, +-65504 for f16), so that a cast of it saturates
    there, itself otherwise. Past those JAX's ``astype`` gives NaN (e4m3)
    or +-inf (e5m2 from 61440, f16 from 65520), and torch's e4m3 cast
    past 464 differs between versions (NaN in 2.11, +-448 in 2.13), so
    the port clamps first and writes the largest value on every version
    (ROADMAP Queue 3, deliberate departures: one NaN or inf slot would
    turn every later attention over it into NaN). Below that the bytes
    are the plain cast's, which JAX's equal. The bound is the largest
    value of ``x``'s dtype not above it (a bf16 ``x`` into f16 clamps at
    65280: bf16 has no 65504, and its 65536 casts to inf)."""
    top = CACHE_MAX.get(dtype)
    if top is None or x.dtype == dtype:
        return x
    lim = torch.tensor(top, dtype=x.dtype)
    if lim.item() > top:
        lim = torch.nextafter(lim, lim.new_zeros(()))
    return x.clamp(-lim.item(), lim.item())


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast into a cache of ``dtype`` (:func:`saturate`, then the
    cast)."""
    return saturate(x, dtype).to(dtype)


def kv_bytes(t: torch.Tensor) -> torch.Tensor:
    """An fp8 (e4m3 or e5m2) cache tensor as a ``uint8`` view of the same
    storage, any other as itself: index copies of an fp8 cache move its
    bytes (not every torch op has a Float8 kernel on CUDA, and gloo
    refuses fp8 tensors), never a widened copy."""
    return t.view(torch.uint8) if t.dtype in FP8_DTYPES else t


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def local_kv_heads(model: Qwen2Model) -> int:
    """The kv heads a decoder's cache holds on this rank."""
    tp = getattr(model, "tp", None)
    return model.cfg.num_key_value_heads if tp is None else len(tp.kv_heads)


def embed(model: Qwen2Model, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings. A vocab-sharded decoder looks up the ids its rows
    hold (zeros elsewhere) and all-reduces: one rank contributes each
    row, so the sum is exact."""
    ids = input_ids.to(torch.int64)
    tp = getattr(model, "tp", None)
    if tp is None or tp.vocab is None:
        return model.embed_tokens[ids]
    lo, hi = tp.vocab
    mine = (ids >= lo) & (ids < hi)
    rows = model.embed_tokens[torch.where(mine, ids - lo, 0)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return all_reduce(rows, tp.group)


def row_shards(model: Qwen2Model) -> Dict[str, Optional[RowShard]]:
    """The :class:`ops.quant.RowShard` of each row-parallel projection of
    a sharded decoder (o_proj over the q heads' channels, down_proj over
    the intermediate ones), None where the site is whole: where this
    rank's input rows lie in the whole input, which the int4 W4A8 forms
    need (each packed half's int8 scale is its global half's)."""
    tp = getattr(model, "tp", None)
    out = {"o_proj": None, "down_proj": None}
    if tp is None:
        return out
    D = model.cfg.head_dim
    if tp.attn_split:
        out["o_proj"] = RowShard(model.cfg.num_attention_heads * D,
                                 tp.q_heads[0] * D,
                                 (tp.q_heads[-1] + 1) * D, tp.group)
    if tp.mlp is not None:
        out["down_proj"] = RowShard(model.cfg.intermediate_size, *tp.mlp,
                                    tp.group)
    return out


def dense(x: torch.Tensor, lin: nn.Module, lora=None,
          lora_scale: float = 1.0, w8a8: bool = False,
          indexed: bool = False, reduce=None, col=None,
          rows: Optional[RowShard] = None) -> torch.Tensor:
    """Linear layer (``nn.Linear``, or ``QuantLinear`` with ``w8a8`` and
    ``indexed`` passed on) plus gated LoRA deltas ``(x @ a) @ b * gate *
    scale`` for each (adapter, gate) in ``lora``, on top of the base.
    ``reduce`` (a process group) makes it row-parallel: ``x`` and the
    weight hold this rank's input channels (``rows``: where they lie in
    the whole input), and the output is all-reduced
    (``ops/quant.row_parallel_linear``); each adapter's ``a`` then holds
    the same rows (:func:`_add_lora`). ``col`` (a process group) marks a
    column-parallel site: the adapters' ``b`` hold this rank's columns and
    ``a`` is replicated."""
    if reduce is not None:
        return _add_lora(row_parallel_linear(lin, x, reduce, w8a8, indexed,
                                             rows),
                         x, lora, lora_scale, row=reduce)
    y = lin(x, w8a8, indexed) if isinstance(lin, QuantLinear) else lin(x)
    return _add_lora(y, x, lora, lora_scale, col=col)


def _add_lora(y: torch.Tensor, x: torch.Tensor, lora, lora_scale: float,
              col=None, row=None) -> torch.Tensor:
    """``y`` plus each gated delta ``(x @ a) @ b * gate * scale``.

    On a column-parallel site (``col``, the model group) ``b`` holds this
    rank's columns and ``a`` is whole: ``a`` enters through
    :func:`copy_to_model`, whose backward sums the ranks' partial ``a``
    gradients. On a row-parallel site (``row``) ``x`` and ``a`` hold this
    rank's rows: ``x @ a`` is all-reduced (r columns wide) before the
    whole ``b``, so ``b``'s gradient is whole and ``a``'s is its rows'."""
    for adapter, gate in lora or ():
        a = copy_to_model(adapter["a"], col).to(x.dtype)
        u = all_reduce(x @ a, row)
        y = y + (u @ adapter["b"].to(x.dtype)) * float(gate * lora_scale)
    return y


def _lora_at(adapters: Adapters, layer: int, group: str, name: str):
    """Per-layer adapter entries for one projection → dense()'s lora."""
    out = []
    for tree, gate in adapters or ():
        layers = tree.get("layers") if isinstance(tree, dict) else None
        node = layers[layer].get(group, {}).get(name) if layers else None
        if node is not None:
            out.append((node, gate))
    return out


class _SlotWriter:
    """Pooled cache writes of one forward (``write_slots``), built once
    and applied to each layer's [B_pool, max_len, Hkv, D] cache.

    * host slots (a numpy array [B, S], every prefill): the dropped
      (row, slot) pairs (slot >= max_len) are filtered out on the host,
      so the scatter gets unique in-range indices and no device sync;
    * device slots (a tensor [B, 1], a decode step): a dropped row
      writes its slot's own old value back (its slot clamped into the
      cache), which leaves it unchanged; rows are unique, so the
      scatter has no duplicate index.
    """

    def __init__(self, write_slots, positions: torch.Tensor,
                 rows: Optional[CacheRows], pos: torch.Tensor,
                 read: int):
        B, S = positions.shape
        T = pos.shape[1]
        dev = pos.device
        self.device_slots = isinstance(write_slots, torch.Tensor)
        if self.device_slots:
            if tuple(write_slots.shape) != (B, 1):
                raise ValueError("device write_slots must be [B, 1] (one "
                                 "decode step)")
            slot = write_slots[:, 0].to(device=dev, dtype=torch.int64)
            self.ok = (slot < T)[:, None, None]
            self.r = (torch.arange(B, device=dev) if rows is None
                      else rows.dev.to(torch.int64))
            self.t = slot.clamp(max=T - 1)
            old = pos[self.r, self.t]
            pos[self.r, self.t] = torch.where(self.ok[:, 0, 0],
                                              positions[:, 0], old)
            return
        ws = np.asarray(write_slots, np.int64)
        if ws.shape != (B, S):
            raise ValueError(f"write_slots {ws.shape} != positions "
                             f"{(B, S)}")
        b_idx, s_idx = np.nonzero(ws < T)
        row_of = np.arange(B) if rows is None else np.asarray(rows.host)
        r_idx, t_idx = row_of[b_idx], ws[b_idx, s_idx]
        if len(np.unique(r_idx * T + t_idx)) != len(t_idx):
            raise ValueError("write_slots repeat a (row, slot) pair")
        if t_idx.size and t_idx.max() >= read:
            raise RuntimeError(f"cache write at slot {int(t_idx.max())} "
                               f"beyond the read window {read}")
        self.b, self.s, self.r, self.t = (
            torch.from_numpy(a).to(dev) for a in (b_idx, s_idx, r_idx, t_idx))
        pos[self.r, self.t] = positions[self.b, self.s]

    def __call__(self, layer_cache: torch.Tensor, new: torch.Tensor) -> None:
        # the cast into the cache's dtype first (an fp8 cache rounds here),
        # then the index ops on its bytes (kv_bytes)
        dst = kv_bytes(layer_cache)
        if self.device_slots:
            old = dst[self.r, self.t]
            dst[self.r, self.t] = torch.where(
                self.ok, kv_bytes(to_cache(new[:, 0], layer_cache.dtype)),
                old)
        else:
            dst[self.r, self.t] = kv_bytes(to_cache(new[self.b, self.s],
                                                    layer_cache.dtype))


@torch.inference_mode()
def qwen2_forward(
    model: Qwen2Model,
    inputs_embeds: torch.Tensor,   # [B, S, H]
    positions: torch.Tensor,       # [B, S] int32; -1 marks padding
    cache: Optional[KVCache] = None,
    adapters: Adapters = None,
    lora_scale: float = 2.0,
    kv_allowed: Optional[torch.Tensor] = None,  # [B, max_len] bool
    kv_window: Optional[int] = None,            # read bound (cached modes)
    write_slots=None,      # [B, S] per-row cache slots (pooled mode)
    cache_rows=None,       # [B] pool row per input row (pooled mode)
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack. Returns (hidden [B, S, H], cache).

    Without a cache: causal self-attention over the S new tokens (K3).
    With a cache: the new tokens' K/V and positions are written at
    ``cache.write_index`` and attention spans the cache's first
    ``kv_window`` slots (all of it by default), masked by stored
    positions AND ``kv_allowed``: K3 for S > 8, K4 for decode steps.

    Pooled mode: ``write_slots`` (a host numpy array [B, S], or a device
    tensor [B, 1] for a decode step; slots >= max_len are dropped)
    replaces the shared write index, so each row sits at its own fill
    level. ``cache_rows`` (a sequence or :class:`CacheRows`, with
    ``write_slots``) maps the B input rows onto rows of a larger pool
    cache; only the [B, window] positions are gathered, to build ``eff``,
    and K3 / K4 read the K/V rows in place. ``kv_allowed`` stays per
    input row. ``write_index`` stays as it was: a pooled session keeps
    its own fill level.
    """
    cfg = model.cfg
    B, S, _ = inputs_embeds.shape
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    tp = model.tp
    red_attn = red_mlp = None
    if tp is not None:
        Hq, Hkv = len(tp.q_heads), len(tp.kv_heads)
        red_attn = tp.group if tp.attn_split else None
        red_mlp = tp.group if tp.mlp is not None else None
    # the JAX rule (qwen2.py w8): prefill-length programs (S >= 16) run the
    # quantized projections with int8 activations under w8a8_prefill,
    # decode-length ones (S < 16) under w4a8_decode; bf16 weights ignore it
    w8 = (cfg.w8a8_prefill and S >= 16) or (cfg.w4a8_decode and S < 16)
    shards = row_shards(model)
    indexed = cache is not None
    positions = positions.to(torch.int32)
    angles = rope_angles(positions.clamp(min=0), D, cfg.rope_theta)
    if cache_rows is not None and write_slots is None:
        raise ValueError("cache_rows requires write_slots")
    rows = writer = None
    if cache is None:
        eff = effective_kv_positions(positions)
        attend = prefill_flash_attention
    elif write_slots is not None:
        read = cache.max_len if kv_window is None else kv_window
        rows = as_cache_rows(cache_rows, cache.pos.device)
        writer = _SlotWriter(write_slots, positions, rows, cache.pos, read)
        pos = (cache.pos[:, :read] if rows is None
               else cache.pos[rows.dev.to(torch.int64), :read])
        eff = effective_kv_positions(
            pos, None if kv_allowed is None else kv_allowed[:, :read]
        ).contiguous()
        attend = decode_attention if S <= DECODE_MAX_S \
            else prefill_flash_attention
    else:
        wi = cache.write_index
        read = cache.max_len if kv_window is None else kv_window
        if wi + S > read:
            raise RuntimeError(f"cache write {wi}+{S} beyond the read "
                               f"window {read}")
        cache.pos[:, wi:wi + S] = positions
        eff = effective_kv_positions(
            cache.pos[:, :read],
            None if kv_allowed is None else kv_allowed[:, :read]
        ).contiguous()
        attend = decode_attention if S <= DECODE_MAX_S \
            else prefill_flash_attention

    x = inputs_embeds
    for li, layer in enumerate(model.layers):
        ap, mp = layer.attn, layer.mlp

        def proj(group, name, inp, reduce=None):
            return dense(inp, (ap if group == "attn" else mp)[name],
                         _lora_at(adapters, li, group, name), lora_scale,
                         w8a8=w8, indexed=indexed, reduce=reduce,
                         rows=shards.get(name))

        h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
        q = apply_rope(proj("attn", "q_proj", h).reshape(B, S, Hq, D), angles)
        k = apply_rope(proj("attn", "k_proj", h).reshape(B, S, Hkv, D), angles)
        v = proj("attn", "v_proj", h).reshape(B, S, Hkv, D)
        if cache is None:
            attn = attend(q, k, v.contiguous(), positions, eff)
        elif writer is not None:
            writer(cache.k[li], k)
            writer(cache.v[li], v)
            attn = attend(q, cache.k[li], cache.v[li], positions, eff,
                          rows=rows)
        else:
            # the slice's copy casts (one kernel after the clamp)
            cache.k[li, :, wi:wi + S] = saturate(k, cache.k.dtype)
            cache.v[li, :, wi:wi + S] = saturate(v, cache.v.dtype)
            attn = attend(q, cache.k[li], cache.v[li], positions, eff)
        x = x + proj("attn", "o_proj", attn.reshape(B, S, Hq * D),
                     red_attn)
        h = rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
        gate = proj("mlp", "gate_proj", h)
        up = proj("mlp", "up_proj", h)
        x = x + proj("mlp", "down_proj", F.silu(gate) * up, red_mlp)
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    if cache is not None and writer is None:
        cache.write_index = wi + S
    return x, cache


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def fold_seed(seed: int, *ids: int) -> int:
    """A seed derived from ``seed`` and ``ids`` (``jax.random.fold_in``'s
    role): the same ids give the same seed, different ids unrelated ones."""
    words = np.random.SeedSequence([int(seed), *map(int, ids)]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def site_generator(seed: int, *ids: int, device=None) -> torch.Generator:
    """A generator for one dropout site, seeded from the step's seed and
    the site's ids (layer, projection): the same ids give the same mask,
    so a recomputed layer (``remat``) redraws exactly its forward's."""
    g = torch.Generator(device=device)
    g.manual_seed(fold_seed(seed, *ids))
    return g


def adapter_in(x: torch.Tensor, rate: float,
               generator: Optional[torch.Generator],
               cols: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Adapter-branch input with inverted dropout (PEFT lora_dropout: the
    frozen dense path never drops). Identity without a generator or at
    rate 0. ``cols = (width, lo, hi)``: ``x`` holds channels [lo, hi) of
    a ``width``-wide input (a row-parallel shard), and its mask is that
    slice of the whole input's."""
    if generator is None or rate <= 0.0:
        return x
    shape = x.shape if cols is None else (*x.shape[:-1], cols[0])
    keep = torch.rand(shape, generator=generator, device=x.device) \
        < (1.0 - rate)
    if cols is not None:
        keep = keep[..., cols[1]:cols[2]]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x)).to(
        x.dtype)


# dropout site ids, in the JAX scan's order (q, k, v, o, gate, up, down)
_SITES = tuple(("attn", n) for n in ATTN_PROJ) + tuple(
    ("mlp", n) for n in MLP_PROJ)


def qwen2_forward_train(
    model: Qwen2Model,
    inputs_embeds: torch.Tensor,   # [B, S, H]
    positions: torch.Tensor,       # [B, S] int32; -1 marks padding
    adapters: Adapters = None,
    lora_scale: float = 2.0,
    remat: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    cfg: Optional[Qwen2Config] = None,
    attn_override=None,
    apply_final_norm: bool = True,
) -> torch.Tensor:
    """Grad-enabled cache-free decoder forward; returns hidden [B, S, H].

    Causal attention by absolute positions over the S tokens (padding -1
    sees and is seen by nothing), through the plain
    ``causal_gqa_attention``. ``remat`` recomputes each layer in the
    backward pass (``torch.utils.checkpoint``; the JAX scan's
    ``jax.checkpoint``). With ``dropout_seed`` the adapters' inputs drop
    at ``dropout_rate``, one generator per (layer, projection) derived
    from the seed (:func:`site_generator`); without it the forward is
    deterministic.

    ``cfg`` is the config the caller trains under (default
    ``model.cfg``): its flags pick the quantized base's activation mode by
    JAX's rule, ``w8 = (w8a8_prefill and S >= 16) or (w4a8_decode and S <
    16)`` (stage-2 ``--w8a8-forward`` sets ``w8a8_prefill``: int8 weights
    then run W8A8 with a straight-through gradient).

    A decoder sharded for a mesh (``model.tp``) runs its local heads and
    channels under autograd: the normed input of each column-parallel
    block (q / k / v, gate / up) enters through ``copy_to_model``, o_proj
    and down_proj all-reduce their partial sums (forward; identity
    backward), and the adapters follow their sites (:func:`_add_lora`).
    Every rank of a model group draws the same dropout masks: a
    row-parallel input's is its slice of the whole input's. ``remat``
    replays a layer's collectives in the backward, the same ones in the
    same order on every rank. Int8 activations run on the shards as on
    one device: a row-parallel W8A8 site takes the whole row's absmax and
    reduces its int32 sums before the epilogue
    (``ops/quant._W8A8STE``), an int4 W4A8 form reads the site's
    :class:`RowShard` (:func:`row_shards`), so each product is the whole
    one's.

    ``attn_override`` replaces the attention: a cache-free ``f(q, k, v,
    positions)`` (the sequence-parallel ring, :func:`qwen2_forward_sp`).
    ``apply_final_norm=False`` leaves the final norm out: a pipeline stage
    (parallel/pipeline.py, ``model`` its view) runs its blocks, the norm
    runs once after the last stage."""
    cfg = cfg or model.cfg
    B, S, _ = inputs_embeds.shape
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    tp = getattr(model, "tp", None)
    groups = {"attn": None, "mlp": None}
    cols = {"o_proj": None, "down_proj": None}
    if tp is not None:
        Hq, Hkv = len(tp.q_heads), len(tp.kv_heads)
        if tp.attn_split:
            groups["attn"] = tp.group
            cols["o_proj"] = (cfg.num_attention_heads * D,
                              tp.q_heads[0] * D, (tp.q_heads[-1] + 1) * D)
        if tp.mlp is not None:
            groups["mlp"] = tp.group
            cols["down_proj"] = (cfg.intermediate_size, *tp.mlp)
    w8 = (cfg.w8a8_prefill and S >= 16) or (cfg.w4a8_decode and S < 16)
    shards = row_shards(model)
    positions = positions.to(torch.int32)
    angles = rope_angles(positions.clamp(min=0), D, cfg.rope_theta)
    kv_valid = positions >= 0
    drop = dropout_seed is not None and dropout_rate > 0.0

    def layer_fn(li: int, x: torch.Tensor) -> torch.Tensor:
        layer = model.layers[li]
        mods = {"attn": layer.attn, "mlp": layer.mlp}

        def proj(site: int, inp: torch.Tensor) -> torch.Tensor:
            group, name = _SITES[site]
            gen = (site_generator(dropout_seed, li, site, device=inp.device)
                   if drop else None)
            lin = mods[group][name]
            g = groups[group]
            row = g if name in cols else None
            if row is not None:
                y = row_parallel_linear(lin, inp, row, w8,
                                        rows=shards[name])
            else:
                y = lin(inp, w8) if isinstance(lin, QuantLinear) \
                    else lin(inp)
            xa = adapter_in(inp, dropout_rate, gen,
                            cols[name] if row is not None else None)
            return _add_lora(y, xa, _lora_at(adapters, li, group, name),
                             lora_scale, col=None if row is not None else g,
                             row=row)

        h = copy_to_model(rms_norm(x, layer.input_norm, cfg.rms_norm_eps),
                          groups["attn"])
        q = apply_rope(proj(0, h).reshape(B, S, Hq, D), angles)
        k = apply_rope(proj(1, h).reshape(B, S, Hkv, D), angles)
        v = proj(2, h).reshape(B, S, Hkv, D)
        if attn_override is not None:
            attn = attn_override(q, k, v, positions)
        else:
            attn = causal_gqa_attention(q, k, v, q_positions=positions,
                                        kv_valid=kv_valid,
                                        kv_positions=positions)
        x = x + proj(3, attn.reshape(B, S, Hq * D))
        h = copy_to_model(rms_norm(x, layer.post_attn_norm,
                                   cfg.rms_norm_eps), groups["mlp"])
        return x + proj(6, F.silu(proj(4, h)) * proj(5, h))

    x = inputs_embeds
    for li in range(len(model.layers)):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                layer_fn, li, x, use_reentrant=False)
        else:
            x = layer_fn(li, x)
    if not apply_final_norm:
        return x
    return rms_norm(x, model.final_norm, cfg.rms_norm_eps)


def sequence_shard(x: torch.Tensor, n: int, index: int) -> torch.Tensor:
    """Rank ``index``'s contiguous shard of ``x``'s sequence dim (dim 1)
    split ``n`` ways (JAX's ``P(None, axis)``); S must divide by ``n``."""
    S = x.shape[1]
    if S % n:
        raise ValueError(f"S={S} must divide the sp={n} axis")
    w = S // n
    return x[:, index * w:(index + 1) * w]


def qwen2_forward_sp(
    model: Qwen2Model,
    inputs_embeds: torch.Tensor,   # [B, S, H], whole on every rank
    positions: torch.Tensor,       # [B, S]; -1 = padding
    mesh,                          # parallel/mesh.SequenceMesh
    adapters: Adapters = None,
    lora_scale: float = 2.0,
    remat: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    cfg: Optional[Qwen2Config] = None,
) -> torch.Tensor:
    """Sequence-parallel decoder forward (cache-free), the counterpart of
    JAX's ``qwen2_forward_sp``: this rank's shard of the sequence, [B,
    S/P, H], goes through the layers, whose attention is the ring over the
    mesh's ``sp`` group (ops/ring_attention.py; MLP and norms are
    token-local, so only K/V travel, P - 1 hops a layer). Weights and
    adapters are replicated along the axis. Returns this rank's shard of
    the hidden states, [B, S/P, H] (JAX's out_spec ``P(None, axis)``;
    the whole [B, S, H] is the shards in rank order).

    Dropout folds in the ring position (:func:`fold_seed`): each shard's
    adapter inputs draw their own masks, as a data-parallel step folds
    the data index (``train/trainer.make_train_step``)."""
    from ..ops.ring_attention import ring_causal_gqa_attention

    n, r = mesh.size, mesh.sp_index
    emb = sequence_shard(inputs_embeds, n, r)
    pos = sequence_shard(positions.to(torch.int32), n, r)

    def ring(q, k, v, q_positions):
        return ring_causal_gqa_attention(q, k, v, q_positions, q_positions,
                                         mesh.sp_group)

    seed = None
    if dropout_seed is not None and dropout_rate > 0.0:
        seed = fold_seed(dropout_seed, r)
    return qwen2_forward_train(model, emb, pos, adapters, lora_scale,
                               remat=remat, dropout_rate=dropout_rate,
                               dropout_seed=seed, cfg=cfg,
                               attn_override=ring)


def lm_logits(model: Qwen2Model, hidden: torch.Tensor, adapters: Adapters = None,
              lora_scale: float = 2.0, w8a8: bool = False,
              head=None, head_lora: Optional[List] = None) -> torch.Tensor:
    """Logits through ``model.lm_head`` — or through a sliced head
    ``head`` with its sliced LoRA entries (the static ``logit_ids`` head
    of runtime/generate.py): a callable ``h -> h @ W_sliced``. ``w8a8``
    mirrors dense(): decode loops pass ``cfg.w4a8_decode`` so an int4
    head's per-step vocab read rides the W4A8 GEMV (K7) and an int8 head
    the W8A8 product, as in JAX. A vocab-sharded decoder returns its
    vocab slice (``model.tp.vocab``); under autograd ``hidden`` enters the
    column-parallel head through ``copy_to_model``."""
    if head is None:
        head_lora = [(t["lm_head"], g) for t, g in adapters or ()
                     if isinstance(t, dict) and t.get("lm_head") is not None]
        tp = getattr(model, "tp", None)
        col = None if tp is None else tp.vocab_group
        return dense(copy_to_model(hidden, col), model.lm_head, head_lora,
                     lora_scale, w8a8=w8a8, col=col)
    return _add_lora(head(hidden), hidden, head_lora, lora_scale)
