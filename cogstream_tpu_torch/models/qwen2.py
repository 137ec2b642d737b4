"""Qwen2 decoder (GQA) — port of ``cogstream_tpu/models/qwen2.py``.

Per-layer ``nn.Module``s (no stacked ``[L]`` leaves, no scan), a
position-tagged KV cache, gated LoRA deltas, and three forward modes:

* cache-free: causal attention over the S new tokens only;
* prefill into the cache: K/V written at ``write_index``, attention over
  the cache (K3);
* cached decode (S <= 8): the step's K/V written in place, attention
  over the cache's first ``kv_window`` slots (K4).

The cache is updated IN PLACE (the JAX package rebinds a donated
buffer); ``qwen2_forward`` returns the same object.

A model quantized by ``ops/quant.py`` (``quantize_text_``, or the bridge
from a quantized JAX tree) holds every projection as an ``Int4Linear``
over per-site stacked int4 storage. ``dense`` then dispatches like the
JAX ``dense`` (``quantized_matmul``): cached forwards hand the stacked
weight plus a layer index to the indexed kernels (K8/K9) where they
route, as the JAX decode scan does; the cache-free forward uses each
layer's 2D slice (K6/K7), as the JAX cache-free scan does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Qwen2Config
from ..ops.lm_attention import (DECODE_MAX_S, decode_attention,
                                effective_kv_positions,
                                prefill_flash_attention)
from ..ops.quant import Int4Linear, QUEUE_MSG
from ..ops.rope import apply_rope, rope_angles
from .vision_encoder import linear

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
        self.cfg = cfg
        H = cfg.hidden_size
        self.embed_tokens = nn.Parameter(torch.empty(
            cfg.vocab_size, H, device=device, dtype=dtype))
        self.layers = nn.ModuleList(Qwen2Layer(cfg, device, dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(H, device=device))
        self.lm_head = linear(H, cfg.vocab_size, device, dtype, bias=False)

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
                  device=None) -> KVCache:
    dtype = dtype or cfg.torch_dtype
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
             cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, max_len), -1, dtype=torch.int32,
                       device=device),
        write_index=0)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def embed(model: Qwen2Model, input_ids: torch.Tensor) -> torch.Tensor:
    return model.embed_tokens[input_ids.to(torch.int64)]


def dense(x: torch.Tensor, lin: nn.Module, lora=None,
          lora_scale: float = 1.0, w8a8: bool = False,
          indexed: bool = False) -> torch.Tensor:
    """Linear layer (``nn.Linear``, or ``Int4Linear`` with ``w8a8`` and
    ``indexed`` passed on) plus gated LoRA deltas ``(x @ a) @ b * gate *
    scale`` for each (adapter, gate) in ``lora``, on top of the base."""
    y = lin(x, w8a8, indexed) if isinstance(lin, Int4Linear) else lin(x)
    return _add_lora(y, x, lora, lora_scale)


def _add_lora(y: torch.Tensor, x: torch.Tensor, lora,
              lora_scale: float) -> torch.Tensor:
    for adapter, gate in lora or ():
        delta = (x @ adapter["a"].to(x.dtype)) @ adapter["b"].to(x.dtype)
        y = y + delta * float(gate * lora_scale)
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
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack. Returns (hidden [B, S, H], cache).

    Without a cache: causal self-attention over the S new tokens (K3).
    With a cache: the new tokens' K/V and positions are written at
    ``cache.write_index`` and attention spans the cache's first
    ``kv_window`` slots (all of it by default), masked by stored
    positions AND ``kv_allowed``: K3 for S > 8, K4 for decode steps.
    """
    cfg = model.cfg
    B, S, _ = inputs_embeds.shape
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if cfg.w8a8_prefill:
        raise NotImplementedError(f"w8a8_prefill is {QUEUE_MSG}")
    # the JAX rule (qwen2.py w8): decode-length programs (S < 16) run the
    # int4 projections with int8 activations under w4a8_decode; it has no
    # effect on bf16 weights
    w8 = cfg.w4a8_decode and S < 16
    indexed = cache is not None
    positions = positions.to(torch.int32)
    angles = rope_angles(positions.clamp(min=0), D, cfg.rope_theta)
    if cache is None:
        eff = effective_kv_positions(positions)
        attend = prefill_flash_attention
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

        def proj(group, name, inp):
            return dense(inp, (ap if group == "attn" else mp)[name],
                         _lora_at(adapters, li, group, name), lora_scale,
                         w8a8=w8, indexed=indexed)

        h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
        q = apply_rope(proj("attn", "q_proj", h).reshape(B, S, Hq, D), angles)
        k = apply_rope(proj("attn", "k_proj", h).reshape(B, S, Hkv, D), angles)
        v = proj("attn", "v_proj", h).reshape(B, S, Hkv, D)
        if cache is None:
            attn = attend(q, k, v.contiguous(), positions, eff)
        else:
            cache.k[li, :, wi:wi + S] = k
            cache.v[li, :, wi:wi + S] = v
            attn = attend(q, cache.k[li], cache.v[li], positions, eff)
        x = x + proj("attn", "o_proj", attn.reshape(B, S, Hq * D))
        h = rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
        gate = proj("mlp", "gate_proj", h)
        up = proj("mlp", "up_proj", h)
        x = x + proj("mlp", "down_proj", F.silu(gate) * up)
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    if cache is not None:
        cache.write_index = wi + S
    return x, cache


def lm_logits(model: Qwen2Model, hidden: torch.Tensor, adapters: Adapters = None,
              lora_scale: float = 2.0, w8a8: bool = False,
              head=None, head_lora: Optional[List] = None) -> torch.Tensor:
    """Logits through ``model.lm_head`` — or through a sliced head
    ``head`` with its sliced LoRA entries (the static ``logit_ids`` head
    of runtime/generate.py): a callable ``h -> h @ W_sliced``. ``w8a8``
    mirrors dense(): decode loops pass ``cfg.w4a8_decode`` so an int4
    head's per-step vocab read rides the W4A8 GEMV (K7)."""
    if head is None:
        head_lora = [(t["lm_head"], g) for t, g in adapters or ()
                     if isinstance(t, dict) and t.get("lm_head") is not None]
        return dense(hidden, model.lm_head, head_lora, lora_scale,
                     w8a8=w8a8)
    return _add_lora(head(hidden), hidden, head_lora, lora_scale)
