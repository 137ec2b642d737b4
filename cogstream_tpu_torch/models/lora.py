"""LoRA adapter trees (port of ``cogstream_tpu/models/lora.py``).

The reference trains two PEFT LoRA adapters (r=8, alpha=16, dropout 0.1
on q/k/v/o/gate/up/down — first_stage_training.py:448-465; stage 2 also
adapts ``mm_projector.readout`` — second_stage_training.py:252-255).

An adapter here is a tree of f32 leaf tensors that mirrors the port's
per-layer modules (``models/qwen2.py``'s ``Adapters``): every adapted
projection ``[din -> dout]`` gets ``{"a": [din, r], "b": [r, dout]}``,
one entry per layer in ``{"layers": [...]}`` (the JAX package stacks
them ``[L, din, r]`` for its layer scan; ``models/bridge.py`` converts
both ways). The trainable leaves carry ``requires_grad``; the frozen
base never does.

On a mesh (``mesh=``) every rank draws the WHOLE tree from the seed and
keeps its slice (``parallel/sharding.LoraLayout``), so the initial
adapters equal the one-process ones whatever the layout.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..config import CogReasonerConfig, LoRAConfig, Qwen2Config
from .vision_encoder import default_device


def _gaussian(generator: torch.Generator, din: int, r: int, dtype,
              device) -> torch.Tensor:
    a = torch.randn((din, r), generator=generator, device=generator.device)
    return (a / math.sqrt(din)).to(device=device, dtype=dtype)


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_(True)


def qwen2_lora_dims(cfg: Qwen2Config) -> Dict[str, Tuple[int, int]]:
    """(din, dout) of every adaptable decoder projection, by
    ``group.name``."""
    H, D = cfg.hidden_size, cfg.head_dim
    kv_out = cfg.num_key_value_heads * D
    I = cfg.intermediate_size
    return {
        "attn.q_proj": (H, H),
        "attn.k_proj": (H, kv_out),
        "attn.v_proj": (H, kv_out),
        "attn.o_proj": (H, H),
        "mlp.gate_proj": (H, I),
        "mlp.up_proj": (H, I),
        "mlp.down_proj": (I, H),
    }


def init_qwen2_lora(generator: torch.Generator, cfg: Qwen2Config,
                    lora: LoRAConfig, dtype=torch.float32,
                    device=None, mesh=None) -> Dict:
    """LoRA tree for the decoder: ``a`` gaussian / sqrt(din), ``b`` zeros
    (the delta starts at zero). Draws come from ``generator`` (on its own
    device), the tree lives on ``device`` (the card unless named). With
    ``mesh``: this rank's slice of the whole tree under the decoder's
    plan."""
    if mesh is not None:
        from ..parallel.sharding import LoraLayout, qwen2_param_specs

        whole = init_qwen2_lora(generator, cfg, lora, dtype, device)
        return LoraLayout(whole, qwen2_param_specs(cfg, mesh),
                          mesh).shard(whole)
    device = default_device(device)
    wanted = set(lora.target_modules)
    layers: List[Dict] = []
    for _ in range(cfg.num_hidden_layers):
        layer: Dict = {"attn": {}, "mlp": {}}
        for path, (din, dout) in sorted(qwen2_lora_dims(cfg).items()):
            group, name = path.split(".")
            if name not in wanted:
                continue
            layer[group][name] = {
                "a": _leaf(_gaussian(generator, din, lora.rank, dtype,
                                     device)),
                "b": _leaf(torch.zeros((lora.rank, dout), dtype=dtype,
                                       device=device)),
            }
        layers.append(layer)
    return {"layers": layers}


def projector_lora_dims(cfg: CogReasonerConfig) -> List[Tuple[int, int]]:
    """(din, dout) of the two readout linears of ``mlp2x_gelu``."""
    return [(cfg.vision.hidden_size, cfg.text.hidden_size),
            (cfg.text.hidden_size, cfg.text.hidden_size)]


def lora_site_dims(site: str, cfg: CogReasonerConfig) -> Tuple[int, int]:
    """(din, dout) of the weight a LoRA site adapts, by its path: a
    decoder tree's ``layers.<i>.<group>.<name>`` or ``lm_head`` (under
    ``text.`` in a stage-2 tree), or ``projector.layers.<i>``."""
    parts = site.removeprefix("text.").split(".")
    if parts[0] == "projector":
        return projector_lora_dims(cfg)[int(parts[2])]
    if parts[0] == "lm_head":
        return cfg.text.hidden_size, cfg.text.vocab_size
    return qwen2_lora_dims(cfg.text)[".".join(parts[2:])]


def init_projector_lora(generator: torch.Generator, cfg: CogReasonerConfig,
                        lora: LoRAConfig, dtype=torch.float32,
                        device=None) -> Dict:
    """LoRA on the two readout linears of ``mlp2x_gelu``."""
    device = default_device(device)
    return {"layers": [
        {"a": _leaf(_gaussian(generator, din, lora.rank, dtype, device)),
         "b": _leaf(torch.zeros((lora.rank, dout), dtype=dtype,
                                device=device))}
        for din, dout in projector_lora_dims(cfg)]}


def init_cogreasoner_lora(generator: torch.Generator, cfg: CogReasonerConfig,
                          lora: LoRAConfig, dtype=torch.float32,
                          device=None, mesh=None) -> Dict:
    """The stage-2 tree: the decoder's, plus the projector's with
    ``lora.include_projector``. With ``mesh``: this rank's slice of the
    whole tree under the CogReasoner's plan."""
    if mesh is not None:
        from ..parallel.sharding import LoraLayout, cogreasoner_param_specs

        whole = init_cogreasoner_lora(generator, cfg, lora, dtype, device)
        return LoraLayout(whole, cogreasoner_param_specs(cfg, mesh),
                          mesh).shard(whole)
    tree = {"text": init_qwen2_lora(generator, cfg.text, lora, dtype, device)}
    if lora.include_projector:
        tree["projector"] = init_projector_lora(generator, cfg, lora, dtype,
                                                device)
    return tree


def iter_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf, in the tree's order (lists by
    index, dicts by insertion)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        if tree is not None:
            yield prefix, tree
        return
    for k, v in items:
        yield from iter_leaves(v, f"{prefix}.{k}" if prefix else str(k))


def map_leaves(fn, tree):
    """The tree with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def num_lora_params(tree) -> int:
    return sum(t.numel() for _, t in iter_leaves(tree))


# ---------------------------------------------------------------------------
# PEFT interchange (load reference-trained adapters)
# ---------------------------------------------------------------------------

_PEFT_NAMES = {
    "self_attn.q_proj": ("attn", "q_proj"),
    "self_attn.k_proj": ("attn", "k_proj"),
    "self_attn.v_proj": ("attn", "v_proj"),
    "self_attn.o_proj": ("attn", "o_proj"),
    "mlp.gate_proj": ("mlp", "gate_proj"),
    "mlp.up_proj": ("mlp", "up_proj"),
    "mlp.down_proj": ("mlp", "down_proj"),
}


def qwen2_lora_from_peft_state_dict(sd: Dict, cfg: Qwen2Config,
                                    dtype=torch.float32,
                                    device=None) -> Dict:
    """PEFT adapter_model state dict → the port's LoRA tree.

    PEFT stores ``lora_A.weight`` as [r, din] and ``lora_B.weight`` as
    [dout, r]; the tree's layout is a=[din, r], b=[r, dout] — transposed
    once here (the JAX package's rule)."""
    device = default_device(device)
    layers = [dict(attn={}, mlp={}) for _ in range(cfg.num_hidden_layers)]
    for name, tensor in sd.items():
        if ".lora_A." not in name and ".lora_B." not in name:
            continue
        parts = name.split(".layers.")
        if len(parts) != 2:
            continue
        idx, rest = parts[1].split(".", 1)
        for hf_name, (group, ours) in _PEFT_NAMES.items():
            if rest.startswith(hf_name):
                slot = layers[int(idx)][group].setdefault(ours, {})
                arr = torch.as_tensor(np.asarray(
                    tensor.detach().cpu().float() if hasattr(tensor, "detach")
                    else tensor, np.float32))
                slot["a" if ".lora_A." in name else "b"] = _leaf(
                    arr.T.contiguous().to(device=device, dtype=dtype))
                break
    return {"layers": layers}
