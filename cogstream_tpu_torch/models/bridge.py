"""Weight bridge: the JAX package's parameter tree (as numpy arrays) →
the port's modules.

It imports no JAX: callers turn the JAX tree into numpy first (e.g.
``jax.tree.map(np.asarray, params)``). What it does:

* unstacks the decoder's ``[L, ...]`` leaves into per-layer modules
  (like ``cogstream_tpu/models/checkpoint.py::_unstack``);
* transposes ``[in, out]`` kernels to the ``nn.Linear`` ``[out, in]``
  layout;
* concatenates the vision tower's q/k/v kernels into one fused QKV
  weight ``[3*H*D, hidden]`` (rows q | k | v) — once, at load;
* takes a decoder whose kernels are rank-1 int4 dicts (``quantize_tree(
  ..., bits=4, rank1=True)``: ``q4/scale/rscale/code``, stacked layers,
  2D ``lm_head``) byte for byte into the port's int4 storage, in the JAX
  layout ``[L, din/2, dout]`` (NOT transposed).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import CogReasonerConfig, Qwen2Config, VisionEncoderConfig
from .cogreasoner import CogReasoner
from .projector import Projector
from ..ops import quant
from .qwen2 import ATTN_PROJ, MLP_PROJ, Qwen2Model
from .vision_encoder import VisionTower


def _copy(param: torch.Tensor, value) -> None:
    src = torch.from_numpy(np.array(value, np.float32))
    if tuple(src.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(src.shape)} != {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(src)


def _load_linear(lin, p: Dict) -> None:
    _copy(lin.weight, np.asarray(p["kernel"], np.float32).T)
    if lin.bias is not None:
        _copy(lin.bias, p["bias"])


def _int4(qp: Dict, device) -> Dict[str, torch.Tensor]:
    """A JAX rank-1 int4 dict → torch tensors, bytes unchanged."""
    if "rscale" not in qp:
        raise NotImplementedError(f"group-wise int4 / NF4 is "
                                  f"{quant.QUEUE_MSG}")
    return {k: torch.from_numpy(np.array(qp[k], {"q4": np.int8}.get(
        k, np.float32))).to(device) for k in ("q4", "scale", "rscale", "code")}


def qwen2_from_params(tree: Dict, cfg: Qwen2Config, device=None,
                      dtype=None) -> Qwen2Model:
    """Stacked JAX decoder tree (bf16/f32 kernels, or rank-1 int4
    kernels) → Qwen2Model."""
    model = Qwen2Model(cfg, device=device, dtype=dtype)
    _copy(model.embed_tokens, tree["embed_tokens"])
    _copy(model.final_norm, tree["final_norm"]["scale"])
    stacked = tree["layers"]
    if isinstance(tree["lm_head"]["kernel"], dict):
        for i, layer in enumerate(model.layers):
            _copy(layer.input_norm,
                  np.asarray(stacked["input_norm"]["scale"])[i])
            _copy(layer.post_attn_norm,
                  np.asarray(stacked["post_attn_norm"]["scale"])[i])
            for group, names in (("attn", ATTN_PROJ), ("mlp", MLP_PROJ)):
                for name in names:
                    lin = getattr(layer, group)[name]
                    if lin.bias is not None:
                        _copy(lin.bias, np.asarray(
                            stacked[group][name]["bias"])[i])
        stores = {name: _int4(stacked[group][name]["kernel"], device)
                  for group, names in (("attn", ATTN_PROJ), ("mlp", MLP_PROJ))
                  for name in names}
        quant.install_int4_(model, stores,
                            _int4(tree["lm_head"]["kernel"], device))
        return model.requires_grad_(False)
    _load_linear(model.lm_head, tree["lm_head"])
    for i, layer in enumerate(model.layers):
        _copy(layer.input_norm, np.asarray(stacked["input_norm"]["scale"])[i])
        _copy(layer.post_attn_norm,
              np.asarray(stacked["post_attn_norm"]["scale"])[i])
        for group, names in (("attn", ATTN_PROJ), ("mlp", MLP_PROJ)):
            for name in names:
                p = stacked[group][name]
                _load_linear(getattr(layer, group)[name],
                             {k: np.asarray(v)[i] for k, v in p.items()})
    return model.requires_grad_(False)


def vision_from_params(tree: Dict, cfg: VisionEncoderConfig, device=None,
                       dtype=None) -> VisionTower:
    """Per-layer JAX vision tree → VisionTower (q/k/v fused)."""
    tower = VisionTower(cfg, device=device, dtype=dtype)
    _load_linear(tower.patch_embed, tree["patch_embed"])
    _copy(tower.post_ln.scale, tree["post_ln"]["scale"])
    _copy(tower.post_ln.bias, tree["post_ln"]["bias"])
    for layer, p in zip(tower.layers, tree["layers"]):
        for ln in ("ln1", "ln2"):
            _copy(getattr(layer, ln).scale, p[ln]["scale"])
            _copy(getattr(layer, ln).bias, p[ln]["bias"])
        a = p["attn"]
        _load_linear(layer.qkv, {
            "kernel": np.concatenate([np.asarray(a[n]["kernel"], np.float32)
                                      for n in ("q", "k", "v")], axis=1),
            "bias": np.concatenate([np.asarray(a[n]["bias"], np.float32)
                                    for n in ("q", "k", "v")])})
        _load_linear(layer.o, a["o"])
        _load_linear(layer.fc1, p["mlp"]["fc1"])
        _load_linear(layer.fc2, p["mlp"]["fc2"])
    return tower.requires_grad_(False)


def projector_from_params(tree: Dict, vision_hidden: int, lm_hidden: int,
                          projector_type: str = "mlp2x_gelu", device=None,
                          dtype=torch.bfloat16) -> Projector:
    proj = Projector(vision_hidden, lm_hidden, projector_type, device, dtype)
    for lin, p in zip(proj.layers, tree["layers"]):
        _load_linear(lin, p)
    return proj.requires_grad_(False)


def cogreasoner_from_params(tree: Dict, cfg: CogReasonerConfig,
                            device=None) -> CogReasoner:
    """Whole JAX CogReasoner tree ({"text", "vision", "projector"}) →
    CogReasoner at the config's dtypes."""
    return CogReasoner(
        text=qwen2_from_params(tree["text"], cfg.text, device),
        vision=vision_from_params(tree["vision"], cfg.vision, device),
        projector=projector_from_params(
            tree["projector"], cfg.vision.hidden_size, cfg.text.hidden_size,
            cfg.mm_projector_type, device, cfg.text.torch_dtype))


def adapter_from_params(tree: Dict, device=None) -> Dict:
    """Stacked JAX LoRA tree ({"layers": {group: {name: {"a": [L, din,
    r], "b": [L, r, dout]}}}, optional "lm_head") → the port's adapter
    tree: per-layer entries, a/b kept in the [din, r] / [r, dout]
    layout (f32)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    stacked = tree.get("layers", {})
    leaves = [np.asarray(ab["a"]) for g in stacked.values()
              for ab in g.values()]
    L = leaves[0].shape[0] if leaves else 0
    layers = [{group: {name: {"a": t(np.asarray(ab["a"])[i]),
                              "b": t(np.asarray(ab["b"])[i])}
                       for name, ab in names.items()}
               for group, names in stacked.items()} for i in range(L)]
    out = {"layers": layers}
    if tree.get("lm_head") is not None:
        out["lm_head"] = {"a": t(tree["lm_head"]["a"]),
                          "b": t(tree["lm_head"]["b"])}
    return out
