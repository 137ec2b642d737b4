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
* takes a decoder whose kernels are quantized dicts (``quantize_tree``:
  int8 ``q/scale``, rank-1 int4 ``q4/scale/rscale/code``, group-wise int4
  / NF4 ``q4/scale``; stacked layers, 2D ``lm_head``) byte for byte into
  the port's quantized storage, in the JAX layout (``[L, din, dout]``,
  ``[L, din/2, dout]``; NOT transposed), and a quantized vision tower
  and projector (``quantize_vision_w8a8``'s int8 GEMMs, or a whole tree
  from ``quantize_tree(params, bits=4|8)``, the QLoRA base: group-wise
  NF4 / int4 GEMMs with int8 where the group does not divide din, the
  patch embedding included) into ``QuantLinear``s, the tower's q / k / v
  dicts concatenated along dout into the fused QKV store.
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
from .vision_encoder import VisionTower, default_device


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


def _quant(qp: Dict, device) -> Dict[str, torch.Tensor]:
    """A JAX quantized dict → torch tensors, bytes and dtypes unchanged."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in qp.items()}


def _bias(value, lin) -> torch.Tensor:
    """``value`` as ``lin``'s bias (its dtype and device)."""
    _copy(lin.bias, value)
    return lin.bias


def _linear_from(lin, p: Dict, device):
    """A JAX dense ``{"kernel", "bias"}`` as ``lin``'s replacement: ``lin``
    loaded with a plain kernel, a ``QuantLinear`` (bias in ``lin``'s
    dtype) for a quantized one."""
    if isinstance(p["kernel"], dict):
        return quant.QuantLinear(quant.QuantWeight(_quant(p["kernel"], device)),
                                 bias=_bias(p["bias"], lin))
    _load_linear(lin, p)
    return lin


def qwen2_from_params(tree: Dict, cfg: Qwen2Config, device=None,
                      dtype=None) -> Qwen2Model:
    """Stacked JAX decoder tree (bf16/f32 kernels, or quantized kernels)
    → Qwen2Model."""
    device = default_device(device)
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
        stores = {name: _quant(stacked[group][name]["kernel"], device)
                  for group, names in (("attn", ATTN_PROJ), ("mlp", MLP_PROJ))
                  for name in names}
        quant.install_quantized_(model, stores,
                                 _quant(tree["lm_head"]["kernel"], device))
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
    """Per-layer JAX vision tree → VisionTower (q/k/v fused); quantized
    kernels (``quantize_vision_w8a8``, ``quantize_tree``) give
    ``QuantLinear``s of their scheme."""
    tower = VisionTower(cfg, device=device, dtype=dtype)
    device = tower.patch_embed.weight.device
    tower.patch_embed = _linear_from(tower.patch_embed, tree["patch_embed"],
                                     device)
    _copy(tower.post_ln.scale, tree["post_ln"]["scale"])
    _copy(tower.post_ln.bias, tree["post_ln"]["bias"])
    for layer, p in zip(tower.layers, tree["layers"]):
        for ln in ("ln1", "ln2"):
            _copy(getattr(layer, ln).scale, p[ln]["scale"])
            _copy(getattr(layer, ln).bias, p[ln]["bias"])
        a = p["attn"]
        bias = np.concatenate([np.asarray(a[n]["bias"], np.float32)
                               for n in ("q", "k", "v")])
        if isinstance(a["q"]["kernel"], dict):
            # every scale is per output column: the three dicts side by
            # side along dout are the fused weight's quantization
            kern = {k: np.concatenate([np.asarray(a[n]["kernel"][k])
                                       for n in ("q", "k", "v")], -1)
                    for k in a["q"]["kernel"]}
        else:
            kern = np.concatenate([np.asarray(a[n]["kernel"], np.float32)
                                   for n in ("q", "k", "v")], axis=1)
        layer.qkv = _linear_from(layer.qkv, {"kernel": kern, "bias": bias},
                                 device)
        for ours, p_lin in (("o", a["o"]), ("fc1", p["mlp"]["fc1"]),
                            ("fc2", p["mlp"]["fc2"])):
            setattr(layer, ours, _linear_from(getattr(layer, ours), p_lin,
                                              device))
    return tower.requires_grad_(False)


def projector_from_params(tree: Dict, vision_hidden: int, lm_hidden: int,
                          projector_type: str = "mlp2x_gelu", device=None,
                          dtype=torch.bfloat16) -> Projector:
    proj = Projector(vision_hidden, lm_hidden, projector_type, device, dtype)
    for i, p in enumerate(tree["layers"]):
        proj.layers[i] = _linear_from(proj.layers[i], p,
                                      proj.layers[i].weight.device)
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


def adapter_from_params(tree: Dict, device=None,
                        requires_grad: bool = False) -> Dict:
    """Stacked JAX LoRA tree ({"layers": {group: {name: {"a": [L, din,
    r], "b": [L, r, dout]}}}, optional "lm_head") → the port's adapter
    tree: per-layer entries, a/b kept in the [din, r] / [r, dout]
    layout (f32). ``requires_grad`` makes every entry a trainable leaf
    (models/lora.py)."""
    device = default_device(device)

    def t(a):
        out = torch.from_numpy(np.array(a, np.float32)).to(device)
        return out.requires_grad_(True) if requires_grad else out

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


def lora_from_params(tree: Dict, device=None) -> Dict:
    """A JAX LoRA tree (numpy leaves) → the port's trainable tree: a
    decoder tree (``init_qwen2_lora``) or a whole one with ``"text"`` and
    optional ``"projector"`` (``init_cogreasoner_lora``). Every leaf is
    an f32 tensor with ``requires_grad``."""
    if "text" not in tree:
        return adapter_from_params(tree, device, requires_grad=True)
    device = default_device(device)
    out = {"text": adapter_from_params(tree["text"], device,
                                       requires_grad=True)}
    if tree.get("projector") is not None:
        out["projector"] = {"layers": [
            {k: torch.from_numpy(np.array(ab[k], np.float32)).to(
                device).requires_grad_(True) for k in ("a", "b")}
            for ab in tree["projector"]["layers"]]}
    return out


def lora_to_params(tree: Dict) -> Dict:
    """The port's LoRA tree → the JAX layout as numpy f32: decoder
    entries stacked ``[L, ...]`` per projection, the projector's list
    kept. The inverse of :func:`lora_from_params`."""
    def n(t):
        return t.detach().float().cpu().numpy()

    def decoder(d):
        layers = d.get("layers", [])
        stacked = {}
        if layers:
            for group, names in layers[0].items():
                stacked[group] = {
                    name: {k: np.stack([n(layer[group][name][k])
                                        for layer in layers])
                           for k in ("a", "b")}
                    for name in names}
        out = {"layers": stacked}
        if d.get("lm_head") is not None:
            out["lm_head"] = {k: n(d["lm_head"][k]) for k in ("a", "b")}
        return out

    if "text" not in tree:
        return decoder(tree)
    out = {"text": decoder(tree["text"])}
    if tree.get("projector") is not None:
        out["projector"] = {"layers": [{k: n(ab[k]) for k in ("a", "b")}
                                       for ab in tree["projector"]["layers"]]}
    return out
