"""HF checkpoint I/O — port of ``cogstream_tpu/models/checkpoint.py``.

The reference ships one flat safetensors checkpoint
(``model.safetensors.index.json``: the Qwen2 LM, ``model.vision_encoder.*``
and ``model.mm_projector.readout.{0,2}``). This module maps those names
onto the port's modules, both ways, through the port's own safetensors
reader and writer (models/safetensors_io.py).

Loading streams tensor by tensor: the model is built on the ``meta``
device (no storage), and each parameter is mapped from its shard,
copied to the target device and cast there, before the next one is
mapped. Host memory therefore peaks at one checkpoint tensor's mapped
pages. The layouts need
no transposes: an HF ``[out, in]`` weight is ``nn.Linear``'s layout, the
patch-embedding conv ``[hidden, C, ps, ps]`` flattens to the port's
``[hidden, C*ps*ps]`` linear weight (the (c, ph, pw) order the image
processor serializes patch rows in), and the vision q/k/v weights
concatenate into the port's fused QKV weight.

``quantize_text_bits`` quantizes each decoder projection on the device
as it arrives, with the arithmetic of ``quantize_text_``: 4 with
``ops/quant.quantize_int4_rank1(nf4=False)`` into the stacked stores
K6-K9 serve, 8 with ``ops/quant.quantize_int8`` (JAX's ``_lazy_quant8``)
into the stores K10 serves; neither host nor device ever holds the bf16
decoder.

With ``mesh`` (parallel/mesh.Mesh) each rank maps a tensor, cuts its slice
under the serving plan (parallel/sharding.py) from the mapped pages and
copies only that slice to its device, so no rank ever holds the whole
decoder; load-time quantization then quantizes the slice with its
absmaxes taken over every rank's part, which gives the slice of the whole
weight's quantization.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..config import CogReasonerConfig, Qwen2Config, VisionEncoderConfig
from ..ops import quant
from ..parallel.sharding import (adapt_specs_to_quantized, attach_shards,
                                 cogreasoner_param_specs, slice_leaf,
                                 stage_qwen2, text_shard)
from .cogreasoner import CogReasoner
from .projector import Projector
from .qwen2 import ATTN_PROJ, MLP_PROJ, Qwen2Model
from .safetensors_io import CheckpointReader, save_file
from .vision_encoder import VisionTower, default_device

SHARD = "model.safetensors"


def _checked(value: torch.Tensor, like: torch.Tensor, name: str,
             device) -> torch.Tensor:
    """A copy of ``value`` on ``device`` after checking it has ``like``'s
    shape (a copy also on the CPU: the model owns its storage, not the
    reader's mapped file pages)."""
    if tuple(like.shape) != tuple(value.shape):
        raise ValueError(f"{name}: checkpoint shape {tuple(value.shape)} "
                         f"!= model shape {tuple(like.shape)}")
    return value.to(device, copy=True)


def _fill(module: nn.Module, name: str, value: torch.Tensor,
          device, leaf=None) -> None:
    """Give ``module.<name>`` (a meta-device parameter) its storage:
    ``value`` moved to ``device`` and cast there to the parameter's
    dtype. ``leaf`` (a ``parallel/sharding.LeafSpec``): only this rank's
    slice of ``value`` is copied."""
    old = getattr(module, name)
    if leaf is not None:
        old, value = slice_leaf(old, leaf), slice_leaf(value, leaf)
    module._parameters[name] = nn.Parameter(
        _checked(value, old, name, device).to(old.dtype),
        requires_grad=False)


def _sub(leaves, prefix: str):
    """The leaf specs under ``prefix``, keyed without it (None: whole)."""
    if leaves is None:
        return None
    return {k[len(prefix):]: v for k, v in leaves.items()
            if k.startswith(prefix)}


def _at(leaves, key: str):
    return None if leaves is None else leaves[key]


def _check_loaded(model: nn.Module) -> None:
    missing = [n for n, p in model.named_parameters() if p.is_meta]
    missing += [n for n, b in model.named_buffers() if b.is_meta]
    if missing:
        raise ValueError(f"checkpoint left {len(missing)} tensors "
                         f"unloaded, e.g. {missing[:3]}")


def qwen2_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: Qwen2Config,
                          prefix: str = "model.", dtype=None, device=None,
                          quantize_text_bits: Optional[int] = None,
                          mesh=None, leaves=None, pipe=None) -> Qwen2Model:
    """HF Qwen2 tensors → ``Qwen2Model`` on ``device``: projections and
    embeddings at ``dtype`` (the config's by default), norm scales f32.
    With ``quantize_text_bits`` 4 (8) every projection and the lm_head
    become rank-1 uniform int4 (per-channel int8) stores, quantized from
    the stored values. ``mesh`` with ``leaves`` (the decoder's leaf specs,
    see ``load_cogreasoner_from_hf``): this rank's shard. ``pipe`` (a
    ``parallel/mesh.PipelineMesh``): this rank's pipeline stage
    (``parallel/sharding.stage_qwen2``), whose other stages' layers are
    never loaded; bf16 only."""
    if quantize_text_bits not in (None, 4, 8):
        raise ValueError("load-time quantization supports bits 4 or 8 "
                         f"(got bits={quantize_text_bits})")
    if pipe is not None and quantize_text_bits is not None:
        raise ValueError("a pipeline stage loads unquantized")
    device = default_device(device)
    model = Qwen2Model(cfg, device="meta", dtype=dtype)
    if mesh is not None:
        model.tp = text_shard(cfg, mesh)
    lo = 0
    if pipe is not None:
        model = stage_qwen2(model, pipe)
        lo = model.pp.lo

    def fill(mod, name, key, path):
        _fill(mod, name, sd[key], device, _at(leaves, path))

    fill(model, "embed_tokens", f"{prefix}embed_tokens.weight",
         "embed_tokens")
    fill(model, "final_norm", f"{prefix}norm.weight", "final_norm")
    for i, layer in enumerate(model.layers, lo):
        lp = f"{prefix}layers.{i}."
        fill(layer, "input_norm", lp + "input_layernorm.weight",
             f"layers.{i}.input_norm")
        fill(layer, "post_attn_norm", lp + "post_attention_layernorm.weight",
             f"layers.{i}.post_attn_norm")
        for name in ATTN_PROJ:
            lin = layer.attn[name]
            if lin.bias is not None:
                fill(lin, "bias", lp + f"self_attn.{name}.bias",
                     f"layers.{i}.attn.{name}.bias")
    if quantize_text_bits is None:
        fill(model.lm_head, "weight", "lm_head.weight", "lm_head.weight")
        for i, layer in enumerate(model.layers, lo):
            lp = f"{prefix}layers.{i}."
            for grp, name in quant.GEMV_SITES:
                hf = "self_attn" if grp == "attn" else "mlp"
                fill(getattr(layer, grp)[name], "weight",
                     lp + f"{hf}.{name}.weight",
                     f"layers.{i}.{grp}.{name}.weight")
        _check_loaded(model)
        return model.requires_grad_(False)

    # one stacked store per projection site, filled a layer at a time
    # from the stored tensor (JAX's _lazy_quant8 / _lazy_quant4u quantize
    # the stored values too, not a copy already cast to the model dtype);
    # a shard quantizes as its slice of the whole weight
    def quantize(w, site):
        rg, cg = quant.site_groups(model, site)
        return (quant.quantize_int8(w, rg) if quantize_text_bits == 8
                else quant.quantize_int4_rank1(w, nf4=False, row_group=rg,
                                               col_group=cg))

    def local(key, like, path):
        value, leaf = sd[key], _at(leaves, path)
        if leaf is not None:
            like, value = slice_leaf(like, leaf), slice_leaf(value, leaf)
        return _checked(value, like, key, device)

    L = cfg.num_hidden_layers
    stores = {}
    for grp, name in quant.GEMV_SITES:
        hf = "self_attn" if grp == "attn" else "mlp"
        stack = None
        for i in range(L):
            key = f"{prefix}layers.{i}.{hf}.{name}.weight"
            w = local(key, getattr(model.layers[i], grp)[name].weight,
                      f"layers.{i}.{grp}.{name}.weight")
            qp = quantize(w.t(), name)
            del w
            if stack is None:
                stack = quant.empty_stack(L, qp)
            for k in stack:
                stack[k][i] = qp[k]
            del qp
        stores[name] = stack
    head = quantize(local("lm_head.weight", model.lm_head.weight,
                          "lm_head.weight").t(), "lm_head")
    quant.install_quantized_(model, stores, head)
    _check_loaded(model)
    return model.requires_grad_(False)


def vision_from_state_dict(sd: Mapping[str, torch.Tensor],
                           cfg: VisionEncoderConfig,
                           prefix: str = "model.vision_encoder.", dtype=None,
                           device=None, leaves=None) -> VisionTower:
    """Reference vision-tower tensors → ``VisionTower``: the conv patch
    embedding flattened to the linear weight, q/k/v fused (rows q | k |
    v), LayerNorm parameters f32. ``leaves``: this rank's shard."""
    device = default_device(device)
    tower = VisionTower(cfg, device="meta", dtype=dtype)

    def fill(mod, name, value, path):
        _fill(mod, name, value, device, _at(leaves, path))

    w = sd[prefix + "embeddings.patch_embedding.weight"]
    fill(tower.patch_embed, "weight", w.reshape(w.shape[0], -1),
         "patch_embed.weight")
    fill(tower.patch_embed, "bias",
         sd[prefix + "embeddings.patch_embedding.bias"], "patch_embed.bias")
    fill(tower.post_ln, "scale", sd[prefix + "post_layernorm.weight"],
         "post_ln.scale")
    fill(tower.post_ln, "bias", sd[prefix + "post_layernorm.bias"],
         "post_ln.bias")
    for i, layer in enumerate(tower.layers):
        lp = f"{prefix}encoder.layers.{i}."
        for ln in ("1", "2"):
            mod = getattr(layer, f"ln{ln}")
            fill(mod, "scale", sd[lp + f"layer_norm{ln}.weight"],
                 f"layers.{i}.ln{ln}.scale")
            fill(mod, "bias", sd[lp + f"layer_norm{ln}.bias"],
                 f"layers.{i}.ln{ln}.bias")
        for part in ("weight", "bias"):
            fill(layer.qkv, part, torch.cat(
                [sd[lp + f"self_attn.{n}_proj.{part}"] for n in "qkv"]),
                f"layers.{i}.qkv.{part}")
        for ours, theirs in (("o", "self_attn.out_proj"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            for part in ("weight", "bias"):
                fill(getattr(layer, ours), part,
                     sd[lp + f"{theirs}.{part}"], f"layers.{i}.{ours}.{part}")
    _check_loaded(tower)
    return tower.requires_grad_(False)


def projector_from_state_dict(sd: Mapping[str, torch.Tensor],
                              vision_hidden: int, lm_hidden: int,
                              projector_type: str = "mlp2x_gelu",
                              prefix: str = "model.mm_projector.readout.",
                              dtype=torch.bfloat16, device=None,
                              leaves=None) -> Projector:
    """``readout.{0,2,...}`` linears (a GELU between them has no
    parameters) → ``Projector``. ``leaves``: this rank's shard."""
    device = default_device(device)
    proj = Projector(vision_hidden, lm_hidden, projector_type, "meta", dtype)
    if f"{prefix}{2 * len(proj.layers)}.weight" in sd:
        raise ValueError(f"checkpoint has more projector layers than "
                         f"{projector_type}")
    for j, lin in enumerate(proj.layers):
        for part in ("weight", "bias"):
            _fill(lin, part, sd[f"{prefix}{2 * j}.{part}"], device,
                  _at(leaves, f"layers.{j}.{part}"))
    return proj.requires_grad_(False)


def load_cogreasoner_from_hf(model_dir: str, cfg: CogReasonerConfig,
                             dtype=None,
                             quantize_text_bits: Optional[int] = None,
                             device=None, mesh=None) -> CogReasoner:
    """The whole CogReasoner from an HF checkpoint directory
    (``model.safetensors`` with or without its index, or sharded
    ``model-*.safetensors`` behind the index), on ``device`` — the card
    unless the caller names another. ``dtype`` overrides the config's
    dtypes (norm scales stay f32); ``quantize_text_bits`` 4 or 8 loads the
    decoder as rank-1 uniform int4 or per-channel int8 (see the module
    docstring). ``mesh``: this rank's shard under the serving plan, every
    rank of the mesh loading together (see the module docstring)."""
    sd = CheckpointReader(model_dir)
    leaves = None
    if mesh is not None:
        whole = CogReasoner(
            Qwen2Model(cfg.text, device="meta", dtype=dtype),
            VisionTower(cfg.vision, device="meta", dtype=dtype),
            Projector(cfg.vision.hidden_size, cfg.text.hidden_size,
                      cfg.mm_projector_type, "meta",
                      dtype or cfg.text.torch_dtype))
        leaves = adapt_specs_to_quantized(
            whole, cogreasoner_param_specs(cfg, mesh))
    model = CogReasoner(
        text=qwen2_from_state_dict(sd, cfg.text, dtype=dtype, device=device,
                                   quantize_text_bits=quantize_text_bits,
                                   mesh=mesh, leaves=_sub(leaves, "text.")),
        vision=vision_from_state_dict(sd, cfg.vision, dtype=dtype,
                                      device=device,
                                      leaves=_sub(leaves, "vision.")),
        projector=projector_from_state_dict(
            sd, cfg.vision.hidden_size, cfg.text.hidden_size,
            cfg.mm_projector_type, dtype=dtype or cfg.text.torch_dtype,
            device=device, leaves=_sub(leaves, "projector.")))
    return model if mesh is None else attach_shards(model, cfg, mesh)


@torch.no_grad()
def merge_lora(model: CogReasoner, lora: Dict,
               lora_scale: float = 2.0) -> CogReasoner:
    """Fold LoRA deltas into the base weights IN PLACE: W' = W + (a @
    b)^T * lora_scale, summed in f32 and rounded once to W's dtype — the
    PEFT ``merge_and_unload`` equivalent. ``lora`` is the port's tree
    (``{"text": {"layers": [...], "lm_head"?}, "projector"?}``, or a bare
    decoder tree); projections without an adapter are untouched. A
    quantized decoder cannot take a dense delta."""
    if "text" not in lora:
        lora = {"text": lora}

    def fold(lin: nn.Module, ab: Dict) -> None:
        if isinstance(lin, quant.Int4Linear):
            raise NotImplementedError("merging LoRA into a quantized "
                                      "decoder; merge before quantizing")
        w = lin.weight
        a = ab["a"].detach().to(w.device, torch.float32)
        b = ab["b"].detach().to(w.device, torch.float32)
        delta = (a @ b) * lora_scale              # [din, dout]
        w.copy_((w.to(torch.float32) + delta.t()).to(w.dtype))

    text = lora.get("text") or {}
    for layer, entry in zip(model.text.layers, text.get("layers", [])):
        for grp, names in entry.items():
            for name, ab in names.items():
                fold(getattr(layer, grp)[name], ab)
    if text.get("lm_head") is not None:
        fold(model.text.lm_head, text["lm_head"])
    proj = lora.get("projector") or {}
    for lin, ab in zip(model.projector.layers, proj.get("layers", [])):
        fold(lin, ab)
    return model


def cogreasoner_state_dict(model: CogReasoner, cfg: CogReasonerConfig,
                           dtype=None) -> Dict[str, torch.Tensor]:
    """The model's tensors under the reference checkpoint's names, at
    ``dtype`` (the decoder config's by default; every tensor, norms
    included, as the JAX exporter writes them). A tensor already at
    ``dtype`` is the model's own storage, not a copy."""
    dtype = dtype or cfg.text.torch_dtype
    sd: Dict[str, torch.Tensor] = {}

    def put(name: str, t: torch.Tensor) -> None:
        sd[name] = t.detach().to(dtype)

    def lin(name: str, mod: nn.Module) -> None:
        if isinstance(mod, quant.Int4Linear):
            raise ValueError("exporting a quantized decoder is not "
                             "supported; export the bf16 model")
        put(name + ".weight", mod.weight)
        if mod.bias is not None:
            put(name + ".bias", mod.bias)

    text = model.text
    put("model.embed_tokens.weight", text.embed_tokens)
    put("model.norm.weight", text.final_norm)
    lin("lm_head", text.lm_head)
    for i, layer in enumerate(text.layers):
        lp = f"model.layers.{i}."
        put(lp + "input_layernorm.weight", layer.input_norm)
        put(lp + "post_attention_layernorm.weight", layer.post_attn_norm)
        for name in ATTN_PROJ:
            lin(lp + f"self_attn.{name}", layer.attn[name])
        for name in MLP_PROJ:
            lin(lp + f"mlp.{name}", layer.mlp[name])

    vis, vp = model.vision, "model.vision_encoder."
    C, ps = cfg.vision.num_channels, cfg.vision.patch_size
    pe = vis.patch_embed.weight
    put(vp + "embeddings.patch_embedding.weight", pe.reshape(-1, C, ps, ps))
    put(vp + "embeddings.patch_embedding.bias", vis.patch_embed.bias)
    put(vp + "post_layernorm.weight", vis.post_ln.scale)
    put(vp + "post_layernorm.bias", vis.post_ln.bias)
    for i, layer in enumerate(vis.layers):
        lp = f"{vp}encoder.layers.{i}."
        for ln in ("1", "2"):
            put(lp + f"layer_norm{ln}.weight", getattr(layer, f"ln{ln}").scale)
            put(lp + f"layer_norm{ln}.bias", getattr(layer, f"ln{ln}").bias)
        qkv = {part: getattr(layer.qkv, part).chunk(3)
               for part in ("weight", "bias")}
        for j, n in enumerate("qkv"):
            for part in ("weight", "bias"):
                put(lp + f"self_attn.{n}_proj.{part}", qkv[part][j])
        lin(lp + "self_attn.out_proj", layer.o)
        lin(lp + "mlp.fc1", layer.fc1)
        lin(lp + "mlp.fc2", layer.fc2)
    for j, layer in enumerate(model.projector.layers):
        lin(f"model.mm_projector.readout.{2 * j}", layer)
    return sd


def save_cogreasoner_to_hf(model: CogReasoner, cfg: CogReasonerConfig,
                           out_dir: str, dtype=None) -> str:
    """Write the model as a reference-layout HF checkpoint
    (``model.safetensors`` + its index + ``config.json``) — the inverse
    of :func:`load_cogreasoner_from_hf`, in the files the JAX package's
    exporter writes."""
    from ..config import save_hf_config
    from ..utils.io import atomic_write_json

    os.makedirs(out_dir, exist_ok=True)
    sd = cogreasoner_state_dict(model, cfg, dtype)
    save_file(sd, os.path.join(out_dir, SHARD))
    total = sum(t.numel() * t.element_size() for t in sd.values())
    atomic_write_json(
        os.path.join(out_dir, "model.safetensors.index.json"),
        {"metadata": {"total_size": total},
         "weight_map": {name: SHARD for name in sd}})
    save_hf_config(cfg, os.path.join(out_dir, "config.json"))
    return out_dir
