"""Tensor-parallel plans for the port's modules — port of
``cogstream_tpu/parallel/sharding.py``.

The Megatron layout, on the ``model`` axis of a :class:`Mesh`:

* column-parallel (output channels split, no communication): the decoder's
  q / k / v and gate / up, the tower's fused QKV and fc1, the projector's
  first linear, and the lm_head's vocab columns;
* row-parallel (input channels split, one all-reduce after, the bias added
  once after it): o_proj, down_proj, the tower's o and fc2, the projector's
  second linear;
* vocab-parallel: ``embed_tokens`` rows (a masked local lookup, then an
  all-reduce) and the lm_head columns (each rank's logits are its vocab
  slice; sampling combines them, runtime/sampling.py).

A dim is split only when it divides; otherwise that block is replicated.
Unlike the JAX package, which splits attention by WIDTH (GSPMD reshards a
head cut in two), the port splits attention only on head boundaries: a
rank holds ``Hq / tp`` consecutive q heads and the kv heads they read
(head ``h`` reads ``h // G``), so K3 and K4 see one GQA ratio on every
rank. When ``Hkv`` does not divide, ranks hold overlapping kv heads (each
the ones its q heads read: JAX replicates them all); when ``Hq`` does not
divide (or a rank's q heads would straddle kv heads unevenly) the
attention block is replicated and the MLP still split. The tower splits by
its heads, each of q, k and v sliced per head in the fused QKV weight.

Quantized weights (ops/quant.py) slice their components: ``q`` / ``q4`` /
column ``scale`` follow the weight, ``rscale`` and group scales the input
rows. A row-parallel rank-1 int4 store is REPACKED to its own split-halves
pairing (packed row ``p`` holds local rows ``p`` and ``p + din_local/2``),
so K6 / K8 run unchanged on the local store; a group-wise store needs its
group size to divide ``din / tp``.

Specs are keyed by the port's parameter names (``text.layers.0.attn.
q_proj.weight``), in ``nn.Linear``'s ``[out, in]`` layout: ``out`` is the
kept output rows (an index tensor), ``inn`` the kept input range.

LoRA adapters follow the sites they adapt (:func:`lora_specs_like`, JAX's
rule): ``a`` [din, r] takes the weight's input placement, ``b`` [r, dout]
its output placement; a training run keeps each rank's slice
(:class:`LoraLayout`: the slices of a whole tree, and the whole tree back
from every rank's slice).

On the ``pipe`` axis of a :class:`~.mesh.PipelineMesh` (JAX's
``_stage_specs`` / ``_adapter_specs``) a stage holds its contiguous
``L / P`` decoder layers (:func:`stage_qwen2`, a view that copies no
tensor) and their adapters (:class:`PipeLayout`); the embedding, the
final norm, the lm_head and every adapter outside ``layers`` are
replicated.
"""

from __future__ import annotations

import copy
import math
import types
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import CogReasonerConfig, Qwen2Config, VisionEncoderConfig
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_gather, as_bytes,
                   gather_to_first, scatter_from_first)

Range = Tuple[int, int]


class Spec(NamedTuple):
    """One parameter's local slice: ``out`` the kept indices of dim 0
    (output channels, embedding rows), ``inn`` the kept range of dim 1
    (input channels). Both None: replicated."""

    out: Optional[torch.Tensor] = None
    inn: Optional[Range] = None


@dataclass(frozen=True)
class TextShard:
    """A rank's share of the decoder."""

    mesh: Mesh
    q_heads: Tuple[int, ...]       # global q heads held here
    kv_heads: Tuple[int, ...]      # global kv heads held here (in order)
    attn_split: bool               # o_proj row-parallel (reduce after it)
    mlp: Optional[Range]           # intermediate channels held here
    vocab: Optional[Range]         # vocab ids held here

    @property
    def group(self):
        return self.mesh.model_group

    @property
    def vocab_group(self):
        return self.group if self.vocab is not None else None


@dataclass(frozen=True)
class TowerShard:
    """A rank's share of the vision tower."""

    mesh: Mesh
    heads: Tuple[int, ...]
    attn_split: bool
    mlp: Optional[Range]

    @property
    def group(self):
        return self.mesh.model_group


@dataclass(frozen=True)
class ProjectorShard:
    mesh: Mesh
    hidden: Optional[Range]        # layer-0 outputs / layer-1 inputs here

    @property
    def group(self):
        return self.mesh.model_group


def _axis_range(dim: int, mesh: Mesh) -> Optional[Range]:
    """This rank's block of ``dim`` on the model axis, or None when the
    axis is 1 or does not divide ``dim`` (replicated)."""
    tp = mesh.shape[MODEL_AXIS]
    if tp == 1 or dim % tp:
        return None
    n = dim // tp
    return (mesh.model_index * n, (mesh.model_index + 1) * n)


def text_shard(cfg: Qwen2Config, mesh: Mesh) -> TextShard:
    Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    G = Hq // Hkv
    blk = _axis_range(Hq, mesh)
    if blk is not None:
        n = blk[1] - blk[0]
        if n % G and G % n:      # a rank's heads would straddle kv groups
            blk = None
    if blk is None:
        q_heads, kv_heads = tuple(range(Hq)), tuple(range(Hkv))
    else:
        q_heads = tuple(range(*blk))
        kv_heads = tuple(sorted({h // G for h in q_heads}))
    return TextShard(mesh, q_heads, kv_heads, blk is not None,
                     _axis_range(cfg.intermediate_size, mesh),
                     _axis_range(cfg.vocab_size, mesh))


def tower_shard(cfg: VisionEncoderConfig, mesh: Mesh) -> TowerShard:
    blk = _axis_range(cfg.num_attention_heads, mesh)
    heads = tuple(range(*blk)) if blk else tuple(
        range(cfg.num_attention_heads))
    return TowerShard(mesh, heads, blk is not None,
                      _axis_range(cfg.intermediate_size, mesh))


def projector_shard(cfg: CogReasonerConfig, depth: int,
                    mesh: Mesh) -> ProjectorShard:
    hidden = (_axis_range(cfg.text.hidden_size, mesh) if depth == 2
              else None)
    return ProjectorShard(mesh, hidden)


def _channels(heads, D: int, offset: int = 0) -> torch.Tensor:
    return torch.cat([torch.arange(offset + h * D, offset + (h + 1) * D)
                      for h in heads]) if heads else torch.zeros(
        0, dtype=torch.int64)


def _idx(r: Optional[Range]) -> Optional[torch.Tensor]:
    return None if r is None else torch.arange(r[0], r[1])


def _col(out: Optional[torch.Tensor], bias: bool) -> Dict[str, Spec]:
    spec = {"weight": Spec(out=out)}
    if bias:
        spec["bias"] = Spec(out=out)
    return spec


def _row(inn: Optional[Range], bias: bool) -> Dict[str, Spec]:
    spec = {"weight": Spec(inn=inn)}
    if bias:
        spec["bias"] = Spec()        # added once, after the reduce
    return spec


def _flat(prefix: str, tree: Dict) -> Dict[str, Spec]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(f"{prefix}{k}.", v))
        else:
            out[prefix + k] = v
    return out


def qwen2_param_specs(cfg: Qwen2Config, mesh: Mesh) -> Dict[str, Spec]:
    sh = text_shard(cfg, mesh)
    D = cfg.head_dim
    split = sh.attn_split
    q_out = _channels(sh.q_heads, D) if split else None
    kv_out = _channels(sh.kv_heads, D) if split else None
    q_in = ((sh.q_heads[0] * D, (sh.q_heads[-1] + 1) * D) if split
            else None)
    mlp = _idx(sh.mlp)
    vocab = _idx(sh.vocab)
    layer = {
        "input_norm": Spec(), "post_attn_norm": Spec(),
        "attn": {"q_proj": _col(q_out, True), "k_proj": _col(kv_out, True),
                 "v_proj": _col(kv_out, True),
                 "o_proj": _row(q_in, False)},
        "mlp": {"gate_proj": _col(mlp, False), "up_proj": _col(mlp, False),
                "down_proj": _row(sh.mlp, False)},
    }
    tree = {"embed_tokens": Spec(out=vocab), "final_norm": Spec(),
            "lm_head": _col(vocab, False),
            "layers": {str(i): layer
                       for i in range(cfg.num_hidden_layers)}}
    return _flat("", tree)


def vision_param_specs(cfg: VisionEncoderConfig,
                       mesh: Mesh) -> Dict[str, Spec]:
    sh = tower_shard(cfg, mesh)
    H, D = cfg.num_attention_heads, cfg.head_dim
    if sh.attn_split:
        qkv = torch.cat([_channels(sh.heads, D, j * H * D)
                         for j in range(3)])
        o_in = (sh.heads[0] * D, (sh.heads[-1] + 1) * D)
    else:
        qkv, o_in = None, None
    ln = {"scale": Spec(), "bias": Spec()}
    layer = {"ln1": ln, "ln2": ln, "qkv": _col(qkv, True),
             "o": _row(o_in, True), "fc1": _col(_idx(sh.mlp), True),
             "fc2": _row(sh.mlp, True)}
    tree = {"patch_embed": {"weight": Spec(), "bias": Spec()},
            "post_ln": ln,
            "layers": {str(i): layer
                       for i in range(cfg.num_hidden_layers)}}
    return _flat("", tree)


def projector_param_specs(cfg: CogReasonerConfig, depth: int,
                          mesh: Mesh) -> Dict[str, Spec]:
    """First linear column-parallel, second row-parallel (the mlp2x_gelu
    readout); any other depth replicated."""
    sh = projector_shard(cfg, depth, mesh)
    layers = {str(i): {"weight": Spec(), "bias": Spec()}
              for i in range(depth)}
    if sh.hidden is not None:
        layers = {"0": _col(_idx(sh.hidden), True),
                  "1": _row(sh.hidden, True)}
    return _flat("layers.", layers)


def cogreasoner_param_specs(cfg: CogReasonerConfig,
                            mesh: Mesh) -> Dict[str, Spec]:
    from ..models.projector import projector_depth

    depth = projector_depth(cfg.mm_projector_type)
    out = {}
    for prefix, specs in (
            ("text.", qwen2_param_specs(cfg.text, mesh)),
            ("vision.", vision_param_specs(cfg.vision, mesh)),
            ("projector.", projector_param_specs(cfg, depth, mesh))):
        out.update({prefix + k: v for k, v in specs.items()})
    return out


# ---------------------------------------------------------------------------
# quantized leaves
# ---------------------------------------------------------------------------

class LeafSpec(NamedTuple):
    """A parameter's or buffer's slice and how its axes map onto the
    weight's: ``kind`` "w" ([out, in]), "v" (dim 0 = out), "q" (int8
    [.., din, dout]), "q4" (packed [.., din/2, dout]), "s" (column scale
    [.., dout]), "gs" (group scale [.., din/G, dout]), "r" (row scale
    [.., din]) or "rep" (replicated)."""

    spec: Spec
    kind: str
    din: int = 0


def _store_kinds(store) -> Dict[str, str]:
    kinds = {"code": "rep", "layer_ids": "rep", "rscale": "r",
             "q": "q", "q4": "q4"}
    kinds["scale"] = ("gs" if "q4" in store.fields
                      and "rscale" not in store.fields else "s")
    return kinds


def adapt_specs_to_quantized(model: nn.Module,
                             specs: Dict[str, Spec]) -> Dict[str, LeafSpec]:
    """Every parameter and buffer of ``model`` (plain or quantized by
    ops/quant.py) → its :class:`LeafSpec`. A quantized store's components
    take the spec of the weight they replace: a stacked decoder store
    (``text.int4.q_proj.*``, also reached as
    ``text.layers.<i>.attn.q_proj.store.*``) that of every layer's
    projection, which is one spec. A name with no spec raises."""
    from ..ops.quant import QuantLinear, QuantWeight

    modules = dict(model.named_modules())
    sites = {}
    for path, mod in modules.items():
        if isinstance(mod, QuantLinear):
            sites.setdefault(id(mod.store), path)
    out: Dict[str, LeafSpec] = {}
    missing = []
    params = dict(model.named_parameters())
    for name in list(params) + [n for n, _ in model.named_buffers()]:
        owner_path, _, leaf = name.rpartition(".")
        owner = modules.get(owner_path)
        if isinstance(owner, QuantWeight):
            lin_path = sites.get(id(owner))
            w = specs.get(f"{lin_path}.weight") if lin_path else None
            if w is None:
                missing.append(name)
                continue
            din = (owner.q4.shape[-2] * 2 if "q4" in owner.fields
                   else owner.q.shape[-2])
            out[name] = LeafSpec(w, _store_kinds(owner)[leaf], din)
            continue
        spec = specs.get(name)
        if spec is None:
            missing.append(name)
            continue
        t = params.get(name)
        kind = "w" if t is not None and t.ndim == 2 else "v"
        out[name] = LeafSpec(spec, kind)
    if missing:
        raise KeyError(f"parameters {missing[:4]} have no spec")
    return out


def _repack_rows(q4: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of a split-halves packed weight, repacked to their
    own split-halves pairing."""
    from ..ops.quant import _pack_split, _unpack_halves

    if (hi - lo) % 2:
        raise ValueError(f"int4 shard of {hi - lo} rows is not even")
    a, b = _unpack_halves(q4)
    nib = torch.cat([a, b], dim=-2)[..., lo:hi, :]
    return _pack_split(nib, q4.dtype)


def slice_leaf(t: torch.Tensor, ls: LeafSpec) -> torch.Tensor:
    """The local slice of one parameter or buffer (a new tensor)."""
    from ..ops.quant import column_major

    out, inn = ls.spec.out, ls.spec.inn
    kind = ls.kind
    if kind == "rep" or (out is None and inn is None):
        return t
    if out is not None:
        dim = {"w": 0, "v": 0}.get(kind, -1)
        if kind != "r":
            t = t.index_select(dim, out.to(t.device))
    if inn is not None:
        lo, hi = inn
        if kind == "w":
            t = t[:, lo:hi]
        elif kind == "q":
            t = t[..., lo:hi, :]
        elif kind == "r":
            t = t[..., lo:hi]
        elif kind == "q4":
            t = _repack_rows(t, lo, hi)
        elif kind == "gs":
            G = ls.din // t.shape[-2]
            if lo % G or hi % G:
                raise ValueError(f"group size {G} does not divide the "
                                 f"shard rows [{lo}, {hi})")
            t = t[..., lo // G:hi // G, :]
    t = t.contiguous()
    return column_major(t) if kind == "q" else t


# ---------------------------------------------------------------------------
# sharding a model
# ---------------------------------------------------------------------------

def _set_tensor(root: nn.Module, name: str, value: torch.Tensor) -> None:
    owner_path, _, leaf = name.rpartition(".")
    owner = root.get_submodule(owner_path) if owner_path else root
    if leaf in owner._parameters:
        owner._parameters[leaf] = nn.Parameter(value, requires_grad=False)
    else:
        owner._buffers[leaf] = value


def attach_shards(model, cfg: CogReasonerConfig, mesh: Mesh):
    """Record the plans on a model whose tensors are already local."""
    from ..models.projector import projector_depth

    model.text.tp = text_shard(cfg.text, mesh)
    model.vision.tp = tower_shard(cfg.vision, mesh)
    model.projector.tp = projector_shard(
        cfg, projector_depth(cfg.mm_projector_type), mesh)
    return model


def sharded_mesh(model) -> Optional[Mesh]:
    """The mesh a model's tensors are sharded for (None: whole)."""
    tp = getattr(getattr(model, "text", model), "tp", None)
    return None if tp is None else tp.mesh


@torch.no_grad()
def shard_cogreasoner(model, cfg: CogReasonerConfig, mesh: Mesh):
    """A new CogReasoner holding this rank's slice of every tensor of
    ``model`` (plain or quantized), with the plans attached; ``model`` is
    left as it is. Each slice is a copy, so dropping ``model`` frees the
    whole weights."""
    new = _shard_module(model, cogreasoner_param_specs(cfg, mesh))
    return attach_shards(new, cfg, mesh)


def _shard_module(model: nn.Module, specs: Dict[str, Spec]) -> nn.Module:
    """A copy of ``model`` holding this rank's slice of every tensor."""
    leaves = adapt_specs_to_quantized(model, specs)
    memo = {id(t): t for t in list(model.parameters())
            + list(model.buffers())}
    new = copy.deepcopy(model, memo)
    named = dict(new.named_parameters())
    named.update(dict(new.named_buffers()))
    for name, ls in leaves.items():
        t = named[name]
        local = slice_leaf(t, ls)
        if local is not t:
            _set_tensor(new, name, local)
    return new


@torch.no_grad()
def shard_qwen2(model, cfg: Qwen2Config, mesh: Mesh):
    """A new decoder holding this rank's slice of every tensor of the
    whole ``model`` (plain or quantized), its plan attached (stage-1
    training shards the decoder alone)."""
    new = _shard_module(model, qwen2_param_specs(cfg, mesh))
    new.tp = text_shard(cfg, mesh)
    return new


def training_mesh(model, data: Optional[int], tp: Optional[int]):
    """The mesh a training run uses: the one ``model`` (a ``Qwen2Model``
    or ``CogReasoner``; None before a load) is already sharded for, when
    its layout is the asked one, else ``make_mesh(data, tp)`` of the
    process group; None for one process asking for no parallelism.
    ``data`` / ``tp`` that do not fit the world raise ``ValueError``
    (JAX's ``make_mesh`` does on a device count that does not match): a
    run never falls back to one rank."""
    from .mesh import make_mesh, world_size

    have = sharded_mesh(model)
    if have is not None:
        want = {DATA_AXIS: data or have.data,
                MODEL_AXIS: tp or have.model}
        if want != have.shape:
            raise ValueError(f"model is sharded for {have.shape}, asked "
                             f"for {want}")
        return have
    if world_size() == 1 and (data or 1) == 1 and (tp or 1) == 1:
        return None
    return make_mesh(data, tp)


def ensure_cogreasoner_sharded(model, cfg: CogReasonerConfig,
                               mesh: Optional[Mesh]):
    """``model`` under its serving plan on ``mesh`` — idempotent: a model
    already sharded for ``mesh`` comes back as it is (a server shards
    once and hands the model to its sessions and pool), and ``mesh=None``
    returns ``model``. A model sharded for another mesh raises."""
    if mesh is None:
        return model
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    have = sharded_mesh(model)
    if have is mesh:
        return model
    if have is not None:
        raise ValueError("model is sharded for another mesh")
    return shard_cogreasoner(model, cfg, mesh)


@torch.no_grad()
def init_cogreasoner_sharded(cfg: CogReasonerConfig,
                             generator: torch.Generator, mesh: Mesh,
                             device=None):
    """This rank's shard of ``models/cogreasoner.init_cogreasoner_params``
    (same generator, same draws): each full tensor is drawn on ``device``
    in the same order, sliced, and freed before the next, so no rank holds
    the whole model."""
    from ..models.cogreasoner import CogReasoner
    from ..models.projector import Projector
    from ..models.qwen2 import Qwen2Model
    from ..models.vision_encoder import VisionTower, default_device

    device = default_device(device)
    model = CogReasoner(
        text=Qwen2Model(cfg.text, device="meta"),
        vision=VisionTower(cfg.vision, device="meta"),
        projector=Projector(cfg.vision.hidden_size, cfg.text.hidden_size,
                            cfg.mm_projector_type, "meta",
                            cfg.text.torch_dtype))
    leaves = adapt_specs_to_quantized(model,
                                      cogreasoner_param_specs(cfg, mesh))
    params = dict(model.named_parameters())
    for path, mod in model.named_modules():
        if not isinstance(mod, nn.Linear):
            continue
        s = 1.0 / math.sqrt(mod.in_features)
        w = torch.empty(mod.weight.shape, dtype=mod.weight.dtype,
                        device=device).uniform_(-s, s, generator=generator)
        _set_tensor(model, f"{path}.weight",
                    slice_leaf(w, leaves[f"{path}.weight"]))
        del w
        if mod.bias is not None:
            b = torch.zeros(mod.bias.shape, dtype=mod.bias.dtype,
                            device=device)
            _set_tensor(model, f"{path}.bias",
                        slice_leaf(b, leaves[f"{path}.bias"]))
    e = params["text.embed_tokens"]
    full = torch.empty(e.shape, dtype=e.dtype, device=device).normal_(
        0.0, 0.02, generator=generator)
    _set_tensor(model, "text.embed_tokens",
                slice_leaf(full, leaves["text.embed_tokens"]))
    del full
    # norm scales ones, LayerNorm biases zeros (replicated)
    for name, p in list(model.named_parameters()):
        if p.is_meta:
            fill = 0.0 if name.endswith("bias") else 1.0
            _set_tensor(model, name, torch.full(p.shape, fill,
                                                dtype=p.dtype,
                                                device=device))
    return attach_shards(model.requires_grad_(False), cfg, mesh)


# ---------------------------------------------------------------------------
# LoRA adapters
# ---------------------------------------------------------------------------

class LoraSpec(NamedTuple):
    """One LoRA leaf's placement: ``axes`` as a ``PartitionSpec`` names
    them (``("model", None)``: rows split; ``(None, "model")``: columns
    split; ``(None, None)``: replicated), ``dim`` the split dim and
    ``index`` this rank's indices on it (None: replicated)."""

    axes: Tuple
    dim: Optional[int] = None
    index: Optional[torch.Tensor] = None


def lora_specs_like(lora_tree, param_specs: Dict[str, Spec]
                    ) -> Dict[str, LoraSpec]:
    """Placements of a LoRA tree's leaves, by their dotted paths
    (``models/lora.iter_leaves``): ``a`` [din, r] takes the adapted
    weight's input placement and ``b`` [r, dout] its output placement
    (JAX's ``lora_specs_like``). ``param_specs`` is keyed by parameter
    names relative to the tree's root: ``qwen2_param_specs`` for a
    decoder tree (``layers.<i>.attn.q_proj``), ``cogreasoner_param_specs``
    for a stage-2 tree (``text.layers.<i>...``, ``projector.layers.<i>``).
    The port's decoder entries are per layer (JAX stacks them ``[L]`` with
    a leading unsplit axis) and the projector's a list, as in JAX."""
    from ..models.lora import iter_leaves

    out = {}
    for path, _ in iter_leaves(lora_tree):
        site, _, leaf = path.rpartition(".")
        spec = param_specs.get(f"{site}.weight")
        if spec is None or leaf not in ("a", "b"):
            raise KeyError(f"LoRA leaf {path} adapts no known weight")
        if leaf == "a" and spec.inn is not None:
            out[path] = LoraSpec((MODEL_AXIS, None), 0,
                                 torch.arange(*spec.inn))
        elif leaf == "b" and spec.out is not None:
            out[path] = LoraSpec((None, MODEL_AXIS), 1, spec.out)
        else:
            out[path] = LoraSpec((None, None))
    return out


class LoraLayout:
    """A LoRA tree's split over the model axis of ``mesh`` (replicated on
    its data axis): built from the WHOLE tree (every rank initializes it
    from the seed) and the adapted model's parameter specs, it gives this
    rank's slice of a whole tree (:meth:`shard`) and the whole tree from
    every rank's slice (:meth:`gather`, collective over the model group),
    and the same for the optimizer's per-leaf moments. Each split leaf is
    a rank-ordered block (the plans split on head, channel and vocab
    blocks); a split the blocks cannot express (kv heads shared by ranks,
    whose adapters would each get part of the gradient) raises."""

    def __init__(self, lora_tree, param_specs: Dict[str, Spec],
                 mesh: Mesh):
        from ..models.lora import iter_leaves

        self.mesh = mesh
        self.specs = lora_specs_like(lora_tree, param_specs)
        for path, t in iter_leaves(lora_tree):
            _check_block(path, self.specs[path], t.shape, mesh)
        self._order = [p for p, _ in iter_leaves(lora_tree)]

    @property
    def group(self):
        return self.mesh.model_group

    @property
    def paths(self):
        """The whole tree's leaf paths, in :meth:`gather_leaves`' order."""
        return list(self._order)

    def shard(self, tree):
        """This rank's slice of a whole tree (new trainable leaves)."""
        return shard_lora(tree, self.specs)

    def shard_leaves(self, leaves):
        """This rank's slices of per-leaf tensors (optimizer moments) in
        the tree's leaf order."""
        return [_lora_slice(t, self.specs[p])
                for p, t in zip(self._order, leaves)]

    def gather_leaves(self, leaves):
        """The whole tensors from every rank's slices (collective over the
        model group): the split leaves travel in one flat all-gather."""
        split = [i for i, p in enumerate(self._order)
                 if self.specs[p].index is not None]
        out = [t.detach() for t in leaves]
        if self.group is None or not split:
            return out
        flat = torch.cat([out[i].reshape(-1).to(torch.float32)
                          for i in split])
        parts = all_gather(flat, self.group, dim=0).view(
            self.mesh.shape[MODEL_AXIS], -1)
        at = 0
        for i in split:
            t, dim = out[i], self.specs[self._order[i]].dim
            n = t.numel()
            out[i] = torch.cat([p[at:at + n].view(t.shape) for p in parts],
                               dim=dim).to(t.dtype)
            at += n
        return out

    def gather(self, tree):
        """The whole tree (detached) from every rank's slices."""
        from ..models.lora import iter_leaves, map_leaves

        whole = iter(self.gather_leaves([t for _, t in iter_leaves(tree)]))
        return map_leaves(lambda t: next(whole), tree)


def _check_block(path: str, spec: LoraSpec, whole, mesh: Mesh) -> None:
    """A split leaf of ``whole`` shape must be this rank's block of it; a
    plan that holds other indices (kv heads shared by ranks, whose
    adapters would each get part of the gradient) raises."""
    if spec.index is None:
        return
    n, tp = len(spec.index), mesh.shape[MODEL_AXIS]
    block = torch.arange(mesh.model_index * n, (mesh.model_index + 1) * n)
    if n * tp != whole[spec.dim] or not torch.equal(spec.index.cpu(),
                                                    block):
        raise NotImplementedError(
            f"LoRA on {path}: the plan holds indices that are not this "
            f"rank's block of {whole[spec.dim]} (kv heads shared by ranks);"
            " use another model-axis size")


def _lora_slice(t: torch.Tensor, spec: LoraSpec) -> torch.Tensor:
    if spec.index is None:
        return t
    return t.index_select(spec.dim, spec.index.to(t.device)).contiguous()


def shard_lora(tree, lora_specs: Dict[str, LoraSpec]):
    """A rank's slice of a whole LoRA tree under :func:`lora_specs_like`'s
    placements (leaves detached and trainable)."""
    from ..models.lora import iter_leaves, map_leaves

    specs = iter([lora_specs[p] for p, _ in iter_leaves(tree)])
    return map_leaves(lambda t: _lora_slice(t, next(specs)).detach()
                      .clone().requires_grad_(True), tree)


# ---------------------------------------------------------------------------
# pipeline stages
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PipeStage:
    """A decoder view's stage: its layers are the whole decoder's from
    ``lo`` on."""

    mesh: object                   # parallel/mesh.PipelineMesh
    lo: int


def stage_range(n_layers: int, mesh) -> Range:
    """This rank's contiguous layers ``[lo, hi)`` on the pipe axis; a
    stage count that does not divide the layers raises JAX's
    ``ValueError``."""
    P = mesh.pipe
    if n_layers % P:
        raise ValueError(f"pipe={P} stages must divide L={n_layers} layers")
    w = n_layers // P
    return mesh.pipe_index * w, (mesh.pipe_index + 1) * w


def stage_qwen2(model, mesh):
    """A view of the decoder ``model`` for this rank's pipeline stage: its
    ``layers[lo:hi]`` (:func:`stage_range`) and the replicated embedding,
    final norm and lm_head, the tensors shared with ``model`` (no copy:
    dropping ``model`` frees the other stages' layers), the stage in
    ``.pp``. A view for ``mesh`` comes back as it is."""
    have = getattr(model, "pp", None)
    if have is not None:
        if have.mesh is not mesh:
            raise ValueError("decoder is staged for another pipeline mesh")
        return model
    if getattr(model, "tp", None) is not None:
        raise ValueError("pipeline_stages is exclusive with model_parallel")
    lo, hi = stage_range(len(model.layers), mesh)
    new = copy.copy(model)
    new._modules = dict(model._modules)
    new._parameters = dict(model._parameters)
    new._buffers = dict(model._buffers)
    new._modules["layers"] = nn.ModuleList(list(model.layers)[lo:hi])
    new.pp = PipeStage(mesh, lo)
    return new


class PipeLayout:
    """A LoRA tree's split over the pipe axis of ``mesh`` (replicated on
    its data axis): this stage keeps the adapters of its layers
    (``tree["layers"][lo:hi]``) and every leaf outside ``layers``. The
    same interface as :class:`LoraLayout`: :meth:`shard` / :meth:`gather`
    of a tree, :meth:`shard_leaves` / :meth:`gather_leaves` of per-leaf
    tensors (optimizer moments) in the tree's leaf order; a gather is
    collective over the pipe group, this stage's layer leaves in one flat
    all-gather."""

    def __init__(self, lora_tree, mesh):
        from ..models.lora import iter_leaves, map_leaves

        self.mesh = mesh
        self.lo, self.hi = stage_range(len(lora_tree["layers"]), mesh)
        w = self.hi - self.lo
        layer = [int(p.split(".")[1]) if p.startswith("layers.") else None
                 for p, _ in iter_leaves(lora_tree)]
        self._mine = [i for i, li in enumerate(layer)
                      if li is None or self.lo <= li < self.hi]
        # whole-tree indices of each stage's layer leaves, in leaf order
        self._stages = [[i for i, li in enumerate(layer)
                         if li is not None and s * w <= li < (s + 1) * w]
                        for s in range(mesh.pipe)]
        self._skeleton = map_leaves(lambda t: 0, lora_tree)
        self._n = len(layer)

    @property
    def group(self):
        return self.mesh.pipe_group

    @property
    def paths(self):
        """The whole tree's leaf paths, in :meth:`gather_leaves`' order."""
        from ..models.lora import iter_leaves

        return [p for p, _ in iter_leaves(self._skeleton)]

    def shard(self, tree):
        """This stage's part of a whole tree (new trainable leaves)."""
        from ..models.lora import map_leaves

        part = dict(tree)
        part["layers"] = list(tree["layers"][self.lo:self.hi])
        return map_leaves(lambda t: t.detach().clone().requires_grad_(True),
                          part)

    def shard_leaves(self, leaves):
        """This stage's part of the whole tree's per-leaf tensors."""
        return [leaves[i] for i in self._mine]

    def gather_leaves(self, leaves):
        """The whole tree's per-leaf tensors from every stage's part
        (collective over the pipe group; the leaves outside ``layers``
        from this stage's copy)."""
        out: List[Optional[torch.Tensor]] = [None] * self._n
        for i, t in zip(self._mine, leaves):
            out[i] = t.detach()
        mine = self._stages[self.mesh.pipe_index]
        if self.group is None or not mine:
            return out
        flat = torch.cat([out[i].reshape(-1).to(torch.float32) for i in mine])
        parts = all_gather(flat, self.group, dim=0).view(self.mesh.pipe, -1)
        for s, idx in enumerate(self._stages):
            at = 0
            for i, j in zip(idx, mine):     # stages share leaf shapes
                t = out[j]
                out[i] = parts[s, at:at + t.numel()].view(t.shape).to(t.dtype)
                at += t.numel()
        return out

    def gather(self, tree):
        """The whole tree (detached) from every stage's part."""
        from ..models.lora import iter_leaves, map_leaves

        whole = iter(self.gather_leaves([t for _, t in iter_leaves(tree)]))
        return map_leaves(lambda _: next(whole), self._skeleton)


# ---------------------------------------------------------------------------
# the KV cache
# ---------------------------------------------------------------------------

def kv_cache_specs(cfg: Qwen2Config, mesh: Mesh, batch: int):
    """The local cache layout: (kv heads held here, this rank's row
    range or None). The kv heads are those of the decoder plan; rows
    split on the data axis when it divides ``batch``."""
    sh = text_shard(cfg, mesh)
    d = mesh.shape[DATA_AXIS]
    rows = None
    if d > 1 and batch % d == 0:
        n = batch // d
        rows = (mesh.data_index * n, (mesh.data_index + 1) * n)
    return sh.kv_heads, rows


def place_kv_cache(cache, cfg: Qwen2Config, mesh: Mesh):
    """A whole KVCache's local slice under :func:`kv_cache_specs` (for a
    cache built whole, e.g. a restored snapshot)."""
    from ..models.qwen2 import KVCache

    heads, rows = kv_cache_specs(cfg, mesh, cache.k.shape[1])
    h = torch.as_tensor(heads, device=cache.k.device)
    r = slice(None) if rows is None else slice(*rows)
    return KVCache(cache.k[:, r].index_select(3, h).contiguous(),
                   cache.v[:, r].index_select(3, h).contiguous(),
                   cache.pos[r].contiguous(), cache.write_index)


def shard_lora_tree(tree, cfg: CogReasonerConfig, mesh: Mesh):
    """This rank's slice of one serving LoRA tree (a decoder tree, or a
    whole one with ``text`` and ``projector``) under the model's serving
    plan, its leaves detached: :func:`shard_lora` over
    :func:`lora_specs_like` of ``qwen2_param_specs`` (a decoder tree) or
    ``cogreasoner_param_specs`` (a whole tree: the decoder, tower and
    projector plans). A tree already sliced for ``mesh`` comes back as it
    is; one whose shapes are neither whole nor this rank's slice raises
    ``ValueError``; a plan with kv heads shared by ranks raises
    ``NotImplementedError`` (:class:`LoraLayout`'s refusal)."""
    from ..models.lora import iter_leaves, lora_site_dims, map_leaves

    specs = lora_specs_like(tree, cogreasoner_param_specs(cfg, mesh)
                            if "text" in tree else
                            qwen2_param_specs(cfg.text, mesh))
    whole, sliced = True, True
    for path, t in iter_leaves(tree):
        site, _, ab = path.rpartition(".")
        din, dout = lora_site_dims(site, cfg)
        spec = specs[path]
        want = (din, t.shape[1]) if ab == "a" else (t.shape[0], dout)
        _check_block(path, spec, want, mesh)
        local = list(want)
        if spec.index is not None:
            local[spec.dim] = len(spec.index)
        whole &= tuple(t.shape) == want
        sliced &= tuple(t.shape) == tuple(local)
    if whole and not sliced:
        return map_leaves(torch.Tensor.detach, shard_lora(tree, specs))
    if sliced:
        return tree
    raise ValueError(f"LoRA tree is neither whole nor sliced for the mesh "
                     f"{mesh.shape} (rank {mesh.model_index} of its model "
                     "axis)")


def shard_adapters(adapters: Optional[Dict], cfg: CogReasonerConfig,
                   mesh: Optional[Mesh]) -> Optional[Dict]:
    """A session's, pool's, engine's or server's adapters
    (``{"language_module": tree, "full_module": tree}``) sliced for
    ``mesh`` (:func:`shard_lora_tree` per tree), idempotent: adapters
    already sliced for ``mesh`` come back as they are, and ``mesh=None``
    returns ``adapters``."""
    if mesh is None or not adapters:
        return adapters
    out = {k: None if t is None else shard_lora_tree(t, cfg, mesh)
           for k, t in adapters.items()}
    return adapters if all(out[k] is adapters[k] for k in out) else out


# ---------------------------------------------------------------------------
# a sharded session's cache, whole on the model group's first rank
# ---------------------------------------------------------------------------

def kv_head_map(cfg: Qwen2Config, mesh: Mesh) -> Tuple[Tuple[int, ...], ...]:
    """The global kv heads each rank of this rank's model group holds
    (:attr:`TextShard.kv_heads`), in model-rank order: each head once in
    the plain split; a head on several ranks where ``Hkv`` does not divide
    the model axis (overlapping heads); every head on every rank where the
    attention is replicated."""
    return tuple(
        text_shard(cfg, types.SimpleNamespace(
            shape=mesh.shape, data_index=mesh.data_index, model_index=m,
            model_group=None, data_group=None)).kv_heads
        for m in range(mesh.shape[MODEL_AXIS]))


def gather_kv_heads(x: torch.Tensor, cfg: Qwen2Config, mesh: Mesh,
                    dim: int) -> Optional[torch.Tensor]:
    """The whole tensor (every kv head on ``dim``) from each model rank's
    ``x`` (its kv heads), on the first rank of the model group (None on
    the others), moved as bytes. A head several ranks hold is taken from
    the first of them."""
    heads = kv_head_map(cfg, mesh)
    if len({len(h) for h in heads}) != 1:
        raise ValueError(f"kv heads per rank differ: {heads}")
    parts = gather_to_first(as_bytes(x), mesh.model_group)
    if parts is None:
        return None
    flat = [h for hs in heads for h in hs]
    idx = torch.tensor([flat.index(h) for h in range(cfg.num_key_value_heads)],
                       device=x.device)
    return torch.cat(parts, dim).index_select(dim, idx).view(x.dtype)


def scatter_kv_heads(whole: Optional[torch.Tensor], like: torch.Tensor,
                     cfg: Qwen2Config, mesh: Mesh, dim: int) -> torch.Tensor:
    """The inverse of :func:`gather_kv_heads`: the first rank's ``whole``
    (None on the others) sent as bytes, each rank receiving the kv heads
    it holds; ``like`` is this rank's part (shape, dtype, device)."""
    parts = None
    if whole is not None:
        b = as_bytes(whole)
        parts = [b.index_select(dim, torch.tensor(hs, device=b.device))
                 for hs in kv_head_map(cfg, mesh)]
    return scatter_from_first(parts, like, mesh.model_group)
