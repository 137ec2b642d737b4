"""Multimodal (stage-2 / baseline-finetune) training objective (port of
``cogstream_tpu/train/multimodal.py``).

One differentiable function from patch rows to masked CE: the frozen
vision tower (under ``torch.no_grad``: its output is a constant of the
step, so nothing is kept for a backward) → projector (+ LoRA on the
readout) → exact minor-frame pooling → splice into the token embeddings
→ grad-enabled decoder → masked CE. On a quantized base (QLoRA) the
tower, the projector and the decoder hold ``QuantLinear``s: the tower and
the projector dequantize each weight into its GEMM as JAX's
``materialize_kernel`` does, the decoder routes as JAX's ``dense``. The
tower takes its head-major
branch with ``use_pallas=True``: on a CUDA device that is K5
(``csrc/segment_attention.cu``), whose per-tile ranges are built on the
host from the batch's segment ids (the JAX package cannot under jit and
runs the plain attention there).

On a mesh (the model sharded, ``parallel/sharding.py``) the step is JAX's
SPMD one: the frozen tower runs on its head shards (K5 on the local heads,
K2) with no gradient, the projector's first linear column-parallel and its
second row-parallel with their LoRA slices, then the splice and the
sharded decoder; the text rows of the batch are this rank's data chunk
(``trainer.shard_batch``) while the patch rows stay whole.

Under ring sequence parallelism (``sp``, a ``parallel/mesh.SequenceMesh``,
JAX's ``sp=(mesh, axis)``) the frozen tower, the projector and the splice
run replicated on every rank (K5 and K2 in the tower, under no grad); the
decoder runs this rank's sequence shard (``qwen2_forward_sp``, the ring),
and the loss is the shard's share: Σ nll of its next-token targets over
the turn's whole count. The shares sum to the one-process loss, and each
rank's gradients are partial sums (the trainer sums them over the sp
group once).

Batch layout (tensors on the model's device; host-padded shapes):
  pixel_values [N, C*ps*ps]   patch rows for ALL items in the batch
  vis_pos      [N, 2]         2D rope positions (vision metadata)
  vis_seg      [N]            frame segment ids, -1 pad
  vis_grp      [N]            merge-group ids, -1 pad
  input_ids    [B, S]
  feat_src     [B, S]         row into the merged-feature table, -1 = text
  positions    [B, S]         -1 on padding
  labels       [B, S]         IGNORE_INDEX outside the answer span
  pool_group   [N]            optional: minor-frame pool group id, -1 = none
  pool_dst     [G]            optional: destination row per group (its
                              frame's patch-0 row); padded entries >= N
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import Qwen2Config
from ..models import qwen2
from ..models.projector import projector_forward_lora
from ..models.qwen2 import adapter_in as _adapter_in  # noqa: F401 (JAX name)
from ..models.qwen2 import site_generator
from ..models.vision_encoder import vision_encoder_core
from .trainer import loss_groups, masked_cross_entropy, next_token_labels


def pool_feature_table(proj: torch.Tensor, pool_group: torch.Tensor,
                       pool_dst: torch.Tensor) -> torch.Tensor:
    """Exact minor-frame pooling inside the differentiable graph: rows
    sharing a ``pool_group`` id are mean-pooled and the mean overwrites
    the group's ``pool_dst`` row; destinations past the table are
    dropped (``.at[].set(mode="drop")``)."""
    G = pool_dst.shape[0]
    seg = torch.where(pool_group >= 0, pool_group,
                      torch.full_like(pool_group, G)).to(torch.int64)
    sums = torch.zeros((G + 1, proj.shape[1]), dtype=torch.float32,
                       device=proj.device).index_add(
                           0, seg, proj.to(torch.float32))[:G]
    counts = torch.zeros((G + 1,), dtype=torch.float32,
                         device=proj.device).index_add(
                             0, seg, torch.ones((proj.shape[0],),
                                                dtype=torch.float32,
                                                device=proj.device))[:G]
    pooled = sums / counts.clamp(min=1.0)[:, None]
    keep = pool_dst < proj.shape[0]
    return proj.index_put((pool_dst[keep].to(torch.int64),),
                          pooled[keep].to(proj.dtype))


def multimodal_loss_fn(
    model,                          # models.cogreasoner.CogReasoner (frozen)
    lora: Dict,
    batch: Dict[str, torch.Tensor],
    lora_scale: float,
    num_vis_tokens: int,            # merged-feature table rows
    remat: bool = True,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    sp: Optional[Any] = None,
    text_cfg: Optional[Qwen2Config] = None,
) -> torch.Tensor:
    """Stage-2 loss of one packed turn. ``text_cfg`` is the decoder
    config the caller trains under (its ``w8a8_prefill`` runs an int8
    base's projections W8A8, ``qwen2_forward_train``; default
    ``model.text.cfg``). ``sp`` (a ``SequenceMesh``) runs the decoder
    sequence-parallel (see the module docstring): the returned loss is
    this rank's share."""
    text = model.text
    with torch.no_grad():
        feats = vision_encoder_core(
            model.vision, batch["pixel_values"], batch["vis_pos"],
            batch["vis_seg"], batch["vis_grp"], num_vis_tokens,
            use_pallas=True)
    x0 = feats.to(text.dtype)
    if isinstance(lora, dict) and "projector" in lora:
        gens = None
        if dropout_seed is not None and dropout_rate > 0.0:
            gens = [site_generator(dropout_seed, i, device=x0.device)
                    for i in range(len(model.projector.layers))]
        proj = projector_forward_lora(model.projector, x0,
                                      lora["projector"]["layers"],
                                      lora_scale, dropout_rate, gens)
    else:
        proj = model.projector(x0)

    if "pool_group" in batch:
        proj = pool_feature_table(proj, batch["pool_group"],
                                  batch["pool_dst"])

    ids = batch["input_ids"]
    feat_src = batch["feat_src"].to(torch.int64)
    emb = qwen2.embed(text, ids)
    spliced = torch.where((feat_src >= 0)[..., None],
                          proj[feat_src.clamp(min=0)].to(emb.dtype), emb)

    text_lora = lora.get("text", lora) if isinstance(lora, dict) else lora
    adapters = [(text_lora, 1.0)]
    if sp is not None:
        hidden = qwen2.qwen2_forward_sp(
            text, spliced, batch["positions"], sp, adapters, lora_scale,
            remat=remat, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, cfg=text_cfg)
        logits = qwen2.lm_logits(text, hidden, adapters, lora_scale)
        targets = qwen2.sequence_shard(next_token_labels(batch["labels"]),
                                       sp.size, sp.sp_index)
        loss, _ = masked_cross_entropy(logits, targets, shifted=True,
                                       count_group=sp.sp_group)
        return loss
    hidden = qwen2.qwen2_forward_train(
        text, spliced, batch["positions"], adapters, lora_scale,
        remat=remat, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
        cfg=text_cfg)
    logits = qwen2.lm_logits(text, hidden, adapters, lora_scale)
    loss, _ = masked_cross_entropy(logits, batch["labels"],
                                   **loss_groups(text))
    return loss
