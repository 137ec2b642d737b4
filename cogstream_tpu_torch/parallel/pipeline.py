"""GPipe pipeline parallelism for the decoder — port of
``cogstream_tpu/parallel/pipeline.py``.

Each rank of a ``pipe`` group (``parallel/mesh.PipelineMesh``) holds a
contiguous ``L / P`` stage of the decoder's layers and their LoRA
adapters (``parallel/sharding.stage_qwen2`` / ``PipeLayout``); the
embedding, final norm and lm_head are replicated. JAX's GPipe schedule,
one process a stage: ``M + P - 1`` ticks, at tick ``t`` stage ``s`` runs
microbatch ``t - s`` through its layers (the same cache-free block code
as one process, ``qwen2_forward_train`` with ``apply_final_norm=False``)
and its output hops to the next stage round the ring
(``parallel/mesh.ppermute``). Stage 0 takes the embeddings and drops
what the ring brings it; in the fill and drain ticks a stage runs a
clipped microbatch whose output nothing reads. The last stage's outputs
reach every stage through a sum in which the others add zeros, and the
final norm runs once, after it. The bubble is the textbook ``(P - 1) /
(M + P - 1)``.

The backward is autograd's. Every rank must take every hop's reverse in
the same order, so, as JAX's ``jnp.where`` does, every hop's output stays
in each rank's graph: stage 0 selects the embeddings over the received
state with ``torch.where`` (a zero gradient, still a node), and every
stage writes each tick's output into the output buffer through
``torch.where`` (selected on the last stage only), so each rank's loss
reaches each of its hops. The broadcast sum's backward is the identity
(``parallel/mesh.all_reduce`` under autograd): the last stage's outputs
get the loss's gradient once, and a replicated leaf's gradient is whole
on every stage. The last tick's hop feeds no tick, so it is not sent:
``M + P - 2`` hops a forward and as many in the backward.

Training path only (cache-free); decoding wants tensor parallelism.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import qwen2
from .mesh import all_reduce, ppermute


def auto_microbatches(batch: int, n_stages: int) -> int:
    """JAX's rule for ``num_microbatches=None``: the smallest divisor of
    ``batch`` that is at least ``4 * n_stages`` (< 20% bubble), ``batch``
    itself when none is."""
    return next(c for c in range(min(batch, 4 * n_stages), batch + 1)
                if batch % c == 0)


def pipeline_decoder_forward(
    model,                          # this stage's stage_qwen2 view
    inputs_embeds: torch.Tensor,    # [B_local, S, H] this data rank's rows
    positions: torch.Tensor,        # [B_local, S]; -1 = padding
    mesh,                           # parallel/mesh.PipelineMesh
    num_microbatches: Optional[int] = None,
    adapters=None,
    lora_scale: float = 2.0,
    remat: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    cfg=None,
) -> torch.Tensor:
    """Pipelined cache-free decoder forward; returns hidden [B_local, S,
    H] with the final norm applied (``qwen2_forward_train``'s contract),
    the same on every stage. ``model`` is this stage's view of the decoder
    (``parallel/sharding.stage_qwen2(decoder, mesh)``, which raises JAX's
    error when the stages do not divide the layers) and ``adapters``'
    ``layers`` are its layers' adapters (``PipeLayout``). The global batch
    is ``B_local x data``; JAX's errors: M must divide it, and the data
    axis the microbatch size. Data rank ``d`` splits its rows into M
    microbatches (JAX puts rows ``[m * mb + d * mb / data, ...)`` of the
    global batch on it: the same rows' sums, in another order).

    LoRA dropout folds in the stage and the microbatch index
    (``qwen2.fold_seed``): each stage numbers its layers from 0, and
    microbatches are separate draws."""
    stage = getattr(model, "pp", None)
    if stage is None or stage.mesh is not mesh:
        raise ValueError("pipeline_decoder_forward runs this stage's view: "
                         "parallel/sharding.stage_qwen2(decoder, mesh)")
    cfg = cfg or model.cfg
    P, s = mesh.pipe, mesh.pipe_index
    B_local, S, H = inputs_embeds.shape
    dp = mesh.data
    B = B_local * dp
    M = num_microbatches or auto_microbatches(B, P)
    if B % M:
        raise ValueError(f"microbatches M={M} must divide B={B}")
    mb = B // M
    if mb % dp:
        raise ValueError(f"data axis {dp} must divide microbatch size {mb}")
    emb_mb = inputs_embeds.reshape(M, mb // dp, S, H)
    pos_mb = positions.to(torch.int32).reshape(M, mb // dp, S)
    dev = inputs_embeds.device
    first = torch.tensor(s == 0, device=dev)
    last = torch.tensor(s == P - 1, device=dev)
    drop = dropout_seed is not None and dropout_rate > 0.0

    state = torch.zeros_like(emb_mb[0])
    outs = [torch.zeros_like(emb_mb[0]) for _ in range(M)]
    for t in range(M + P - 1):
        x_in = torch.where(first, emb_mb[min(t, M - 1)], state)
        i = min(max(t - s, 0), M - 1)
        x_out = qwen2.qwen2_forward_train(
            model, x_in, pos_mb[i], adapters, lora_scale, remat=remat,
            dropout_rate=dropout_rate,
            dropout_seed=qwen2.fold_seed(dropout_seed, s, i) if drop
            else None, cfg=cfg, apply_final_norm=False)
        if t >= P - 1:
            d = t - (P - 1)
            outs[d] = torch.where(last, x_out, outs[d])
        if t < M + P - 2:
            state = ppermute(x_out, mesh.pipe_group)
    out = all_reduce(torch.stack(outs), mesh.pipe_group)
    return qwen2.rms_norm(out.reshape(B_local, S, H), model.final_norm,
                          cfg.rms_norm_eps)
