"""Training core: losses, optimizer, train step (port of
``cogstream_tpu/train/trainer.py``).

One step is: forward (remat'd decoder layers) → masked CE → gradients
with respect to the LoRA leaves only (the base is frozen: its tensors
never require grad) → AdamW. The optimizer reproduces the JAX
package's optax chain exactly — ``optax.adamw`` (b1, b2, eps 1e-8,
decoupled weight decay) under ``optax.warmup_cosine_decay_schedule``,
and ``optax.MultiSteps`` gradient accumulation (a running mean of the
micro-step gradients, one inner update every ``grad_accum`` micro-steps,
the schedule counting inner updates) — over trees of torch tensors. The
LoRA leaves and the optimizer moments update IN PLACE (the JAX package
returns new arrays), so a step allocates no second copy of either.

On a (data, model) mesh (``parallel/mesh.py``; one process per rank) the
step is JAX's SPMD program taken apart: each rank holds its decoder shard
and LoRA slice (``parallel/sharding.LoraLayout``) and its chunk of the
batch's leading dim (:func:`shard_batch`); the loss is vocab-parallel
(:func:`masked_cross_entropy` on the ranks' logit slices) and, as in JAX,
Σ nll over the GLOBAL count of valid targets, so each rank's loss is its
own Σ nll over that count and the data group's gradient SUM is the
global loss's gradient. On a (data, pipe) mesh (``pipeline=``, GPipe,
``parallel/pipeline.py``) each stage computes the whole loss from the last
stage's outputs and its own adapters' gradients; on an ``sp`` mesh
(``train/multimodal.py``'s ring) each rank's loss is its sequence shard's
share and its gradients partial sums: the step sums gradients and losses
over the mesh's ``grad_group`` (data, data, sp).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import LoRAConfig, Qwen2Config
from ..models import qwen2
from ..models.lora import iter_leaves
from ..parallel.mesh import DATA_AXIS, all_reduce, all_reduce_grads
from ..parallel.sharding import sharded_mesh

IGNORE_INDEX = -100


class PreemptionGuard:
    """SIGTERM-aware stop flag for preemption-safe training.

    The signal handler only sets a flag; the train loop checks it at the
    next step boundary, saves the train state and exits cleanly — the
    relaunch resumes from that exact step via ``restore_train_state``.

    Usage::

        with PreemptionGuard() as guard:
            train_stage1(..., stop_flag=guard)

    The guard is callable (returns ``triggered``) so loops can take
    any ``stop_flag: Callable[[], bool]``. Outside the main thread
    (where CPython forbids signal handlers) it degrades to a plain
    never-triggered flag. On a mesh the loops read it through
    :func:`stop_requested`: a signal to any rank stops every rank at the
    same step.
    """

    def __init__(self, signals: Tuple[int, ...] = None):
        import signal as _signal

        self._signal = _signal
        self._signals = signals if signals is not None \
            else (_signal.SIGTERM,)
        self._prev: Dict[int, Any] = {}
        self.triggered = False

    def _handle(self, signum, frame):
        self.triggered = True

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            try:
                self._prev[s] = self._signal.signal(s, self._handle)
            except ValueError:      # not the main thread
                pass
        return self

    def __exit__(self, *exc) -> bool:
        for s, prev in self._prev.items():
            self._signal.signal(s, prev)
        self._prev.clear()
        return False

    def __call__(self) -> bool:
        return self.triggered


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def masked_cross_entropy(
    logits: torch.Tensor,       # [B, S, V] (or the slice [B, S, hi - lo])
    labels: torch.Tensor,       # [B, S] int, IGNORE_INDEX outside the target
    vocab_mask: Optional[torch.Tensor] = None,   # [V] bool — constrained loss
    vocab: Optional[Tuple[int, int]] = None,
    group=None,
    count_group=None,
    shifted: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE over the shifted sequence, in f32. Returns (loss,
    n_targets). With ``vocab_mask`` the distribution is renormalized over
    the allowed tokens first (the stage-1 constrained objective).
    ``shifted``: ``labels`` are already each position's next-token target
    (:func:`next_token_labels`; a sequence shard's), and every position's
    logits count.

    Vocab-parallel (``vocab = (lo, hi)``, ``group`` the model group):
    ``logits`` hold this rank's vocab slice. The row max is MAXed over the
    group (a constant of the graph), Σ exp summed, and the target's logit
    taken from the rank that holds it, all in f32 and under autograd
    (``all_reduce``: identity backward). A slice with no allowed token
    (``vocab_mask``) holds -1e30 everywhere: the group's max comes from
    the slices that hold one, and its Σ exp is 0. ``count_group`` (the
    data group): the loss is Σ nll over the count of valid targets summed
    over it (JAX's mean over the global batch); each rank returns its own
    Σ nll over that count, and the global count."""
    if shifted:
        logits, targets = logits.to(torch.float32), labels.to(torch.int64)
    else:
        logits = logits[:, :-1].to(torch.float32)
        targets = labels[:, 1:].to(torch.int64)
    valid = targets != IGNORE_INDEX
    n = all_reduce(valid.sum(), count_group)
    if vocab is None:
        if vocab_mask is not None:
            logits = logits.masked_fill(~vocab_mask[None, None, :], -1e30)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
    else:
        lo, hi = vocab
        if vocab_mask is not None:
            logits = logits.masked_fill(~vocab_mask[None, None, lo:hi],
                                        -1e30)
        m = all_reduce(logits.detach().amax(dim=-1), group, "max")
        sumexp = all_reduce((logits - m[..., None]).exp().sum(dim=-1),
                            group)
        t = targets.clamp(min=0)
        mine = (t >= lo) & (t < hi)
        tl = logits.gather(-1, (t - lo).clamp(0, hi - lo - 1)[..., None])
        tl = all_reduce(torch.where(mine, tl[..., 0],
                                    torch.zeros_like(tl[..., 0])), group)
        nll = m + sumexp.log() - tl
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / n.clamp(min=1), n


def next_token_labels(labels: torch.Tensor) -> torch.Tensor:
    """[B, S] labels -> each position's next-token target (``labels``
    shifted left, ``IGNORE_INDEX`` at the end): what a sequence shard's
    :func:`masked_cross_entropy` with ``shifted=True`` reads."""
    return torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                     IGNORE_INDEX)], dim=1)


def loss_groups(text) -> Dict[str, Any]:
    """:func:`masked_cross_entropy`'s mesh arguments for a decoder
    (``Qwen2Model``): its vocab slice and the model group when the lm_head
    is vocab-split, the data group for the count; none for a whole
    decoder."""
    tp = getattr(text, "tp", None)
    if tp is None:
        return {}
    return {"vocab": tp.vocab, "group": tp.vocab_group,
            "count_group": tp.mesh.data_group}


def positions_from_ids(input_ids: torch.Tensor, pad_id: int = 0
                       ) -> torch.Tensor:
    """[B, S] absolute positions; padding slots get -1."""
    valid = input_ids != pad_id
    pos = torch.cumsum(valid.to(torch.int32), dim=1, dtype=torch.int32) - 1
    return torch.where(valid, pos, torch.full_like(pos, -1))


# ---------------------------------------------------------------------------
# schedule and optimizer (optax's semantics over torch tensors)
# ---------------------------------------------------------------------------

def make_lr_schedule(
    learning_rate: float,
    total_steps: int,
    warmup_steps: int,
    grad_accum: int = 1,
    schedule: str = "cosine",
):
    """Warmup-cosine over the run horizon in optimizer UPDATES (the
    accumulation advances the schedule once per accumulated update):
    ``optax.warmup_cosine_decay_schedule(0, lr, warmup, max(updates,
    warmup + 1))`` as a function of the update count. Any other
    ``schedule`` is the constant ``learning_rate``."""
    if schedule != "cosine":
        return learning_rate
    updates = max(1, total_steps // max(grad_accum, 1))
    decay_steps = max(updates, warmup_steps + 1)

    def lr(count: int) -> float:
        if warmup_steps > 0 and count < warmup_steps:
            # optax.linear_schedule(0, peak, warmup): (init - end) * frac + end
            frac = 1.0 - count / warmup_steps
            return (0.0 - learning_rate) * frac + learning_rate
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        return learning_rate * 0.5 * (
            1.0 + math.cos(math.pi * t / (decay_steps - warmup_steps)))

    return lr


class AdamW:
    """``optax.adamw(lr, b1, b2, eps=1e-8, weight_decay)``: Adam moments
    with bias correction, ``m̂ / (sqrt(v̂) + eps)``, plus ``wd * param``,
    times ``-lr(count)``. State: ``{"count", "mu", "nu"}`` (lists aligned
    with the parameter leaves)."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.lr = learning_rate if callable(learning_rate) \
            else (lambda count, v=float(learning_rate): v)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: List[torch.Tensor]) -> Dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params],
                "nu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params]}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict,
               params: List[torch.Tensor]) -> Tuple[List[torch.Tensor], Dict]:
        lr = self.lr(state["count"])     # optax's schedule counts from 0
        count = state["count"] + 1
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        updates = []
        for g, m, v, p in zip(grads, state["mu"], state["nu"], params):
            g = g.to(torch.float32)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / c1) / ((v / c2).sqrt() + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.to(torch.float32)
            updates.append(u * -lr)
        state["count"] = count
        return updates, state


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)``: the running mean
    of ``k`` micro-step gradients feeds one inner update; the micro-steps
    in between return no update (``None``: the parameters stay)."""

    def __init__(self, inner, every_k: int):
        self.inner = inner
        self.k = int(every_k)

    def init(self, params: List[torch.Tensor]) -> Dict:
        return {"mini_step": 0, "gradient_step": 0,
                "inner": self.inner.init(params),
                "acc": [torch.zeros_like(p, dtype=torch.float32)
                        for p in params]}

    @torch.no_grad()
    def update(self, grads, state: Dict, params):
        n = state["mini_step"]
        for a, g in zip(state["acc"], grads):
            a.add_((g.to(torch.float32) - a) / (n + 1))
        state["mini_step"] = (n + 1) % self.k
        if n != self.k - 1:
            return None, state
        updates, state["inner"] = self.inner.update(state["acc"],
                                                    state["inner"], params)
        for a in state["acc"]:
            a.zero_()
        state["gradient_step"] += 1
        return updates, state


def make_optimizer(
    learning_rate: float = 1e-4,
    total_steps: int = 10_000,
    warmup_steps: int = 100,
    weight_decay: float = 0.0,
    grad_accum: int = 1,
    schedule: str = "cosine",
    b1: float = 0.9,
    b2: float = 0.999,
):
    """AdamW + warmup-cosine (the reference's cosine LR,
    first_stage_training.py:488, second_stage_training.py:310), with
    gradient accumulation over ``grad_accum`` micro-steps."""
    sched = make_lr_schedule(learning_rate, total_steps, warmup_steps,
                             grad_accum, schedule)
    tx = AdamW(sched, b1=b1, b2=b2, weight_decay=weight_decay)
    if grad_accum > 1:
        tx = MultiSteps(tx, grad_accum)
    return tx


# ---------------------------------------------------------------------------
# train state and step
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    lora: Any                # trainable adapter tree (leaves require grad)
    opt_state: Any
    step: int                # micro-steps taken
    # a mesh run's parallel/sharding.LoraLayout: ``lora`` and the
    # optimizer's moments are this rank's slices (checkpoints gather them)
    layout: Any = None


def init_train_state(tx, lora: Any, layout=None) -> TrainState:
    return TrainState(lora, tx.init([t for _, t in iter_leaves(lora)]), 0,
                      layout)


def step_seed(base_seed: int, step: int) -> int:
    """The dropout seed of one step (``jax.random.fold_in(key, step)``'s
    role): stochastic across steps, reproducible from the base seed."""
    return qwen2.fold_seed(base_seed, step)


def make_train_step(tx, loss_fn: Callable,
                    dropout_seed: Optional[int] = None,
                    data_sharded: bool = True, mesh=None) -> Callable:
    """The (base frozen, LoRA trainable) train step ``step(params, state,
    batch) -> (state, loss)``. With ``dropout_seed`` the loss is called
    with a per-step seed derived from the step counter (train-mode LoRA
    dropout, reproducible); without it with no seed (deterministic).

    On a mesh (``params`` sharded, ``parallel/sharding.sharded_mesh``)
    ``batch`` is this rank's chunk and the loss its share of the global
    loss (:func:`masked_cross_entropy`'s ``count_group``); the gradients
    are summed over the data group in one collective, so every data
    replica applies the same update, and the loss returned is the global
    one. With ``data_sharded`` (a batch split on ``data``) and more than
    one data rank, the data index is folded into the dropout seed, so the
    replicas draw different masks (a departure from one process, which
    draws one mask over the whole batch); without it (the stage-2 turn,
    which every data replica computes whole, as JAX's) they draw the
    same.

    ``mesh`` is the mesh of a run whose model is not sharded for it (a
    pipeline or sp mesh; default: the one ``params`` is sharded for): the
    gradients and the loss are summed over its ``grad_group``."""

    def step(params, state: TrainState, batch):
        m = mesh if mesh is not None else sharded_mesh(params)
        group = None if m is None else m.grad_group
        leaves = [t for _, t in iter_leaves(state.lora)]
        if dropout_seed is not None:
            seed = step_seed(dropout_seed, state.step)
            if m is not None and m.data_group is not None \
                    and data_sharded:
                seed = step_seed(seed, m.data_index)
            loss = loss_fn(params, state.lora, batch, seed)
        else:
            loss = loss_fn(params, state.lora, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        grads = all_reduce_grads(grads, group)
        loss = all_reduce(loss.detach(), group)
        updates, opt_state = tx.update(grads, state.opt_state, leaves)
        if updates is not None:
            with torch.no_grad():
                for p, u in zip(leaves, updates):
                    p.add_(u.to(p.dtype))
        return state._replace(opt_state=opt_state, step=state.step + 1), \
            loss

    return step


def quiet_log(*args, **kwargs) -> None:
    """The log of a mesh rank other than 0: only rank 0 logs."""


def stop_requested(stop_flag: Optional[Callable[[], bool]], mesh) -> bool:
    """``stop_flag()`` (False without one), MAXed over every rank of
    ``mesh`` through its host group at a step boundary: true on every rank
    as soon as it is true on one."""
    flag = bool(stop_flag()) if stop_flag is not None else False
    if mesh is None or mesh.size == 1:
        return flag
    return bool(all_reduce(torch.tensor([int(flag)]), mesh.host_group,
                           "max").item())


# ---------------------------------------------------------------------------
# losses bound to a model
# ---------------------------------------------------------------------------

def text_loss_fn(
    model,                      # models.qwen2.Qwen2Model (frozen)
    lora: Dict,
    batch: Dict[str, torch.Tensor],
    lora_scale: float,
    vocab_mask: Optional[torch.Tensor] = None,
    remat: bool = True,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    pipeline: Optional[Tuple[Any, int]] = None,
    text_cfg: Optional[Qwen2Config] = None,
) -> torch.Tensor:
    """Stage-1 objective: text-only selector training. ``text_cfg`` is
    the decoder config the caller trains under (its serving flags pick a
    quantized base's activation mode, ``qwen2_forward_train``; default
    ``model.cfg``). ``pipeline=(mesh, M)`` runs the decoder through the
    GPipe schedule (``parallel/pipeline.py``) on the (data, pipe) mesh
    with M microbatches (``model`` a stage view, ``lora`` the stage's)."""
    ids = batch["input_ids"]
    positions = batch.get("positions")
    if positions is None:
        positions = positions_from_ids(ids)
    adapters = [(lora, 1.0)]
    emb = qwen2.embed(model, ids)
    groups = loss_groups(model)
    if pipeline is not None:
        from ..parallel.pipeline import pipeline_decoder_forward

        pp_mesh, n_mb = pipeline
        hidden = pipeline_decoder_forward(
            model, emb, positions, pp_mesh, num_microbatches=n_mb,
            adapters=adapters, lora_scale=lora_scale, remat=remat,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            cfg=text_cfg)
        groups = {"count_group": pp_mesh.data_group}
    else:
        hidden = qwen2.qwen2_forward_train(
            model, emb, positions, adapters, lora_scale, remat=remat,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            cfg=text_cfg)
    logits = qwen2.lm_logits(model, hidden, adapters, lora_scale)
    loss, _ = masked_cross_entropy(logits, batch["labels"], vocab_mask,
                                   **groups)
    return loss


def embeds_loss_fn(
    model,
    lora: Dict,
    batch: Dict[str, torch.Tensor],
    lora_scale: float,
    remat: bool = True,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    text_cfg: Optional[Qwen2Config] = None,
) -> torch.Tensor:
    """Stage-2 / baseline objective over pre-spliced embeddings: the
    batch carries ``inputs_embeds``, ``positions`` and shifted labels
    (``text_cfg`` as in :func:`text_loss_fn`)."""
    adapters = [(lora.get("text", lora), 1.0)]
    hidden = qwen2.qwen2_forward_train(
        model, batch["inputs_embeds"], batch["positions"], adapters,
        lora_scale, remat=remat, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed, cfg=text_cfg)
    logits = qwen2.lm_logits(model, hidden, adapters, lora_scale)
    loss, _ = masked_cross_entropy(logits, batch["labels"],
                                   **loss_groups(model))
    return loss


def bind_text_loss(lora_cfg: Optional[LoRAConfig] = None,
                   vocab_mask: Optional[torch.Tensor] = None,
                   remat: bool = True,
                   pipeline: Optional[Tuple[Any, int]] = None,
                   text_cfg: Optional[Qwen2Config] = None) -> Callable:
    lc = lora_cfg or LoRAConfig()

    def loss(model, lora, batch, seed=None):
        return text_loss_fn(model, lora, batch, lc.scale,
                            vocab_mask=vocab_mask, remat=remat,
                            dropout_rate=lc.dropout, dropout_seed=seed,
                            pipeline=pipeline, text_cfg=text_cfg)
    return loss


def bind_embeds_loss(lora_cfg: Optional[LoRAConfig] = None,
                     remat: bool = True,
                     text_cfg: Optional[Qwen2Config] = None) -> Callable:
    lc = lora_cfg or LoRAConfig()

    def loss(model, lora, batch, seed=None):
        return embeds_loss_fn(model, lora, batch, lc.scale, remat=remat,
                              dropout_rate=lc.dropout, dropout_seed=seed,
                              text_cfg=text_cfg)
    return loss


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch → tensors on ``device`` (ints stay int, floats f32)."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def batch_specs(batch_example: Dict[str, Any]) -> Dict[str, Tuple]:
    """Every batch leaf shards its leading (batch) dim on ``data`` (JAX's
    ``P(DATA_AXIS, None, ...)``, as a tuple of axis names)."""
    return {k: (DATA_AXIS,) + (None,) * (np.ndim(v) - 1)
            for k, v in batch_example.items()}


def shard_batch(batch: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """This rank's contiguous chunk of every leaf's leading dim (data rank
    ``d`` of ``D`` keeps rows ``[d·B/D, (d+1)·B/D)``, as JAX's
    ``NamedSharding`` over ``data`` places them); the batch itself without
    a mesh or with one data rank. A leading dim that ``data`` does not
    divide raises, as JAX's placement does."""
    if mesh is None or mesh.data == 1:
        return batch
    out = {}
    for k, v in batch.items():
        B = np.shape(v)[0]
        if B % mesh.data:
            raise ValueError(f"batch leaf {k!r} of {B} rows does not divide "
                             f"over {mesh.data} data ranks")
        n = B // mesh.data
        out[k] = v[mesh.data_index * n:(mesh.data_index + 1) * n]
    return out
