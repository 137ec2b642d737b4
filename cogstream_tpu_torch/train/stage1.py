"""Stage-1 training loop: the historic-dialogue-retrieval selector (port
of ``cogstream_tpu/train/stage1.py``).

LoRA r=8 on all attention/MLP projections, constrained-vocab CE on the
bracketed selection target, shuffle-augmented history, cosine LR, grad
accumulation, remat — on one GPU, or on a (data, model) mesh of one
process per rank (``torchrun --nproc-per-node N``): the decoder and its
LoRA under the Megatron plans, each batch split on ``data``, every rank on
the model axis unless ``data_parallel`` says otherwise (JAX's
``make_mesh`` default). :func:`main` is the ``train-stage1`` command: an
HF checkpoint directory, its tokenizer (the byte tokenizer where it ships
none), and ``--qa-json`` (a dataset file, or a directory of published
query chains). With ``pipeline_stages`` P (``--pipeline-stages P`` under
``torchrun``) the run takes a (data, pipe) mesh instead: each rank holds
its stage's L / P layers and their adapters, each data replica's batch
runs JAX's GPipe schedule (``parallel/pipeline.py``) in
``pipeline_microbatches`` microbatches (0: JAX's auto rule).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, Optional

import torch

from ..config import CogReasonerConfig, LoRAConfig
from ..models.lora import init_qwen2_lora
from ..parallel.mesh import SequenceMesh, make_pipeline_mesh
from ..parallel.pipeline import auto_microbatches
from ..parallel.sharding import (LoraLayout, PipeLayout, qwen2_param_specs,
                                 shard_qwen2, stage_qwen2, training_mesh)
from ..processor.tokenizer import constrained_selector_token_ids
from ..runtime.sampling import build_vocab_mask
from . import checkpoint as ckpt
from .data import (load_selector_dataset, load_selector_dir,
                   selection_exact_match, selector_batches)
from .trainer import (bind_text_loss, init_train_state,
                      make_optimizer, make_train_step, quiet_log,
                      shard_batch, stop_requested, to_device)


def check_pipeline(tcfg) -> None:
    """JAX's check of ``pipeline_stages``: exclusive with
    ``model_parallel``."""
    if tcfg.pipeline_stages > 1:
        if tcfg.model_parallel and tcfg.model_parallel > 1:
            raise ValueError(
                "pipeline_stages is exclusive with model_parallel (a "
                "pipeline stage replicates its layers at full width; "
                "pick TP or PP for weight distribution)")


def pipeline_microbatches(tcfg) -> int:
    """The microbatches a pipelined step runs: ``pipeline_microbatches``,
    or JAX's auto rule over ``batch_size`` (0)."""
    return tcfg.pipeline_microbatches or auto_microbatches(
        tcfg.batch_size, tcfg.pipeline_stages)


@dataclasses.dataclass
class Stage1Config:
    epochs: int = 8                  # ref :481-500
    batch_size: int = 8
    max_len: int = 1024
    learning_rate: float = 1e-4
    grad_accum: int = 4
    warmup_steps: int = 50
    shuffle_copies: int = 2
    save_every: int = 200
    log_every: int = 20
    data_parallel: Optional[int] = None
    model_parallel: Optional[int] = None
    # >1: GPipe pipeline parallelism over a (data, pipe) mesh instead of
    # tensor parallelism (parallel/pipeline.py); the stages must divide
    # num_hidden_layers; exclusive with model_parallel
    pipeline_stages: int = 1
    # 0 = auto: the smallest divisor of batch_size >= 4 * stages
    pipeline_microbatches: int = 0
    # few-shot demo block in the serialized selector prompt — must
    # match the flag used at serving (Selector.select include_demo)
    include_demo: bool = True
    seed: int = 0


def train_stage1(
    model,                      # models.qwen2.Qwen2Model (frozen base)
    cfg: CogReasonerConfig,
    tokenizer,
    samples,
    out_dir: str,
    tcfg: Stage1Config = Stage1Config(),
    resume: bool = True,
    log=print,
    stop_flag=None,
    lora_cfg: Optional[LoRAConfig] = None,
    lora: Optional[Dict] = None,
    mesh=None,
):
    """Train the selector LoRA on ``model``'s device; returns the final
    TrainState.

    In a process group of several ranks (or asked for a data or model
    axis above 1) the run takes ``make_mesh(tcfg.data_parallel,
    tcfg.model_parallel)``, or the mesh ``model`` is already sharded for:
    a whole ``model`` is sharded (a copy), every rank draws the whole
    initial LoRA from the seed and keeps its slice, shuffles the same
    batches and keeps its chunk of each; only rank 0 logs and writes, and
    a stop on any rank stops all at the same step. Sizes that do not fit
    the world raise (``ValueError``).

    With ``tcfg.pipeline_stages`` above 1 the run takes the (data, pipe)
    mesh (``mesh``, or ``make_pipeline_mesh(stages, data_parallel)``):
    ``model`` becomes this stage's view (``stage_qwen2``), every rank draws
    the whole initial LoRA and keeps its stage's (``PipeLayout``), and
    each step runs the GPipe schedule; checkpoints and the adapter file
    are the one-process ones.

    ``lora_cfg`` defaults to the reference recipe (``LoRAConfig()``:
    r=8, alpha 16, dropout 0.1); ``lora`` is the initial adapter tree
    (default: ``init_qwen2_lora`` from ``tcfg.seed``). ``stop_flag`` is
    an optional ``Callable[[], bool]`` polled at every step boundary
    (trainer.PreemptionGuard wires it to SIGTERM): when it turns true the
    train state is saved and the function returns early — a relaunch
    resumes from that step.
    """
    check_pipeline(tcfg)
    pipeline = None
    if tcfg.pipeline_stages > 1:
        mesh = mesh or make_pipeline_mesh(tcfg.pipeline_stages,
                                          tcfg.data_parallel)
        model = stage_qwen2(model, mesh)
        pipeline = (mesh, pipeline_microbatches(tcfg))
    else:
        mesh = training_mesh(model, tcfg.data_parallel, tcfg.model_parallel)
        if mesh is not None and getattr(model, "tp", None) is None:
            model = shard_qwen2(model, cfg.text, mesh)
    if mesh is not None and mesh.rank != 0:
        log = quiet_log
    dev = model.device
    lora_cfg = lora_cfg or LoRAConfig()
    if lora is None:
        lora = init_qwen2_lora(torch.Generator(device=dev).manual_seed(
            tcfg.seed), cfg.text, lora_cfg, device=dev)
    layout = None
    if pipeline is not None:
        layout = PipeLayout(lora, mesh)
    elif mesh is not None:
        layout = LoraLayout(lora, qwen2_param_specs(cfg.text, mesh), mesh)
    if layout is not None:
        lora = layout.shard(lora)

    steps_per_epoch = max(1, (len(samples) * tcfg.shuffle_copies)
                          // tcfg.batch_size)
    total = steps_per_epoch * tcfg.epochs
    tx = make_optimizer(tcfg.learning_rate, total_steps=total,
                        warmup_steps=tcfg.warmup_steps,
                        grad_accum=tcfg.grad_accum)
    vm = build_vocab_mask(cfg.text.vocab_size,
                          constrained_selector_token_ids(tokenizer), dev)
    loss_fn = bind_text_loss(lora_cfg, vocab_mask=vm, remat=True,
                             pipeline=pipeline, text_cfg=cfg.text)
    # reference recipe: LoRA dropout 0.1 during training
    # (first_stage_training.py:458-465); seeded → reproducible
    drop_seed = tcfg.seed ^ 0x5EED if lora_cfg.dropout > 0 else None
    step_fn = make_train_step(tx, loss_fn, dropout_seed=drop_seed,
                              mesh=mesh if pipeline is not None else None)

    state = init_train_state(tx, lora, layout)
    if resume:
        restored = ckpt.restore_train_state(out_dir, state)
        if restored is not None:
            state = restored
            log(f"resumed from step {state.step}")

    t0 = time.time()
    for epoch in range(tcfg.epochs):
        for batch in selector_batches(
                tokenizer, samples, tcfg.batch_size, tcfg.max_len,
                seed=tcfg.seed + epoch,
                shuffle_copies=tcfg.shuffle_copies,
                include_demo=tcfg.include_demo):
            state, loss = step_fn(model, state,
                                  to_device(shard_batch(batch, mesh), dev))
            s = state.step
            if s % tcfg.log_every == 0:
                log(f"epoch {epoch} step {s} loss {float(loss):.4f} "
                    f"({s / (time.time() - t0 + 1e-9):.2f} it/s)")
            if s % tcfg.save_every == 0:
                ckpt.save_train_state(out_dir, state)
            if stop_requested(stop_flag, mesh):
                ckpt.save_train_state(out_dir, state)
                log(f"preempted at step {s}: train state saved — "
                    "rerun to resume")
                return state
        ckpt.save_train_state(out_dir, state)
        log(f"epoch {epoch} done")
    ckpt.save_lora_adapter(out_dir, state.lora, name="language_module",
                           layout=layout)
    return state


def evaluate_selector(engine_selector, samples, limit: int = 100) -> Dict:
    """Exact-match digit metrics (compute_metrics, ref :397-420) of a
    ``runtime.retrieval.Selector``."""
    hits = 0
    n = 0
    for s in samples[:limit]:
        pred = engine_selector.select(s.question, s.hist_qs, s.hist_as)
        hits += selection_exact_match(pred, s.target)
        n += 1
    return {"exact_match": hits / max(n, 1), "n": n}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cogstream_tpu_torch train-stage1")
    ap.add_argument("--qa-json", required=True,
                    help="dataset JSON, or a directory of per-video "
                         "query-chain JSONs (the published layout)")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--max-len", type=int, default=Stage1Config.max_len,
                    help="token budget of one selector prompt; longer "
                         "samples are dropped (a checkpoint without "
                         "tokenizer files trains on byte tokens: a prompt "
                         "with the demo block runs to 2-4 thousand)")
    ap.add_argument("--pipeline-stages", type=int, default=1,
                    help=">1 trains with GPipe pipeline parallelism over a "
                         "(data, pipe) mesh of the torchrun world instead of "
                         "tensor parallelism; num_hidden_layers must divide "
                         "by it")
    ap.add_argument("--pipeline-microbatches", type=int, default=0,
                    help="GPipe microbatches a step; must divide "
                         "--batch-size. 0 = auto (smallest divisor >= "
                         "4 x stages)")
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="data-parallel size under torchrun; the rest of "
                         "the world goes on the model axis (default: "
                         "every rank on the model axis)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; under "
                         "torchrun cuda:LOCAL_RANK)")
    args = ap.parse_args(argv)

    from ..config import load_hf_config
    from ..models.checkpoint import (load_cogreasoner_from_hf,
                                     qwen2_from_state_dict)
    from ..models.safetensors_io import CheckpointReader
    from ..processor.tokenizer import load_tokenizer
    from .trainer import PreemptionGuard

    tcfg = Stage1Config(epochs=args.epochs, batch_size=args.batch_size,
                        max_len=args.max_len, learning_rate=args.lr,
                        data_parallel=args.data_parallel,
                        pipeline_stages=args.pipeline_stages,
                        pipeline_microbatches=args.pipeline_microbatches)
    check_pipeline(tcfg)
    rank, device, mesh = join_training_world(
        args.device, tcfg.data_parallel, tcfg.model_parallel,
        pipeline_stages=tcfg.pipeline_stages)
    say = print if rank == 0 else quiet_log
    cfg = load_hf_config(os.path.join(args.model_dir, "config.json"))
    if tcfg.pipeline_stages > 1:
        # the decoder's stage only: no rank loads the tower or the other
        # stages' layers
        text = qwen2_from_state_dict(CheckpointReader(args.model_dir),
                                     cfg.text, device=device, pipe=mesh)
    else:
        text = load_cogreasoner_from_hf(args.model_dir, cfg, device=device,
                                        mesh=mesh).text
    tokenizer = load_tokenizer(args.model_dir, cfg.image_token_index,
                               cfg.text.vocab_size)
    samples = (load_selector_dir(args.qa_json) if os.path.isdir(args.qa_json)
               else load_selector_dataset(args.qa_json))
    say(f"{len(samples)} selector samples")
    with PreemptionGuard() as guard:    # SIGTERM → save + clean exit
        state = train_stage1(text, cfg, tokenizer, samples, args.out,
                             tcfg, stop_flag=guard, mesh=mesh)
    say(f"stage1: {state.step} steps")


def join_training_world(device: Optional[str], data_parallel=None,
                        model_parallel=None, pipeline_stages: int = 1,
                        sequence_parallel: int = 1):
    """A training command's process group and mesh: under torchrun
    (``WORLD_SIZE`` > 1) the group is joined (NCCL on the cards, gloo
    with a CPU ``device``), this rank's device is ``cuda:LOCAL_RANK``
    unless ``device`` names one, and the mesh is ``make_mesh(data_parallel,
    model_parallel)`` (``parallel/sharding.training_mesh``), the (data,
    pipe) mesh with ``pipeline_stages`` above 1, or the sp mesh with
    ``sequence_parallel`` above 1; one process gets no (data, model) mesh.
    Returns (rank, device, mesh). Sizes that do not fit the world raise,
    in one process too."""
    from ..parallel.distributed import initialize_if_needed, local_rank

    cpu = device is not None and str(device).startswith("cpu")
    rank, world = initialize_if_needed(backend="gloo" if cpu else None)
    if world > 1 and device is None:
        device = f"cuda:{local_rank()}"
    if pipeline_stages > 1:
        return rank, device, make_pipeline_mesh(pipeline_stages,
                                                data_parallel)
    if sequence_parallel > 1:
        return rank, device, SequenceMesh(sequence_parallel)
    return rank, device, training_mesh(None, data_parallel, model_parallel)


if __name__ == "__main__":
    main()
