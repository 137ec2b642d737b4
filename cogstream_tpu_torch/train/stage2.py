"""Stage-2 training pieces: video-text interleaved reasoning and the
plain baseline finetune (port of ``cogstream_tpu/train/stage2.py``).

Per QA turn the selector is teacher-forced with the ground-truth
chain-of-inference, the prompt is rewritten to the selected history, the
visual stream is compressed, and CE lands on the answer span only. The
host assembles the static-shape batch (:func:`pack_turn_batch`, with the
exact pooling plan of :func:`build_pool_arrays`); the device runs
``train/multimodal.py``'s loss and the LoRA update
(:class:`Stage2Trainer`). :func:`train_stage2_video` runs one video's
curriculum (both segment layouts; the GT-selection rewrite; the frozen
model's compression pass on visual turns), :func:`count_dataset_turns`
gives the cosine schedule's horizon, and :func:`main` is the
``train-stage2`` command. Its ``--quantize-base {int8,nf4,int4}`` freezes
the whole base quantized while LoRA trains in f32 (QLoRA, the reference
recipe's NF4 base; ``ops/quant.quantize_cogreasoner_``), and
``--w8a8-forward`` runs an int8 base's decoder GEMMs W8A8 with a
straight-through gradient.

On a (data, model) mesh (one process per rank, ``torchrun``; every rank
on the model axis unless ``data_parallel`` says otherwise, JAX's
``make_mesh`` default) the weights and the LoRA sit under the Megatron
plans (plain or quantized bases: their stores slice), and the turn is NOT
split on ``data``: as in JAX, which calls no ``shard_batch`` for this
B = 1 batch, every data replica computes the same turn.
``--w8a8-forward`` runs there too: a row-parallel site's W8A8 takes the
whole row's absmax and reduces its int32 sums before the epilogue
(``ops/quant._W8A8STE``).

With ``sequence_parallel`` N (``--sequence-parallel N`` under ``torchrun
--nproc-per-node N``) every rank of the world sits on one ``sp`` axis
(``parallel/mesh.SequenceMesh``): weights and adapters are replicated,
each turn is split along the sequence and the decoder's attention runs the
ring (``train/multimodal.py``); each rank's loss share and gradients are
summed over the axis. JAX's checks come first (:func:`check_parallel`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CogReasonerConfig, LoRAConfig
from ..models import cogreasoner
from ..models.lora import init_cogreasoner_lora
from ..models.vision_encoder import build_vision_metadata
from ..parallel.mesh import SequenceMesh, world_size
from ..parallel.sharding import (LoraLayout, cogreasoner_param_specs,
                                 shard_cogreasoner, training_mesh)
from ..runtime.history import parse_selection, rewrite_history, \
    selection_string
from . import checkpoint as ckpt
from .multimodal import multimodal_loss_fn
from .trainer import (IGNORE_INDEX, init_train_state,
                      make_optimizer, make_train_step, quiet_log,
                      stop_requested, to_device)


def check_parallel(tcfg, world: int = 1) -> None:
    """What stage 2 refuses on ``world`` ranks: JAX's ``sequence_parallel``
    checks, in its order (exclusive with ``model_parallel``, a power of
    two, dividing ``max_seq_len``, ``n`` ranks), where the port's one
    process a rank also refuses more ranks than ``n`` (a rank cannot idle
    through the step)."""
    n = tcfg.sequence_parallel
    if n > 1:
        if tcfg.model_parallel and tcfg.model_parallel > 1:
            raise ValueError("sequence_parallel is exclusive with "
                             "model_parallel (weights replicate along the "
                             "sp axis)")
        if n & (n - 1):
            raise ValueError(f"sequence_parallel={n} must be a power of two "
                             "(turn lengths bucket to powers of two)")
        if tcfg.max_seq_len % n:
            raise ValueError(f"sequence_parallel={n} must divide "
                             f"max_seq_len={tcfg.max_seq_len}")
        if world < n:
            raise ValueError(
                f"sequence_parallel={n} needs {n} devices, have {world} — a "
                "silent 1-device sp mesh would defeat the long-turn memory "
                "split")
        if world > n:
            raise ValueError(f"sequence_parallel={n} uses {n} of {world} "
                             "ranks; the rest would idle — run "
                             f"--nproc-per-node {n}")


@dataclasses.dataclass
class Stage2Config:
    num_epochs: int = 1
    learning_rate: float = 1e-4
    grad_accum: int = 4            # ref :166-181
    save_every: int = 30           # updates (ref :182-202)
    log_every: int = 10
    max_seq_len: int = 4096
    max_frames: int = 180          # ref :149
    fps: int = 1
    data_parallel: Optional[int] = None
    model_parallel: Optional[int] = None
    # >1: ring sequence parallelism on an sp axis of that many ranks (the
    # world); a power of two that divides max_seq_len, exclusive with
    # model_parallel
    sequence_parallel: int = 1
    seed: int = 0
    baseline: bool = False         # C14: skip selection/compression


def build_pool_arrays(
    minor: np.ndarray,            # [T_total] bool minor-frame mask
    grid_sizes: np.ndarray,       # [B, 3]
    merge_sizes: np.ndarray,      # [B]
    num_vis_tokens: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The discrete pooling plan: merged-feature rows of each minor frame
    share a pool-group id; the group mean lands on the frame's patch-0
    row (its only surviving token). Returns None when nothing pools.
    ``pool_dst`` is bucketed (pad entries point past the table → dropped
    scatters)."""
    if minor is None or not np.any(minor):
        return None
    pool_group = np.full((num_vis_tokens,), -1, np.int32)
    dst: List[int] = []
    row = frame = 0
    for (t, gh, gw), ms in zip(grid_sizes, merge_sizes):
        t, gh, gw, ms = int(t), int(gh), int(gw), int(ms)
        merged = (gh // ms) * (gw // ms)
        for _ in range(t):
            if frame < len(minor) and minor[frame]:
                pool_group[row:row + merged] = len(dst)
                dst.append(row)
            frame += 1
            row += merged
    G = max(8, -(-len(dst) // 8) * 8)
    pool_dst = np.full((G,), num_vis_tokens, np.int32)
    pool_dst[:len(dst)] = dst
    return pool_group, pool_dst


def pack_turn_batch(
    tokenizer,
    cfg: CogReasonerConfig,
    prompt_text: str,
    answer_text: str,
    images,                       # ImageBatch-like or None
    keep_visual: Optional[np.ndarray],
    max_seq_len: int,
    minor_frames: Optional[np.ndarray] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """One teacher-forced turn → static-shape multimodal batch (B=1).

    ``keep_visual`` masks merged visual tokens (compression); surviving
    ``<image>`` ids map in order onto surviving feature rows.
    ``minor_frames`` adds the exact-pooling plan (build_pool_arrays).
    """
    img_id = tokenizer.image_token_id
    p_ids = tokenizer.encode(prompt_text)
    a_ids = tokenizer.encode(answer_text) + [tokenizer.eos_token_id]

    ids: List[int] = []
    feat_src: List[int] = []
    vis_i = 0
    for tid in p_ids:
        if tid == img_id:
            if keep_visual is None or keep_visual[vis_i]:
                ids.append(tid)
                feat_src.append(vis_i)
            vis_i += 1
        else:
            ids.append(tid)
            feat_src.append(-1)
    prompt_len = len(ids)
    ids.extend(a_ids)
    feat_src.extend([-1] * len(a_ids))
    if len(ids) > max_seq_len:
        return None

    S = max(64, 1 << math.ceil(math.log2(len(ids))))
    S = min(S, max_seq_len)
    if len(ids) > S:
        return None
    pad = S - len(ids)
    labels = [IGNORE_INDEX] * prompt_len + a_ids + [IGNORE_INDEX] * pad
    positions = list(range(len(ids))) + [-1] * pad
    batch = {
        "input_ids": np.asarray([ids + [0] * pad], np.int32),
        "feat_src": np.asarray([feat_src + [-1] * pad], np.int32),
        "labels": np.asarray([labels], np.int32),
        "positions": np.asarray([positions], np.int32),
    }
    if images is not None:
        meta = build_vision_metadata(images.grid_sizes, images.merge_sizes)
        batch.update({
            "pixel_values": images.pixel_values.astype(np.float32),
            "vis_pos": meta.pos_ids,
            "vis_seg": meta.segment_ids,
            "vis_grp": meta.merge_group_ids,
        })
        batch["num_vis_tokens"] = meta.num_out_tokens  # static sidecar
        if minor_frames is not None:
            pool = build_pool_arrays(minor_frames, images.grid_sizes,
                                     images.merge_sizes,
                                     meta.num_out_tokens)
            if pool is not None:
                batch["pool_group"], batch["pool_dst"] = pool
    return batch


def build_gt_selection(relevance: Sequence[int], n_hist: int,
                       if_visual: bool) -> str:
    idx = [i for i, r in enumerate(relevance[:n_hist]) if r]
    return selection_string(if_visual, idx)


class Stage2Trainer:
    """Drives the per-turn curriculum on the model's device: one LoRA
    micro-step per packed turn; on a mesh (see the module docstring) every
    rank drives the same turns on its shard or sequence shard, rank 0 logs
    and writes."""

    def __init__(self, model, cfg: CogReasonerConfig, tokenizer,
                 tcfg: Stage2Config, out_dir: str,
                 total_steps: Optional[int] = None, log=print,
                 stop_flag=None, lora_cfg: Optional[LoRAConfig] = None,
                 lora: Optional[Dict] = None, mesh=None):
        """``lora_cfg`` defaults to the reference recipe with the
        projector adapted unless ``tcfg.baseline``; ``lora`` is the
        initial adapter tree (default: ``init_cogreasoner_lora`` from
        ``tcfg.seed``). ``mesh``: the ``SequenceMesh`` of a
        ``sequence_parallel`` run (default: built over the world)."""
        check_parallel(tcfg, world_size())
        self.sp = None
        if tcfg.sequence_parallel > 1:
            self.sp = self.mesh = mesh or SequenceMesh(tcfg.sequence_parallel)
        else:
            self.mesh = training_mesh(model, tcfg.data_parallel,
                                      tcfg.model_parallel)
            if self.mesh is not None and \
                    getattr(model.text, "tp", None) is None:
                model = shard_cogreasoner(model, cfg, self.mesh)
        if self.mesh is not None and self.mesh.rank != 0:
            log = quiet_log
        self.model = model
        self.cfg = cfg
        self.tok = tokenizer
        self.tcfg = tcfg
        self.out_dir = out_dir
        self.log = log
        # optional Callable[[], bool] (trainer.PreemptionGuard): polled
        # at turn boundaries; true → save state and stop cleanly
        self.stop_flag = stop_flag
        self.device = model.text.device
        self.lora_cfg = lora_cfg or LoRAConfig(
            include_projector=not tcfg.baseline)
        if lora is None:
            lora = init_cogreasoner_lora(
                torch.Generator(device=self.device).manual_seed(tcfg.seed),
                cfg, self.lora_cfg, device=self.device)

        # cosine horizon = real run length (dataset turns × epochs)
        if total_steps is None:
            total_steps = 10_000
            log("stage2: total_steps not given; cosine horizon defaults "
                "to 10k updates — pass the dataset turn count × epochs")
        self.tx = make_optimizer(
            tcfg.learning_rate, total_steps=total_steps,
            warmup_steps=min(100, max(1, total_steps // 10)),
            grad_accum=tcfg.grad_accum)
        layout = None
        if self.mesh is not None and self.sp is None:
            layout = LoraLayout(lora, cogreasoner_param_specs(cfg, self.mesh),
                                self.mesh)
            lora = layout.shard(lora)
        self.state = init_train_state(self.tx, lora, layout)
        restored = ckpt.restore_train_state(out_dir, self.state)
        if restored is not None:
            self.state = restored
            log(f"resumed at step {self.state.step}")
        # reference recipe trains with LoRA dropout 0.1; seeds derive
        # from tcfg.seed so runs are reproducible
        scale, rate = self.lora_cfg.scale, self.lora_cfg.dropout
        self._num_vis = 0

        def loss(m, lo, b, seed=None):
            return multimodal_loss_fn(m, lo, b, scale,
                                      num_vis_tokens=self._num_vis,
                                      remat=True, dropout_rate=rate,
                                      dropout_seed=seed, sp=self.sp,
                                      text_cfg=cfg.text)

        self._step = make_train_step(
            self.tx, loss,
            dropout_seed=tcfg.seed ^ 0x5EED if rate > 0 else None,
            data_sharded=False, mesh=self.sp)

    def train_turn(self, batch: Dict[str, np.ndarray]) -> float:
        batch = dict(batch)
        n_vis = int(batch.pop("num_vis_tokens", 0))
        if n_vis == 0:
            # text-only turn: tiny dummy visual table keeps one code path
            batch["pixel_values"] = np.zeros(
                (4, 3 * self.cfg.vision.patch_size ** 2), np.float32)
            batch["vis_pos"] = np.zeros((4, 2), np.int32)
            batch["vis_seg"] = np.full((4,), -1, np.int32)
            batch["vis_grp"] = np.full((4,), -1, np.int32)
            n_vis = 1
        self._num_vis = n_vis
        self.state, loss = self._step(self.model, self.state,
                                      to_device(batch, self.device))
        s = self.state.step
        # state.step counts MICRO-steps; the reference checkpoints every
        # 30 accumulated UPDATES (second_stage_training.py:182-202)
        if s % (self.tcfg.save_every * max(1, self.tcfg.grad_accum)) == 0:
            ckpt.save_train_state(self.out_dir, self.state)
        return float(loss)

    def preempted(self) -> bool:
        """True once the stop flag fires; saves the train state when
        observed so the caller can simply stop."""
        if stop_requested(self.stop_flag, self.mesh):
            ckpt.save_train_state(self.out_dir, self.state)
            self.log(f"preempted at step {self.state.step}: train state "
                     "saved — rerun to resume")
            return True
        return False

    def finish(self):
        ckpt.save_train_state(self.out_dir, self.state)
        ckpt.save_lora_adapter(self.out_dir, self.state.lora,
                               name="full_module", layout=self.state.layout)


def train_stage2_video(
    trainer: Stage2Trainer,
    processor,
    video_path: str,
    segments: Sequence[dict],
    log=print,
) -> List[float]:
    """One video's curriculum: grow the conversation segment by segment,
    teacher-forcing each QA (the loop at second_stage_training.py:104-218).

    ``segments``: [{"timestamp": [s, e], "QAs": [{"QA_pairs": [{"Q","A"}],
    "relevance": [...], "is_visual": bool}]}], or the published layout's
    ``{"segment_file": ...}`` (a file under the per-video directory
    ``video_path``). Visual turns run the frozen model's compression pass
    (``encode_images`` and ``run_visual_compression``, under no grad,
    under the trainer's config's serving flags) with a k-means generator
    seeded 0 on every turn, as JAX passes ``PRNGKey(0)``.
    """
    cfg, tok, tcfg = trainer.cfg, trainer.tok, trainer.tcfg
    model = cogreasoner.with_serving_flags(trainer.model, cfg)
    dev = trainer.device
    conversation: List[dict] = []
    hist_qs: List[str] = []
    hist_as: List[str] = []
    losses: List[float] = []

    for seg in segments:
        if "segment_file" in seg:
            # published layout: each segment is its own file under the
            # per-video directory (second_stage_training.py:143-152)
            video_args = {
                "video_path": os.path.join(video_path,
                                           seg["segment_file"]),
                "fps": tcfg.fps, "max_frames": tcfg.max_frames}
        else:
            s, e = seg.get("timestamp", [None, None])[:2]
            video_args = {"video_path": video_path, "fps": tcfg.fps,
                          "max_frames": tcfg.max_frames}
            if s is not None:
                video_args["start_time"] = s
            if e is not None:
                video_args["end_time"] = e
        conversation.append({
            "role": "stream",
            "content": [{"type": "video", "video": video_args}],
        })
        for qa in seg.get("QAs", []):
            pair = qa["QA_pairs"][0] if isinstance(qa.get("QA_pairs"), list) \
                else qa.get("QA_pairs", qa)
            q, a = pair.get("Q", ""), pair.get("A", "")
            conversation.append({"role": "user", "content": q})
            out = processor(conversation, add_generation_prompt=True)

            if tcfg.baseline:
                prompt_text = out.original_text
                keep = minor = None
            else:
                gt = build_gt_selection(qa.get("relevance", []),
                                        len(hist_qs),
                                        bool(qa.get("is_visual", True)))
                vis, idx = parse_selection(gt)
                kept_q = [hist_qs[i] for i in idx if i < len(hist_qs)]
                kept_a = [hist_as[i] for i in idx if i < len(hist_qs)]
                prompt_text = rewrite_history(
                    out.original_text, vis, kept_q, kept_a, q)
                keep = minor = None
                if vis and out.images is not None and \
                        out.images.pixel_values.shape[0] > 0:
                    images = out.images
                    with torch.no_grad():
                        pv = torch.from_numpy(images.pixel_values).to(dev)
                        comp = cogreasoner.run_visual_compression(
                            model, cfg, tok,
                            cogreasoner.encode_images(
                                model, pv, images.grid_sizes,
                                images.merge_sizes),
                            pv, images.grid_sizes, images.merge_sizes,
                            images.modals, out.all_timestamps,
                            np.asarray(tok.encode(q), np.int32),
                            torch.Generator(device=dev).manual_seed(0))
                    keep = comp.keep_visual.cpu().numpy()
                    if comp.minor_frames is not None:
                        minor = comp.minor_frames.cpu().numpy()

            batch = pack_turn_batch(tok, cfg, prompt_text, a, out.images,
                                    keep, tcfg.max_seq_len,
                                    minor_frames=minor)
            if batch is not None:
                losses.append(trainer.train_turn(batch))
            conversation.append({"role": "assistant", "content": a})
            hist_qs.append(q)
            hist_as.append(a)
            if trainer.preempted():
                return losses
    return losses


def count_dataset_turns(query_dir: str) -> int:
    """Total QA turns across the query dir — one optimizer micro-step is
    taken per turn, so turns × epochs is the cosine schedule horizon.
    Reads both the internal spec and the published query-chain layout."""
    n = 0
    for fname in sorted(os.listdir(query_dir)):
        if not fname.endswith(".json"):
            continue
        try:
            with open(os.path.join(query_dir, fname)) as f:
                spec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(spec, dict) and "segments" in spec:
            n += sum(len(seg.get("QAs", []))
                     for seg in spec.get("segments", []))
        else:                       # published chains: chain 0 trains
            if isinstance(spec, dict):
                spec = spec.get("query_chains", [])
            if isinstance(spec, list) and spec:
                chain = spec[0] if isinstance(spec[0], list) else spec
                n += sum(1 for qa in chain if isinstance(qa, dict))
    return max(n, 1)


QUANTIZE_BASE = {"int8": (8, True), "nf4": (4, True), "int4": (4, False)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cogstream_tpu_torch train-stage2")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--video-dir", required=True)
    ap.add_argument("--query-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-epochs", type=int, default=1)
    ap.add_argument("--baseline", action="store_true",
                    help="C14 VideoLLaMA3-style finetune (no modules)")
    ap.add_argument("--quantize-base", choices=["none", "int8", "nf4",
                                                "int4"], default="none",
                    help="freeze the whole base quantized while LoRA "
                         "trains full precision (QLoRA; nf4 is the "
                         "reference recipe's scheme, group 64)")
    ap.add_argument("--sequence-parallel", type=int, default=1,
                    help=">1: ring sequence parallelism over that many "
                         "ranks (torchrun --nproc-per-node N): each turn "
                         "split along the sequence, weights replicated; a "
                         "power of two")
    ap.add_argument("--w8a8-forward", action="store_true",
                    help="run the frozen int8 base's decoder GEMMs W8A8 "
                         "(requires --quantize-base int8); activation "
                         "gradients pass straight through the rounding")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.w8a8_forward and args.quantize_base != "int8":
        ap.error("--w8a8-forward requires --quantize-base int8")

    from ..config import load_hf_config
    from ..evaluate.answer_generate import load_eval_spec
    from ..models.checkpoint import load_cogreasoner_from_hf
    from ..ops.quant import quantize_cogreasoner_
    from ..processor.processing import CogStreamProcessor
    from ..processor.tokenizer import load_tokenizer
    from .stage1 import join_training_world
    from .trainer import PreemptionGuard

    tcfg = Stage2Config(num_epochs=args.num_epochs, baseline=args.baseline,
                        sequence_parallel=args.sequence_parallel)
    check_parallel(tcfg, int(os.environ.get("WORLD_SIZE", "1")))
    cfg = load_hf_config(os.path.join(args.model_dir, "config.json"))
    if args.w8a8_forward:
        cfg = dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, w8a8_prefill=True))
    rank, device, mesh = join_training_world(
        args.device, sequence_parallel=tcfg.sequence_parallel)
    say = print if rank == 0 else quiet_log
    tp_mesh = None if tcfg.sequence_parallel > 1 else mesh
    # a quantized base is quantized whole, then sharded (its stores slice)
    model = load_cogreasoner_from_hf(
        args.model_dir, cfg, device=device,
        mesh=tp_mesh if args.quantize_base == "none" else None)
    if args.quantize_base != "none":
        bits, nf4 = QUANTIZE_BASE[args.quantize_base]
        quantize_cogreasoner_(model, bits, nf4=nf4)
        if tp_mesh is not None:
            model = shard_cogreasoner(model, cfg, tp_mesh)
    tok = load_tokenizer(args.model_dir, cfg.image_token_index,
                         cfg.text.vocab_size)
    processor = CogStreamProcessor(tok, cfg.processor)

    with PreemptionGuard() as guard:    # SIGTERM → save + clean exit
        trainer = Stage2Trainer(
            model, cfg, tok, tcfg, args.out,
            total_steps=(count_dataset_turns(args.query_dir)
                         * tcfg.num_epochs),
            stop_flag=guard, mesh=None if tp_mesh else mesh)
        for epoch in range(tcfg.num_epochs):
            for fname in sorted(os.listdir(args.query_dir)):
                if not fname.endswith(".json"):
                    continue
                # both layouts: internal specs pass through; published
                # query chains map to per-segment files of the video dir
                spec = load_eval_spec(
                    os.path.join(args.query_dir, fname), args.video_dir)
                video = os.path.join(
                    args.video_dir, spec.get("video", fname[:-5] + ".mp4"))
                try:
                    losses = train_stage2_video(
                        trainer, processor, video, spec.get("segments", []))
                    say(f"{fname}: {len(losses)} turns, "
                        f"mean loss {np.mean(losses or [0]):.4f}")
                except Exception as e:  # per-video resilience (ref :161-164)
                    if mesh is not None:
                        # a rank that skips a video would leave the others
                        # in its collectives: a failure ends the run
                        raise
                    say(f"{fname}: skipped ({type(e).__name__}: {e})")
                if stop_requested(guard, mesh):
                    break
            if stop_requested(guard, mesh):
                break
        trainer.finish()


if __name__ == "__main__":
    main()
