"""Stage-2 training pieces: video-text interleaved reasoning and the
plain baseline finetune (port of ``cogstream_tpu/train/stage2.py``).

Per QA turn the selector is teacher-forced with the ground-truth
chain-of-inference, the prompt is rewritten to the selected history, the
visual stream is compressed, and CE lands on the answer span only. The
host assembles the static-shape batch (:func:`pack_turn_batch`, with the
exact pooling plan of :func:`build_pool_arrays`); the device runs
``train/multimodal.py``'s loss and the LoRA update
(:class:`Stage2Trainer`).

Not ported yet: ``train_stage2_video``, ``count_dataset_turns`` and
``main`` wait for the video processor and the visual compression pass
(ROADMAP Queue 1 #1 and #7); sequence and tensor parallelism raise
(Queue 1 #9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CogReasonerConfig, LoRAConfig
from ..models.lora import init_cogreasoner_lora
from ..models.vision_encoder import build_vision_metadata
from ..runtime.history import selection_string
from . import checkpoint as ckpt
from .multimodal import multimodal_loss_fn
from .trainer import (IGNORE_INDEX, PARALLEL_MSG, init_train_state,
                      make_optimizer, make_train_step, to_device)


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
    # >1: ring sequence parallelism in the JAX package; not ported
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
    micro-step per packed turn."""

    def __init__(self, model, cfg: CogReasonerConfig, tokenizer,
                 tcfg: Stage2Config, out_dir: str,
                 total_steps: Optional[int] = None, log=print,
                 stop_flag=None, lora_cfg: Optional[LoRAConfig] = None,
                 lora: Optional[Dict] = None):
        """``lora_cfg`` defaults to the reference recipe with the
        projector adapted unless ``tcfg.baseline``; ``lora`` is the
        initial adapter tree (default: ``init_cogreasoner_lora`` from
        ``tcfg.seed``)."""
        if tcfg.sequence_parallel > 1 or (tcfg.model_parallel or 1) > 1 \
                or (tcfg.data_parallel or 1) > 1:
            raise NotImplementedError(PARALLEL_MSG)
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
        self.state = init_train_state(self.tx, lora)
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
                                      dropout_seed=seed)

        self._step = make_train_step(
            self.tx, loss,
            dropout_seed=tcfg.seed ^ 0x5EED if rate > 0 else None)

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
        if self.stop_flag is not None and self.stop_flag():
            ckpt.save_train_state(self.out_dir, self.state)
            self.log(f"preempted at step {self.state.step}: train state "
                     "saved — rerun to resume")
            return True
        return False

    def finish(self):
        ckpt.save_train_state(self.out_dir, self.state)
        ckpt.save_lora_adapter(self.out_dir, self.state.lora,
                               name="full_module")
