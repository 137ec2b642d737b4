"""CogReasoner multimodal core — port of ``cogstream_tpu/models/cogreasoner.py``.

The model container, random initialization and ``encode_images``, then
the Visual Stream Compression of one evaluation turn
(``run_visual_compression``, the reference's cogreasoner_chat.py:264-584):

1. cluster the video frames into events with temporal-semantic k-means
   and keep ``keyframes_per_event`` keyframes per event (ops/kmeans.py);
2. summarize each event with one batched LM forward and score it
   against the current question by cosine similarity
   (``event_relevance``: two forwards, through K3 on the card);
3. mean-pool the frames of unimportant events into their first patch
   (``pool_minor_frames``);
4. the pixel-diff keep mask: merged patches that barely changed since
   the previous frame are dropped, minor frames keep one token
   (``pixel_diff_keep_mask``, on the rows' device);
5. drop the masked ``<image>`` positions and splice the kept visual
   features into the embedding stream (``splice_and_compact``).

The one host sync of a turn is the cluster-assignment vector, which
writes the summary prompts' text (``build_summary_batch``). Unlike the
JAX package, the event batch is not padded to a power of two (see
``run_visual_compression``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import CogReasonerConfig
from . import qwen2
from .projector import Projector
from .qwen2 import Qwen2Model
from .vision_encoder import (VisionTower, quantize_vision_w8a8,
                             vision_encoder_forward)

SUMMARY_SYSTEM = (
    "You are a helpful assistant specializing in summarizing events from "
    "timestamped visual data."
)
SUMMARY_INSTRUCTION = (
    "Concisely list the key points of the event shown in the timestamped "
    "images, adhering strictly and honestly to the visual content. For "
    "each key point, identify relevant objects or actions, note any "
    "visible text, and specify the approximate timestamp(s). Provide an "
    "overview focusing on these key timestamped points."
)


class CogReasoner(nn.Module):
    """Vision tower + projector + Qwen2 decoder."""

    def __init__(self, text: Qwen2Model, vision: VisionTower,
                 projector: Projector):
        super().__init__()
        self.text = text
        self.vision = vision
        self.projector = projector


SERVING_FLAGS = ("w8a8_prefill", "w4a8_decode")


def with_serving_flags(model: CogReasoner,
                       cfg: CogReasonerConfig) -> CogReasoner:
    """``model`` with its decoder under ``cfg.text``'s serving flags
    (``w8a8_prefill``, ``w4a8_decode``). The port's forward reads them from
    ``model.text.cfg``, the JAX session from the config it is given: where
    the two differ, this returns a new CogReasoner over a shallow copy of
    the decoder (the same parameters and buffers) whose config carries
    ``cfg``'s flags; the caller's model is left as it is."""
    want = {k: getattr(cfg.text, k) for k in SERVING_FLAGS}
    if all(getattr(model.text.cfg, k) == v for k, v in want.items()):
        return model
    text = copy.copy(model.text)
    text.cfg = dataclasses.replace(model.text.cfg, **want)
    return CogReasoner(text, model.vision, model.projector)


def with_int8_tower(model: CogReasoner) -> CogReasoner:
    """``model`` with a W8A8 copy of its vision tower (the serving
    ``encoder_int8`` mode, ``quantize_vision_w8a8``): a new CogReasoner
    that shares the decoder and the projector, as the JAX package builds
    a new tree; the model's own tower is left as it is. A model whose
    tower is int8 already comes back as it is."""
    if model.vision.int8:
        return model
    return CogReasoner(model.text, quantize_vision_w8a8(model.vision),
                       model.projector)


@torch.no_grad()
def init_cogreasoner_params(cfg: CogReasonerConfig,
                            generator: torch.Generator,
                            device=None) -> CogReasoner:
    """Random weights from ``generator`` (on ``device``), at the config's
    dtypes, with the JAX initializers' distributions: linear kernels
    U(-1/sqrt(din), 1/sqrt(din)), zero biases, unit norm scales, token
    embeddings N(0, 0.02^2). The draws differ from JAX's (tests feed
    JAX-initialized weights through models/bridge.py instead)."""
    model = CogReasoner(
        text=Qwen2Model(cfg.text, device=device),
        vision=VisionTower(cfg.vision, device=device),
        projector=Projector(cfg.vision.hidden_size, cfg.text.hidden_size,
                            cfg.mm_projector_type, device,
                            cfg.text.torch_dtype))
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            s = 1.0 / math.sqrt(mod.in_features)
            mod.weight.uniform_(-s, s, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
    model.text.embed_tokens.normal_(0.0, 0.02, generator=generator)
    return model.requires_grad_(False)


def encode_images(model: CogReasoner, pixel_values, grid_sizes: np.ndarray,
                  merge_sizes: np.ndarray,
                  pad_to: Optional[int] = None) -> torch.Tensor:
    """Patch rows → projected LM-space features [N_merged, H_lm]."""
    feats = vision_encoder_forward(model.vision, pixel_values, grid_sizes,
                                   merge_sizes, pad_to=pad_to)
    return model.projector(feats.to(model.text.dtype))


def pixel_diff_keep_mask(
    pixel_values: torch.Tensor,  # [t*gh*gw, C*ps*ps] one video item's rows
    t: int,
    merged_per_frame: int,
    minor: torch.Tensor,         # [t] bool
    threshold: float = 0.1,
    min_tokens: int = 1,
    image_std: Tuple[float, ...] = (0.5, 0.5, 0.5),
    rescale_factor: float = 1.0 / 255.0,
) -> torch.Tensor:
    """[t, merged_per_frame] bool keep mask from inter-frame pixel diff,
    on the rows' device: frame 0 keeps all tokens, frames whose diff
    mask is empty keep the first ``min_tokens``, minor frames keep
    exactly token 0 (f32, byte-exact with the JAX package's device mask
    and its host mirror). The engine and the streaming session run it
    on the card."""
    x = pixel_values.reshape(t, merged_per_frame, -1)
    if x.dtype == torch.uint8:
        C = len(image_std)
        scale = torch.tensor([rescale_factor / s for s in image_std],
                             dtype=torch.float32,
                             device=x.device)[None, None, :, None]
        x = (x.reshape(t, merged_per_frame, C, -1).to(torch.float32)
             * scale).reshape(t, merged_per_frame, -1)
    else:
        x = x.to(torch.float32)
    diff = torch.abs(x[1:] - x[:-1]).mean(dim=-1) * 255.0
    diff = torch.cat([torch.full((1, merged_per_frame), threshold + 1.0,
                                 dtype=torch.float32, device=x.device),
                      diff], dim=0)
    mask = diff > threshold
    needs_pad = mask.sum(dim=1) < min_tokens
    col = torch.arange(merged_per_frame, device=x.device) < min_tokens
    mask = torch.where(needs_pad[:, None], mask | col[None, :], mask)
    minor_row = torch.arange(merged_per_frame, device=x.device) == 0
    return torch.where(minor.to(torch.bool)[:, None], minor_row[None, :],
                       mask)


# ---------------------------------------------------------------------------
# event clustering (device) + summary prompt construction (host)
# ---------------------------------------------------------------------------

def num_events_for(total_frames: int, cfg: CogReasonerConfig) -> int:
    """ceil(T / frames_per_event); compression only runs when this is
    >= min_events_for_compression."""
    return math.ceil(total_frames / cfg.compression.frames_per_event)


def compression_active(total_frames: int, cfg: CogReasonerConfig) -> bool:
    return (cfg.use_token_compression
            and num_events_for(total_frames, cfg)
            >= cfg.compression.min_events_for_compression)


class SummaryBatch(NamedTuple):
    """Host-built batch of K event-summary prompts, rows padded to one
    length.

    ``feat_src[k, i]`` is the frame-feature row (flat index into the
    [T*P, H] frame features) to splice at position i, or -1 for a text
    token. ``positions`` is -1 on padding.
    """

    input_ids: np.ndarray   # [K, L]
    feat_src: np.ndarray    # [K, L]
    positions: np.ndarray   # [K, L]


def build_summary_batch(
    tokenizer,
    assignments: np.ndarray,     # [T] cluster ids (host copy)
    timestamps: np.ndarray,      # [T] seconds
    patches_per_frame: int,
    num_events: int,
    image_token: str = "<image>",
    max_frames_per_event: int = 0,   # >0: uniform-subsample big events
) -> SummaryBatch:
    """Tokenize the K event-summary prompts with per-frame feature slots
    (the JAX function without its ``pad_events_to``): system header,
    per-frame ``Time X.Xs:<image>*P`` joined by commas, instruction,
    assistant cue; rows padded to a multiple of 64 tokens.
    ``max_frames_per_event`` bounds a skewed cluster's prompt by uniform
    subsampling."""
    img_id = tokenizer.image_token_id
    seqs: List[List[int]] = []
    srcs: List[List[int]] = []
    for k in range(num_events):
        members = np.nonzero(assignments == k)[0]
        if max_frames_per_event and len(members) > max_frames_per_event:
            sel = np.linspace(0, len(members) - 1, max_frames_per_event,
                              dtype=int)
            members = members[sel]
        parts = [
            "<|im_start|>system\n" + SUMMARY_SYSTEM + "<|im_end|>\n"
            "<|im_start|>user\n"
        ]
        for j, fi in enumerate(members):
            stamp = f"Time {float(timestamps[fi]):.1f}s:"
            parts.append(stamp + image_token * patches_per_frame
                         + ("," if j < len(members) - 1 else ""))
        parts.append("\n" + SUMMARY_INSTRUCTION + "<|im_end|>\n"
                     "<|im_start|>assistant")
        ids = tokenizer.encode("".join(parts))
        src = [-1] * len(ids)
        # map image-token occurrences to flat frame-feature rows, in order
        slot = 0
        for i, tid in enumerate(ids):
            if tid == img_id:
                frame = members[slot // patches_per_frame]
                src[i] = (int(frame) * patches_per_frame
                          + slot % patches_per_frame)
                slot += 1
        if slot != len(members) * patches_per_frame:
            raise ValueError(f"event {k}: {slot} image tokens for "
                             f"{len(members)} frames of {patches_per_frame}")
        seqs.append(ids)
        srcs.append(src)

    L = max(len(s) for s in seqs)
    L = max(8, -(-L // 64) * 64)  # bucket to multiples of 64
    ids_arr = np.zeros((num_events, L), np.int32)
    src_arr = np.full((num_events, L), -1, np.int32)
    pos_arr = np.full((num_events, L), -1, np.int32)
    for k, (ids, src) in enumerate(zip(seqs, srcs)):
        ids_arr[k, :len(ids)] = ids
        src_arr[k, :len(src)] = src
        pos_arr[k, :len(ids)] = np.arange(len(ids))
    return SummaryBatch(ids_arr, src_arr, pos_arr)


def _masked_mean(hidden: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    valid = (pos >= 0).to(torch.float32)[..., None]
    return (torch.sum(hidden.to(torch.float32) * valid, dim=1)
            / torch.clamp(torch.sum(valid, dim=1), min=1.0))


def event_relevance(
    model: CogReasoner,
    cfg: CogReasonerConfig,
    frame_features: torch.Tensor,   # [T*P, H] projected features
    summary: SummaryBatch,
    question_ids: np.ndarray,       # [Lq] current-question token ids
) -> torch.Tensor:
    """Cosine similarity per event [K] f32 between each event summary's
    mean hidden state (one [K, L] batch forward) and the current
    question's (one [1, Lq] forward, truncated to 128 tokens and padded
    to a multiple of 32). An event is unimportant when its similarity is
    below ``cfg.compression.similarity_threshold``. Both forwards are
    cache-free, so they run K3 on the card; padding carries position -1,
    which K3 masks."""
    text = model.text
    dev = text.device
    ids = torch.from_numpy(summary.input_ids).to(dev)
    src = torch.from_numpy(summary.feat_src).to(dev)
    pos = torch.from_numpy(summary.positions).to(dev)
    emb = qwen2.embed(text, ids)
    feats = frame_features.to(emb.dtype)
    spliced = torch.where((src >= 0)[..., None],
                          feats[src.clamp(min=0).to(torch.int64)], emb)
    hidden, _ = qwen2.qwen2_forward(text, spliced, pos)
    pooled = _masked_mean(hidden, pos)                           # [K, H]

    qi = np.asarray(question_ids, np.int32)[:128]
    Lq = max(32, -(-len(qi) // 32) * 32)
    q_ids = np.zeros((1, Lq), np.int32)
    q_ids[0, :len(qi)] = qi
    q_pos = np.full((1, Lq), -1, np.int32)
    q_pos[0, :len(qi)] = np.arange(len(qi))
    q_pos_t = torch.from_numpy(q_pos).to(dev)
    q_hidden, _ = qwen2.qwen2_forward(
        text, qwen2.embed(text, torch.from_numpy(q_ids).to(dev)), q_pos_t)
    q = _masked_mean(q_hidden, q_pos_t)                          # [1, H]
    return torch.sum(pooled * q, dim=-1) / (
        torch.linalg.norm(pooled, dim=-1) * torch.linalg.norm(q, dim=-1)
        + 1e-8)


def minor_frame_mask(
    assignments: torch.Tensor,         # [T]
    unimportant_events: torch.Tensor,  # [K] bool
    keyframe_idx: torch.Tensor,        # [K, k] int32
    keyframe_valid: torch.Tensor,      # [K, k] bool
    total_frames: int,
) -> torch.Tensor:
    """[T] bool — frames to squash to one token: members of unimportant
    events, excluding each event's keyframes."""
    unimp = unimportant_events[assignments.to(torch.int64)]
    key_mask = torch.zeros((total_frames,), dtype=torch.bool,
                           device=assignments.device)
    flat_idx = keyframe_idx.reshape(-1).to(torch.int64)
    key_mask[flat_idx[keyframe_valid.reshape(-1)]] = True
    return unimp & ~key_mask


def pool_minor_frames(
    mm_features: torch.Tensor,   # [T*P, H]
    minor: torch.Tensor,         # [T] bool
    patches_per_frame: int,
) -> torch.Tensor:
    """Mean-pool each minor frame's patches into its patch 0 (the mean
    sums in f32 and rounds once to the features' dtype)."""
    T = minor.shape[0]
    x = mm_features.reshape(T, patches_per_frame, -1)
    pooled = x.to(torch.float32).mean(dim=1).to(x.dtype)
    first = torch.where(minor[:, None], pooled, x[:, 0])
    x = torch.cat([first[:, None], x[:, 1:]], dim=1)
    return x.reshape(T * patches_per_frame, -1)


# ---------------------------------------------------------------------------
# compaction + splice
# ---------------------------------------------------------------------------

class MultimodalInputs(NamedTuple):
    embeds: torch.Tensor      # [S, H] compacted embeddings (padded)
    positions: torch.Tensor   # [S] int32; -1 on padding
    length: torch.Tensor      # [] int real length
    last_index: torch.Tensor  # [] int index of the last real token


def splice_and_compact(
    model: CogReasoner,
    cfg: CogReasonerConfig,
    input_ids: torch.Tensor,     # [S] int32 (image tokens pre-expanded)
    valid: torch.Tensor,         # [S] bool — real (non-padding) slots
    mm_features: torch.Tensor,   # [N, H] visual features in order
    keep_visual: torch.Tensor,   # [N] bool — compression keep mask
) -> MultimodalInputs:
    """Drop the masked ``<image>`` positions, embed, splice the kept
    visual features in order. A stable sort moves dropped slots to the
    tail; the output keeps length S with positions -1 beyond the new
    length. Feature indices clamp to the feature count, as JAX's
    gathers do."""
    img_id = cfg.image_token_index
    S = input_ids.shape[0]
    dev = input_ids.device
    n_feat = mm_features.shape[0]
    is_img = (input_ids == img_id) & valid
    vis_idx = torch.cumsum(is_img.to(torch.int32), dim=0) - 1
    keep = torch.where(is_img, keep_visual[vis_idx.clamp(0, n_feat - 1)],
                       valid)

    order = torch.argsort((~keep).to(torch.int8), stable=True)
    new_ids = input_ids[order]
    new_is_img = is_img[order]
    new_len = torch.sum(keep.to(torch.int32))
    slot = torch.arange(S, device=dev)
    valid = slot < new_len

    feat_order = torch.argsort((~keep_visual).to(torch.int8), stable=True)
    kept_feats = mm_features[feat_order]
    img_rank = torch.cumsum((new_is_img & valid).to(torch.int32), dim=0) - 1

    emb = qwen2.embed(model.text, torch.where(valid, new_ids,
                                              torch.zeros_like(new_ids)))
    spliced = torch.where(
        (new_is_img & valid)[:, None],
        kept_feats[img_rank.clamp(0, n_feat - 1)].to(emb.dtype), emb)
    positions = torch.where(valid, slot, -1).to(torch.int32)
    return MultimodalInputs(spliced, positions, new_len, new_len - 1)


# ---------------------------------------------------------------------------
# the per-turn pipeline (batch size 1, like the reference)
# ---------------------------------------------------------------------------

@dataclass
class VisualCompressionResult:
    keep_visual: torch.Tensor              # [N] bool
    mm_features: torch.Tensor              # [N, H] (minor frames pooled)
    minor_frames: Optional[torch.Tensor]   # [T] bool or None
    similarities: Optional[torch.Tensor]   # [K] or None


def run_visual_compression(
    model: CogReasoner,
    cfg: CogReasonerConfig,
    tokenizer,
    mm_features: torch.Tensor,    # [N, H] projected features (all items)
    pixel_values: torch.Tensor,   # patch rows (all items), on the device
    grid_sizes: np.ndarray,       # [B, 3]
    merge_sizes: np.ndarray,      # [B]
    modals: Sequence[str],
    timestamps: np.ndarray,       # [T_total] one stamp per video frame
    question_ids: np.ndarray,     # current-question token ids
    generator: Optional[torch.Generator] = None,
) -> VisualCompressionResult:
    """Visual Stream Compression for one turn. ``mm_features`` covers
    all items (images keep all their tokens); clustering treats the
    video frames as one stream. The event machinery runs only on pure
    video with one merged-grid size across items, K < T and enough
    events; the pixel-diff mask runs on every multi-frame video item
    regardless. ``generator`` draws the k-means seeds."""
    from ..ops.kmeans import kmeans_with_time, select_event_keyframes

    grid_sizes = np.asarray(grid_sizes)
    merge_sizes = np.asarray(merge_sizes)
    total_frames = int(timestamps.shape[0])
    n_tokens = int(mm_features.shape[0])
    dev = mm_features.device
    cc = cfg.compression

    if total_frames == 0 or not cfg.use_token_compression:
        keep = torch.ones((n_tokens,), dtype=torch.bool, device=dev)
        return VisualCompressionResult(keep, mm_features, None, None)

    merged_counts = {
        (int(gh) // int(ms)) * (int(gw) // int(ms))
        for (t, gh, gw), ms, m in zip(grid_sizes, merge_sizes, modals)
        if m == "video"}
    K = num_events_for(total_frames, cfg)
    uniform_video = (all(m == "video" for m in modals)
                     and len(merged_counts) == 1
                     and n_tokens % total_frames == 0
                     and n_tokens // total_frames in merged_counts)
    events_on = (uniform_video and K < total_frames
                 and compression_active(total_frames, cfg))

    minor = None
    sim = None
    pooled = mm_features
    if events_on:
        P = n_tokens // total_frames
        frames = mm_features.reshape(total_frames, P, -1)
        ts = torch.as_tensor(np.asarray(timestamps, np.float32), device=dev)
        km = kmeans_with_time(frames, ts, K, generator,
                              alpha=cc.kmeans_alpha,
                              max_iters=cc.kmeans_max_iters)
        key_idx, key_valid = select_event_keyframes(
            frames, km.centers, km.assignments, k=cc.keyframes_per_event)
        # host sync: the assignments write the summary prompts. K is not
        # padded: JAX pads it to a power of two so that one compiled
        # program serves a range of K, and a pad row costs a full-length
        # forward, which eager execution has no reason to pay
        summary = build_summary_batch(
            tokenizer, km.assignments.cpu().numpy(), np.asarray(timestamps),
            P, K, max_frames_per_event=cc.summary_max_frames_per_event)
        sim = event_relevance(model, cfg, mm_features, summary,
                              np.asarray(question_ids, np.int32))
        unimportant = sim < cc.similarity_threshold
        minor = minor_frame_mask(km.assignments, unimportant, key_idx,
                                 key_valid, total_frames)
        pooled = pool_minor_frames(mm_features, minor, P)
    minor_for_mask = (minor if minor is not None
                      else torch.zeros((total_frames,), dtype=torch.bool,
                                       device=dev))

    keeps: List[torch.Tensor] = []
    row_offset = 0
    frame_offset = 0
    for (t, gh, gw), ms, modal in zip(grid_sizes, merge_sizes, modals):
        t, gh, gw, ms = int(t), int(gh), int(gw), int(ms)
        rows = t * gh * gw
        merged = (gh // ms) * (gw // ms)
        if modal == "video" and t > 1:
            mask = pixel_diff_keep_mask(
                pixel_values[row_offset:row_offset + rows], t, merged,
                minor_for_mask[frame_offset:frame_offset + t],
                threshold=cc.pixel_diff_threshold,
                min_tokens=cc.min_tokens_per_frame,
                image_std=tuple(cfg.vision.image_std),
                rescale_factor=cfg.vision.rescale_factor)
            keeps.append(mask.reshape(-1))
        else:
            keeps.append(torch.ones((t * merged,), dtype=torch.bool,
                                    device=dev))
        frame_offset += t
        row_offset += rows
    keep = (torch.cat(keeps) if keeps
            else torch.ones((0,), dtype=torch.bool, device=dev))
    return VisualCompressionResult(keep, pooled, minor, sim)
