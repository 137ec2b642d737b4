"""CogReasoner multimodal core (port of the serving-path pieces of
``cogstream_tpu/models/cogreasoner.py``): the model container, random
initialization, ``encode_images``, the host pixel-diff keep mask, and
the event-summary prompt strings."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import CogReasonerConfig
from .projector import Projector
from .qwen2 import Qwen2Model
from .vision_encoder import VisionTower, vision_encoder_forward

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


def pixel_diff_keep_mask_host(
    pixel_values: np.ndarray,   # [t*gh*gw, C*ps*ps] host patch rows
    t: int,
    merged_per_frame: int,
    minor: np.ndarray,          # [t] bool
    threshold: float = 0.1,
    min_tokens: int = 1,
    image_std: Tuple[float, ...] = (0.5, 0.5, 0.5),
    rescale_factor: float = 1.0 / 255.0,
) -> np.ndarray:
    """[t, merged_per_frame] bool keep-mask from inter-frame pixel diff:
    frame 0 keeps all tokens, frames whose diff mask is empty keep the
    first ``min_tokens``, minor frames keep exactly token 0 (host numpy,
    f32 — byte-exact with the JAX package's host mirror)."""
    x = np.asarray(pixel_values).reshape(t, merged_per_frame, -1)
    if x.dtype == np.uint8:
        C = len(image_std)
        scale = np.asarray([rescale_factor / s for s in image_std],
                           np.float32)[None, None, :, None]
        x = (x.reshape(t, merged_per_frame, C, -1).astype(np.float32)
             * scale).reshape(t, merged_per_frame, -1)
    else:
        x = x.astype(np.float32)
    diff = np.abs(x[1:] - x[:-1]).mean(axis=-1) * 255.0
    diff = np.concatenate(
        [np.full((1, merged_per_frame), threshold + 1.0, np.float32),
         diff], axis=0)
    mask = diff > threshold
    needs_pad = mask.sum(axis=1) < min_tokens
    col = np.arange(merged_per_frame) < min_tokens
    mask = np.where(needs_pad[:, None], mask | col[None, :], mask)
    minor_row = np.arange(merged_per_frame) == 0
    mask = np.where(np.asarray(minor, bool)[:, None],
                    minor_row[None, :], mask)
    return mask
