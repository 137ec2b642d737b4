"""Any-resolution image/video preprocessing (copy of
``cogstream_tpu/processor/image_processor.py``).

* smart resize — snap (H, W) to multiples of ``patch_size * merge_size``
  under a *global* visual-token budget (min_tokens/max_tokens);
* PIL bicubic resize (bit-accurate with the HF reference);
* rescale 1/255 and normalize with mean/std 0.5;
* patchify to flat ``[t*gh*gw, C*patch*patch]`` rows in merge-block
  order, ready for the vision tower's patch embedding.

Two changes from the original, so that a machine without Pillow runs
the processor on frames already at their target size: PIL is imported
inside ``resize_bicubic``, and a frame that already has the target (H,
W) is returned unchanged (Pillow's ``Image.resize`` returns a copy in
exactly that case; tests/test_torch_host.py pins the identity). A PIL
image is recognized only once PIL is imported, as no PIL image can
exist before.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..config import ProcessorConfig

ArrayLike = Union[np.ndarray, "PIL.Image.Image"]


def _is_pil(x) -> bool:
    pil = sys.modules.get("PIL.Image")
    return pil is not None and isinstance(x, pil.Image)


def _frame_hw(image: ArrayLike) -> Tuple[int, int]:
    """Height/width of one frame. Accepts HWC/CHW numpy or PIL."""
    if _is_pil(image):
        w, h = image.size
        return h, w
    a = np.asarray(image)
    if a.ndim == 2:
        return a.shape[0], a.shape[1]
    if a.ndim == 3:
        # channels-first iff the first dim looks like a channel count
        if a.shape[0] in (1, 3, 4) and a.shape[2] not in (1, 3, 4):
            return a.shape[1], a.shape[2]
        return a.shape[0], a.shape[1]
    raise ValueError(f"Cannot infer frame size from shape {a.shape}")


def _num_frames(item: Union[ArrayLike, Sequence[ArrayLike]]) -> int:
    if isinstance(item, (list, tuple)):
        return len(item)
    a = np.asarray(item)
    return a.shape[0] if a.ndim == 4 else 1


def _first_frame(item: Union[ArrayLike, Sequence[ArrayLike]]) -> ArrayLike:
    if isinstance(item, (list, tuple)):
        return item[0]
    a = np.asarray(item)
    return a[0] if a.ndim == 4 else a


def smart_resize_single_factor(
    items: Sequence[Union[ArrayLike, Sequence[ArrayLike]]],
    factor: int,
    min_tokens: int,
    max_tokens: int,
    num_frames_override: Optional[int] = None,
) -> List[Tuple[int, int]]:
    """Target (H, W) per item when all items share one merge factor.

    Semantics of ``simple_batched_resize``
    (image_processing_videollama3.py:93-131): each of the N total frames
    gets an equal share of the global pixel budget; sizes snap to
    multiples of ``factor`` (floor when shrinking, ceil when growing).
    ``num_frames_override`` budgets against a total larger than the
    items at hand — chunked ingest sizes every chunk as if the whole
    window were one batch.
    """
    min_pixels = min_tokens * factor * factor
    max_pixels = max_tokens * factor * factor
    num_frames_total = (num_frames_override if num_frames_override
                        else sum(_num_frames(it) for it in items))
    out: List[Tuple[int, int]] = []
    for it in items:
        h, w = _frame_hw(_first_frame(it))
        h_bar = round(h / factor) * factor
        w_bar = round(w / factor) * factor
        budget = max_pixels // max(num_frames_total, 1)
        if h_bar * w_bar > budget:
            beta = math.sqrt((h * w) / budget)
            h_bar = math.floor(h / beta / factor) * factor
            w_bar = math.floor(w / beta / factor) * factor
        if h_bar * w_bar < min_pixels:
            beta = math.sqrt(min_pixels / (h * w))
            h_bar = math.ceil(h * beta / factor) * factor
            w_bar = math.ceil(w * beta / factor) * factor
        out.append((h_bar, w_bar))
    return out


def smart_resize_mixed_factors(
    items: Sequence[Union[ArrayLike, Sequence[ArrayLike]]],
    factors: Sequence[int],
    min_tokens: int,
    max_tokens: int,
) -> List[Tuple[int, int]]:
    """Target sizes when items carry different merge factors
    (``batched_resize``, image_processing_videollama3.py:134-173): scale
    everything down uniformly only if the *total* token count overflows
    the budget."""
    sizes = []
    for it in items:
        h, w = _frame_hw(_first_frame(it))
        sizes.append((_num_frames(it), h, w))

    total_tokens = sum(
        t * math.ceil(h / f) * math.ceil(w / f)
        for (t, h, w), f in zip(sizes, factors)
    )
    out: List[Tuple[int, int]] = []
    if total_tokens > max_tokens:
        beta = math.sqrt(total_tokens / max_tokens)
        for (_, h, w), f in zip(sizes, factors):
            out.append((math.floor(h / beta / f) * f, math.floor(w / beta / f) * f))
    else:
        for (_, h, w), f in zip(sizes, factors):
            out.append((round(h / f) * f, round(w / f) * f))
    return out


def _to_hwc_uint8(frame: ArrayLike) -> np.ndarray:
    """Convert one frame to HWC uint8 RGB."""
    if _is_pil(frame):
        return np.asarray(frame.convert("RGB"))
    a = np.asarray(frame)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    elif a.ndim == 3 and a.shape[0] in (1, 3, 4) and a.shape[2] not in (1, 3, 4):
        a = np.transpose(a, (1, 2, 0))
    if a.shape[2] == 1:
        a = np.repeat(a, 3, axis=2)
    elif a.shape[2] == 4:
        a = a[..., :3]
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    return a


def resize_bicubic(frame_hwc: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """PIL bicubic resize on host — identical to the HF reference path
    (transformers.image_transforms.resize with resample=BICUBIC)."""
    th, tw = target_hw
    if frame_hwc.shape[:2] == (th, tw):
        return frame_hwc
    from PIL import Image

    img = Image.fromarray(frame_hwc)
    img = img.resize((tw, th), resample=Image.Resampling.BICUBIC)
    return np.asarray(img)


def patchify(
    frames_chw: np.ndarray,
    patch_size: int,
    merge_size: int,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Flatten [T, C, H, W] into per-patch rows in merge-block order.

    Layout matches the reference patch serialization
    (image_processing_videollama3.py:332-345): patches are emitted
    grouped by (gh/merge, gw/merge) block, then the merge_size x
    merge_size sub-patches row-major inside each block — so the vision
    encoder's merge-window downsample sees contiguous groups.
    """
    t, c, h, w = frames_chw.shape
    gh, gw = h // patch_size, w // patch_size
    x = frames_chw.reshape(
        t, c,
        gh // merge_size, merge_size, patch_size,
        gw // merge_size, merge_size, patch_size,
    )
    x = x.transpose(0, 2, 5, 3, 6, 1, 4, 7)
    return x.reshape(t * gh * gw, c * patch_size * patch_size), (t, gh, gw)


def patchify_hwc(
    frames_thwc: np.ndarray,
    patch_size: int,
    merge_size: int,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """``patchify`` taking ``[T, H, W, C]`` input — identical output rows.

    The resize stage produces HWC frames; going straight from there to
    patch rows is ONE permuted copy, skipping the intermediate
    HWC→CHW transpose-copy (and, done on uint8, it moves 4x fewer
    bytes than the old float32 ordering).
    """
    t, h, w, c = frames_thwc.shape
    gh, gw = h // patch_size, w // patch_size
    x = frames_thwc.reshape(
        t,
        gh // merge_size, merge_size, patch_size,
        gw // merge_size, merge_size, patch_size,
        c,
    )
    x = x.transpose(0, 1, 4, 2, 5, 7, 3, 6)
    return x.reshape(t * gh * gw, c * patch_size * patch_size), (t, gh, gw)


@dataclass
class ImageBatch:
    """Flat multi-image batch: concatenated patch rows plus per-item grids."""

    pixel_values: np.ndarray      # [sum(t*gh*gw), C*patch*patch] float32
    grid_sizes: np.ndarray        # [N, 3] int32 (t, gh, gw)
    merge_sizes: np.ndarray       # [N] int32
    modals: List[str]             # "image" | "video" per item

    @property
    def num_patches_per_item(self) -> np.ndarray:
        return self.grid_sizes.prod(axis=1)


class ImageProcessor:
    """The C1 component: dynamic-resolution preprocess → ImageBatch."""

    def __init__(self, config: Optional[ProcessorConfig] = None):
        self.config = config or ProcessorConfig()

    def __call__(
        self,
        items: Sequence[Union[ArrayLike, Sequence[ArrayLike]]],
        modals: Sequence[str],
        merge_sizes: Optional[Sequence[int]] = None,
        raw_uint8: bool = False,
        target_sizes: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> ImageBatch:
        """``raw_uint8=True`` skips host-side rescale/normalize and
        emits uint8 patch rows — 4x less host->device traffic; the
        vision encoder normalizes on device (models/vision_encoder.py)
        with identical arithmetic. ``target_sizes`` pins precomputed
        (H, W) targets (chunked ingest: one budget for the whole
        window, identical grids across chunks)."""
        cfg = self.config
        if merge_sizes is None:
            merge_sizes = [
                cfg.image_merge_size if m == "image" else cfg.video_merge_size
                for m in modals
            ]
        factors = [cfg.patch_size * ms for ms in merge_sizes]
        if target_sizes is not None:
            target_sizes = list(target_sizes)
        elif len(set(merge_sizes)) <= 1:
            target_sizes = smart_resize_single_factor(
                items, factors[0] if factors else cfg.patch_size,
                cfg.min_tokens, cfg.max_tokens)
        else:
            target_sizes = smart_resize_mixed_factors(
                items, factors, cfg.min_tokens, cfg.max_tokens)

        # Fused affine normalize: (x*rescale - mean)/std == x*A + B with
        # A = rescale/std, B = -mean/std (computed in float64, cast
        # once). For the reference's mean=std=0.5 this is BIT-IDENTICAL
        # to the two-step form — dividing by 0.5 is an exact power-of-2
        # scale, and float rounding commutes with exact scaling — which
        # the golden test vs the actual HF module checks at atol=1e-6.
        mean = np.asarray(cfg.image_mean, dtype=np.float64).reshape(3)
        std = np.asarray(cfg.image_std, dtype=np.float64).reshape(3)
        scale = (cfg.rescale_factor / std).astype(np.float32).reshape(1, 3, 1)
        shift = (-mean / std).astype(np.float32).reshape(1, 3, 1)

        all_patches: List[np.ndarray] = []
        grid_sizes_out: List[Tuple[int, int, int]] = []
        for item, ms, target in zip(items, merge_sizes, target_sizes):
            if isinstance(item, (list, tuple)):
                frames = item
                if (len(frames) > 1
                        and isinstance(frames[0], np.ndarray)
                        and frames[0].ndim == 3
                        and frames[0].shape[0] in (1, 3, 4)
                        and frames[0].shape[2] not in (1, 3, 4)
                        and all(isinstance(f, np.ndarray)
                                and f.shape == frames[0].shape
                                for f in frames[1:])):
                    # uniform CHW frame list (the load_video contract):
                    # one bulk TCHW→THWC copy instead of a strided
                    # per-frame copy inside PIL's fromarray
                    frames = list(np.ascontiguousarray(
                        np.stack(frames).transpose(0, 2, 3, 1)))
            else:
                arr = np.asarray(item)
                if arr.ndim == 4:
                    if arr.shape[1] in (1, 3, 4) and arr.shape[3] not in (1, 3, 4):
                        # bulk TCHW→THWC once: per-frame transposed
                        # views would pay a strided copy inside PIL
                        arr = np.ascontiguousarray(arr.transpose(0, 2, 3, 1))
                    frames = list(arr)
                else:
                    frames = [item]
            th, tw = target
            resized = np.empty((len(frames), th, tw, 3), np.uint8)
            for i, f in enumerate(frames):
                resized[i] = resize_bicubic(_to_hwc_uint8(f), target)
            # patchify on uint8 (4x less copy traffic than float32),
            # then one astype + two in-place passes for the normalize
            patches, grid = patchify_hwc(resized, cfg.patch_size, ms)
            if not raw_uint8:
                patches = patches.astype(np.float32)
                view = patches.reshape(-1, 3, cfg.patch_size ** 2)
                view *= scale
                view += shift
            all_patches.append(patches)
            grid_sizes_out.append(grid)

        out_dtype = np.uint8 if raw_uint8 else np.float32
        return ImageBatch(
            pixel_values=np.concatenate(all_patches, axis=0)
            if all_patches else np.zeros((0, 3 * cfg.patch_size ** 2),
                                         out_dtype),
            grid_sizes=np.asarray(grid_sizes_out, dtype=np.int32).reshape(-1, 3),
            merge_sizes=np.asarray(list(merge_sizes), dtype=np.int32),
            modals=list(modals),
        )
