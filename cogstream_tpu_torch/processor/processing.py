"""Conversation → model inputs (copy of
``cogstream_tpu/processor/processing.py``; tests/test_torch_host.py holds
its outputs byte-exact to the original's).

Rebuild of ``Videollama3Qwen2Processor``
(the reference's `processing_cogreasoner.py:223-956`):

* loads media referenced by messages (videos via the host video loader)
  and accumulates **global** timestamps across stream segments with the
  reference's +1 s inter-segment offset (ref :461-507);
* renders the chat template (processor/chat_template.py), expands each
  ``<image>`` into ``prod(grid/merge)`` per-patch tokens (ref :707-730);
* builds training labels with the ``stream``-role negative sampling
  scheme (ref :530-608);
* extracts dialogue history (hist_qs / hist_as / current_question,
  ref :936-956).

Everything here is host-side; outputs are numpy plus the ImageBatch.
"""

from __future__ import annotations

import copy
import json
import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import ProcessorConfig
from .chat_template import DEFAULT_IMAGE_TOKEN, GENERATION_PROMPT, render_chat
from .image_processor import ImageBatch, ImageProcessor
from . import video_loader

IGNORE_INDEX = -100

Conversation = List[Dict[str, Any]]


@dataclass
class ProcessorOutput:
    input_ids: np.ndarray                  # [S] int32
    labels: Optional[np.ndarray]           # [S] int32 or None
    images: Optional[ImageBatch]
    hist_qs: List[str]
    hist_as: List[str]
    current_question: str
    all_timestamps: np.ndarray             # [T_video_frames] float32
    total_image_num: int
    original_text: str


class CogStreamProcessor:
    """Host-side preprocessing front end."""

    def __init__(self, tokenizer, config: Optional[ProcessorConfig] = None):
        self.tokenizer = tokenizer
        self.config = config or ProcessorConfig()
        self.image_processor = ImageProcessor(self.config)
        self.generation_prompt_ids = tokenizer.encode(GENERATION_PROMPT)

    # -- media loading -------------------------------------------------------

    def load_multimodal(self, conversation: Conversation
                        ) -> Tuple[Conversation, np.ndarray]:
        """Resolve media references in-place (copy) and return global
        timestamps. Mirrors ``_load_multimodal_data`` (ref :431-509):
        contents referencing the same media id are loaded once over the
        union time range; global stamps advance by +1 s between
        segments."""
        conversation = copy.deepcopy(conversation)
        groups: Dict[str, List[dict]] = defaultdict(list)
        for message in conversation:
            if not isinstance(message.get("content"), (list, tuple)):
                continue
            for content in message["content"]:
                if not isinstance(content, dict):
                    continue
                ctype = content.get("type")
                if ctype in ("image", "video") and isinstance(
                        content.get(ctype), dict):
                    args = content[ctype]
                    data_id = json.dumps(
                        {k: v for k, v in args.items()
                         if k not in ("start_time", "end_time")},
                        sort_keys=True)
                    groups[data_id].append(content)

        seg_time_end = 0.0
        total_duration = 0.0
        all_timestamps: List[float] = []

        for data_id, contents in groups.items():
            ctype = contents[0]["type"]
            if ctype == "image":
                from PIL import Image

                path = contents[0]["image"]["image_path"]
                img = np.asarray(Image.open(path).convert("RGB"))
                for content in contents:
                    content["image"] = [img.copy()]
                continue

            load_args = dict(contents[0]["video"])
            start_times = [c["video"].get("start_time", 0.0) for c in contents]
            end_times = [c["video"].get("end_time", float("inf"))
                         for c in contents]
            s, e = min(start_times), max(end_times)
            # REFERENCE-PARITY QUIRK (kept deliberately, ref :452-459):
            # when the union bound equals the unset default (s == 0 /
            # e == inf), contents[0]'s own start/end survive in
            # load_args — so a content with no start_time grouped after
            # one with start_time=5 still loads from 5. The reference
            # behaves identically; "fixing" it would desync golden
            # prompt parity.
            if s > 0:
                load_args["start_time"] = s
            if e < float("inf"):
                load_args["end_time"] = e
            load_args.setdefault("fps", self.config.fps)
            load_args.setdefault("max_frames", self.config.max_frames)
            load_args.pop("video_path_", None)
            path = load_args.pop("video_path")

            frac, _ = math.modf(total_duration)
            if total_duration == 0:
                frac = 1.0
            frames, timestamps, duration = video_loader.load_video(
                path, trim_time=1 - frac, **load_args)
            total_duration += duration

            for content, st, et in zip(contents, start_times, end_times):
                cur_frames, cur_ts = [], []
                max_time = seg_time_end
                for fr, ts in zip(frames, timestamps):
                    if st <= ts <= et:
                        cur_frames.append(fr)
                        cur_ts.append(ts + seg_time_end)
                        all_timestamps.append(ts + seg_time_end)
                        max_time = ts + seg_time_end
                content["video"] = cur_frames
                content["num_frames"] = len(cur_frames)
                content["timestamps"] = cur_ts
                seg_time_end = max_time + 1.0

        return conversation, np.asarray(all_timestamps, np.float32)

    def gather_media(self, conversation: Conversation):
        """Collect (modal, frames) pairs in message order (ref :511-528)."""
        items, modals = [], []
        for message in conversation:
            if not isinstance(message.get("content"), (list, tuple)):
                continue
            for content in message["content"]:
                if not isinstance(content, dict):
                    continue
                if content.get("type") == "video" and isinstance(
                        content.get("video"), list):
                    items.append(content["video"])
                    modals.append("video")
                elif content.get("type") == "image" and isinstance(
                        content.get("image"), list):
                    items.append(content["image"])
                    modals.append("image")
        return items, modals

    # -- text ----------------------------------------------------------------

    @staticmethod
    def downsampled_grid_tokens(images: ImageBatch) -> List[int]:
        """Visual tokens per <image> occurrence: one entry per frame for
        videos, one per image (ref _get_downsampled_grid_sizes :287-296)."""
        out: List[int] = []
        for (t, gh, gw), ms in zip(images.grid_sizes, images.merge_sizes):
            per_frame = int(gh // ms) * int(gw // ms)
            out.extend([per_frame] * int(t))
        return out

    def expand_image_tokens(self, text: str, images: Optional[ImageBatch]) -> str:
        if images is None or DEFAULT_IMAGE_TOKEN not in text:
            assert images is None or images.grid_sizes.shape[0] == 0, \
                "images given but no <image> token in text"
            return text
        counts = self.downsampled_grid_tokens(images)
        parts = text.split(DEFAULT_IMAGE_TOKEN)
        assert len(parts) - 1 == len(counts), (
            f"{len(parts)-1} image tokens vs {len(counts)} grids")
        out = [parts[0]]
        for count, nxt in zip(counts, parts[1:]):
            out.append(DEFAULT_IMAGE_TOKEN * count)
            out.append(nxt)
        return "".join(out)

    @staticmethod
    def history_qas(conversation: Conversation
                    ) -> Tuple[List[str], List[str], str]:
        """(hist_qs, hist_as, current_question) — ref :936-956."""
        qs: List[str] = []
        ans: List[str] = []
        for message in conversation:
            role, content = message.get("role"), message.get("content")
            if role == "user":
                if isinstance(content, str):
                    qs.append(content)
                elif isinstance(content, list):
                    for item in content:
                        if isinstance(item, dict) and item.get("type") == "text":
                            qs.append(item.get("text"))
            elif role == "assistant":
                ans.append(content)
        current = qs[-1] if qs else ""
        return qs[:-1], ans, current

    # -- main ----------------------------------------------------------------

    def __call__(
        self,
        conversation: Conversation,
        add_generation_prompt: bool = True,
        add_system_prompt: bool = False,
        return_labels: bool = False,
        rng: Optional[np.random.Generator] = None,
    ) -> ProcessorOutput:
        conversation, all_timestamps = self.load_multimodal(conversation)
        items, modals = self.gather_media(conversation)

        images = None
        total_image_num = 0
        if items:
            images = self.image_processor(items, modals)
            total_image_num = sum(len(it) for it in items)

        if return_labels:
            ids, labels, text = self._tokenize_with_labels(
                conversation, images, rng or np.random.default_rng())
        else:
            text = render_chat(conversation,
                               add_system_prompt=add_system_prompt,
                               add_generation_prompt=add_generation_prompt)
            text = self.expand_image_tokens(text, images)
            ids = np.asarray(self.tokenizer.encode(text), np.int32)
            labels = None

        hist_qs, hist_as, current = self.history_qas(conversation)
        return ProcessorOutput(
            input_ids=ids, labels=labels, images=images,
            hist_qs=hist_qs, hist_as=hist_as, current_question=current,
            all_timestamps=all_timestamps, total_image_num=total_image_num,
            original_text=text)

    # -- training labels -----------------------------------------------------

    def _tokenize_with_labels(self, conversation, images, rng):
        """Per-message tokenization with label spans + stream-role
        negative sampling (ref _process_conversation_with_label
        :530-608)."""
        counts = self.downsampled_grid_tokens(images) if images else []
        img_id = self.tokenizer.image_token_id
        eos_id = self.tokenizer.eos_token_id
        gen_len = len(self.generation_prompt_ids)

        image_idx = 0
        all_ids: List[np.ndarray] = []
        all_labels: List[np.ndarray] = []
        all_types: List[np.ndarray] = []
        texts: List[str] = []

        for mi, message in enumerate(conversation):
            prompt = render_chat([message])
            chunks = prompt.split(DEFAULT_IMAGE_TOKEN)
            built = [chunks[0]]
            for nxt in chunks[1:]:
                built.append(DEFAULT_IMAGE_TOKEN * counts[image_idx])
                built.append(nxt)
                image_idx += 1
            prompt = "".join(built)
            texts.append(prompt)
            ids = np.asarray(self.tokenizer.encode(prompt), np.int32)
            labels = np.full_like(ids, IGNORE_INDEX)
            types = np.full_like(ids, IGNORE_INDEX)

            if message["role"] == "assistant":
                labels[gen_len:-1] = ids[gen_len:-1]
            elif message["role"] == "stream":
                is_img = (ids == img_id).astype(np.int8)
                diff = np.diff(is_img)
                ends = np.nonzero(diff < 0)[0]
                labels[ends + 1] = ids[ends + 1]
                types = labels.copy()
                types[(types > 0) & (types != eos_id)] = 0
                labels[-2] = ids[-2]

            if mi > 0 and conversation[mi - 1]["role"] == "stream":
                labels[0] = ids[0]
                types[0] = ids[0]

            all_ids.append(ids)
            all_labels.append(labels)
            all_types.append(types)

        ids = np.concatenate(all_ids)
        labels = np.concatenate(all_labels)
        types = np.concatenate(all_types)

        # negative sampling: balance per-type label counts (ref :592-604)
        vals, cnts = np.unique(types[types > -1], return_counts=True)
        if len(vals) > 0:
            target = cnts.min()
            for v, c in zip(vals, cnts):
                if c > target:
                    idx = np.nonzero(types == v)[0]
                    drop = rng.permutation(idx)[:-target] if target > 0 else idx
                    labels[drop] = IGNORE_INDEX

        assert image_idx == len(counts), "image token/grid mismatch"
        return ids, labels, "".join(texts)
