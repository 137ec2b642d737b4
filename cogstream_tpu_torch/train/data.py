"""Training data pipelines (host side): a copy of
``cogstream_tpu/train/data.py`` (importing it would import JAX through
the package ``__init__``); tests/test_torch_train.py holds its outputs
to the original's.

Stage 1 (C12): the reference flattens per-video QA chains into
(question, history, GT-selection) samples (FlattenedQADataset,
first_stage_training.py:332-376) and augments each batch item with 1/2/4
history-order shuffles, remapping the target indices (CustomDataCollator
:129-250). Targets serialize as the bracketed selection string
``[yes,0,5]`` the selector decodes at inference (C8).

The expected JSON layout matches the published CogStream dataset
(COG_Dataset_simply, dataset_gen_pipeline/data_formating.py:24-73):
per video a flat QA list where each entry carries ``QA_pairs`` (one
{Q, A}), ``relevance`` (binary vector over prior QAs) and ``is_visual``.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime.history import selection_string
from ..runtime.retrieval import build_selector_prompt

IGNORE_INDEX = -100


@dataclass
class SelectorSample:
    question: str
    hist_qs: List[str]
    hist_as: List[str]
    relevance: List[int]      # indices of helpful history QAs
    if_visual: bool

    @property
    def target(self) -> str:
        return selection_string(self.if_visual, sorted(self.relevance))


def _qa_text(qa) -> Tuple[str, str]:
    if isinstance(qa, dict):
        q = qa.get("Q") or qa.get("question") or ""
        a = qa.get("A") or qa.get("answer") or ""
        return q, a
    return str(qa), ""


def _first(x):
    """Published chains store Q/A as 1-element lists."""
    if isinstance(x, (list, tuple)):
        return x[0] if x else ""
    return x


def _is_chain_qa(x) -> bool:
    return isinstance(x, dict) and "info" in x and ("Q" in x or "A" in x)


def _chain_group_samples(group: Sequence[Dict]) -> List[SelectorSample]:
    """One published query chain → selector samples: history is the
    chain prefix, the target comes from ``info.relevance`` (binary
    vector over the prefix, sometimes a JSON-encoded string) — the
    reference's FlattenedQADataset semantics
    (first_stage_training.py:332-376; ID==0 items carry no history and
    are skipped)."""
    samples: List[SelectorSample] = []
    hist_qs: List[str] = []
    hist_as: List[str] = []
    for i, qa in enumerate(group):
        info = qa.get("info") or {}
        q, a = _first(qa.get("Q", "")), _first(qa.get("A", ""))
        rel = info.get("relevance", qa.get("relevance"))
        if isinstance(rel, str):
            try:
                rel = json.loads(rel)
            except json.JSONDecodeError:
                rel = []
        if isinstance(rel, (list, tuple)) and rel and isinstance(
                rel[0], (list, tuple)):
            rel = rel[0]
        rel_idx = [j for j, r in enumerate(rel or []) if int(r)]
        vis = bool(info.get("is_visual", info.get("if_visual", True)))
        if i > 0:
            samples.append(SelectorSample(
                q, list(hist_qs), list(hist_as), rel_idx, vis))
        hist_qs.append(q)
        hist_as.append(a)
    return samples


def _chain_groups(data) -> List[Sequence[Dict]]:
    """Extract published query-chain groups from a JSON root, if any."""
    if isinstance(data, dict) and "query_chains" in data:
        data = data["query_chains"]
    if not isinstance(data, list):
        return []
    groups = []
    for el in data:
        if isinstance(el, list) and el:
            if _is_chain_qa(el[0]):
                groups.append(el)
            else:   # one more nesting level (per-video file lists)
                groups.extend(sub for sub in el
                              if isinstance(sub, list) and sub
                              and _is_chain_qa(sub[0]))
    return groups


def load_selector_dir(folder: str) -> List[SelectorSample]:
    """Load every per-video .json in a folder — the reference trains
    stage 1 straight off the published dataset directory
    (first_stage_training.py:39-48,478)."""
    import os

    samples: List[SelectorSample] = []
    for fname in sorted(os.listdir(folder)):
        if fname.endswith(".json"):
            samples.extend(
                load_selector_dataset(os.path.join(folder, fname)))
    return samples


def load_selector_dataset(path: str) -> List[SelectorSample]:
    """Flatten per-video QA chains into selector samples. Reads both
    the internal datagen layout (module docstring) and the published
    query-chain layout (groups of {Q, A, info.relevance} dicts)."""
    with open(path) as f:
        data = json.load(f)
    chain_groups = _chain_groups(data)
    if chain_groups:
        out: List[SelectorSample] = []
        for g in chain_groups:
            out.extend(_chain_group_samples(g))
        return out
    samples: List[SelectorSample] = []
    videos = list(data.values()) if isinstance(data, dict) else data
    flat = []
    for video in videos:
        if isinstance(video, list):      # merged layout: streams per video
            flat.extend(video)
        else:
            flat.append(video)
    for video in flat:
        qas = video.get("QAs") if isinstance(video, dict) else video
        if qas is None:
            continue
        hist_qs: List[str] = []
        hist_as: List[str] = []
        for item in qas:
            pairs = item.get("QA_pairs") or item.get("QA") or []
            if isinstance(pairs, dict):
                pairs = [pairs]
            rel = item.get("relevance") or []
            rel_idx = [i for i, r in enumerate(rel) if r]
            vis = bool(item.get("is_visual", True))
            for pair in pairs:
                q, a = _qa_text(pair)
                if hist_qs:
                    samples.append(SelectorSample(
                        q, list(hist_qs), list(hist_as), rel_idx, vis))
                hist_qs.append(q)
                hist_as.append(a)
    return samples


def shuffle_augment(sample: SelectorSample, rng: random.Random,
                    n_copies: int) -> List[SelectorSample]:
    """History-order permutations with remapped relevance indices
    (the collator's 1/2/4-expansion augmentation, ref :140-250)."""
    out = [sample]
    n = len(sample.hist_qs)
    for _ in range(max(0, n_copies - 1)):
        perm = list(range(n))
        rng.shuffle(perm)
        inv = {old: new for new, old in enumerate(perm)}
        out.append(SelectorSample(
            sample.question,
            [sample.hist_qs[i] for i in perm],
            [sample.hist_as[i] for i in perm],
            sorted(inv[i] for i in sample.relevance if i in inv),
            sample.if_visual))
    return out


def encode_selector_sample(
    tokenizer, sample: SelectorSample, max_len: int,
    include_demo: bool = True,
) -> Optional[Dict[str, np.ndarray]]:
    """(input_ids, labels) with IGNORE_INDEX outside the target span."""
    prompt = build_selector_prompt(sample.question, sample.hist_qs,
                                   sample.hist_as, include_demo)
    target = sample.target
    p_ids = tokenizer.encode(prompt)
    t_ids = tokenizer.encode(target) + [tokenizer.eos_token_id]
    ids = p_ids + t_ids
    if len(ids) > max_len:
        return None
    labels = [IGNORE_INDEX] * len(p_ids) + t_ids
    pad = max_len - len(ids)
    return {
        "input_ids": np.asarray(ids + [0] * pad, np.int32),
        "labels": np.asarray(labels + [IGNORE_INDEX] * pad, np.int32),
    }


def selector_batches(
    tokenizer,
    samples: Sequence[SelectorSample],
    batch_size: int,
    max_len: int,
    seed: int = 0,
    shuffle_copies: int = 2,
    include_demo: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled, augmented, padded batch stream for stage 1.

    ``include_demo`` mirrors Selector.select's flag (the few-shot demo
    block is part of the serialized prompt interface; train and serve
    must agree on it)."""
    rng = random.Random(seed)
    expanded: List[SelectorSample] = []
    for s in samples:
        expanded.extend(shuffle_augment(s, rng, shuffle_copies))
    rng.shuffle(expanded)

    buf: List[Dict[str, np.ndarray]] = []
    for s in expanded:
        enc = encode_selector_sample(tokenizer, s, max_len,
                                     include_demo=include_demo)
        if enc is None:
            continue
        buf.append(enc)
        if len(buf) == batch_size:
            yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
            buf = []
    if buf:  # final partial batch padded by repetition to static shape
        while len(buf) < batch_size:
            buf.append(buf[-1])
        yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}


def selection_exact_match(pred: str, target: str) -> bool:
    """Digit-set exact match metric (compute_metrics, ref :397-420)."""
    def norm(s):
        parts = [p.strip() for p in s.strip().strip("[]").split(",") if p.strip()]
        head = parts[0] if parts and parts[0] in ("yes", "no") else None
        idx = sorted(p for p in parts if p.isdigit())
        return head, idx
    return norm(pred) == norm(target)
