"""QA remix / caps / dynamic-updating injection (C20).

Host-only copy of ``cogstream_tpu/datagen/reformatting.py`` (the port
imports nothing of the JAX package; tests/test_torch_host.py pins the
copy's code to the original).

Rebuild of dataset_gen_pipeline/reformating.py: Temporal-Perception and
Dialogue-Recalling QAs move to a later random segment (forcing genuine
cross-time recall), per-level counts are capped (L1<=5, L3<=4, L4<=2 by
default), and Dynamic-Updating QAs can be injected at their annotated
timestamps.
"""

from __future__ import annotations

import copy
import random
import re
from typing import Dict, List, Optional, Sequence

TEMPORAL_RE = re.compile(
    r"\b(when|before|after|first|then|earlier|order|sequence)\b", re.I)

DEFAULT_CAPS = {"L1": 5, "L3": 4, "L4": 2}


def is_temporal(qa: Dict) -> bool:
    """Label-driven first (the generation prompt tags L1 QAs with
    [Temporal Perception]); regex heuristic only for untagged QAs."""
    t = qa.get("type")
    if t is not None:
        return t.replace("-", " ").lower() == "temporal perception"
    return bool(TEMPORAL_RE.search(qa.get("Q", "")))


def _remap_l2_refs(qas: Dict, index_map: Dict[int, int]) -> None:
    """Re-point L2 co-reference ``ref`` indices after their segment's L1
    list changed; follow-ups whose parent left the segment are dropped
    (their pronoun no longer resolves)."""
    if "L2" not in qas:
        return
    kept = []
    for l2 in qas["L2"]:
        ref = l2.get("ref")
        if ref in index_map:
            kept.append(dict(l2, ref=index_map[ref]))
    if kept:
        qas["L2"] = kept
    else:
        qas.pop("L2")


def remix(video: Dict, seed: int = 0) -> Dict:
    """Move temporal-perception L1/L3 QAs and the DR QA to later
    segments; annotate moved QAs with their source segment."""
    rng = random.Random(seed)
    video = copy.deepcopy(video)
    segments: List[Dict] = video.get("segments", [])
    n = len(segments)
    if n < 2:
        return video

    moves: List[tuple] = []   # (qa, src_idx, level)
    for si, seg in enumerate(segments[:-1]):
        qas = seg.get("QAs", {})
        for level in ("L1", "L3"):
            keep = []
            index_map: Dict[int, int] = {}
            for i, qa in enumerate(qas.get(level, [])):
                if is_temporal(qa) and rng.random() < 0.5:
                    moves.append((qa, si, level))
                else:
                    index_map[i] = len(keep)
                    keep.append(qa)
            if level in qas:
                qas[level] = keep
                if level == "L1":
                    _remap_l2_refs(qas, index_map)
        for qa in qas.pop("DR", []):
            moves.append((qa, si, "DR"))

    for qa, src, level in moves:
        dst = rng.randrange(src + 1, n)
        qa = dict(qa, source_segment=src,
                  type="Dialogue-Recalling" if level == "DR"
                  else "Temporal-Perception")
        segments[dst].setdefault("QAs", {}).setdefault(
            "DR" if level == "DR" else "TP", []).append(qa)
    return video


def cap_counts(video: Dict, caps: Optional[Dict[str, int]] = None,
               seed: int = 0) -> Dict:
    """Per-level caps with random subsampling (shrim semantics)."""
    caps = caps or DEFAULT_CAPS
    rng = random.Random(seed)
    video = copy.deepcopy(video)
    for seg in video.get("segments", []):
        qas = seg.get("QAs", {})
        for level, cap in caps.items():
            if level in qas and len(qas[level]) > cap:
                kept_idx = sorted(rng.sample(range(len(qas[level])), cap))
                qas[level] = [qas[level][i] for i in kept_idx]
                if level == "L1":
                    _remap_l2_refs(qas, {old: new for new, old
                                         in enumerate(kept_idx)})
    return video


def inject_dynamic_updating(video: Dict,
                            du_qas: Sequence[Dict]) -> Dict:
    """Insert Dynamic-Updating QAs into the segment covering their
    timestamp. du_qas: [{"Q", "A", "time": seconds}]."""
    video = copy.deepcopy(video)
    segments = video.get("segments", [])
    for qa in du_qas:
        t = qa.get("time", 0)
        target = None
        for seg in segments:
            s, e = (seg.get("timestamp") or [0, float("inf")])[:2]
            if s is not None and e is not None and s <= t < e:
                target = seg
                break
        if target is None and segments:
            target = segments[-1]
        if target is not None:
            target.setdefault("QAs", {}).setdefault("DU", []).append(
                {"Q": qa["Q"], "A": qa["A"], "type": "Dynamic-Updating"})
    return video
