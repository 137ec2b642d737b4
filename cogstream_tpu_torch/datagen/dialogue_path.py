"""Dialogue-path construction (C23).

Host-only copy of ``cogstream_tpu/datagen/dialogue_path.py`` (the port
imports nothing of the JAX package; tests/test_torch_host.py pins the
copy's code to the original).

Rebuild of dataset_gen_pipeline/dialogue_path_construction.py: merge the
raters' score matrices (disagreement keeps the max), turn edges >= R
into chain-of-inference (COI) links at **per-QA granularity**, then
sample N dialogue streams per video. Per segment, selection follows the
reference's order and semantics (:190-266):

- every Dynamic-Updating QA;
- the special classes wholesale — Temporal-Perception and
  Object-Tracking QAs always, Dialogue-Recalling only when one of its
  COI predecessors is already in the stream;
- ~40% of L1, with a coin-flip chained L2 co-reference follow-up
  inserted right after its referenced L1 parent (:214-235);
- K L3 then K L4 QAs via sequential softmax rounds over
  score + chain-boost, where the boost reads each candidate's selected
  predecessors' chain lengths (updated after every pick, so boosts
  differ across QAs within one segment) and a structural score of
  ``auto_take_score`` is taken immediately without consuming a round
  (:237-266).

Chain lengths are tracked **per QA** (``1 + max over linked
predecessors``, reference ``_update_chain_length`` :267-270), not per
segment. Each emitted QA carries {segment_path, label "Group/Class",
class, is_visual, QA_pairs, coi} where ``coi`` lists the **stream
indices** of its selected COI predecessors — the index space the
reference's ``coi_qa_info``/``relevance`` vectors use
(data_formating.py:44-48).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple
from ..utils.io import atomic_write_json

# Flattening orders of the relevance-score index spaces — must match
# datagen/scoring.py (current QAs: SCORED_LEVELS_CURRENT + TP/DR;
# previous QAs: SCORED_LEVELS_PREVIOUS).
CUR_LEVELS = ("L3", "L4", "TP", "DR")
PREV_LEVELS = ("L1", "L3")

LEVEL_LABEL = {
    "L1": "Basic", "L2": "Basic", "CR": "Streaming",
    "L3": "Streaming", "TP": "Streaming", "DR": "Streaming",
    "DU": "Streaming",
    "L4": "Global",
}

# Default fine-grained class per level (the published taxonomy names,
# evaluate/aggregate.LABEL_GROUPS); L1 QAs usually override via their
# bracket-tag "type".
LEVEL_CLASS = {
    "L1": "Attributes", "L2": "Co-reference", "CR": "Object Tracking",
    "L3": "Reasoning", "TP": "Sequence Perception",
    "DR": "Dialogue Recalling", "DU": "Dynamic Updating",
    "L4": "Global Analysis",
}

# hyphenated "type" tags set by reformatting → taxonomy class names
# ("Co-reference" keeps its hyphen in the published taxonomy)
_CLASS_SYNONYMS = {
    "Dialogue-Recalling": "Dialogue Recalling",
    "Dynamic-Updating": "Dynamic Updating",
    "Temporal-Perception": "Temporal Perception",
    "Object-Tracking": "Object Tracking",
}

# QAs are identified by (level, segment_index, index_within_level).
QAKey = Tuple[str, int, int]


def merge_score_matrices(raters: Sequence[Dict]) -> Dict:
    """Merge 1-2 raters' link stores; disagreements keep the max score
    (ref :133-138)."""
    merged: Dict = {}
    for links in raters:
        for ci, seg in links.items():
            mseg = merged.setdefault(ci, {})
            for qi, prevs in seg.items():
                mq = mseg.setdefault(qi, {})
                for pi, scores in prevs.items():
                    if pi in mq:
                        if len(mq[pi]) != len(scores):
                            # zip would silently drop the longer tail
                            # (raters scored different remixes of the
                            # same video) — losing >=threshold edges
                            raise ValueError(
                                f"rater score-list mismatch at segment "
                                f"{ci} qa {qi} prev {pi}: "
                                f"{len(mq[pi])} vs {len(scores)}")
                        mq[pi] = [max(a, b) for a, b in
                                  zip(mq[pi], scores)]
                    else:
                        mq[pi] = list(scores)
    return merged


def coi_links(merged: Dict, threshold: int = 5) -> Dict:
    """Edges >= threshold become COI links: {(ci, qi): [prev_seg,...]}

    Segment-granular view kept for callers that only need "which earlier
    segments matter"; dialogue-path selection uses the QA-granular
    ``qa_link_scores`` instead."""
    out: Dict[Tuple[int, int], List[int]] = {}
    for ci, seg in merged.items():
        for qi, prevs in seg.items():
            deps = [int(pi) for pi, scores in prevs.items()
                    if scores and max(scores) >= threshold]
            out[(int(ci), int(qi))] = sorted(deps)
    return out


def _level_counts(seg: Dict, levels: Sequence[str]) -> List[int]:
    qas = seg.get("QAs", {})
    return [len(qas.get(lv, [])) for lv in levels]


def qa_link_scores(video: Dict, merged: Dict) -> Dict[QAKey, Dict[QAKey, int]]:
    """Per-QA dependency scores: {current QAKey: {previous QAKey: score}}.

    Decodes the nested link store (scoring.score_video: current index qi
    flattens CUR_LEVELS; each previous segment's score list flattens
    PREV_LEVELS) back into (level, segment, index) keys — the reference
    keeps an equivalent per-QA ``S`` matrix (:133-146)."""
    segments = video.get("segments", [])
    out: Dict[QAKey, Dict[QAKey, int]] = {}
    for ci, seg in enumerate(segments):
        seg_links = merged.get(str(ci), {})
        qi = 0
        for level in CUR_LEVELS:
            for k in range(len(seg.get("QAs", {}).get(level, []))):
                cur_key: QAKey = (level, ci, k)
                prevs = seg_links.get(str(qi), {})
                dep_scores: Dict[QAKey, int] = {}
                for pi_str, slist in prevs.items():
                    pi = int(pi_str)
                    if not 0 <= pi < len(segments):
                        continue
                    pseg = segments[pi]
                    j = 0
                    for plevel in PREV_LEVELS:
                        for pk in range(len(pseg.get("QAs", {})
                                            .get(plevel, []))):
                            if j < len(slist):
                                dep_scores[(plevel, pi, pk)] = slist[j]
                            j += 1
                out[cur_key] = dep_scores
                qi += 1
    return out


class _StreamSampler:
    """One stream's selection state (the reference's ``Sequence``)."""

    def __init__(self, rng: random.Random, scores, coi_threshold: int,
                 chain_boost: float, auto_take_score: int, tau: float):
        self.rng = rng
        self.scores = scores                    # QAKey -> {QAKey: score}
        self.coi_threshold = coi_threshold
        self.chain_boost = chain_boost
        self.auto_take_score = auto_take_score
        self.tau = tau
        self.order: List[QAKey] = []            # stream order
        self.selected: set = set()
        self.chain_len: Dict[QAKey, int] = {}

    def linked_preds(self, key: QAKey) -> List[QAKey]:
        return [p for p, s in self.scores.get(key, {}).items()
                if s >= self.coi_threshold]

    def take(self, key: QAKey, preds: Optional[List[QAKey]] = None):
        """Append + per-QA chain-length update (ref :267-270)."""
        if preds is None:
            preds = self.linked_preds(key)
        self.chain_len[key] = (
            1 + max((self.chain_len.get(p, 0) for p in preds), default=0)
            if preds else 1)
        self.order.append(key)
        self.selected.add(key)

    def softmax_pick(self, cands: List[Tuple[QAKey, float]]) -> QAKey:
        mx = max(w for _, w in cands)
        exps = [math.exp((w - mx) / self.tau) for _, w in cands]
        r = self.rng.random() * sum(exps)
        acc = 0.0
        for (key, _), e in zip(cands, exps):
            acc += e
            if acc >= r:
                return key
        return cands[-1][0]

    def select_advanced(self, level: str, ci: int, n: int, k_rounds: int):
        """K sequential softmax rounds over one level's candidates
        (ref _select_advanced_qa :237-266): structural scores auto-take
        without consuming a round; boosts recompute from the chain
        lengths updated by earlier picks."""
        for _ in range(k_rounds):
            cands: List[Tuple[QAKey, float]] = []
            for k in range(n):
                key: QAKey = (level, ci, k)
                if key in self.selected:
                    continue
                preds_in = [p for p in self.linked_preds(key)
                            if p in self.selected]
                if not preds_in:
                    cands.append((key, 1.0))
                    continue
                mx = max(self.scores[key][p] for p in preds_in)
                if mx >= self.auto_take_score:
                    self.take(key)
                    continue
                boost = self.chain_boost * max(
                    self.chain_len.get(p, 0) + 1 for p in preds_in)
                cands.append((key, mx + boost))
            if not cands:
                break
            self.take(self.softmax_pick(cands))


def build_streams(
    video: Dict,
    merged_links: Dict,
    n_streams: int = 2,
    k_advanced: int = 2,
    coi_threshold: int = 5,
    chain_boost: float = 0.1,
    auto_take_score: int = 8,
    basic_rate: float = 0.4,
    tau: float = 1.0,
    seed: int = 0,
) -> List[Dict]:
    """Sample N dialogue streams. Returns a list of streams, each a list
    of per-QA records ordered by segment."""
    segments = video.get("segments", [])
    scores = qa_link_scores(video, merged_links)
    streams: List[Dict] = []

    for si_stream in range(n_streams):
        rng = random.Random(seed * 1000 + si_stream)
        s = _StreamSampler(rng, scores, coi_threshold, chain_boost,
                           auto_take_score, tau)

        for ci, seg in enumerate(segments):
            qas = seg.get("QAs", {})

            for k in range(len(qas.get("DU", []))):     # all dynamic
                s.take(("DU", ci, k), preds=[])

            # special classes wholesale; DR needs a selected predecessor
            # (ref _select_special_qa :199-212)
            for k in range(len(qas.get("TP", []))):
                s.take(("TP", ci, k))
            for k in range(len(qas.get("CR", []))):
                s.take(("CR", ci, k), preds=[])
            for k in range(len(qas.get("DR", []))):
                key = ("DR", ci, k)
                if any(p in s.selected for p in s.linked_preds(key)):
                    s.take(key)

            # basics: ~40% of L1, coin-flip one chained L2 follow-up
            # inserted after its referenced parent (ref :214-235)
            l1_idx = list(range(len(qas.get("L1", []))))
            rng.shuffle(l1_idx)
            take_n = max(1, int(len(l1_idx) * basic_rate)) if l1_idx else 0
            picked_l1 = l1_idx[:take_n]
            l2s = qas.get("L2", [])
            chained_l2: Optional[Tuple[int, int]] = None  # (l2_idx, parent)
            if l2s and rng.random() < 0.5:
                for k, l2 in enumerate(l2s):
                    if l2.get("ref") in picked_l1:
                        chained_l2 = (k, l2["ref"])
                        break
            for k in picked_l1:
                s.take(("L1", ci, k), preds=[])
                if chained_l2 and chained_l2[1] == k:
                    s.take(("L2", ci, chained_l2[0]),
                           preds=[("L1", ci, k)])

            # advanced: K softmax rounds per level, L3 then L4
            for level in ("L3", "L4"):
                s.select_advanced(level, ci, len(qas.get(level, [])),
                                  k_advanced)

        # emission: resolve keys to records; COI deps become stream
        # indices (the reference's coi_qa_info space)
        pos = {key: i for i, key in enumerate(s.order)}
        stream: List[Dict] = []
        for key in s.order:
            level, ci, k = key
            qa = segments[ci].get("QAs", {}).get(level, [])[k]
            deps = [pos[p] for p in s.linked_preds(key) if p in pos]
            if level == "L2":
                parent = ("L1", ci, qa.get("ref", -1))
                if parent in pos:
                    deps = sorted(set(deps) | {pos[parent]})
            if level == "TP":
                # taxonomy name for moved temporal QAs (the published
                # results table's "Seq." column)
                cls = "Sequence Perception"
            else:
                cls = qa.get("type") or LEVEL_CLASS.get(level, "Attributes")
                cls = _CLASS_SYNONYMS.get(cls, cls)
            group = LEVEL_LABEL.get(level, "Basic")
            if cls == "Temporal Perception":
                # the published taxonomy has no Basic/Temporal class:
                # temporal questions are the "Seq." column whether or
                # not remix moved them — an off-taxonomy label would
                # fall out of every per-class aggregate column
                cls, group = "Sequence Perception", "Streaming"
            stream.append({
                "segment_path": ci,
                "label": f"{group}/{cls}",
                "class": cls,
                "is_visual": level not in ("DR",),
                "chain_length": s.chain_len.get(key, 1),
                "QA_pairs": [{"Q": qa.get("Q", ""),
                              "A": qa.get("A", "")}],
                "coi": sorted(deps),
            })
        streams.append({"stream": si_stream, "QAs": stream})
    return streams


def run_path_construction(scored_dir: str, qa_dir: str, out_dir: str,
                          n_streams: int = 2, threshold: int = 5,
                          seed: int = 0, log=print) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for fname in sorted(os.listdir(qa_dir)):
        if not fname.endswith(".json"):
            continue
        out_path = os.path.join(out_dir, fname)
        if os.path.exists(out_path):   # resumable
            continue
        with open(os.path.join(qa_dir, fname)) as f:
            video = json.load(f)
        raters = []
        spath = os.path.join(scored_dir, fname)
        if os.path.exists(spath):
            with open(spath) as f:
                raters.append(json.load(f).get("links", {}))
        merged = merge_score_matrices(raters)
        # per-video seed component: one corpus-wide seed would replay
        # the SAME Random sequence for every video (positionally
        # identical L1 subsets / coin flips — a corpus-wide selection
        # bias); hashing the filename keeps runs reproducible
        vid_seed = seed + int(
            hashlib.sha1(fname.encode()).hexdigest()[:8], 16)
        streams = build_streams(video, merged, n_streams=n_streams,
                                coi_threshold=threshold, seed=vid_seed)
        atomic_write_json(out_path, {"video": video.get("video"), "streams": streams}, indent=1)
        log(f"{fname}: {n_streams} streams")
