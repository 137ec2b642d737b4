"""Score aggregation, COI retrieval metrics, dialogue coherence (C17).

Host-only copy of ``cogstream_tpu/evaluate/aggregate.py`` (the port
imports nothing of the JAX package; tests/test_torch_host.py pins the
copy's code to the original).

Rebuild of the reference analysis stage
(evaluate/analysis/step1a_static_cor.py, step1b_statistic_score.py,
step2b_* LaTeX printers): chain-of-inference retrieval
accuracy/precision/recall/F1 against GT relevance vectors, five-metric
aggregation over the {Basic, Streaming, Global} label hierarchy,
per-class scores, and the inter/exter dialogue-coherence statistic
(1 - mean adjacent normalized score difference).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple
from ..utils.io import atomic_write_json

METRICS = ("IA", "DC", "CA", "TP", "LC")

# The published dataset tags each QA with a fine-grained "Group/Class"
# label. Aggregation first collapses the seven reasoning-family variants
# into one class (the reference's `levels` alias merge,
# analysis/step1b_statistic_score.py:22-26), then buckets classes into
# the three groups of its `LEVELS` table (:27-34) — the Basic/Streaming/
# Global columns plus per-class columns of the published results table.
LABEL_ALIASES = {alias: "Streaming/Reasoning" for alias in (
    "Streaming/Analysis",
    "Streaming/Causality",
    "Streaming/Causal Discovery",
    "Streaming/Causal discovery",
    "Streaming/Ingredients Analysis",
    "Streaming/Intention",
    "Streaming/Prediction",
)}

LABEL_GROUPS = {
    "Basic": ("Basic/Attributes", "Basic/Items", "Basic/Co-reference",
              "Basic/Actions"),
    "Streaming": ("Streaming/Reasoning", "Streaming/Sequence Perception",
                  "Streaming/Dialogue Recalling", "Streaming/Dynamic Updating",
                  "Streaming/Object Tracking"),
    "Global": ("Global/Overall Summary", "Global/Global Analysis"),
}
_CLASS_TO_GROUP = {c: g for g, cs in LABEL_GROUPS.items() for c in cs}


def canonical_label(label: str) -> str:
    """Alias-merged class name for a per-QA label."""
    return LABEL_ALIASES.get(label, label)


def label_group(label) -> Optional[str]:
    """Group for a per-QA label: a known class maps via the LEVELS
    table; a literal group name maps to itself (internal datasets); an
    unknown 'Group/Class' label falls back to its prefix so novel
    classes still aggregate (the reference raises instead)."""
    if not label:
        return None
    c = canonical_label(str(label))
    if c in _CLASS_TO_GROUP:
        return _CLASS_TO_GROUP[c]
    if c in LABEL_GROUPS:
        return c
    head = c.split("/", 1)[0]
    return head if head in LABEL_GROUPS else None


# ---------------------------------------------------------------------------
# COI retrieval metrics (step1a)
# ---------------------------------------------------------------------------

def coi_confusion(pred: Sequence[int], gt: Sequence[int],
                  n_hist: int) -> Tuple[int, int, int, int]:
    """(tp, fp, fn, tn) of predicted COI indices vs the GT set over a
    history of n_hist turns."""
    p, g = set(pred), set(gt)
    p = {i for i in p if 0 <= i < n_hist}
    g = {i for i in g if 0 <= i < n_hist}
    tp = len(p & g)
    fp = len(p - g)
    fn = len(g - p)
    tn = n_hist - tp - fp - fn
    return tp, fp, fn, tn


def coi_metrics(items: Iterable[Dict]) -> Dict[str, float]:
    """items: [{"pred_coi": [...], "gt_coi": [...], "n_hist": int}].
    Items without GT relevance (gt_coi None) are not COI-scorable and
    skip (they may still carry a scorable visual flag)."""
    TP = FP = FN = TN = 0
    for it in items:
        if it.get("gt_coi") is None:
            continue
        tp, fp, fn, tn = coi_confusion(it.get("pred_coi", []),
                                       it.get("gt_coi", []),
                                       it.get("n_hist", 0))
        TP += tp
        FP += fp
        FN += fn
        TN += tn
    total = TP + FP + FN + TN
    precision = TP / (TP + FP) if TP + FP else 0.0
    recall = TP / (TP + FN) if TP + FN else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {
        "accuracy": (TP + TN) / total if total else 0.0,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "support": total,
    }


def visual_flag_metrics(items: Iterable[Dict]) -> Dict[str, float]:
    """Accuracy of the predicted if_visual flag vs GT is_visual. Items
    missing EITHER flag (None) are unscorable and excluded — the old
    key-presence guard was dead (the builder always sets both keys) and
    coerced None==None into free hits."""
    hit = n = 0
    for it in items:
        if it.get("pred_visual") is not None \
                and it.get("gt_visual") is not None:
            hit += int(bool(it["pred_visual"]) == bool(it["gt_visual"]))
            n += 1
    return {"accuracy": hit / n if n else 0.0, "n": n}


# ---------------------------------------------------------------------------
# score aggregation (step1b)
# ---------------------------------------------------------------------------

def aggregate_scores(videos: Iterable[Dict]) -> Dict:
    """videos: judged per-video dicts ({"QAs": [{"label", "class",
    "scores": {metric: 0-10}}]}). Returns per-metric means ×10 (0-100),
    per-group and per-class breakdowns, and the overall average —
    the layout of step1b_statistic_score.py's JSON artifact."""
    per_metric: Dict[str, List[float]] = defaultdict(list)
    per_group: Dict[str, List[float]] = defaultdict(list)
    per_class: Dict[str, List[float]] = defaultdict(list)

    for video in videos:
        for qa in video.get("QAs", []):
            scores = [s for s in (qa.get("scores") or {}).values()
                      if s is not None]
            if not scores:
                continue
            mean_s = sum(scores) / len(scores)
            for m, s in (qa.get("scores") or {}).items():
                if s is not None:
                    per_metric[m].append(s)
            label = qa.get("label", "")
            group = label_group(label)
            if group:
                per_group[group].append(mean_s)
            # per-class column: the alias-merged fine-grained label when
            # present (ref qa_class keying, step1b:144), else any
            # explicit class/type annotation
            cls = (canonical_label(str(label)) if label and "/" in str(label)
                   else qa.get("class") or qa.get("type"))
            if cls:
                per_class[str(cls)].append(mean_s)

    def x10(vals):
        return round(10 * sum(vals) / len(vals), 2) if vals else None

    all_scores = [v for vs in per_metric.values() for v in vs]
    return {
        "average": x10(all_scores),
        "metrics": {m: x10(v) for m, v in sorted(per_metric.items())},
        "groups": {g: x10(v) for g, v in sorted(per_group.items())},
        "classes": {c: x10(v) for c, v in sorted(per_class.items())},
        "n_scored": len(all_scores),
    }


def dialogue_coherence(videos: Iterable[Dict]) -> Dict[str, float]:
    """1 - mean |adjacent normalized score difference| within (inter)
    each video's dialogue and across video boundaries (exter) —
    step1b_statistic_score.py:109-154 semantics."""
    inter_diffs: List[float] = []
    last_video_mean: Optional[float] = None
    exter_diffs: List[float] = []
    for video in videos:
        seq = []
        for qa in video.get("QAs", []):
            scores = [s for s in (qa.get("scores") or {}).values()
                      if s is not None]
            if scores:
                seq.append(sum(scores) / len(scores) / 10.0)
        inter_diffs.extend(abs(a - b) for a, b in zip(seq, seq[1:]))
        if seq:
            mean = sum(seq) / len(seq)
            if last_video_mean is not None:
                exter_diffs.append(abs(mean - last_video_mean))
            last_video_mean = mean

    def coh(diffs):
        return round(1.0 - sum(diffs) / len(diffs), 4) if diffs else None

    return {"inter": coh(inter_diffs), "exter": coh(exter_diffs)}


# ---------------------------------------------------------------------------
# directory driver + table printer (step2b analogue; markdown, not LaTeX)
# ---------------------------------------------------------------------------

def load_judged_dir(path: str) -> List[Dict]:
    out = []
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".json"):
            with open(os.path.join(path, fname)) as f:
                out.append(json.load(f))
    return out


def gt_qa_indices(qa: Dict) -> Optional[List[int]]:
    """Canonical GT chain-of-inference as PRIOR-QA indices.

    The dataset format stores GT as a binary ``relevance`` vector over
    prior QAs (data_formating.py:24-73 / step1a's element-wise
    comparison); ``gt_coi`` may carry explicit indices. The raw ``coi``
    field from dialogue-path construction indexes prior SEGMENTS — a
    different space — and is deliberately NOT used here.
    """
    if "relevance" in qa and qa["relevance"] is not None:
        return [i for i, r in enumerate(qa["relevance"]) if r]
    if "gt_coi" in qa:
        return list(qa["gt_coi"])
    return None


def coi_items_from_videos(videos: Iterable[Dict]) -> List[Dict]:
    """Per-QA items for coi_metrics AND visual_flag_metrics. The COI
    fields require GT relevance; the visual flag does not — a dataset
    without relevance vectors still scores if_visual accuracy (items
    carry gt_coi=None there and coi_metrics skips them)."""
    items = []
    for video in videos:
        qas = video.get("QAs", [])
        for i, qa in enumerate(qas):
            gt = gt_qa_indices(qa)
            if "pred_coi" not in qa and "pred_visual" not in qa:
                continue
            items.append({
                "pred_coi": qa.get("pred_coi", []),
                "gt_coi": gt,
                "n_hist": i,
                "pred_visual": qa.get("pred_visual"),
                "gt_visual": qa.get("is_visual"),
            })
    return items


def latency_stats(videos: Iterable[Dict]) -> Optional[Dict[str, float]]:
    """p50/p95 per-turn latency if answer generation recorded it."""
    lats = sorted(qa["latency_s"] for video in videos
                  for qa in video.get("QAs", []) if "latency_s" in qa)
    if not lats:
        return None
    pick = lambda p: lats[min(len(lats) - 1, int(p * (len(lats) - 1)))]
    return {"p50_s": round(pick(0.5), 3), "p95_s": round(pick(0.95), 3),
            "n": len(lats)}


def summarize(judged_dir: str, out_path: Optional[str] = None) -> Dict:
    videos = load_judged_dir(judged_dir)
    items = coi_items_from_videos(videos)
    report = {
        "scores": aggregate_scores(videos),
        "coherence": dialogue_coherence(videos),
        "coi": coi_metrics(items),
        "visual_flag": visual_flag_metrics(items),
        "latency": latency_stats(videos),
        "n_videos": len(videos),
    }
    if out_path:
        atomic_write_json(out_path, report, indent=2)
    return report


def format_table(report: Dict, latex: bool = False) -> str:
    """Markdown (default) or LaTeX results table (the step2b printers
    emit LaTeX rows for the paper table)."""
    s = report["scores"]
    rows = [("Avg.", s["average"])]
    rows += list((s.get("metrics") or {}).items())
    rows += list((s.get("groups") or {}).items())
    # per-class columns of the published results table (Att./Obj./…)
    rows += list((s.get("classes") or {}).items())
    c = report.get("coherence") or {}
    rows.append(("coherence inter/exter",
                 f"{c.get('inter')}/{c.get('exter')}"))
    k = report.get("coi") or {}
    if k.get("support"):
        rows.append(("COI F1", round(k["f1"], 4)))
    lat = report.get("latency")
    if lat:
        rows.append(("latency p50/p95 (s)",
                     f"{lat['p50_s']}/{lat['p95_s']}"))
    if latex:
        body = " \\\\\n".join(f"{name} & {val}" for name, val in rows)
        return ("\\begin{tabular}{lr}\n\\toprule\nmetric & score \\\\\n"
                "\\midrule\n" + body + " \\\\\n\\bottomrule\n"
                "\\end{tabular}")
    lines = ["| metric | score |", "|---|---|"]
    lines += [f"| {'**Avg.**' if name == 'Avg.' else name} | {val} |"
              for name, val in rows]
    return "\n".join(lines)
