"""Per-segment QA generation (C19).

Host-only copy of ``cogstream_tpu/datagen/generation.py`` (the port
imports nothing of the JAX package; tests/test_torch_host.py pins the
copy's code to the original).

Rebuild of dataset_gen_pipeline/generation.py: for each video segment
(keyframes from C18) generate L1 basic + L2 co-reference QAs; L3
cross-temporal QAs conditioned on the rolling summary, then a polish
pass; update the two-task rolling summary; L4 global QAs on the final
segment; a Dialogue-Recalling QA on one random "lucky" segment; and
Object-Tracking co-reference QAs over annotated appearance windows.
JSON-format validation with bounded retries; per-video outputs are
skipped when present (resumable, ref generation.py:134-136).
"""

from __future__ import annotations

import json
import os
import random
import re
from typing import Dict, List, Optional, Sequence

from . import prompts
from ..utils.io import atomic_write_json

_JSON_LIST_RE = re.compile(r"\[\s*(?:\{.*\}\s*)?\]", re.DOTALL)
# '[Attributes] What colour ...' → ('Attributes', 'What colour ...')
_L1_TAG_RE = re.compile(r"^\s*\[([^\]]+)\]\s*")
# '[Co-reference](QA2) How did it break?' → ref index 2 (1-based)
_COREF_RE = re.compile(r"^\s*\[Co-?reference\]\s*\(\s*(?:QA)?(\d+)\s*\)\s*",
                       re.IGNORECASE)


def split_label(q: str):
    """(label, clean_question) from a bracket-tagged question; label is
    None when untagged (reference extract_label semantics)."""
    m = _L1_TAG_RE.match(q)
    if not m:
        return None, q
    return m.group(1).strip(), q[m.end():].strip()


def split_coref(q: str):
    """(0-based L1 ref index, clean_question) for an L2 question, or
    (None, q) when the '(QA<k>)' marker is absent/malformed."""
    m = _COREF_RE.match(q)
    if not m:
        return None, q
    return int(m.group(1)) - 1, q[m.end():].strip()


def parse_qa_json(text: str) -> Optional[List[Dict[str, str]]]:
    """Validate the model's QA JSON (check_qa_pairs semantics)."""
    m = _JSON_LIST_RE.search(text)
    if not m:
        return None
    try:
        data = json.loads(m.group(0))
    except json.JSONDecodeError:
        return None
    if not isinstance(data, list):
        return None
    out = []
    for item in data:
        if not isinstance(item, dict):
            return None
        q = item.get("Q") or item.get("q") or item.get("question")
        a = item.get("A") or item.get("a") or item.get("answer")
        if not q or not a:
            return None
        out.append({"Q": str(q).strip(), "A": str(a).strip()})
    return out


def ask_qas(client, prompt: str, images: Sequence,
            max_retries: int = 3) -> List[Dict[str, str]]:
    """Vision call + JSON validation + retry (gpt_response semantics)."""
    for attempt in range(max_retries):
        text = (client.vision(prompt, images) if images
                else client.chat(prompt))
        qas = parse_qa_json(text)
        if qas is not None:
            return qas
    return []


def generate_video_qas(
    client,
    segments: Sequence[Dict],
    seed: int = 0,
    n_basic: int = 5,
    n_coref: int = 2,
    n_cross: int = 4,
    n_global: int = 2,
    log=print,
) -> Dict:
    """segments: [{"index", "keyframes": [paths/bytes], "timestamp",
    "objects": [{"entity", "windows": [(s,e), (s,e)]}]?}].
    Returns {"segments": [{... "QAs": {level: [...]}}], "summary": str}.
    """
    rng = random.Random(seed)
    lucky = rng.randrange(1, max(len(segments), 2))  # recall needs history
    summary: Optional[str] = None
    out_segments: List[Dict] = []
    history_pairs: List[Dict] = []

    for si, seg in enumerate(segments):
        frames = seg.get("keyframes", [])
        levels: Dict[str, List] = {}

        l1 = []
        for qa in ask_qas(client, prompts.basic_qa_prompt(n_basic),
                          frames):
            label, clean = split_label(qa["Q"])
            entry = {"Q": clean, "A": qa["A"]}
            if label:
                entry["type"] = label
            l1.append(entry)
        levels["L1"] = l1

        # L2 co-reference follow-ups: a distinct tagged level whose every
        # pair cites its L1 parent, so dialogue-path chaining can insert
        # it after the parent (ref all_prompt.py:158-166,
        # dialogue_path_construction.py:214-235)
        if l1:
            l2 = []
            for qa in ask_qas(
                    client,
                    prompts.coreference_qa_prompt(json.dumps(l1), n_coref),
                    frames):
                ref, clean = split_coref(qa["Q"])
                if ref is None or not 0 <= ref < len(l1):
                    continue    # unchained L2s are unusable downstream
                l2.append({"Q": clean, "A": qa["A"],
                           "type": "Co-reference", "ref": ref})
            if l2:
                levels["L2"] = l2
        if summary:
            draft = ask_qas(client,
                            prompts.cross_temporal_qa_prompt(summary,
                                                             n_cross),
                            frames)
            if draft:
                polished = ask_qas(
                    client, prompts.polish_prompt(json.dumps(draft)), [])
                levels["L3"] = polished or draft
            else:
                levels["L3"] = []
        summary_text = client.vision(
            prompts.rolling_summary_prompt(summary), frames) if frames \
            else client.chat(prompts.rolling_summary_prompt(summary))
        summary = summary_text.strip() or summary

        if si == len(segments) - 1 and summary:
            levels["L4"] = ask_qas(
                client, prompts.global_qa_prompt(summary, n_global), [])

        if si == lucky and history_pairs:
            hist = "\n".join(f"Q: {p['Q']} A: {p['A']}"
                             for p in history_pairs[-8:])
            rec = ask_qas(client, prompts.recalling_qa_prompt(hist), [])
            if rec:
                levels["DR"] = rec[:1]

        for obj in seg.get("objects", []):
            windows = obj.get("windows", [])
            if len(windows) >= 2:
                ot = ask_qas(client, prompts.object_tracking_prompt(
                    obj.get("entity", "object"),
                    str(windows[0]), str(windows[1])), frames)
                if ot:
                    levels.setdefault("CR", []).extend(ot[:1])

        for lvl in ("L1", "L2", "L3", "L4", "DR", "CR"):
            history_pairs.extend(levels.get(lvl, []))

        out_segments.append({**{k: v for k, v in seg.items()
                                if k != "keyframes"},
                             "index": si, "QAs": levels})
        log(f"segment {si}: " + ", ".join(
            f"{k}={len(v)}" for k, v in levels.items()))
    return {"segments": out_segments, "summary": summary}


def run_generation(client, segments_dir: str, out_dir: str,
                   seed: int = 0, log=print) -> None:
    """Directory driver: one JSON spec per video, resumable."""
    os.makedirs(out_dir, exist_ok=True)
    for fname in sorted(os.listdir(segments_dir)):
        if not fname.endswith(".json"):
            continue
        out_path = os.path.join(out_dir, fname)
        if os.path.exists(out_path):
            continue
        with open(os.path.join(segments_dir, fname)) as f:
            spec = json.load(f)
        result = generate_video_qas(client, spec.get("segments", []),
                                    seed=seed, log=log)
        result["video"] = spec.get("video", fname[:-5])
        atomic_write_json(out_path, result, indent=1)
        log(f"{fname}: done")
