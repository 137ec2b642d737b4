"""Cross-QA relevance scoring (C21).

Host-only copy of ``cogstream_tpu/datagen/scoring.py`` (the port imports
nothing of the JAX package; tests/test_torch_host.py pins the copy's
code to the original).

Rebuild of dataset_gen_pipeline/scoring.py: every current L3/L4 QA is
scored 0-7 against every previous segment's L1/L3 QA by the judge LLM
(prompts.scoring_prompt); structural co-references (a moved QA scored
against its source segment's pairs) are auto-assigned the maximum score
of 7; scores persist incrementally per segment so interrupted runs
resume (ref scoring.py:118-134,186-237).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

from . import prompts
from ..utils.io import atomic_write_json

_INT_RE = re.compile(r"-?\d+")

SCORED_LEVELS_CURRENT = ("L3", "L4")
SCORED_LEVELS_PREVIOUS = ("L1", "L3")
MAX_SCORE = 7
# structural co-references score ABOVE the judged 0-7 scale so the
# dialogue-path auto-take (auto_take_score=8) always fires for them,
# mirroring the reference's SCORE_THRESHOLD=8 convention
STRUCTURAL_SCORE = 8


def parse_score(text: str) -> Optional[int]:
    """LAST integer in the reply: judges often restate the scale
    before the verdict ("on the 0-7 scale, this is a 6") — taking the
    first integer would record those as 0."""
    ms = _INT_RE.findall(text)
    if not ms:
        return None
    return max(0, min(MAX_SCORE, int(ms[-1])))


def is_structural_coreference(qa: Dict, prev_segment_index: int) -> bool:
    """Moved QAs (remix) depend on their source segment by
    construction — any type remix relocated, not just DR (the old
    second clause was `A or (B and A)`, identically A)."""
    return qa.get("source_segment") == prev_segment_index


def score_video(client, video: Dict, out_path: Optional[str] = None,
                log=print) -> Dict:
    """Returns {"links": {cur_seg: {qa_idx: {prev_seg: [scores...]}}}}
    — the nested link_raw store."""
    links: Dict = {}
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            links = json.load(f).get("links", {})

    segments = video.get("segments", [])
    for ci, cseg in enumerate(segments):
        ckey = str(ci)
        if ckey in links:       # resumable per segment
            continue
        cur_items: List[Tuple[int, Dict]] = []
        idx = 0
        for level in SCORED_LEVELS_CURRENT + ("TP", "DR"):
            for qa in cseg.get("QAs", {}).get(level, []):
                cur_items.append((idx, qa))
                idx += 1
        seg_links: Dict = {}
        for qi, qa in cur_items:
            per_prev: Dict = {}
            for pi in range(ci):
                pseg = segments[pi]
                scores: List[int] = []
                for plevel in SCORED_LEVELS_PREVIOUS:
                    for pqa in pseg.get("QAs", {}).get(plevel, []):
                        if is_structural_coreference(qa, pi):
                            scores.append(STRUCTURAL_SCORE)
                            continue
                        text = client.chat(prompts.scoring_prompt(
                            qa.get("Q", ""), qa.get("A", ""),
                            pqa.get("Q", ""), pqa.get("A", "")))
                        s = parse_score(text)
                        scores.append(s if s is not None else 0)
                if scores:
                    per_prev[str(pi)] = scores
            seg_links[str(qi)] = per_prev
        links[ckey] = seg_links
        if out_path:            # incremental persistence per segment
            atomic_write_json(out_path, {"video": video.get("video"),
                                         "links": links})
        log(f"scored segment {ci}: {len(cur_items)} QAs")
    return {"video": video.get("video"), "links": links}


def run_scoring(client, qa_dir: str, out_dir: str, log=print) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for fname in sorted(os.listdir(qa_dir)):
        if not fname.endswith(".json"):
            continue
        out_path = os.path.join(out_dir, fname)
        with open(os.path.join(qa_dir, fname)) as f:
            video = json.load(f)
        score_video(client, video, out_path=out_path, log=log)
