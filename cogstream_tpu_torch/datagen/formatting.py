"""Final dataset formatting (C24).

Host-only copy of ``cogstream_tpu/datagen/formatting.py`` (the port
imports nothing of the JAX package; tests/test_torch_host.py pins the
copy's code to the original).

Rebuild of dataset_gen_pipeline/data_formating.py: converts dialogue
streams into the consumed layouts — the per-video flat QA list with
binary ``relevance`` vectors (COG_Dataset_simply; what stage-1 training
reads, train/data.py), the merged full-dataset JSON
(COG_streamv_dataset.json), and the published per-video **query-chain**
test-set layout (the format the reference eval consumes,
evaluate/answer_generate.py:98-143: ``Q``/``A`` alternative lists plus
``info.Event_Time`` / ``info.relevance``), so a dataset generated here
feeds ``answer-generate`` directly.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence
from ..utils.io import atomic_write_json


def stream_to_simple(video_name: str, stream: Dict,
                     segments: Sequence[Dict]) -> Dict:
    """One stream → {"QAs": [...]} with binary relevance vectors.

    ``coi`` lists the stream indices of this QA's chain-of-inference
    predecessors (dialogue_path emission), so ``relevance[i]`` is 1
    exactly when the i-th earlier QA of the stream is a predecessor —
    the reference's ``coi_vector`` construction
    (data_formating.py:44-48).
    """
    qas_out: List[Dict] = []
    seg_of_qa: List[int] = []
    for qa in stream.get("QAs", []):
        deps = set(qa.get("coi", []))
        rel = [1 if i in deps else 0 for i in range(len(seg_of_qa))]
        entry = {
            "QA_pairs": qa.get("QA_pairs", []),
            "label": qa.get("label", "Basic"),
            "class": qa.get("class"),
            "is_visual": bool(qa.get("is_visual", True)),
            "segment_path": qa.get("segment_path", 0),
            "relevance": rel,
            "coi": qa.get("coi", []),
        }
        ts = None
        sp = qa.get("segment_path", 0)
        if 0 <= sp < len(segments):
            ts = segments[sp].get("timestamp")
        if ts is not None:
            entry["timestamp"] = ts
        qas_out.append(entry)
        seg_of_qa.append(sp)
    return {"video": video_name, "QAs": qas_out}


def stream_to_query_chain(stream: Dict,
                          segments: Sequence[Dict]) -> List[Dict]:
    """One stream → one published-format query chain.

    Each QA becomes ``{"Q": [q], "A": [a], "info": {...}}``. Distinct
    ``info.Event_Time`` values must sort in segment order because the
    eval loader zips sorted times with naturally-sorted segment files
    (answer_generate.load_eval_spec); we use the segment END time when
    the segment spec carries timestamps and the segment index otherwise.
    ``info.relevance`` is the binary prefix vector the stage-1 loader
    and COI metrics read.
    """
    chain: List[Dict] = []
    seen: List[int] = []
    for qa in stream.get("QAs", []):
        pairs = qa.get("QA_pairs") or []
        if isinstance(pairs, dict):
            pairs = [pairs]
        if not pairs:
            continue
        deps = set(qa.get("coi", []))
        rel = [1 if i in deps else 0 for i in range(len(seen))]
        sp = int(qa.get("segment_path", 0))
        t = float(sp)
        if 0 <= sp < len(segments):
            ts = segments[sp].get("timestamp")
            if isinstance(ts, (list, tuple)) and len(ts) == 2:
                t = float(ts[1])
        chain.append({
            "Q": [p.get("Q", "") for p in pairs],
            "A": [p.get("A", "") for p in pairs],
            "info": {
                "Event_Time": t,
                "relevance": rel,
                "label": qa.get("label", "Basic"),
                "class": qa.get("class"),
                "if_visual": bool(qa.get("is_visual", True)),
            },
        })
        seen.append(sp)
    return chain


def format_dataset(streams_dir: str, qa_dir: str, out_dir: str,
                   merged_name: str = "COG_streamv_dataset.json",
                   log=print) -> Dict:
    """Write per-video simple files + one merged dataset JSON."""
    os.makedirs(out_dir, exist_ok=True)
    merged: Dict[str, List[Dict]] = {}
    for fname in sorted(os.listdir(streams_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(streams_dir, fname)) as f:
            spec = json.load(f)
        segments = []
        qpath = os.path.join(qa_dir, fname)
        if os.path.exists(qpath):
            with open(qpath) as f:
                segments = json.load(f).get("segments", [])
        video = spec.get("video", fname[:-5])
        simple_all = []
        chains = []
        for stream in spec.get("streams", []):
            simple = stream_to_simple(video, stream, segments)
            simple_all.append(simple)
            chain = stream_to_query_chain(stream, segments)
            if chain:
                chains.append(chain)
        atomic_write_json(os.path.join(out_dir, fname), simple_all)
        vname = os.path.splitext(os.path.basename(str(video)))[0]
        chain_dir = os.path.join(out_dir, "query_chains")
        os.makedirs(chain_dir, exist_ok=True)
        atomic_write_json(os.path.join(chain_dir, f"{vname}.json"),
                          {"query_chains": chains}, indent=1)
        merged[video] = simple_all
        log(f"{fname}: {sum(len(s['QAs']) for s in simple_all)} QAs")
    merged_path = os.path.join(out_dir, merged_name)
    atomic_write_json(merged_path, merged, indent=1)
    stats = {
        "videos": len(merged),
        "qas": sum(len(s["QAs"]) for streams in merged.values()
                   for s in streams),
        "merged_path": merged_path,
        "query_chain_dir": os.path.join(out_dir, "query_chains"),
    }
    log(f"dataset: {stats['videos']} videos / {stats['qas']} QAs")
    return stats
