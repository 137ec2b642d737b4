"""Answer generation over the test set — port of
``cogstream_tpu/evaluate/answer_generate.py``.

Videos shard across processes by the ``torch.distributed`` rank when a
process group is initialized (else one process does them all): pure data
parallelism, no inter-process traffic. Each video streams turn by turn
through either

* the **parity engine** (runtime/engine.py — the full conversation
  re-processed every turn, the reference's semantics), or
* the **streaming session** (runtime/session.py — cross-turn KV reuse).

Per-video JSON output: prediction, predicted COI vector and predicted
if_visual per QA (the fields the judges and the aggregation read).
Existing outputs are skipped (idempotent resume).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..runtime.history import parse_selection
from ..utils.io import atomic_write_json

def shard_items(items: Sequence, index: int, count: int) -> List:
    return [x for i, x in enumerate(items) if i % count == index]


# ---------------------------------------------------------------------------
# published test-set ("query chain") adapter
# ---------------------------------------------------------------------------

_SEGMENT_NUM = re.compile(r"segment_(\d+)")


def natural_segment_order(folder: str) -> List[str]:
    """Segment files of one video dir sorted by their numeric suffix
    (``segment_2`` before ``segment_10``) — the reference's
    natural_sort_segments (evaluate/answer_generate.py:15-28); files
    without a segment number sort last."""
    def key(name: str) -> int:
        m = _SEGMENT_NUM.search(name)
        return int(m.group(1)) if m else 999999

    return sorted(os.listdir(folder), key=key)


def _first(x):
    """Published QA fields are lists of alternatives; take alternative 0
    (ref answer_generate.py:121,143: ``qa["Q"][0]``)."""
    return x[0] if isinstance(x, (list, tuple)) and x else x


def _normalize_chain_qa(qa: Dict) -> Dict:
    info = qa.get("info", {}) or {}
    rel = info.get("relevance", qa.get("relevance"))
    if isinstance(rel, (list, tuple)) and rel and isinstance(
            rel[0], (list, tuple)):
        rel = rel[0]
    return {
        "QA_pairs": {"Q": _first(qa.get("Q", "")),
                     "A": _first(qa.get("A", ""))},
        "relevance": list(rel) if rel is not None else None,
        "is_visual": bool(info.get("if_visual", qa.get("if_visual", True))),
        "label": info.get("label", qa.get("label", "")),
        "class": info.get("class", info.get("type")),
    }


def load_eval_spec(json_path: str, video_dir: str) -> Dict:
    """Read one per-video eval JSON in either layout.

    * **internal spec**: ``{"video": ..., "segments": [{"timestamp",
      "QAs": [...]}]}`` — passed through unchanged;
    * **published query chains** (the CogStream test set,
      ref evaluate/answer_generate.py:78-120): root is a list of query
      chains (chain 0 is used, ref :99), each QA carrying ``Q``/``A``
      lists plus ``info.Event_Time`` / ``info.relevance``. QAs group by
      Event_Time; the k-th distinct sorted time plays the k-th
      naturally-sorted segment file of ``video_dir/<video_name>/``.
    """
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict) and "segments" in data:
        return data
    if isinstance(data, dict) and "query_chains" in data:
        data = data["query_chains"]
    if not isinstance(data, list) or not data:
        raise ValueError(f"{json_path}: unrecognized eval spec")
    chain = data[0] if isinstance(data[0], list) else data

    by_time: Dict[float, List[Dict]] = {}
    for qa in chain:
        t = float(qa["info"]["Event_Time"])
        by_time.setdefault(t, []).append(qa)

    video_name = os.path.splitext(os.path.basename(json_path))[0]
    seg_files = natural_segment_order(os.path.join(video_dir, video_name))
    times = sorted(by_time)
    if len(seg_files) < len(times):
        raise ValueError(
            f"{video_name}: {len(times)} query times but only "
            f"{len(seg_files)} segment files")
    segments = []
    for t, fname in zip(times, seg_files):
        segments.append({
            "segment_file": fname,
            "event_time": t,
            "QAs": [_normalize_chain_qa(qa) for qa in by_time[t]],
        })
    return {"video": video_name, "segments": segments}


def _segment_video_args(video_path: str, seg: Dict, fps: int,
                        max_frames: int) -> Dict:
    """Per-segment video reference: published layout plays a separate
    file per segment (video_path is the per-video directory); the
    internal layout plays [start, end) slices of one file."""
    if "segment_file" in seg:
        return {"video_path": os.path.join(video_path, seg["segment_file"]),
                "fps": fps, "max_frames": max_frames}
    args = {"video_path": video_path, "fps": fps, "max_frames": max_frames}
    s, e = (seg.get("timestamp") or [None, None])[:2]
    if s is not None:
        args["start_time"] = s
    if e is not None:
        args["end_time"] = e
    return args


def _qa_pair(qa: dict) -> dict:
    """First QA pair of a spec entry (both layouts)."""
    return qa["QA_pairs"][0] if isinstance(qa.get("QA_pairs"), list) \
        else qa.get("QA_pairs", qa)


def _qa_result(qa: dict, pair: dict, prediction: str, selection: str,
               pred_visual: bool, n_hist: int, latency_s: float,
               **extra) -> dict:
    """One per-QA output record — single schema for BOTH eval paths
    (the judges/aggregation consume these fields; a field added to one
    path but not the other would silently skew the judges' scores)."""
    _, pred_coi = parse_selection(selection)
    return {
        "question": pair.get("Q", ""),
        "answer": pair.get("A", ""),
        "prediction": prediction,
        "pred_coi": pred_coi,
        "pred_visual": pred_visual,
        "relevance": qa.get("relevance"),
        "coi": qa.get("coi", []),
        "is_visual": qa.get("is_visual", True),
        "label": qa.get("label", ""),
        "class": qa.get("class", qa.get("type")),
        "n_hist": n_hist,
        "latency_s": round(latency_s, 3),
        **extra,
    }


def generate_for_video(
    engine,
    processor,
    video_path: str,
    segments: Sequence[dict],
    mode: str = "FCC",
    max_new_tokens: int = 512,
    fps: int = 1,
    max_frames: int = 180,
    video_role: str = "stream",
    sampling: dict = None,
    log=print,
) -> Dict:
    """Stream one video's dialogue; returns the per-video result dict.

    ``video_role`` picks the prompt placement of each segment's video:
    ``"stream"`` emits a dedicated stream-role turn (this framework's
    richer serialization), ``"user"`` folds the video into the segment's
    first user turn as ``[video, question]`` — byte-parity with the
    reference eval (answer_generate.py:123-134), which a
    reference-trained checkpoint expects zero-shot.
    """
    conversation: List[dict] = []
    results: List[dict] = []
    n_hist = 0
    for seg in segments:
        video_args = _segment_video_args(video_path, seg, fps, max_frames)
        pending_video = [{"type": "video", "video": video_args}]
        if video_role != "user":
            conversation.append({"role": "stream", "content": pending_video})
            pending_video = None
        for qa in seg.get("QAs", []):
            pair = _qa_pair(qa)
            q = pair.get("Q", "")
            if pending_video is not None:   # user-role: video rides turn 1
                conversation.append({
                    "role": "user",
                    "content": pending_video + [{"type": "text", "text": q}],
                })
                pending_video = None
            else:
                conversation.append({"role": "user", "content": q})
            t0 = time.time()
            gt_kwargs = {}
            if mode == "gt":   # teacher-forced selection from GT labels
                rel = qa.get("relevance") or []
                gt_kwargs = {
                    "select_gt": [i for i, r in enumerate(rel) if r],
                    "if_visual": bool(qa.get("is_visual", True)),
                }
            turn = engine.chat(conversation, mode=mode,
                               max_new_tokens=max_new_tokens,
                               **(sampling or {}), **gt_kwargs)
            dt = time.time() - t0
            results.append(_qa_result(qa, pair, turn.text, turn.selection,
                                      turn.if_visual, n_hist, dt))
            conversation.append({"role": "assistant", "content": turn.text})
            n_hist += 1
        if pending_video is not None:   # QA-less segment: keep the video
            conversation.append({"role": "user", "content": pending_video})
    return {"video": video_path, "QAs": results}


def generate_for_video_streaming(
    session_factory,
    processor_cfg,
    video_path: str,
    segments: Sequence[dict],
    mode: str = "FCC",
    max_new_tokens: int = 512,
    sampling: dict = None,
    log=print,
) -> Dict:
    """Streaming-session variant (BASELINE.md config 5): one KV-reusing
    session per video — each segment is ingested once, questions run
    against cached history (vs generate_for_video's per-turn full
    re-process parity path)."""
    from ..processor.image_processor import ImageProcessor
    from ..processor.video_loader import load_video

    sess = session_factory()
    image_processor = ImageProcessor(processor_cfg)
    results: List[dict] = []
    n_hist = 0
    seg_time_end = 0.0     # global-timestamp accumulation (+1s between
                           # segments), matching processor.load_multimodal
    for seg in segments:
        args = _segment_video_args(video_path, seg, processor_cfg.fps,
                                   processor_cfg.max_frames)
        frames, timestamps, _ = load_video(
            args.pop("video_path"),
            start_time=args.get("start_time"),
            end_time=args.get("end_time"),
            fps=args["fps"], max_frames=args["max_frames"])
        if frames:
            # NO rebase — the parity path (processor.load_multimodal,
            # mirroring ref :461-507) accumulates ts + seg_time_end on
            # the loader's own timestamps. Published per-segment FILES
            # start at ~0 so this is identical there; internal specs
            # that slice one file by [start, end) would otherwise get a
            # different global timeline between --streaming and parity
            # runs of the same spec
            stamps = [t + seg_time_end for t in timestamps]
            batch = image_processor([np.stack(frames)], modals=["video"])
            t, gh, gw = (int(x) for x in batch.grid_sizes[0])
            sess.append_stream_segment(
                batch.pixel_values, (t, gh, gw),
                int(batch.merge_sizes[0]), stamps)
            seg_time_end = (max(stamps) if stamps else seg_time_end) + 1.0
        for qa in seg.get("QAs", []):
            pair = _qa_pair(qa)
            q = pair.get("Q", "")
            t0 = time.time()
            r = sess.ask(q, mode=mode, max_new_tokens=max_new_tokens,
                         **(sampling or {}))
            dt = time.time() - t0
            results.append(_qa_result(qa, pair, r["text"], r["selection"],
                                      r["if_visual"], n_hist, dt,
                                      cache_tokens=r["cache_tokens"]))
            n_hist += 1
    return {"video": video_path, "QAs": results, "streaming": True}


def process_rank() -> tuple:
    """(rank, world size) of this process: the ``torch.distributed``
    group's when one is initialized, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def run_eval(
    engine,
    processor,
    video_dir: str,
    query_dir: str,
    save_dir: str,
    mode: str = "FCC",
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    session_factory=None,          # set → streaming KV-reuse path
    processor_cfg=None,
    video_role: str = "stream",
    sampling: dict = None,
    max_new_tokens: int = 512,
    log=print,
) -> None:
    rank, world = process_rank()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    os.makedirs(save_dir, exist_ok=True)

    files = sorted(f for f in os.listdir(query_dir) if f.endswith(".json"))
    for fname in shard_items(files, pi, pc):
        out_path = os.path.join(save_dir, fname)
        if os.path.exists(out_path):  # idempotent resume
            continue
        try:
            spec = load_eval_spec(os.path.join(query_dir, fname), video_dir)
        except Exception as e:
            log(f"{fname}: unreadable spec ({type(e).__name__}: {e})")
            continue
        video = os.path.join(video_dir,
                             spec.get("video", fname[:-5] + ".mp4"))
        try:
            if session_factory is not None:
                result = generate_for_video_streaming(
                    session_factory, processor_cfg, video,
                    spec.get("segments", []), mode=mode,
                    sampling=sampling, max_new_tokens=max_new_tokens)
            else:
                result = generate_for_video(
                    engine, processor, video, spec.get("segments", []),
                    mode=mode, video_role=video_role, sampling=sampling,
                    max_new_tokens=max_new_tokens)
            atomic_write_json(out_path, result, indent=1)
            lat = [q["latency_s"] for q in result["QAs"]]
            log(f"{fname}: {len(lat)} turns, p50 latency "
                f"{np.median(lat) if lat else float('nan'):.2f}s")
        except Exception as e:
            log(f"{fname}: failed ({type(e).__name__}: {e})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--lora-adapter-1", help="language_module .npz")
    ap.add_argument("--lora-adapter-2", help="full_module .npz")
    ap.add_argument("--video-dir", required=True)
    ap.add_argument("--query-dir", required=True)
    ap.add_argument("--save-dir", required=True)
    ap.add_argument("--mode", default="FCC",
                    choices=["FCC", "AC", "NC", "gt"])
    ap.add_argument("--streaming", action="store_true",
                    help="KV-reusing session per video (fast path)")
    ap.add_argument("--video-role", default="stream",
                    choices=["stream", "user"],
                    help="'user' folds each segment's video into its "
                         "first question turn — byte-parity with the "
                         "reference eval serialization")
    ap.add_argument("--sampling", default="greedy",
                    choices=["greedy", "config"],
                    help="'config' decodes with the checkpoint's "
                         "generation_config.json (the reference's "
                         "production sampling); 'greedy' is "
                         "deterministic")
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--lookahead-k", type=int, default=0,
                    help="prompt-lookup speculative decoding draft "
                         "length (exact greedy output, fewer decode "
                         "forwards); only takes effect with --sampling "
                         "greedy: sampled / penalized decodes fall back "
                         "to the vanilla decoder")
    ap.add_argument("--quantize-weights", choices=("int8", "int4"),
                    help="quantize decoder kernels at load: int8 per "
                         "channel (K10 decode), int4 rank-1 uniform (K6-K9)")
    ap.add_argument("--w8a8-prefill", action="store_true",
                    help="int8-activation prefill GEMMs (requires "
                         "--quantize-weights)")
    ap.add_argument("--w4a8-decode", action="store_true",
                    help="int8-activation decode GEMVs (requires "
                         "--quantize-weights int4)")
    ap.add_argument("--encoder-int8", action="store_true",
                    help="W8A8 vision tower")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..runtime.serve import quant_flags, with_text_flags

    flags = quant_flags(args)
    from ..config import load_generation_config, load_hf_config
    from ..models.checkpoint import load_cogreasoner_from_hf
    from ..processor.processing import CogStreamProcessor
    from ..processor.tokenizer import load_tokenizer
    from ..models.cogreasoner import with_int8_tower
    from ..runtime.engine import CogReasonerEngine
    from ..train.checkpoint import load_lora_adapter

    cfg = with_text_flags(
        load_hf_config(os.path.join(args.model_dir, "config.json")), flags)
    model = load_cogreasoner_from_hf(
        args.model_dir, cfg,
        quantize_text_bits={"int8": 8, "int4": 4}.get(args.quantize_weights),
        device=args.device)
    if args.encoder_int8:
        # one W8A8 copy of the tower for the engine and its sessions
        model = with_int8_tower(model)
    tok = load_tokenizer(args.model_dir, cfg.image_token_index,
                         cfg.text.vocab_size)
    adapters = {}
    if args.lora_adapter_1:
        adapters["language_module"] = load_lora_adapter(
            args.lora_adapter_1, device=args.device)
    if args.lora_adapter_2:
        adapters["full_module"] = load_lora_adapter(
            args.lora_adapter_2, device=args.device)
    engine = CogReasonerEngine(model, cfg, tok, adapters=adapters)
    processor = CogStreamProcessor(tok, cfg.processor)
    session_factory = None
    if args.streaming:
        from ..runtime.session import StreamingSession

        def session_factory():
            return StreamingSession(model, cfg, tok, adapters=adapters)

    gen = load_generation_config(args.model_dir)
    if args.sampling == "config":
        sampling = gen.sampling_kwargs
    else:
        # greedy still honors the checkpoint's FULL terminator set — HF
        # stops at every id in generation_config eos_token_id whether or
        # not do_sample is on
        sampling = ({"extra_eos_ids": tuple(gen.eos_token_ids)}
                    if gen.eos_token_ids else None)
    if args.lookahead_k > 0:
        # merged into the per-turn kwargs; the decoders ignore it whenever
        # sampling params make speculative decode unsound
        sampling = {**(sampling or {}), "lookahead_k": args.lookahead_k}
    run_eval(engine, processor, args.video_dir, args.query_dir,
             args.save_dir, mode=args.mode,
             session_factory=session_factory, processor_cfg=cfg.processor,
             video_role=args.video_role, sampling=sampling,
             max_new_tokens=args.max_new_tokens)


if __name__ == "__main__":
    main()
