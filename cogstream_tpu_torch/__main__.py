"""Command line of the port: ``python -m cogstream_tpu_torch <command> ...``

  answer-generate  test-set inference over an HF checkpoint
                   (the reference's torchrun answer_generate.py)
  export-hf        merge LoRA adapters + write an HF-layout checkpoint
                   (PEFT merge_and_unload + save_pretrained)
  serve            JSON-over-HTTP streaming sessions (--pool-rows N:
                   pooled, batched serving; --supervise: a supervisor
                   replaces the serving process after a sticky CUDA
                   error and the new one restores the sessions)
  train-stage1     LoRA training of the history selector
                   (first_stage_training.py; writes language_module.npz)
  train-stage2     the video-text curriculum (second_stage_training.py;
                   writes full_module.npz); --quantize-base
                   {int8,nf4,int4} trains LoRA over a frozen quantized
                   base (QLoRA), --w8a8-forward runs an int8 base W8A8
  judge            run one LLM-judge metric      (eval_{1..5}_*.py)
  summarize        aggregate judged scores       (analysis/step1*.py)
  nlp-metrics      BLEU/METEOR/ROUGE-L/CIDEr     (step2c_basic_nlp_metrics.py)
  segment-videos   split raw videos + sample keyframes (C18)
  datagen          full C19-C24 pipeline over segment specs

These are the commands of ``python -m cogstream_tpu``, with its arguments
and outputs. The model commands run on the CUDA card unless ``--device
cpu`` is given; judge, summarize, nlp-metrics, segment-videos and
datagen run on the host only.
"""

from __future__ import annotations

import sys

# commands of ``python -m cogstream_tpu`` not ported yet, by the ROADMAP
# queue item that holds each: none since every command is ported
NOT_PORTED: dict = {}


def export_hf(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="cogstream_tpu_torch export-hf")
    ap.add_argument("--model-dir", required=True,
                    help="base HF checkpoint directory")
    ap.add_argument("--out", required=True)
    ap.add_argument("--adapter", action="append", default=[],
                    help="LoRA .npz to merge (repeatable)")
    ap.add_argument("--lora-scale", type=float, default=2.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from .config import load_hf_config
    from .models.checkpoint import (load_cogreasoner_from_hf, merge_lora,
                                    save_cogreasoner_to_hf)
    from .train.checkpoint import load_lora_adapter

    cfg = load_hf_config(f"{args.model_dir}/config.json")
    model = load_cogreasoner_from_hf(args.model_dir, cfg, device=args.device)
    for path in args.adapter:
        merge_lora(model, load_lora_adapter(path, device=args.device),
                   lora_scale=args.lora_scale)
    out = save_cogreasoner_to_hf(model, cfg, args.out)
    print(f"exported {out}")
    return 0


def judge(argv) -> int:
    import argparse

    from .evaluate import judges

    ap = argparse.ArgumentParser(prog="cogstream_tpu_torch judge")
    ap.add_argument("--metric", required=True,
                    choices=sorted(judges.METRIC_RUBRICS))
    ap.add_argument("--pred-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--model", default="fake",
                    help="'fake' or an OpenAI-compatible model name")
    args = ap.parse_args(argv)
    client = (judges.FakeJudge() if args.model == "fake"
              else judges.OpenAICompatJudge(args.model))
    judges.judge_directory(args.metric, client, args.pred_dir, args.out_dir,
                           coi_context=args.metric == "DC")
    return 0


def summarize(argv) -> int:
    import argparse

    from .evaluate import aggregate

    ap = argparse.ArgumentParser(prog="cogstream_tpu_torch summarize")
    ap.add_argument("--judged-dir", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    report = aggregate.summarize(args.judged_dir, args.out)
    print(aggregate.format_table(report))
    return 0


def segment_videos(argv) -> int:
    import argparse
    import json

    from .datagen.segmentation import split_and_sample

    ap = argparse.ArgumentParser(prog="cogstream_tpu_torch segment-videos")
    ap.add_argument("--video", required=True)
    ap.add_argument("--timestamps", required=True,
                    help="comma-separated cut points in seconds")
    ap.add_argument("--out-root", required=True)
    args = ap.parse_args(argv)
    ts = [float(t) for t in args.timestamps.split(",") if t.strip()]
    spec = split_and_sample(args.video, args.out_root, ts)
    print(json.dumps({"segments": len(spec["segments"])}))
    return 0


def datagen(argv) -> int:
    import argparse
    import json
    import os

    from .datagen import (dialogue_path, formatting, generation,
                          reformatting, scoring)
    from .datagen.client import FakeMLLM, MLLMClient
    from .utils.io import atomic_write_json

    ap = argparse.ArgumentParser(prog="cogstream_tpu_torch datagen")
    ap.add_argument("--segments-dir", required=True,
                    help="per-video segment specs (C18 output)")
    ap.add_argument("--out-root", required=True)
    ap.add_argument("--model", default="fake",
                    help="'fake' or an OpenAI-compatible model name")
    ap.add_argument("--n-streams", type=int, default=2)
    ap.add_argument("--coi-threshold", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    client = (FakeMLLM(args.seed) if args.model == "fake"
              else MLLMClient(args.model))

    qa_dir = os.path.join(args.out_root, "qas")
    remix_dir = os.path.join(args.out_root, "remixed")
    score_dir = os.path.join(args.out_root, "scores")
    path_dir = os.path.join(args.out_root, "streams")
    final_dir = os.path.join(args.out_root, "dataset")

    generation.run_generation(client, args.segments_dir, qa_dir,
                              seed=args.seed)
    os.makedirs(remix_dir, exist_ok=True)
    for fname in sorted(os.listdir(qa_dir)):
        if not fname.endswith(".json"):
            continue
        out_path = os.path.join(remix_dir, fname)
        if os.path.exists(out_path):
            continue
        with open(os.path.join(qa_dir, fname)) as f:
            video = json.load(f)
        video = reformatting.cap_counts(
            reformatting.remix(video, seed=args.seed), seed=args.seed)
        atomic_write_json(out_path, video)
    scoring.run_scoring(client, remix_dir, score_dir)
    dialogue_path.run_path_construction(
        score_dir, remix_dir, path_dir, n_streams=args.n_streams,
        threshold=args.coi_threshold, seed=args.seed)
    stats = formatting.format_dataset(path_dir, remix_dir, final_dir)
    print(json.dumps(stats))
    return 0


def nlp_metrics(argv) -> int:
    import argparse
    import json

    from .evaluate import nlp_metrics as metrics
    from .evaluate.aggregate import load_judged_dir

    ap = argparse.ArgumentParser(prog="cogstream_tpu_torch nlp-metrics")
    ap.add_argument("--pred-dir", required=True)
    args = ap.parse_args(argv)
    preds, refs = [], []
    for video in load_judged_dir(args.pred_dir):
        for qa in video.get("QAs", []):
            preds.append(qa.get("prediction", ""))
            refs.append(qa.get("answer", ""))
    print(json.dumps(metrics.compute_all(preds, refs)))
    return 0


# host-only commands: each a function of its argument list
HOST_COMMANDS = {"judge": judge, "summarize": summarize,
                 "segment-videos": segment_videos, "datagen": datagen,
                 "nlp-metrics": nlp_metrics}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "answer-generate":
        from .evaluate.answer_generate import main as run

        run(rest)
        return 0
    if cmd == "export-hf":
        return export_hf(rest)
    if cmd == "serve":
        from .runtime.serve import main as run

        run(rest)
        return 0
    if cmd == "train-stage1":
        from .train.stage1 import main as run

        run(rest)
        return 0
    if cmd == "train-stage2":
        from .train.stage2 import main as run

        run(rest)
        return 0
    if cmd in HOST_COMMANDS:
        return HOST_COMMANDS[cmd](rest)
    print(f"unknown command {cmd!r}\n{__doc__}")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
