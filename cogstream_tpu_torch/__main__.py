"""Command line of the port: ``python -m cogstream_tpu_torch <command> ...``

  answer-generate  test-set inference over an HF checkpoint
                   (the reference's torchrun answer_generate.py)
  export-hf        merge LoRA adapters + write an HF-layout checkpoint
                   (PEFT merge_and_unload + save_pretrained)
  serve            JSON-over-HTTP streaming sessions (--pool-rows N:
                   pooled, batched serving)
  train-stage1     LoRA training of the history selector
                   (first_stage_training.py; writes language_module.npz)
  train-stage2     the video-text curriculum (second_stage_training.py;
                   writes full_module.npz); --quantize-base
                   {int8,nf4,int4} trains LoRA over a frozen quantized
                   base (QLoRA), --w8a8-forward runs an int8 base W8A8

The other commands of ``python -m cogstream_tpu`` are not ported yet;
each prints the ROADMAP queue item that holds it. The commands run on
the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import sys

NOT_PORTED = {
    "judge": "Queue 1 #8",
    "summarize": "Queue 1 #8",
    "nlp-metrics": "Queue 1 #8",
    "segment-videos": "Queue 1 #8",
    "datagen": "Queue 1 #8",
}


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
    if cmd in NOT_PORTED:
        print(f"{cmd} is not ported to cogstream_tpu_torch yet (ROADMAP "
              f"{NOT_PORTED[cmd]}); use python -m cogstream_tpu {cmd}")
        return 2
    print(f"unknown command {cmd!r}\n{__doc__}")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
