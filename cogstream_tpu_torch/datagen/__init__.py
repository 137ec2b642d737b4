"""Semi-automatic dataset generation pipeline (C18-C24).

Host-only copy of ``cogstream_tpu/datagen/__init__.py`` (the port
imports nothing of the JAX package; tests/test_torch_host.py pins the
copy's code to the original).

Stage chain mirroring dataset_gen_pipeline/README.md:63-119:

    segmentation.split_and_sample   (C18: split + keyframes)
    → generation.run_generation     (C19: per-segment QA generation)
    → reformatting.remix/cap_counts (C20: remix + caps + DU injection)
    → scoring.run_scoring           (C21: 0-7 dependency scores)
    → dialogue_path.run_path_construction  (C23: COI graph → streams)
    → formatting.format_dataset     (C24: final consumable layouts)

Every stage is resumable (skip-if-output-exists) and all LLM calls go
through datagen.client (C22) — swap in FakeMLLM for offline runs.
"""

from . import (  # noqa: F401
    client,
    dialogue_path,
    formatting,
    generation,
    prompts,
    reformatting,
    scoring,
    segmentation,
)
