"""cogstream_tpu_torch — the PyTorch / CUDA (Hopper) port of cogstream_tpu.

The package mirrors ``cogstream_tpu``'s layout (``ops/``, ``models/``,
``runtime/``, ``config.py``, ``presets.py``) so each counterpart is
found by name. It imports ``torch`` and never ``jax`` or
``cogstream_tpu``: the host pieces the serving slice needs (config
dataclasses, the byte tokenizer, selection parsing, prompt strings)
are small copies, pinned to the JAX originals by the tests.

Every Pallas kernel on the serving path has a hand-written CUDA C++
counterpart under ``csrc/``, built with nvcc for ``sm_90a`` at first
use (``ops/kernels.py``). Each kernel's wrapper launches the kernel for
CUDA tensors and runs its plain PyTorch version for CPU tensors.
"""

__version__ = "0.1.0"

from .config import (
    CogReasonerConfig,
    CompressionConfig,
    ProcessorConfig,
    Qwen2Config,
    VisionEncoderConfig,
)
