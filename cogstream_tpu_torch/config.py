"""Configuration dataclasses, copied from ``cogstream_tpu/config.py``.

The JAX package's config module imports ``jax.numpy`` for its dtype
map, so the port cannot import it on a machine without JAX. The
dataclasses below are field-for-field copies (tests/test_torch_host.py
pins every field and default to the JAX original); ``torch_dtype``
replaces ``jnp_dtype``. The HF checkpoint's config files (config.json,
generation_config.json, the two processor JSONs) are read and written
by copies of the JAX package's functions (tests/test_torch_checkpoint.py
holds them to the originals).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Tuple

import torch

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}


@dataclass(frozen=True)
class VisionEncoderConfig:
    """SigLIP-style ViT encoder config."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_channels: int = 3
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"
    # device-side normalization of raw uint8 patch rows
    image_mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    image_std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    rescale_factor: float = 1.0 / 255.0
    attention_dropout: float = 0.0
    initializer_range: float = 0.02
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]


@dataclass(frozen=True)
class Qwen2Config:
    """Qwen2-7B decoder config (GQA, RoPE theta=1e6)."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    tie_word_embeddings: bool = False
    attention_dropout: float = 0.0
    bos_token_id: int = 151643
    eos_token_id: int = 151645
    dtype: str = "bfloat16"
    # quantized serving modes (models/qwen2.py, JAX's gate per call):
    # prefill-length forwards (S >= 16) of a quantized decoder run int8
    # activations under w8a8_prefill (int8 weights: the W8A8 product;
    # uniform rank-1 int4: the W4A8 GEMVs or prefill branch), and
    # decode-length ones (S < 16) under w4a8_decode
    w8a8_prefill: bool = False
    w4a8_decode: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]


@dataclass(frozen=True)
class CompressionConfig:
    """Visual Stream Compression knobs."""

    frames_per_event: int = 15
    min_events_for_compression: int = 10
    keyframes_per_event: int = 2
    similarity_threshold: float = 0.45
    pixel_diff_threshold: float = 0.1
    min_tokens_per_frame: int = 1
    kmeans_alpha: float = 2.0
    kmeans_max_iters: int = 30
    kmeans_tol: float = 1e-4
    summary_max_frames_per_event: int = 64


@dataclass(frozen=True)
class ProcessorConfig:
    """Image/video preprocessing knobs."""

    patch_size: int = 14
    min_tokens: int = 16
    max_tokens: int = 16384
    image_mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    image_std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    rescale_factor: float = 1.0 / 255.0
    fps: int = 1
    max_frames: int = 128
    image_merge_size: int = 1
    video_merge_size: int = 2
    image_token: str = "<image>"
    image_token_id: int = 151665


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA adapter config (reference: first_stage_training.py:458-465)."""

    rank: int = 8
    alpha: float = 16.0
    dropout: float = 0.1
    # module name suffixes to adapt
    target_modules: Tuple[str, ...] = (
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
    )
    include_projector: bool = False  # stage-2 also adapts mm_projector (2nd stage ref :252-255)

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@dataclass(frozen=True)
class CogReasonerConfig:
    """Top-level model config combining decoder + vision tower + modules."""

    text: Qwen2Config = field(default_factory=Qwen2Config)
    vision: VisionEncoderConfig = field(default_factory=VisionEncoderConfig)
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    processor: ProcessorConfig = field(default_factory=ProcessorConfig)
    mm_projector_type: str = "mlp2x_gelu"
    image_token_index: int = 151665
    use_token_compression: bool = True

    @staticmethod
    def tiny() -> "CogReasonerConfig":
        """Scaled-down config with the real one's structural constraints
        (GQA ratio, even heads, merge-divisible patch grids)."""
        return CogReasonerConfig(
            text=Qwen2Config(
                vocab_size=1024,
                hidden_size=64,
                intermediate_size=128,
                num_hidden_layers=2,
                num_attention_heads=4,
                num_key_value_heads=2,
                max_position_embeddings=2048,
                bos_token_id=1,
                eos_token_id=2,
                dtype="float32",
            ),
            vision=VisionEncoderConfig(
                hidden_size=32,
                intermediate_size=64,
                num_hidden_layers=2,
                num_attention_heads=2,
                patch_size=14,
                dtype="float32",
            ),
            image_token_index=1000,
        )


@dataclass(frozen=True)
class GenerationConfig:
    """Decode-sampling defaults (the reference checkpoint ships
    generation_config.json: do_sample, temperature 0.7, top_k 20, top_p
    0.8, repetition_penalty 1.05)."""

    do_sample: bool = True
    temperature: float = 0.7
    top_k: int = 20
    top_p: float = 0.8
    repetition_penalty: float = 1.05
    eos_token_ids: tuple = (151645, 151643)

    @property
    def sampling_kwargs(self) -> dict:
        """kwargs for ``CogReasonerEngine.chat`` / ``StreamingSession.ask``.

        HF applies the repetition-penalty logits processor to greedy
        search too (only the top-k/top-p warpers are sampling-gated) and
        stops at every id in ``eos_token_id``, so both carry over
        whatever ``do_sample`` says."""
        kw = ({"temperature": self.temperature, "top_p": self.top_p,
               "top_k": self.top_k} if self.do_sample
              else {"temperature": 0.0})
        if self.repetition_penalty != 1.0:
            kw["repetition_penalty"] = self.repetition_penalty
        if self.eos_token_ids:
            kw["extra_eos_ids"] = tuple(self.eos_token_ids)
        return kw


def load_generation_config(model_dir: str) -> GenerationConfig:
    """generation_config.json → GenerationConfig (the defaults above
    when the file is absent)."""
    path = os.path.join(model_dir, "generation_config.json")
    if not os.path.exists(path):
        return GenerationConfig()
    with open(path) as f:
        d = json.load(f)
    eos = d.get("eos_token_id", [151645, 151643])
    if isinstance(eos, int):
        eos = [eos]
    return GenerationConfig(
        do_sample=bool(d.get("do_sample", True)),
        temperature=float(d.get("temperature", 1.0)),
        top_k=int(d.get("top_k", 0) or 0),
        top_p=float(d.get("top_p", 1.0)),
        repetition_penalty=float(d.get("repetition_penalty", 1.0)),
        eos_token_ids=tuple(eos),
    )


def load_processor_config(model_dir: str) -> ProcessorConfig:
    """Merge preprocessor_config.json + processor_config.json of an HF
    checkpoint directory into a ProcessorConfig."""
    knobs: dict = {}
    pre = os.path.join(model_dir, "preprocessor_config.json")
    if os.path.exists(pre):
        with open(pre) as f:
            d = json.load(f)
        mean = d.get("image_mean")
        std = d.get("image_std")
        knobs.update({k: v for k, v in {
            "patch_size": d.get("patch_size"),
            "min_tokens": d.get("min_tokens"),
            "max_tokens": d.get("max_tokens"),
            "image_mean": tuple(mean) if mean else None,
            "image_std": tuple(std) if std else None,
            "rescale_factor": d.get("rescale_factor"),
        }.items() if v is not None})
    proc = os.path.join(model_dir, "processor_config.json")
    if os.path.exists(proc):
        with open(proc) as f:
            d = json.load(f)
        knobs.update({k: v for k, v in {
            "fps": d.get("fps"),
            "max_frames": d.get("max_frames"),
            "image_merge_size": d.get("image_merge_size"),
            "video_merge_size": d.get("video_merge_size"),
        }.items() if v is not None})
    return ProcessorConfig(**knobs)


def save_hf_config(cfg: CogReasonerConfig, path: str) -> None:
    """Inverse of :func:`load_hf_config`: a reference-layout config.json,
    so exported checkpoints describe themselves."""
    from .utils.io import atomic_write_json

    t, v = cfg.text, cfg.vision
    atomic_write_json(path, {
        "architectures": ["Videollama3Qwen2ForCausalLM"],
        "model_type": "videollama3_qwen2",
        "torch_dtype": t.dtype,
        "vocab_size": t.vocab_size,
        "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads,
        "max_position_embeddings": t.max_position_embeddings,
        "rms_norm_eps": t.rms_norm_eps,
        "rope_theta": t.rope_theta,
        "tie_word_embeddings": t.tie_word_embeddings,
        "bos_token_id": t.bos_token_id,
        "eos_token_id": t.eos_token_id,
        "vision_encoder_config": {
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_hidden_layers,
            "num_attention_heads": v.num_attention_heads,
            "patch_size": v.patch_size,
        },
        "mm_projector_type": cfg.mm_projector_type,
        "image_token_index": cfg.image_token_index,
        "use_token_compression": cfg.use_token_compression,
    })


def load_hf_config(path: str) -> CogReasonerConfig:
    """A CogReasonerConfig from an HF-style config.json (the reference
    checkpoint's layout)."""
    with open(path) as f:
        d = json.load(f)
    v = d.get("vision_encoder_config") or {}
    dtype = d.get("torch_dtype", "bfloat16")
    return CogReasonerConfig(
        text=Qwen2Config(
            dtype=dtype,
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d["num_key_value_heads"],
            max_position_embeddings=d.get("max_position_embeddings", 32768),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 1e6),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            bos_token_id=d.get("bos_token_id", 151643),
            eos_token_id=d.get("eos_token_id", 151645),
        ),
        vision=VisionEncoderConfig(
            dtype=dtype,
            hidden_size=v.get("hidden_size", 1152),
            intermediate_size=v.get("intermediate_size", 4304),
            num_hidden_layers=v.get("num_hidden_layers", 27),
            num_attention_heads=v.get("num_attention_heads", 16),
            patch_size=v.get("patch_size", 14),
        ),
        mm_projector_type=d.get("mm_projector_type", "mlp2x_gelu"),
        image_token_index=d.get("image_token_index", 151665),
        use_token_compression=d.get("use_token_compression", True),
    )
