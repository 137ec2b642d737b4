"""Configuration dataclasses, copied from ``cogstream_tpu/config.py``.

The JAX package's config module imports ``jax.numpy`` for its dtype
map, so the port cannot import it on a machine without JAX. The
dataclasses below are field-for-field copies (tests/test_torch_host.py
pins every field and default to the JAX original); ``torch_dtype``
replaces ``jnp_dtype``.
"""

from __future__ import annotations

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
    # quantized serving modes. w4a8_decode is live: decode-length
    # forwards (S < 16) of a rank-1 int4 decoder (ops/quant.py) run int8
    # activations through the W4A8 GEMVs (K7/K9). w8a8_prefill is not
    # ported yet: a session built with it raises NotImplementedError
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
