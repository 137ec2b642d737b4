"""Model size presets (copies of ``cogstream_tpu/presets.py``).

``cogreasoner_7b`` is the reference checkpoint's shape; ``demo`` keeps
every structural ratio at a size that initializes quickly.
"""

from __future__ import annotations

from .config import CogReasonerConfig, Qwen2Config, VisionEncoderConfig


def cogreasoner_7b() -> CogReasonerConfig:
    return CogReasonerConfig()  # defaults are the 7B reference shapes


def demo() -> CogReasonerConfig:
    """~0.5B decoder + small SigLIP tower; same structure as 7B."""
    return CogReasonerConfig(
        text=Qwen2Config(
            vocab_size=152064,
            hidden_size=1024,
            intermediate_size=5504,
            num_hidden_layers=8,
            num_attention_heads=16,
            num_key_value_heads=4,
            max_position_embeddings=32768,
            rope_theta=1e6,
        ),
        vision=VisionEncoderConfig(
            hidden_size=384,
            intermediate_size=1536,
            num_hidden_layers=6,
            num_attention_heads=6,
            patch_size=14,
        ),
        image_token_index=151665,
    )
