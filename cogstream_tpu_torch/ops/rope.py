"""Rotary position embeddings: 1D (decoder) and 2D (vision grids).

Port of ``cogstream_tpu/ops/rope.py``. Rotate-half is an index
operation here; the JAX package's +-1 permutation matmul existed only to
keep a mid-lane slice off the TPU's cross-lane shuffle path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """inv_freq [head_dim//2] (f32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """[..., head_dim//2] rotation angles for integer positions."""
    inv = rope_frequencies(head_dim, theta, positions.device)
    return positions.to(torch.float32)[..., None] * inv


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE. x: [..., seq, heads, head_dim]; angles:
    [..., seq, head_dim//2] (broadcast over heads). f32 math, cast back."""
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    cos = torch.cat([cos, cos], dim=-1)[..., :, None, :]
    sin = torch.cat([sin, sin], dim=-1)[..., :, None, :]
    xf = x.to(torch.float32)
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# 2D vision RoPE
# ---------------------------------------------------------------------------

def grid_position_ids(t: int, h: int, w: int, merge_size: int) -> np.ndarray:
    """(row, col) ids per patch in merge-block traversal order (host
    numpy). Returns [t*h*w, 2] int32."""
    rows = np.arange(h, dtype=np.int32)[:, None].repeat(w, axis=1)
    cols = np.arange(w, dtype=np.int32)[None, :].repeat(h, axis=0)

    def blockify(a):
        a = a.reshape(h // merge_size, merge_size, w // merge_size, merge_size)
        return a.transpose(0, 2, 1, 3).reshape(-1)

    per_frame = np.stack([blockify(rows), blockify(cols)], axis=-1)
    return np.tile(per_frame, (t, 1))


def vision_rope_angles(pos_ids: torch.Tensor, head_dim: int,
                       theta: float = 10000.0) -> torch.Tensor:
    """Per-patch angles [N, head_dim//2]: the first half rotates by row
    position, the second half by column."""
    quarter = head_dim // 4
    inv = 1.0 / (theta ** (torch.arange(0, quarter, dtype=torch.float32,
                                        device=pos_ids.device) / quarter))
    row_ang = pos_ids[:, 0].to(torch.float32)[:, None] * inv
    col_ang = pos_ids[:, 1].to(torch.float32)[:, None] * inv
    return torch.cat([row_ang, col_ang], dim=-1)


def vision_rope_cos_sin(angles: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [N, 1, head_dim] f32, computed once per forward."""
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    return (torch.cat([cos, cos], dim=-1)[:, None, :],
            torch.cat([sin, sin], dim=-1)[:, None, :])


def apply_vision_rope_cs(x: torch.Tensor, cos2: torch.Tensor,
                         sin2: torch.Tensor) -> torch.Tensor:
    """x: [N, heads, head_dim]; cos2/sin2 from vision_rope_cos_sin. f32
    rotation, cast back to x's dtype."""
    xf = x.to(torch.float32)
    return (xf * cos2 + rotate_half(xf) * sin2).to(x.dtype)


def apply_vision_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [N, heads, head_dim]; angles: [N, head_dim//2]."""
    cos2, sin2 = vision_rope_cos_sin(angles)
    return apply_vision_rope_cs(x, cos2, sin2)
