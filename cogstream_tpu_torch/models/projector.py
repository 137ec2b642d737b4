"""Vision→LM projector (port of ``cogstream_tpu/models/projector.py``).

``mlp2x_gelu``: Linear(vision_hidden → lm_hidden) → GELU (exact) →
Linear(lm_hidden → lm_hidden).
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from .vision_encoder import linear


def projector_depth(projector_type: str) -> int:
    if projector_type == "linear":
        return 1
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if not m:
        raise ValueError(f"Unknown projector type: {projector_type}")
    return int(m.group(1))


class Projector(nn.Module):
    def __init__(self, vision_hidden: int, lm_hidden: int,
                 projector_type: str = "mlp2x_gelu", device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        depth = projector_depth(projector_type)
        dims = [vision_hidden] + [lm_hidden] * depth
        self.layers = nn.ModuleList(linear(dims[i], dims[i + 1], device, dtype)
                                    for i in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            if i > 0:
                x = F.gelu(x)          # exact erf gelu
            x = layer(x)
        return x
