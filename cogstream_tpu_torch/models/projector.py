"""Vision→LM projector (port of ``cogstream_tpu/models/projector.py``).

``mlp2x_gelu``: Linear(vision_hidden → lm_hidden) → GELU (exact) →
Linear(lm_hidden → lm_hidden). :func:`projector_forward_lora` is the
stage-2 training readout with a LoRA delta on each linear (the JAX
package writes it inline in ``train/multimodal.py``). A linear may be a
``QuantLinear`` of any scheme (the QLoRA base,
``ops/quant.quantize_cogreasoner_``): both forwards then dequantize its
weight in the activations' dtype, as JAX's ``materialize_kernel`` does.

Sharded for a mesh (``proj.tp``, parallel/sharding.py), the mlp2x_gelu
readout runs its first linear column-parallel and its second row-parallel
(all-reduced, then the bias).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import materialized_linear
from ..parallel.mesh import copy_to_model
from .qwen2 import _add_lora, adapter_in
from .vision_encoder import default_device, linear


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
        device = default_device(device)
        dims = [vision_hidden] + [lm_hidden] * depth
        self.layers = nn.ModuleList(linear(dims[i], dims[i + 1], device, dtype)
                                    for i in range(depth))
        # the tensor-parallel plan (parallel/sharding.ProjectorShard)
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = self.tp is not None and self.tp.hidden is not None
        for i, layer in enumerate(self.layers):
            if i > 0:
                x = F.gelu(x)          # exact erf gelu
            x = materialized_linear(
                layer, x, self.tp.group if split and i == 1 else None)
        return x


def projector_forward_lora(proj: Projector, x: torch.Tensor,
                           lora_layers: Sequence[Dict], lora_scale: float,
                           dropout_rate: float = 0.0,
                           generators: Optional[Sequence] = None
                           ) -> torch.Tensor:
    """The readout with a low-rank delta on each linear, applied to the
    input that linear saw: ``layer(x) + (x_a @ a) @ b * scale``, where
    ``x_a`` is ``x`` with LoRA dropout (one generator per linear, or
    none).

    Sharded (``proj.tp``): the first linear is column-parallel (its
    replicated input through ``copy_to_model``, ``b`` its columns) and
    the second row-parallel (``a`` its rows, the dropout mask the slice of
    the whole input's), as ``qwen2._add_lora`` sets out."""
    split = proj.tp is not None and proj.tp.hidden is not None
    group = proj.tp.group if split else None
    for i, (layer, ab) in enumerate(zip(proj.layers, lora_layers)):
        if i > 0:
            x = F.gelu(x)          # exact erf gelu
        gen = generators[i] if generators else None
        if split and i == 1:
            lo, hi = proj.tp.hidden
            width = (hi - lo) * proj.tp.mesh.model
            xa = adapter_in(x, dropout_rate, gen, (width, *proj.tp.hidden))
            x = _add_lora(materialized_linear(layer, x, group), xa,
                          [(ab, 1.0)], lora_scale, row=group)
            continue
        if split:
            x = copy_to_model(x, group)
        x = _add_lora(materialized_linear(layer, x),
                      adapter_in(x, dropout_rate, gen), [(ab, 1.0)],
                      lora_scale, col=group)
    return x
