"""Checkpoint/resume (port of ``cogstream_tpu/train/checkpoint.py``).

* ``save_train_state``/``restore_train_state``: the LoRA tree, optimizer
  state and step counter in one ``torch.save`` file per step
  (``step_<n>.pt``, written to a temporary name and renamed, so a reader
  never sees a partial file). The format is the port's own; a restore
  continues the same trajectory.
* ``save_lora_adapter``/``load_lora_adapter``: just the adapter weights in
  the JAX package's flat ``.npz`` layout (decoder entries stacked
  ``[L, ...]`` under keys such as ``text.layers.attn.q_proj.a``), so
  adapter files interchange between the two packages.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

from ..models import bridge
from ..models.lora import iter_leaves, map_leaves

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                               os.listdir(directory)) if m)


def save_train_state(directory: str, state, extra: Optional[dict] = None,
                     max_to_keep: int = 3) -> int:
    """Save TrainState (lora, opt_state, step) atomically; keep the
    newest ``max_to_keep``. Returns the step."""
    os.makedirs(directory, exist_ok=True)
    step = int(state.step)
    payload = {"lora": map_leaves(lambda t: t.detach().cpu(), state.lora),
               "opt_state": map_leaves(
                   lambda t: t.detach().cpu() if torch.is_tensor(t) else t,
                   state.opt_state),
               "step": step}
    if extra:
        payload["extra"] = extra
    path = os.path.join(directory, f"step_{step}.pt")
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(os.path.join(directory, f"step_{old}.pt"))
    return step


def restore_train_state(directory: str, template_state) -> Any:
    """The latest checkpoint, placed like ``template_state`` (its leaves'
    devices and dtypes; LoRA leaves require grad). None if the directory
    holds no checkpoint."""
    from .trainer import TrainState

    steps = _steps(directory)
    if not steps:
        return None
    # written by save_train_state: tensors, ints and dicts only
    saved = torch.load(os.path.join(directory, f"step_{steps[-1]}.pt"),
                       weights_only=True)

    def place(template, value):
        if isinstance(template, dict):
            return {k: place(template[k], value[k]) for k in template}
        if isinstance(template, (list, tuple)):
            return [place(t, v) for t, v in zip(template, value)]
        if torch.is_tensor(template):
            return value.to(device=template.device, dtype=template.dtype)
        return value

    lora = map_leaves(lambda t: t.requires_grad_(True),
                      place(template_state.lora, saved["lora"]))
    return TrainState(lora, place(template_state.opt_state,
                                  saved["opt_state"]), int(saved["step"]))


def save_lora_adapter(directory: str, lora_tree, name: str = "adapter") -> str:
    """Export the adapter weights (the ``save_pretrained`` analogue) as a
    flat .npz in the JAX package's layout."""
    os.makedirs(directory, exist_ok=True)
    flat = dict(iter_leaves(bridge.lora_to_params(lora_tree)))
    path = os.path.join(directory, f"{name}.npz")
    np.savez(path, **flat)
    return path


def load_lora_adapter(path: str, device=None):
    """Rebuild the port's LoRA tree (trainable f32 leaves on ``device``,
    the card unless named) from a flat .npz export of either package."""
    data = np.load(path)
    tree: dict = {}
    for key in data.files:
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return bridge.lora_from_params(listify(tree), device)
