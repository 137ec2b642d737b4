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

A mesh run (a ``TrainState`` carrying its ``LoraLayout``, or a pipeline
run's ``PipeLayout`` of stage slices) saves the same files: every rank
takes part in gathering the LoRA leaves and the optimizer's moments whole,
rank 0 writes, and every rank waits for the write. A restore reads the whole state and keeps the rank's slices, so a
run saved on one layout resumes on another, or in one process.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

from ..models import bridge
from ..models.lora import iter_leaves, map_leaves
from ..parallel.distributed import sync_global_devices

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                               os.listdir(directory)) if m)


def _writer() -> bool:
    """True on the rank that writes (rank 0, or the only process)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _map_moments(opt_state, n: int, fn):
    """``opt_state`` with every list of ``n`` per-leaf tensors (AdamW's
    ``mu`` / ``nu``, MultiSteps' ``acc``) replaced by ``fn(list)``."""
    if isinstance(opt_state, dict):
        return {k: _map_moments(v, n, fn) for k, v in opt_state.items()}
    if isinstance(opt_state, list) and len(opt_state) == n and all(
            torch.is_tensor(t) for t in opt_state):
        return fn(opt_state)
    return opt_state


def _whole(state):
    """(lora, opt_state) of ``state`` as one process holds them: gathered
    from every rank's slices on a mesh (collective)."""
    layout = getattr(state, "layout", None)
    if layout is None:
        return state.lora, state.opt_state
    n = len(list(iter_leaves(state.lora)))
    return (layout.gather(state.lora),
            _map_moments(state.opt_state, n, layout.gather_leaves))


def save_train_state(directory: str, state, extra: Optional[dict] = None,
                     max_to_keep: int = 3) -> int:
    """Save TrainState (lora, opt_state, step) atomically; keep the
    newest ``max_to_keep``. Returns the step. On a mesh every rank calls
    it: the state is gathered whole and rank 0 writes."""
    lora, opt_state = _whole(state)
    step = int(state.step)
    if _writer():
        os.makedirs(directory, exist_ok=True)
        payload = {"lora": map_leaves(lambda t: t.detach().cpu(), lora),
                   "opt_state": map_leaves(
                       lambda t: t.detach().cpu() if torch.is_tensor(t)
                       else t, opt_state),
                   "step": step}
        if extra:
            payload["extra"] = extra
        path = os.path.join(directory, f"step_{step}.pt")
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in _steps(directory)[:-max_to_keep]:
            os.remove(os.path.join(directory, f"step_{old}.pt"))
    if getattr(state, "layout", None) is not None:
        sync_global_devices("train state written")
    return step


def restore_train_state(directory: str, template_state) -> Any:
    """The latest checkpoint, placed like ``template_state`` (its leaves'
    devices and dtypes; LoRA leaves require grad). None if the directory
    holds no checkpoint. A template carrying a ``LoraLayout`` gets this
    rank's slices of the saved (whole) state."""
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

    layout = getattr(template_state, "layout", None)
    lora, opt_state = saved["lora"], saved["opt_state"]
    if layout is not None:
        # the saved moments are the whole tree's (a stage keeps fewer)
        n = len(list(iter_leaves(lora)))
        lora = layout.shard(lora)
        opt_state = _map_moments(opt_state, n, layout.shard_leaves)
    lora = map_leaves(lambda t: t.detach().requires_grad_(True),
                      place(template_state.lora, lora))
    return TrainState(lora, place(template_state.opt_state, opt_state),
                      int(saved["step"]), layout)


def save_lora_adapter(directory: str, lora_tree, name: str = "adapter",
                      layout=None) -> str:
    """Export the adapter weights (the ``save_pretrained`` analogue) as a
    flat .npz in the JAX package's layout. With ``layout`` (a mesh run's
    ``LoraLayout``) every rank calls it: the tree is gathered whole and
    rank 0 writes the one-process file."""
    if layout is not None:
        lora_tree = layout.gather(lora_tree)
    path = os.path.join(directory, f"{name}.npz")
    if _writer():
        os.makedirs(directory, exist_ok=True)
        flat = dict(iter_leaves(bridge.lora_to_params(lora_tree)))
        np.savez(path + ".tmp.npz", **flat)
        os.replace(path + ".tmp.npz", path)
    if layout is not None:
        sync_global_devices("adapter written")
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
