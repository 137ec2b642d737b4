"""The (data, model) mesh over the ranks of a process group and the
collectives the sharded forwards use — port of
``cogstream_tpu/parallel/mesh.py``.

A :class:`Mesh` lays the world out as ``(data, model)`` in row-major order
(rank ``r`` sits at ``(r // model, r % model)``, as JAX's ``reshape`` of
the device list) and holds one process group per axis slice: the ranks of
this rank's row (its ``model`` group, over which a tensor-parallel layer
reduces) and of its column (its ``data`` group). Every rank must build the
same meshes in the same order (``new_group`` is collective).

The collectives below skip a group of one rank, count each call by kind in
:data:`COLLECTIVES` (the per-step collective counts the smoke prints), and
reduce bf16 partial sums in f32, rounding once.
"""

from __future__ import annotations

import datetime
from collections import Counter
from typing import List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# collectives issued by the sharded forwards, by kind
COLLECTIVES: Counter = Counter()

# the host group's wait: ranks > 0 of a sharded server wait in it for the
# next request however long the server idles (a rank's failure ends every
# rank through the server's fault path, not through this timeout)
HOST_TIMEOUT = datetime.timedelta(days=365)


def axis_ranks(data: int, model: int):
    """The rank lists of a ``data x model`` layout: one per ``model``
    group (a row, ``[d * model, (d + 1) * model)``) and one per ``data``
    group (a column, every ``model``-th rank), row-major as JAX's
    ``reshape`` of the device list."""
    world = data * model
    return ([list(range(d * model, (d + 1) * model)) for d in range(data)],
            [list(range(m, world, model)) for m in range(model)])


class Mesh:
    """A ``data x model`` layout of the process group's ranks."""

    def __init__(self, data: int, model: int):
        """The mesh of the process group (every rank calls it together)."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} != {world} ranks")
        self.data, self.model = data, model
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.data_index, self.model_index = divmod(self.rank, model)
        self.model_group = self.data_group = self.host_group = None
        if world > 1:
            # every rank creates every group, in one order
            rows, cols = axis_ranks(data, model)
            for d, ranks in enumerate(rows):
                g = dist.new_group(ranks)
                if d == self.data_index:
                    self.model_group = g
            for m, ranks in enumerate(cols):
                g = dist.new_group(ranks)
                if m == self.model_index:
                    self.data_group = g
            # host objects (requests, results) travel over gloo whatever
            # carries the tensors; a follower idles in it between requests
            self.host_group = dist.new_group(backend="gloo",
                                             timeout=HOST_TIMEOUT)
        if model == 1:
            self.model_group = None
        if data == 1:
            self.data_group = None

    def __deepcopy__(self, memo):
        # a handle on process groups: copies of a sharded model share it
        return self

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, "
                f"rank={self.rank})")


def make_mesh(data_parallel: Optional[int] = None,
              model_parallel: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over the process group's ranks (one rank
    without a group). With one size given the other is inferred; with
    neither, every rank goes on the model axis (tensor parallelism, the
    7B default). A product that is not the world size raises."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data_parallel is None and model_parallel is None:
        data_parallel, model_parallel = 1, n
    elif data_parallel is None:
        data_parallel = n // model_parallel
    elif model_parallel is None:
        model_parallel = n // data_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(
            f"mesh {data_parallel}x{model_parallel} != {n} ranks")
    return Mesh(data_parallel, model_parallel)


def single_device_mesh() -> Mesh:
    """The 1 x 1 mesh of a process outside any group."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        raise ValueError("single_device_mesh inside a multi-rank group")
    return Mesh(1, 1)


def divisible(dim: int, mesh: Mesh, axis: str = MODEL_AXIS) -> bool:
    return dim % mesh.shape[axis] == 0


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` summed (``op="sum"``) or maxed (``"max"``) over ``group``; a
    bf16 / f16 sum runs in f32 and rounds once. Returns the result (``x``
    itself when no cast was needed). A group of one returns ``x``."""
    if group is None:
        return x
    COLLECTIVES[f"all_reduce_{op}"] += 1
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    if op == "sum" and x.dtype in (torch.bfloat16, torch.float16):
        y = x.to(torch.float32)
        dist.all_reduce(y, red, group=group)
        return y.to(x.dtype)
    y = x.contiguous()
    dist.all_reduce(y, red, group=group)
    return y


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ``group``'s tensors concatenated along ``dim`` in rank order."""
    if group is None:
        return x
    COLLECTIVES["all_gather"] += 1
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_gather_objects(obj, group) -> list:
    """Every rank's host object, in rank order (``group`` a gloo group)."""
    if group is None:
        return [obj]
    out = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj, group, src: int = 0):
    """Rank ``src``'s host object on every rank of ``group``."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
