"""The (data, model) mesh over the ranks of a process group, the (data,
pipe) and sequence-parallel layouts beside it, and the collectives the
sharded forwards use — port of ``cogstream_tpu/parallel/mesh.py`` (and of
``make_pipeline_mesh`` in ``cogstream_tpu/parallel/pipeline.py``).

A :class:`Mesh` lays the world out as ``(data, model)`` in row-major order
(rank ``r`` sits at ``(r // model, r % model)``, as JAX's ``reshape`` of
the device list) and holds one process group per axis slice: the ranks of
this rank's row (its ``model`` group, over which a tensor-parallel layer
reduces) and of its column (its ``data`` group). Every rank must build the
same meshes in the same order (``new_group`` is collective).

The collectives below skip a group of one rank, count each call by kind in
:data:`COLLECTIVES` (the per-step collective counts the smoke prints), and
reduce bf16 partial sums in f32, rounding once.

Under autograd (training) a SUM of a tensor that requires grad is the
Megatron "reduce from the model group" operator: all-reduce forward,
identity backward. Its partner :func:`copy_to_model` ("copy to the model
group": identity forward, all-reduce backward) goes on the replicated input
of a column-parallel site, so the partial input gradients of the ranks'
column blocks sum to the whole one. A result that every rank computes from
whole tensors is replicated, and so is its gradient: with both operators
in place every replicated leaf's gradient comes out whole on each rank.
:func:`all_reduce_grads` sums a list of gradients over a group in one
flat collective (the data-parallel gradient sum).

:func:`ppermute` is JAX's ``lax.ppermute`` over a group: every rank sends
to the rank ``shift`` places on and receives from the one ``shift`` places
back, in one batch of paired ``isend`` / ``irecv``; under autograd its
backward is the reverse hop. The GPipe schedule (parallel/pipeline.py)
and the ring attention (ops/ring_attention.py) rest on it.
:class:`PipelineMesh` lays the world out as ``(data, pipe)``, row-major
as JAX's ``reshape(data_parallel, n_stages)``, and :class:`SequenceMesh`
puts every rank on one ``sp`` axis.

:func:`gather_to_first` and :func:`scatter_from_first` move a sharded
session's cache between the ranks of a model group and its first rank,
which alone reads and writes snapshot files (:func:`broadcast_from_first`
hands a whole cache from rank 0 to the first ranks of the other data
groups, where a session is replicated over them). They move bytes (``uint8``
views): gloo refuses ``float8_e4m3fn`` (probed with torch 2.11 and 2.13:
"Invalid scalar type"), and a byte copy is exact for every dtype. An error
that every rank of a group raises at the same point, after the same
collectives, is an :class:`AgreedError`: the group is still in step.
"""

from __future__ import annotations

import datetime
import pickle
from collections import Counter
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SP_AXIS = "sp"

# collectives issued by the sharded forwards, by kind
COLLECTIVES: Counter = Counter()
# bytes a rank sent in them, by kind (point-to-point hops only)
COLLECTIVE_BYTES: Counter = Counter()

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


class _Grid:
    """A ``data x n`` layout of the process group's ranks in row-major
    order (JAX's ``reshape(data, n)``): rank ``r`` sits at ``(r // n, r %
    n)``. A subclass names the inner axis (``AXIS``); its size, this
    rank's index on it and its group (this rank's row) are ``<AXIS>``,
    ``<AXIS>_index`` and ``<AXIS>_group``, the data axis's (this rank's
    column) ``data``, ``data_index`` and ``data_group``. A group is None
    on an axis of one rank."""

    AXIS = ""

    def __init__(self, data: int, n: int):
        """The layout of the process group (every rank calls it together:
        every rank creates every group, in one order)."""
        world = world_size()
        if data * n != world:
            raise ValueError(f"mesh {data}x{n} != {world} ranks")
        self.data, self._n = data, n
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.data_index, index = divmod(self.rank, n)
        row = self.data_group = self.host_group = None
        if world > 1:
            rows, cols = axis_ranks(data, n)
            for d, ranks in enumerate(rows):
                g = dist.new_group(ranks)
                if d == self.data_index and n > 1:
                    row = g
            for m, ranks in enumerate(cols):
                g = dist.new_group(ranks)
                if m == index and data > 1:
                    self.data_group = g
            # host objects (requests, results) travel over gloo whatever
            # carries the tensors; a follower idles in it between requests
            self.host_group = dist.new_group(backend="gloo",
                                             timeout=HOST_TIMEOUT)
        setattr(self, self.AXIS, n)
        setattr(self, f"{self.AXIS}_index", index)
        setattr(self, f"{self.AXIS}_group", row)

    def __deepcopy__(self, memo):
        # a handle on process groups: copies of a sharded model share it
        return self

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, self.AXIS: self._n}

    @property
    def size(self) -> int:
        return self.data * self._n

    @property
    def grad_group(self):
        """The group over which the ranks' losses and LoRA gradients are
        partial sums of the step's (the data group)."""
        return self.data_group

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(data={self.data}, "
                f"{self.AXIS}={self._n}, rank={self.rank})")


class Mesh(_Grid):
    """A ``data x model`` layout of the process group's ranks (tensor
    parallelism on ``model``)."""

    AXIS = MODEL_AXIS
    model: int
    model_index: int
    model_group: Optional[dist.ProcessGroup]


class PipelineMesh(_Grid):
    """A ``data x pipe`` layout (JAX's ``make_pipeline_mesh``): rank ``r``
    is stage ``r % pipe`` of data replica ``r // pipe``. Its gradients sum
    over the data group only: each stage holds its own layers' adapters,
    and a replicated leaf gets its whole gradient on every stage."""

    AXIS = PIPE_AXIS
    pipe: int
    pipe_index: int
    pipe_group: Optional[dist.ProcessGroup]


def make_pipeline_mesh(n_stages: int,
                       data_parallel: Optional[int] = None) -> PipelineMesh:
    """The (data, pipe) mesh over the process group's ranks, with JAX's
    messages: fewer ranks than ``data_parallel x n_stages`` raise (JAX:
    "needs N devices"); more raise too, with JAX's warning as the
    message (one process a rank cannot idle through a step that every
    rank of the world takes part in). ``data_parallel`` defaults to the
    world over ``n_stages``."""
    world = world_size()
    data = data_parallel or max(1, world // n_stages)
    need = n_stages * data
    if world < need:
        raise ValueError(
            f"pipeline mesh {data}x{n_stages} needs {need} "
            f"devices, have {world}")
    if world > need:
        raise ValueError(
            f"pipeline mesh {data}x{n_stages} uses {need} of {world} "
            "devices; the rest idle — raise data_parallel (or stages) to "
            "cover them")
    return PipelineMesh(data, n_stages)


class SequenceMesh(_Grid):
    """Every rank of the process group on one ``sp`` axis (stage 2's ring
    sequence parallelism, JAX's ``Mesh(devices[:n], ("sp",))``): the turn
    is split along the sequence, weights and adapters are replicated."""

    AXIS = SP_AXIS
    sp: int
    sp_index: int
    sp_group: Optional[dist.ProcessGroup]

    def __init__(self, n: int):
        super().__init__(1, n)

    @property
    def grad_group(self):
        """The sp group: each rank's loss is its shard's share and its
        gradients are partial sums."""
        return self.sp_group


def world_size() -> int:
    """The process group's size (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_shape(data_parallel: Optional[int] = None,
               model_parallel: Optional[int] = None,
               world: Optional[int] = None) -> Tuple[int, int]:
    """The (data, model) sizes :func:`make_mesh` lays out over ``world``
    ranks (default: the process group's): with one size given the other
    is inferred; with neither, every rank goes on the model axis (tensor
    parallelism, the 7B default). Not checked against ``world``."""
    n = world_size() if world is None else world
    if data_parallel is None and model_parallel is None:
        return 1, n
    if data_parallel is None:
        return n // model_parallel, model_parallel
    if model_parallel is None:
        return data_parallel, n // data_parallel
    return data_parallel, model_parallel


def make_mesh(data_parallel: Optional[int] = None,
              model_parallel: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over the process group's ranks (one rank
    without a group), sized by :func:`mesh_shape`. A product that is not
    the world size raises."""
    n = world_size()
    data, model = mesh_shape(data_parallel, model_parallel, n)
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return Mesh(data, model)


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
    itself when no cast was needed). A group of one returns ``x``.

    A SUM of a tensor in an autograd graph is :class:`_ReduceFromModel`
    (identity backward) and never touches ``x``; a MAX there returns a
    constant of the graph."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        if op == "sum":
            return _ReduceFromModel.apply(x, group)
        x = x.detach().clone()
    return _all_reduce(x, group, op)


def _all_reduce(x: torch.Tensor, group, op: str) -> torch.Tensor:
    COLLECTIVES[f"all_reduce_{op}"] += 1
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    if op == "sum" and x.dtype in (torch.bfloat16, torch.float16):
        y = x.to(torch.float32)
        dist.all_reduce(y, red, group=group)
        return y.to(x.dtype)
    y = x.contiguous()
    dist.all_reduce(y, red, group=group)
    return y


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (SUM) forward, identity backward: the partial sums of a
    row-parallel product become the whole output on every rank, and the
    output's gradient, whole on every rank, is each partial's."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce (SUM) backward: a replicated tensor
    feeding this rank's block of a column-parallel site gets the sum of
    every block's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group, "sum"), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the replicated input of a column-parallel site over
    ``group`` (:class:`_CopyToModel`); ``x`` itself outside autograd or
    for a group of one."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, group)


def all_reduce_grads(grads: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each gradient summed over ``group`` in ONE all-reduce of a flat
    f32 buffer (the data-parallel gradient sum); each comes back in its
    own dtype and shape. A group of one returns ``grads``."""
    if group is None or not grads:
        return grads
    flat = torch.cat([g.detach().reshape(-1).to(torch.float32)
                      for g in grads])
    flat = _all_reduce(flat, group, "sum")
    out, at = [], 0
    for g in grads:
        n = g.numel()
        out.append(flat[at:at + n].view(g.shape).to(g.dtype))
        at += n
    return out


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ``group``'s tensors concatenated along ``dim`` in rank order."""
    if group is None:
        return x
    COLLECTIVES["all_gather"] += 1
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _hop(tensors, group, shift: int) -> List[torch.Tensor]:
    """One ``ppermute`` hop of ``tensors`` (no autograd): each sent as its
    bytes to the rank ``shift`` places on in ``group`` while the same
    shapes arrive from the rank ``shift`` places back, all in one batch of
    paired ``isend`` / ``irecv`` waited together (a ring of blocking sends
    would deadlock). The route follows the group's backend: NCCL moves
    CUDA tensors itself; gloo's send / recv take CPU tensors only, so over
    gloo a CUDA tensor crosses through a host copy."""
    n = group_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    via_host = dist.get_backend(group) == "gloo"
    COLLECTIVES["ppermute"] += 1
    ops, got = [], []
    for t in tensors:
        b = as_bytes(t)
        if via_host:
            b = b.cpu()
        r = torch.empty_like(b)
        COLLECTIVE_BYTES["ppermute"] += b.numel()
        ops += [dist.P2POp(dist.isend, b, dst, group),
                dist.P2POp(dist.irecv, r, src, group)]
        got.append(r)
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return [r.to(t.device).view(t.dtype).view(t.shape)
            for r, t in zip(got, tensors)]


class _PPermute(torch.autograd.Function):
    """:func:`_hop` forward; backward, the reverse hop of every floating
    input's gradient (zeros where an output had none), so every rank
    sends and receives in every backward hop. Integer tensors (positions)
    travel forward only."""

    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.group, ctx.shift = group, shift
        ctx.fp = [x.is_floating_point() for x in xs]
        out = _hop(xs, group, shift)
        ctx.mark_non_differentiable(*[o for o, f in zip(out, ctx.fp)
                                      if not f])
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        sent = [g.contiguous() for g, f in zip(gs, ctx.fp) if f]
        back = iter(_hop(sent, ctx.group, -ctx.shift))
        return (None, None, *[next(back) if f else None for f in ctx.fp])


def ppermute(x, group, shift: int = 1):
    """JAX's ``lax.ppermute`` with ``perm = [(i, (i + shift) % n)]`` over
    ``group``: each rank's ``x`` (a tensor, or a tuple of tensors sent in
    one hop) arrives at the rank ``shift`` places on, and what the rank
    ``shift`` places back sent is returned, in ``x``'s shapes and dtypes.
    Under autograd the backward is the reverse permutation. Every rank of
    ``group`` must call it with the same shapes in the same order, in the
    forward and (through autograd) in the backward. A group of one returns
    ``x``. Counted in ``COLLECTIVES["ppermute"]`` (a hop) and
    ``COLLECTIVE_BYTES["ppermute"]`` (the bytes this rank sent)."""
    if group is None or group_size(group) == 1:
        return x
    xs = (x,) if torch.is_tensor(x) else tuple(x)
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        out = _PPermute.apply(group, shift, *xs)
    else:
        out = tuple(_hop(xs, group, shift))
    return out[0] if torch.is_tensor(x) else out


def all_gather_objects(obj, group) -> list:
    """Every rank's host object, in rank order (``group`` a gloo group)."""
    if group is None:
        return [obj]
    out = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj, group, src: int = 0):
    """The host object of ``group``'s rank ``src`` (its rank within the
    group) on every rank of ``group``."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, group=group, group_src=src)
    return box[0]


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes: a ``uint8`` view of it (contiguous)."""
    return x.contiguous().view(torch.uint8)


def gather_to_first(x: torch.Tensor, group) -> Optional[List[torch.Tensor]]:
    """Every rank's ``x`` (one shape and dtype on every rank) on the first
    rank of ``group``, in rank order; None on the others. ``[x]`` for a
    group of one."""
    if group is None:
        return [x]
    COLLECTIVES["gather"] += 1
    b = as_bytes(x)
    first = dist.get_rank(group) == 0
    parts = ([torch.empty_like(b) for _ in range(group_size(group))]
             if first else None)
    dist.gather(b, parts, group=group, group_dst=0)
    return [p.view(x.dtype) for p in parts] if first else None


def scatter_from_first(parts: Optional[List[torch.Tensor]],
                       like: torch.Tensor, group) -> torch.Tensor:
    """Rank ``i`` of ``group`` receives ``parts[i]`` of its first rank
    (``parts`` None elsewhere); ``like`` gives the part's shape, dtype and
    device on every rank. ``parts[0]`` for a group of one."""
    if group is None:
        return parts[0]
    COLLECTIVES["scatter"] += 1
    out = torch.empty_like(as_bytes(like))
    dist.scatter(out, None if parts is None else [as_bytes(p) for p in parts],
                 group=group, group_src=0)
    return out.view(like.dtype)


def broadcast_from_first(x: Optional[torch.Tensor], like: torch.Tensor,
                         group) -> torch.Tensor:
    """The first rank of ``group``'s ``x`` (None elsewhere) on every rank,
    as bytes; ``like`` gives its shape, dtype and device on every rank.
    ``x`` itself for a group of one."""
    if group is None:
        return x
    COLLECTIVES["broadcast"] += 1
    out = as_bytes(x) if dist.get_rank(group) == 0 \
        else torch.empty_like(as_bytes(like))
    dist.broadcast(out, group=group, group_src=0)
    return out.view(like.dtype)


class AgreedError(RuntimeError):
    """``error``, raised by every rank of a group at the same point after
    the same collectives (the first rank decided it and told the others):
    no rank is left in a collective, so a sharded server answers it as a
    solo server answers ``error`` and keeps serving."""

    def __init__(self, error: BaseException):
        super().__init__(error)
        self.error = error

    def __str__(self) -> str:
        return f"{type(self.error).__name__}: {self.error}"


def portable(error: Optional[BaseException]) -> Optional[BaseException]:
    """``error`` if it pickles, else a RuntimeError with its text (an
    error sent to other ranks)."""
    if error is None:
        return None
    try:
        pickle.dumps(error)
        return error
    except Exception:  # noqa: BLE001 — its text still travels
        return RuntimeError(f"{type(error).__name__}: {error}")


def agree(error: Optional[BaseException], group) -> None:
    """The first rank of ``group`` tells the others its ``error`` (None:
    success); every rank then raises :class:`AgreedError` of it, or
    returns. A group of one raises ``error`` itself."""
    if group is None:
        if error is not None:
            raise error
        return
    error = broadcast_object(portable(error), group)
    if error is not None:
        raise AgreedError(error)
