"""Process-group bring-up and fault helpers — port of
``cogstream_tpu/parallel/distributed.py``.

The JAX package drives every device of its mesh from one process; the port
runs one process per rank (``torchrun --nproc-per-node N``, or explicit
arguments), each building the same objects and computing on its own
shard. :func:`initialize_if_needed` joins the process group once: NCCL when
every rank has its own card, gloo on the CPU or when ranks share a card
(NCCL refuses two ranks on one device). The caller names the backend; the
port never picks another on its own.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Optional, Tuple, TypeVar

import torch.distributed as dist

T = TypeVar("T")


def initialize_if_needed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> Tuple[int, int]:
    """Join the process group when running multi-rank; a no-op for one
    process. Returns (rank, world_size).

    Without arguments the torchrun environment is read (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``; in a world that a
    torchrun agent restarted, through :func:`elastic_world_store`);
    ``init_method``
    (e.g. ``tcp://localhost:29500``), ``world_size`` and ``rank`` name the
    group explicitly. ``backend`` defaults to NCCL when CUDA is available
    and gloo otherwise. An already-initialized group is accepted as it is;
    a failed bring-up (unreachable rendezvous, dead peer) raises and never
    degrades to a one-rank run with wrong shards."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size <= 1 and init_method is None:
        return 0, 1
    if backend is None:
        import torch

        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    store = None
    if init_method is None and os.environ.get(
            "TORCHELASTIC_RESTART_COUNT", "0") != "0":
        store = elastic_world_store(rank, world_size, timeout)
    dist.init_process_group(
        backend, init_method=None if store else init_method or "env://",
        store=store, world_size=world_size, rank=rank, timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def elastic_world_store(rank: int, world_size: int,
                        timeout: datetime.timedelta):
    """The rendezvous store of a world that a torchrun agent restarted,
    its keys under a prefix of their own (``TORCHELASTIC_RESTART_COUNT``).
    The agent's store outlives its worlds: without the prefix a world that
    the agent restarts finds the keys of the world before it (a gloo
    rank then dials a peer address of the dead world and fails to join,
    probed with torch 2.13 and a group created after the default one).
    The first world joins through ``env://`` as any torchrun job does.
    Run over gloo on the CPU only: a restarted world on cards (NCCL) has
    not run yet."""
    use_agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    store = dist.TCPStore(os.environ["MASTER_ADDR"],
                          int(os.environ["MASTER_PORT"]), world_size,
                          is_master=not use_agent and rank == 0,
                          timeout=timeout)
    return dist.PrefixStore(
        f"cogstream/world{os.environ['TORCHELASTIC_RESTART_COUNT']}/", store)


def local_rank() -> int:
    """torchrun's ``LOCAL_RANK`` (0 outside torchrun): the card index of
    this rank on its host."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def with_retries(fn: Callable[[], T], max_attempts: int = 3,
                 backoff_s: float = 5.0, on_error=None) -> T:
    """Failure-detection wrapper for per-item work (the structured
    version of the reference's try/except-and-continue train loop,
    second_stage_training.py:161-164)."""
    if max_attempts < 1:
        raise ValueError(f"max_attempts={max_attempts} must be >= 1")
    last = None
    for attempt in range(max_attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — deliberate catch-all
            last = e
            if on_error:
                on_error(attempt, e)
            if attempt + 1 < max_attempts:    # no sleep after the last
                time.sleep(backoff_s * (attempt + 1))
    raise last


def sync_global_devices(tag: str = "barrier") -> None:
    """Cross-rank barrier (post-checkpoint, pre-eval fences); a no-op for
    one process. ``tag`` names the fence for the reader only."""
    del tag
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
