"""Temporal-semantic k-means on tensors — port of ``cogstream_tpu/ops/kmeans.py``.

Semantics of the reference's ``kmeans_with_time_min_max``:

* kmeans++ initialization on *feature* distance only;
* per-frame min-max normalization of the feature-distance and
  time-distance rows, combined as ``sqrt(nf^2 + alpha * nt^2)``;
* empty clusters reseeded from a random frame;
* a fixed count of Lloyd iterations (``max_iters``).

Randomness comes from an explicit ``torch.Generator`` in place of the
JAX key, so the seeds cannot match JAX's draws. The Lloyd loop is
therefore its own function, :func:`lloyd_iterations`, which a caller
(the tests) can start from given initial indices: started from JAX's
kmeans++ seeds it reproduces JAX's assignments. ``torch.argmin`` takes
the first minimum, as ``jnp.argmin`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class KMeansResult(NamedTuple):
    centers: torch.Tensor        # [K, F] float32 cluster centroids
    center_times: torch.Tensor   # [K] float32 centroid timestamps
    assignments: torch.Tensor    # [T] int32 cluster id per frame


def _pairwise_l2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix [T, K] via the expanded-square identity
    (one matmul instead of a [T, K, F] broadcast)."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)          # [T, 1]
    c2 = torch.sum(c * c, dim=1, keepdim=True).T        # [1, K]
    xc = x @ c.T                                        # [T, K]
    return torch.sqrt(torch.clamp(x2 + c2 - 2.0 * xc, min=0.0))


def _row_minmax(d: torch.Tensor) -> torch.Tensor:
    """Per-row min-max normalization; all-equal rows normalize to 0."""
    lo = torch.amin(d, dim=1, keepdim=True)
    hi = torch.amax(d, dim=1, keepdim=True)
    rng = hi - lo
    pos = rng > 0
    return torch.where(pos, (d - lo) / torch.where(pos, rng, 1.0),
                       torch.zeros_like(d))


def _combined_distance(x, t, centers, center_times, alpha: float):
    df = _row_minmax(_pairwise_l2(x, centers))
    dt = _row_minmax(torch.abs(t[:, None] - center_times[None, :]))
    return torch.sqrt(df * df + alpha * (dt * dt))


def kmeanspp_init(x: torch.Tensor, num_clusters: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """kmeans++ seeding on feature distance: indices [K] int64 of the
    initial centers (frames drawn with probability ∝ squared distance to
    the nearest chosen center; uniformly when every distance is 0)."""
    T = x.shape[0]
    gdev = generator.device if generator is not None else "cpu"

    def randint() -> int:
        return int(torch.randint(0, T, (), generator=generator, device=gdev))

    idxs = [randint()]
    for _ in range(1, num_clusters):
        d = _pairwise_l2(x, x[idxs])                     # [T, i]
        nearest = torch.amin(d, dim=1)
        probs = nearest * nearest
        if float(probs.sum()) > 0:
            nxt = int(torch.multinomial(probs.to(gdev), 1,
                                        generator=generator))
        else:
            nxt = randint()
        idxs.append(nxt)
    return torch.tensor(idxs, dtype=torch.int64, device=x.device)


def lloyd_iterations(x: torch.Tensor, t: torch.Tensor,
                     init_idx: torch.Tensor, max_iters: int, alpha: float,
                     generator: Optional[torch.Generator] = None
                     ) -> KMeansResult:
    """``max_iters`` Lloyd steps on the combined metric from the centers
    ``x[init_idx]`` (times ``t[init_idx]``), then the final assignment.
    An empty cluster is reseeded from a frame drawn with ``generator``
    (a step with no empty cluster draws nothing)."""
    T = x.shape[0]
    K = init_idx.shape[0]
    centers = x[init_idx]
    center_times = t[init_idx]
    gdev = generator.device if generator is not None else "cpu"
    for _ in range(max_iters):
        d = _combined_distance(x, t, centers, center_times, alpha)
        assign = torch.argmin(d, dim=1)                    # [T]
        onehot = torch.nn.functional.one_hot(assign, K).to(torch.float32)
        counts = onehot.sum(dim=0)                         # [K]
        sums = onehot.T @ x                                # [K, F]
        tsums = (onehot.T @ t[:, None])[:, 0]              # [K]
        safe = torch.clamp(counts, min=1.0)
        new_centers = sums / safe[:, None]
        new_times = tsums / safe
        empty = counts == 0
        if bool(empty.any()):
            rows = torch.randint(0, T, (K,), generator=generator,
                                 device=gdev).to(x.device)
            new_centers = torch.where(empty[:, None], x[rows], new_centers)
            new_times = torch.where(empty, t[rows], new_times)
        centers, center_times = new_centers, new_times
    assignments = torch.argmin(
        _combined_distance(x, t, centers, center_times, alpha), dim=1)
    return KMeansResult(centers, center_times, assignments.to(torch.int32))


def kmeans_with_time(features: torch.Tensor, timestamps: torch.Tensor,
                     num_clusters: int,
                     generator: Optional[torch.Generator] = None,
                     alpha: float = 2.0, max_iters: int = 30) -> KMeansResult:
    """Cluster T frames (``features`` [T, F] or [T, P, D]) into
    ``num_clusters`` events on feature + time distance, in f32."""
    if features.ndim == 3:
        features = features.reshape(features.shape[0], -1)
    x = features.to(torch.float32)
    t = timestamps.to(device=x.device, dtype=torch.float32)
    T = x.shape[0]
    if T <= num_clusters:
        raise ValueError(
            f"kmeans needs T > num_clusters (got T={T}, K={num_clusters}); "
            "callers skip clustering in that regime")
    init = kmeanspp_init(x, num_clusters, generator)
    return lloyd_iterations(x, t, init, max_iters, alpha, generator)


def select_event_keyframes(features: torch.Tensor, centers: torch.Tensor,
                           assignments: torch.Tensor, k: int = 2
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per cluster, the k member frames nearest the centroid: (indices
    [K, k] int32, valid [K, k] bool). Non-members get +inf distance, so
    a cluster with fewer than k members yields invalid slots."""
    if features.ndim == 3:
        features = features.reshape(features.shape[0], -1)
    x = features.to(torch.float32)
    d = _pairwise_l2(x, centers)                               # [T, K]
    K = centers.shape[0]
    member = torch.nn.functional.one_hot(assignments.to(torch.int64),
                                         K).to(torch.bool)
    d = torch.where(member, d, torch.full_like(d, float("inf"))).T  # [K, T]
    # a stable ascending sort: equal distances keep the lower frame
    # index first, as lax.top_k orders ties (torch.topk does not promise)
    top, idx = torch.sort(d, dim=1, stable=True)
    return idx[:, :k].to(torch.int32), torch.isfinite(top[:, :k])
