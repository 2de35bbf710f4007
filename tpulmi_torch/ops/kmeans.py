"""k-means (Lloyd) for index partitioning.

The assignment step is one ``x @ c.T`` product followed by argmin; the
update step sums each cluster's rows as a one-hot ``(n, k)`` matrix times
``x``, a product whose summing order is fixed, so the same inputs give the
same centroids to the bit on every run (an ``index_add_`` adds them with
atomics on CUDA, in whatever order the threads run). 25 iterations on at most
``max_points_per_centroid * k`` sampled points (the faiss defaults), squared
L2 assignment, fixed seed. An empty cluster keeps its previous centroid.
"""

from typing import Optional, Tuple

import torch


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances up to a per-row constant: -2 x@c.T + ||c||^2.
    The dropped ||x||^2 term does not change the argmin over centroids."""
    xc = x.float() @ c.float().T
    c_sq = torch.sum(c.float() ** 2, dim=1)
    return c_sq[None, :] - 2.0 * xc


def _lloyd_step(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration on float32 rows `x`: assign, then each cluster's
    mean, in a fixed order (the one-hot product; its counts are exact)."""
    labels = torch.argmin(_sq_dists(x, c), dim=1)
    onehot = torch.nn.functional.one_hot(labels, c.shape[0]).to(x.dtype)
    counts = onehot.sum(0)
    sums = onehot.T @ x
    new_c = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, new_c, c)


def _lloyd(x, init_centroids, k: int, iters: int) -> torch.Tensor:
    x = torch.as_tensor(x).float()
    c = torch.as_tensor(init_centroids, device=x.device).float()
    if c.shape[0] != k:
        raise ValueError(f"{c.shape[0]} initial centroids for k={k}")
    for _ in range(iters):
        c = _lloyd_step(x, c)
    return c


def kmeans_assign(x, centroids, chunk: int = 131072) -> torch.Tensor:
    """Nearest centroid (squared L2) of every row of `x`, in row chunks;
    int32 labels of shape (N,)."""
    x = torch.as_tensor(x)
    centroids = torch.as_tensor(centroids, device=x.device)
    out = [torch.argmin(_sq_dists(x[s:s + chunk].float(), centroids), dim=1)
           for s in range(0, x.shape[0], chunk)]
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=x.device)
    return torch.cat(out).to(torch.int32)


def kmeans(data, k: int, *, iters: int = 25, seed: int = 2023,
           max_points_per_centroid: int = 256,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Cluster `data` into `k` clusters; (centroids, labels) with labels for
    every row. Small-data fallbacks: fewer than 2 rows -> one cluster and no
    centroids; fewer rows than clusters -> k = max(n // 5, 2)."""
    data = torch.as_tensor(data)
    n = int(data.shape[0])
    if n < 2:
        return None, torch.zeros((n,), dtype=torch.int32, device=data.device)
    if n < k:
        k = max(n // 5, 2)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    n_train = min(n, max_points_per_centroid * k)
    if n_train < n:
        train_idx = torch.randperm(n, generator=generator)[:n_train]
        train = data[train_idx.to(data.device)]
    else:
        train = data
    init_idx = torch.randperm(n_train, generator=generator)[:k]
    centroids = _lloyd(train, train[init_idx.to(data.device)], k, iters)
    return centroids, kmeans_assign(data, centroids)
