"""Cosine distances and exact k-NN.

On L2-normalized vectors the cosine distance is ``1 - q @ x.T``. `exact_knn`
is the recall oracle: it streams the database in chunks with a running top-k,
so N is bounded by device memory, not by the (Q, N) distance matrix.
"""

import torch

SENTINEL_DIST = 10_000.0  # the reference's pad/init sentinel


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def pairwise_cosine(x: torch.Tensor, y: torch.Tensor, *,
                    normalized: bool = False,
                    compute_dtype=None) -> torch.Tensor:
    """Dense cosine-distance matrix ``1 - cos(x_i, y_j)`` of shape (X, Y).
    ``compute_dtype`` rounds the inputs (e.g. to bfloat16); the product is
    taken in float32."""
    if not normalized:
        x = l2_normalize(x)
        y = l2_normalize(y)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        y = y.to(compute_dtype)
    return 1.0 - x.float() @ y.float().T


def pairwise_cosine_threshold(x: torch.Tensor, y: torch.Tensor,
                              threshold, *, normalized: bool = False,
                              compute_dtype=None) -> torch.Tensor:
    """`pairwise_cosine` with per-row threshold pruning: entries at or above
    ``threshold[i]`` become the sentinel (masked, not compacted, so they
    lose every later top-k and the result is unchanged)."""
    dists = pairwise_cosine(x, y, normalized=normalized,
                            compute_dtype=compute_dtype)
    threshold = torch.as_tensor(threshold, dtype=torch.float32,
                                device=dists.device).reshape(-1, 1)
    return torch.where(dists < threshold, dists,
                       torch.full_like(dists, SENTINEL_DIST))


def _topk_stable(d: torch.Tensor, i: torch.Tensor, k: int):
    """The k smallest of each row of `d`, ties to the lower column (the
    order `lax.top_k` gives); `i` rides along."""
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return torch.gather(d, 1, order), torch.gather(i, 1, order)


def exact_knn(queries, data, k: int = 10, *, chunk: int = 65536,
              normalized: bool = False):
    """Exact cosine k-NN in float32: (dists, ids) of shape (Q, k), 0-based
    ids, ascending by distance. Streams `data` in `chunk`-row blocks with a
    running top-k merge."""
    queries = torch.as_tensor(queries, dtype=torch.float32)
    data = torch.as_tensor(data, dtype=torch.float32, device=queries.device)
    if not normalized:
        queries = l2_normalize(queries)
        data = l2_normalize(data)
    nq, n = queries.shape[0], data.shape[0]
    chunk = min(chunk, max(128, n))
    best_d = torch.full((nq, k), SENTINEL_DIST, device=queries.device)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=queries.device)
    for start in range(0, n, chunk):
        block = data[start:start + chunk]
        dists = 1.0 - queries @ block.T
        ids = torch.arange(start, start + block.shape[0],
                           device=queries.device).expand(nq, -1)
        best_d, best_i = _topk_stable(torch.cat([best_d, dists], 1),
                                      torch.cat([best_i, ids], 1), k)
    return best_d, best_i
