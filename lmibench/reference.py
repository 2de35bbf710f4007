"""The plain reference: exact cosine k-NN, in plain torch and float32 with
TF32 off, over rows that the benchmark makes again from the seed
(`datagen.Corpus.chunks`), never over anything the program made.

It answers two things: each pool query's exact top-k (for recall), and the
exact cosine distance of each (query, row) pair that the program returned
(to judge the distances it reported). Imports nothing of the program.
"""

import contextlib

import numpy as np
import torch

ROW_BLOCK = 1 << 17


@contextlib.contextmanager
def full_float32():
    """Matrix products in full float32 inside, whatever was set before."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(
        1e-12)


@torch.no_grad()
def exact_answers(corpus, queries_search: np.ndarray, k: int,
                  pair_q: np.ndarray, pair_row: np.ndarray):
    """Over the rows of ``corpus.chunks()``: (top-k row ids (Q, k) int64,
    ascending by distance, ties in any order; and the exact distance of
    each pair (pair_q[i], pair_row[i]), products in float64)."""
    dev = corpus.device
    q = _unit(torch.as_tensor(queries_search, device=dev))
    n_q = q.shape[0]
    best_d = torch.full((n_q, k), float("inf"), device=dev)
    best_i = torch.full((n_q, k), -1, dtype=torch.int64, device=dev)
    pair_q_t = torch.as_tensor(pair_q, dtype=torch.int64, device=dev)
    pair_row_t = torch.as_tensor(pair_row, dtype=torch.int64, device=dev)
    pair_d = torch.full((len(pair_q),), float("nan"), dtype=torch.float64,
                        device=dev)
    with full_float32():
        for lo, hi, x, _ in corpus.chunks():
            x = _unit(x)
            here = (pair_row_t >= lo) & (pair_row_t < hi)
            if bool(here.any()):
                sel = here.nonzero().squeeze(1)
                dots = (q[pair_q_t[sel]].double()
                        * x[pair_row_t[sel] - lo].double()).sum(1)
                pair_d[sel] = 1.0 - dots
            for blo in range(0, hi - lo, ROW_BLOCK):
                dist = 1.0 - q @ x[blo:blo + ROW_BLOCK].T
                kk = min(k, dist.shape[1])
                d_b, i_b = torch.topk(dist, kk, dim=1, largest=False,
                                      sorted=True)
                i_b = i_b + (lo + blo)
                cat_d = torch.cat([best_d, d_b], 1)
                cat_i = torch.cat([best_i, i_b], 1)
                order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
                best_d = torch.gather(cat_d, 1, order)
                best_i = torch.gather(cat_i, 1, order)
            del x
    return best_i.cpu().numpy(), pair_d.cpu().numpy()
