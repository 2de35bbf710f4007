"""The exact float16 rerank on the card (csrc/rerank_card.cu).

`LearnedIndex` reranks the candidates of a quantized store exactly. On the
host (`LearnedIndex._rerank_host`, `csrc/rerank_fused.cpp`) the rows come
from a float16 copy of the corpus in host RAM; here they come from the same
copy held in HBM, and the kernel runs on the current stream right after the
search program, so that only the final (q, k) distances and ids go back to
the host.

- `rerank_card(corpus, ids, queries, k, normalized=...)`: the kernel on
  CUDA tensors, `rerank_card_plain` on CPU tensors; ``rerank_card.launches``
  counts the kernel's launches.
- `rerank_card_plain`: the same function in plain torch: a repeat of an
  earlier id in its row becomes -1, the query is divided by its clamped
  norm, each kept candidate gets 1 - its float32 dot with the float16 row
  (divided by the row's own norm unless `normalized`), an empty place the
  sentinel distance, and the k smallest are kept, ascending with NaN last,
  ties in candidate order: the host pass's rules.
- `takes(k_eff, d)`: the shapes the kernel takes (k_eff <= 64, d a multiple
  of 8 up to 2048).
- `float16_copy(corpus, device)`: the float16 copy of a host corpus on a
  device, slice by slice, equal to the bit to `index._float16_copy`.

Nothing is built at import time.
"""

import numpy as np
import torch

from tpulmi_torch.hoststore import HostBF16, host_tensor
from tpulmi_torch.ops.distance import SENTINEL_DIST

MAX_K_EFF = 64    # candidates a query row (two a lane of the kernel's warp)
MAX_D = 2048      # features a row (eight 16-byte chunks a lane)
COPY_SLICE_BYTES = 256 << 20   # float32 bytes a slice of `float16_copy`
PLAIN_QUERIES = 2048   # query rows a step of the plain version


def takes(k_eff: int, d: int) -> bool:
    """Whether the kernel takes candidate lists of `k_eff` over rows of
    `d` features."""
    return 1 <= k_eff <= MAX_K_EFF and 8 <= d <= MAX_D and d % 8 == 0


def _check(corpus, ids, queries, k: int) -> None:
    if corpus.dtype != torch.float16 or corpus.dim() != 2:
        raise ValueError(f"the rerank reads a (n, d) float16 corpus, not "
                         f"{corpus.dtype} {tuple(corpus.shape)}")
    if ids.dtype not in (torch.int32, torch.int64) or ids.dim() != 2:
        raise ValueError(f"ids must be (q, k_eff) int32 or int64, not "
                         f"{ids.dtype} {tuple(ids.shape)}")
    q, k_eff = ids.shape
    n, d = corpus.shape
    if queries.dtype != torch.float32 or tuple(queries.shape) != (q, d):
        raise ValueError(f"queries must be ({q}, {d}) float32, not "
                         f"{queries.dtype} {tuple(queries.shape)}")
    if not takes(k_eff, d):
        raise ValueError(f"the rerank takes k_eff <= {MAX_K_EFF} and d a "
                         f"multiple of 8 up to {MAX_D}, not k_eff={k_eff}, "
                         f"d={d}")
    if k < 1 or n < 1:
        raise ValueError(f"k={k} over {n} rows: need k >= 1 and a row")
    if len({corpus.device, ids.device, queries.device}) != 1:
        raise ValueError(f"corpus, ids and queries on one device, not "
                         f"{corpus.device}, {ids.device}, {queries.device}")


def rerank_card_plain(corpus: torch.Tensor, ids: torch.Tensor,
                      queries: torch.Tensor, k: int, *,
                      normalized: bool = True):
    """The rerank in plain torch (any device), in steps of
    `PLAIN_QUERIES` query rows. Returns (dists (q, min(k, k_eff))
    float32, ids of ``ids``' dtype)."""
    _check(corpus, ids, queries, k)
    k = min(k, ids.shape[1])
    pos = torch.arange(ids.shape[1], device=ids.device)
    earlier = pos[None, :] < pos[:, None]        # [j, p]: p before j
    out_d, out_i = [], []
    for lo in range(0, ids.shape[0], PLAIN_QUERIES):
        cand = ids[lo:lo + PLAIN_QUERIES]
        qs = queries[lo:lo + PLAIN_QUERIES]
        qs = qs / torch.linalg.vector_norm(qs, dim=1,
                                           keepdim=True).clamp_min(1e-12)
        dup = ((cand[:, :, None] == cand[:, None, :]) & earlier).any(-1)
        empty = (cand < 0) | dup
        kept = torch.where((cand >= 0) & empty, -1, cand)
        rows = corpus[cand.clamp(0, corpus.shape[0] - 1).long()].float()
        # an elementwise product and a sum over the row: equal rows give
        # equal sums, whatever their place
        sims = (rows * qs[:, None, :]).sum(-1)
        if not normalized:
            sims = sims / torch.linalg.vector_norm(rows, dim=2).clamp_min(
                1e-12)
        exact = torch.where(empty, SENTINEL_DIST, 1.0 - sims)
        order = torch.sort(exact, dim=1, stable=True).indices[:, :k]
        out_d.append(exact.gather(1, order))
        out_i.append(kept.gather(1, order))
    if not out_d:
        return (torch.empty((0, k), dtype=torch.float32, device=ids.device),
                torch.empty((0, k), dtype=ids.dtype, device=ids.device))
    return torch.cat(out_d), torch.cat(out_i)


def rerank_card(corpus: torch.Tensor, ids: torch.Tensor,
                queries: torch.Tensor, k: int, *, normalized: bool = True):
    """The exact rerank of candidates ``ids`` (q, k_eff), 0-based, -1 =
    empty, over the float16 ``corpus`` (n, d) with float32 ``queries``
    (q, d), all on one device: the kernel on a CUDA device, launched on the
    current stream (no sync), `rerank_card_plain` on the CPU. Returns
    (dists (q, min(k, k_eff)) float32, ids of ``ids``' dtype). Raises on
    what the kernel does not take; there is no fallback."""
    _check(corpus, ids, queries, k)
    dev = corpus.device
    if dev.type == "cpu":
        return rerank_card_plain(corpus, ids, queries, k,
                                 normalized=normalized)
    if dev.type != "cuda":
        raise ValueError(f"the rerank runs on CUDA or CPU tensors, not {dev}")
    if not all(t.is_contiguous() for t in (corpus, ids, queries)):
        raise ValueError("the rerank kernel's inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (corpus, queries)):
        raise ValueError("the rerank kernel reads 16-byte aligned rows")
    from tpulmi_torch.ops import _kernels

    lib = _kernels.load("rerank_card")
    q, k_eff = ids.shape
    n, d = corpus.shape
    k = min(k, k_eff)
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=ids.dtype, device=dev)
    if q == 0:
        return out_d, out_i
    with torch.cuda.device(dev):
        err = lib.rerank_card_launch(
            corpus.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
            queries.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), q, k_eff,
            k, d, n, 0 if normalized else 1,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rerank_card launch failed with CUDA error {err}")
    rerank_card.launches += 1
    return out_d, out_i


rerank_card.launches = 0


def float16_copy(corpus, device, slice_bytes: int = COPY_SLICE_BYTES
                 ) -> torch.Tensor:
    """The float16 copy of a host corpus (float32, float16, or bfloat16 as
    a `HostBF16`; any other dtype through numpy's cast) on `device`, slice
    by slice, equal to the bit to `index._float16_copy`: each value
    rounded to nearest even. A float32, float16 or bfloat16 slice goes to
    the device as it lies and is converted there; on a CUDA device it is
    staged through two pinned buffers in turn, so that the host fills one
    while the other is copied. Nothing wider than a slice is made beside
    the copy."""
    device = torch.device(device)
    n, d = len(corpus), int(np.asarray(corpus[:1]).shape[1])
    out = torch.empty((n, d), dtype=torch.float16, device=device)
    step = max(1, slice_bytes // (4 * d))
    exact = isinstance(corpus, HostBF16) or str(corpus.dtype) in (
        "float32", "float16")      # torch widens float64 through float32
    pinned, copied = [None, None], [None, None]
    for turn, lo in enumerate(range(0, n, step)):
        hi = min(lo + step, n)
        src = (host_tensor(corpus[lo:hi]) if exact
               else torch.from_numpy(np.asarray(corpus[lo:hi], np.float16)))
        if device.type != "cuda":
            out[lo:hi].copy_(src)
            continue
        b = turn % 2
        if pinned[b] is None:
            pinned[b] = torch.empty((step, d), dtype=src.dtype,
                                    pin_memory=True)
        if copied[b] is not None:
            copied[b].synchronize()    # its copy of two slices ago is done
        stage = pinned[b][:hi - lo]
        stage.copy_(src)
        out[lo:hi].copy_(stage.to(device, non_blocking=True))
        copied[b] = torch.cuda.Event()
        copied[b].record(torch.cuda.current_stream(device))
    return out
