"""Exact brute-force cosine k-NN: the recall oracle.

- `Baseline`: the reference's external contract (1-based ids, a
  (dists, ids, seconds) return) over `ops.distance.exact_knn`.
- `exact_knn_streamed`: a corpus that stays in host memory (float32 or
  float16 arrays, memory maps, `HostBF16`) streamed to the device one block
  at a time with a running top-k, for corpora larger than the card. A scan
  can be resumed from a checkpoint written every few blocks; the
  checkpoint's keys are the JAX package's, so either package resumes the
  other's.

The running top-k keeps the JAX package's order: the k smallest
(distance, id) pairs, ties to the lower id.
"""

import os
import time
import zipfile
from contextlib import contextmanager
from typing import Tuple

import numpy as np
import torch

from tpulmi_torch import hoststore
from tpulmi_torch.hoststore import HostBF16
from tpulmi_torch.ops.distance import (SENTINEL_DIST, _topk_stable,
                                       exact_knn, l2_normalize)
from tpulmi_torch.utils.logging import get_logger
from tpulmi_torch.utils.profiling import resolve_device, sync

log = get_logger("tpulmi_torch.baseline")


@contextmanager
def _float32_products():
    """Matrix products in full float32 on the card (TF32 off) for the
    region: TF32 would round the distances."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _block_topk(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest (distance, id) pairs of each row, ascending, ties to
    the lower column: `torch.topk` finds the kth distance, and only the rows
    where that distance is shared with a row outside the k are resolved
    again, exactly."""
    k = min(k, dists.shape[1])
    vals, cols = torch.topk(dists, k, dim=1, largest=False)
    kth = vals.max(dim=1, keepdim=True).values
    crossing = (dists == kth).sum(1) > (vals == kth).sum(1)
    for r in torch.nonzero(crossing).flatten().tolist():
        row = dists[r]
        keep = torch.nonzero(row <= kth[r]).flatten()   # ascending columns
        order = torch.sort(row[keep], stable=True).indices[:k]
        cols[r] = keep[order]
    # equal distances inside the k: lower column first
    cols = torch.gather(cols, 1, torch.sort(cols, dim=1).indices)
    vals = torch.gather(dists, 1, cols)
    order = torch.sort(vals, dim=1, stable=True).indices
    cols = torch.gather(cols, 1, order)
    return torch.gather(vals, 1, order), torch.gather(ids, 1, cols)


def _merge_block(best_d, best_i, queries, block, base: int, valid: int,
                 k: int):
    """Fold one block of rows (the rows past `valid` are padding) into the
    running (best_d, best_i): distances are ``1 - q . x`` of the blocks as
    given, in float32 products; the best list wins ties against the block,
    as it holds lower ids."""
    with _float32_products():
        dists = queries.float() @ block.float().T
    dists.neg_().add_(1.0)                # 1 - q . x, in place
    if valid < block.shape[0]:
        dists[:, valid:] = SENTINEL_DIST
    ids = torch.arange(base, base + block.shape[0], dtype=torch.int32,
                       device=dists.device).expand(dists.shape[0], -1)
    blk_d, blk_i = _block_topk(dists, ids, k)
    return _topk_stable(torch.cat([best_d, blk_d], 1),
                        torch.cat([best_i, blk_i], 1), k)


def _host_block(host_data, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of a host array as a numpy array of its own dtype (a
    `HostBF16` as its uint16 bits)."""
    rows = host_data[lo:hi]
    if isinstance(rows, HostBF16):
        return rows.bits
    return np.asarray(rows)


def exact_knn_streamed(queries, host_data, k: int = 10, chunk: int = 262144,
                       compute_dtype=torch.bfloat16, normalized: bool = True,
                       resume_path: str = None, checkpoint_every: int = 8,
                       device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Exact cosine k-NN over a corpus in host memory: blocks of `chunk`
    rows are copied to `device` one at a time (the last one zero-padded to
    `chunk` rows and its padding masked) and folded into a running top-k,
    so the device never holds more than two blocks. Both operands are
    rounded to `compute_dtype` and their products summed in float32.

    `host_data` is a float32 or float16 array or memory map, or a
    `HostBF16`; the rows are used as given (normalized), the queries are
    normalized unless ``normalized``. Each block is copied from a pinned
    buffer that is reused only after the device has finished reading it;
    over a memory map, the block's pages are dropped once it is in that
    buffer (`hoststore.release_pages`).

    ``resume_path`` makes the scan resumable: every `checkpoint_every`
    blocks the running lists and the next row are written to
    ``resume_path + ".tmp.npz"`` and renamed over `resume_path`; a rerun
    whose (n, k, chunk, queries) match continues from there, and a
    checkpoint that does not match is ignored. The caller deletes the file.

    Returns (dists (Q, k) float32 ascending, ids (Q, k) int32 0-based)."""
    device = resolve_device(device)
    q_host = np.asarray(queries, np.float32)
    q = q_host.shape[0]
    queries_d = torch.as_tensor(q_host, device=device)
    if not normalized:
        queries_d = l2_normalize(queries_d)
    queries_d = queries_d.to(compute_dtype)
    best_d = torch.full((q, k), SENTINEL_DIST, dtype=torch.float32,
                        device=device)
    best_i = torch.zeros((q, k), dtype=torch.int32, device=device)
    n, d = host_data.shape
    start_lo = 0
    q_sum = float(np.float64(q_host.sum()))
    if resume_path and os.path.exists(resume_path):
        try:
            z = np.load(resume_path)
            ok = (int(z["n"]) == n and int(z["k"]) == k
                  and int(z["chunk"]) == chunk
                  and z["best_d"].shape == (q, k)
                  and abs(float(z["q_sum"]) - q_sum) <= 1e-3)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile):          # a torn or foreign file
            ok = False
        if ok:
            start_lo = int(z["lo"])
            best_d = torch.as_tensor(z["best_d"], device=device)
            best_i = torch.as_tensor(z["best_i"], device=device)
            log.info("exact_knn_streamed: resuming at %d/%d rows",
                     start_lo, n)
        else:
            log.warning("exact_knn_streamed: stale checkpoint at %s "
                        "ignored", resume_path)

    bf16 = isinstance(host_data[:1], HostBF16)
    # bfloat16 bits cross as int16 (torch has no uint16 copies everywhere)
    buf_dtype = np.int16 if bf16 else np.asarray(host_data[:1]).dtype
    pin = device.type == "cuda"
    mapped = hoststore.is_memory_mapped(host_data)
    bufs = [torch.from_numpy(np.zeros((chunk, d), buf_dtype))
            for _ in range(2)]
    if pin:
        bufs = [b.pin_memory() for b in bufs]
    done = [None, None]          # the event after each buffer's last read
    for step, lo in enumerate(range(start_lo, n, chunk)):
        hi = min(lo + chunk, n)
        slot = step % 2
        if done[slot] is not None:
            done[slot].synchronize()     # the device has read this buffer
        host = bufs[slot].numpy()
        rows = _host_block(host_data, lo, hi)
        host[: hi - lo] = rows.view(buf_dtype) if bf16 else rows
        host[hi - lo:] = 0
        if mapped:
            # the block is in the pinned buffer: its pages would otherwise
            # stay resident, and a corpus near the host's memory would
            # count twice against it
            hoststore.release_pages(host_data)
        block = bufs[slot].to(device, non_blocking=True)
        if bf16:
            block = block.view(torch.bfloat16)
        block = block.to(compute_dtype)
        if pin:
            done[slot] = torch.cuda.Event()
            done[slot].record()
        best_d, best_i = _merge_block(best_d, best_i, queries_d, block, lo,
                                      hi - lo, k)
        if lo // chunk % 8 == 0:
            log.info("exact_knn_streamed: %d/%d rows", hi, n)
        if (resume_path and hi < n
                and lo // chunk % checkpoint_every == checkpoint_every - 1):
            tmp = resume_path + ".tmp.npz"
            np.savez(tmp, best_d=best_d.cpu().numpy(),
                     best_i=best_i.cpu().numpy(), lo=hi, n=n, k=k,
                     chunk=chunk, q_sum=q_sum)
            os.replace(tmp, resume_path)
    return best_d.cpu().numpy(), best_i.cpu().numpy()


class Baseline:
    """Exact cosine k-NN with the reference's external contract: 1-based
    ids, a (dists, ids, seconds) return."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._data = None

    def build(self, data) -> float:
        """No index to build: the float32 data goes to the device once.
        Returns seconds."""
        start = time.perf_counter()
        self._data = torch.as_tensor(np.asarray(data, dtype=np.float32),
                                     device=self.device)
        sync(self.device)
        return time.perf_counter() - start

    def search(self, queries, data=None, k: int = 10
               ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Exact k nearest neighbors. Returns (dists float32, 1-based ids
        int64, seconds)."""
        if data is None:
            data = self._data
        if data is None:
            raise ValueError("No data: call build() or pass data "
                             "explicitly.")
        start = time.perf_counter()
        queries = torch.as_tensor(np.asarray(queries, np.float32),
                                  device=self.device)
        with _float32_products():
            dists, ids = exact_knn(queries, data, k=k)
        dists, ids = dists.cpu().numpy(), ids.cpu().numpy()
        elapsed = time.perf_counter() - start
        return dists, ids.astype(np.int64) + 1, elapsed
