"""The work a probe scan needs, counted from the inputs, not from how a
kernel tiles them: the same count whatever kernel does the scan.

For one search of Q queries, each probing P buckets:

- operations: 2 * sum over buckets b of slots(b) * rows(b) * d, where
  slots(b) is how many (query, probe) pairs route to b and rows(b) the
  bucket's rows;
- bytes: each probed bucket's stored rows, scales and ids read once, the
  queries (and their scales) read once, and every slot's candidate list of
  ``list_k`` (distance, row) pairs written once.
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class Work:
    ops: float = 0.0
    bytes: float = 0.0

    def __iadd__(self, other):
        self.ops += other.ops
        self.bytes += other.bytes
        return self

    def least_seconds(self, ops_per_s: float, bytes_per_s: float) -> float:
        return max(self.ops / ops_per_s, self.bytes / bytes_per_s)


@dataclass(frozen=True)
class Layout:
    """What the count needs of a built store and its search."""
    rows: np.ndarray        # (buckets,) rows of each bucket
    d: int
    row_bytes: float        # stored bytes of one row: codes, scale, id
    query_bytes: float      # bytes of one query as the scan reads it
    list_k: int             # candidates a slot's list keeps


def search_work(probes: np.ndarray, layout: Layout) -> Work:
    """The work of one search whose queries route to `probes` (Q, P)."""
    n_b = len(layout.rows)
    p = np.asarray(probes).reshape(-1)
    slots = np.bincount(p[(p >= 0) & (p < n_b)], minlength=n_b).astype(
        np.float64)
    rows = np.asarray(layout.rows, np.float64)
    ops = 2.0 * float(np.dot(slots, rows)) * layout.d
    read = float(rows[slots > 0].sum()) * layout.row_bytes
    q, width = np.asarray(probes).shape
    queries = q * layout.query_bytes
    lists = q * width * layout.list_k * 8.0
    return Work(ops, read + queries + lists)
