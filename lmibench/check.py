"""What decides `correct`: the answers kept from the window (`run.py`
says which), held against the plain reference once the window has
closed.

`Answers` gathers the answers kept from the window per pool query. A
request's rows that equal the first answer seen for their query are only
counted; rows that differ are kept beside it, so every kept answer is
judged, at the cost of the distinct ones. The numbers compared (`judge`):

- ``recall_at_10``: the mean over every kept answer of the share of its
  exact top-10 that it returned; the configuration's limit is a floor.
- ``dist_rms_gap``: the root mean square, over every distinct answer, of
  the gap between a returned distance and the exact cosine distance of the
  row returned with it. One answer altered moves it: a sound run's gaps
  are rounding, some 1e-4, and a wrong row's some 1e-1.
- ``failed``: requests never answered; ``malformed``: answers of the wrong
  shape, with ids outside the corpus or distances that are not finite.
"""

import numpy as np

from lmibench.stats import recall_rows


class Kept:
    """Room, touched in set-up, for the answers a closed loop keeps: each
    kept answer is copied in and the program's own arrays are let go, so
    that the window's allocations stay what the program makes (holding
    them instead grows the heap and slows the program's next allocations).
    An answer of another shape or kind is held as it is, to be judged
    malformed."""

    def __init__(self, most: int, q: int, k: int):
        self.dists = np.ones((most, q, k), np.float32)
        self.ids = np.ones((most, q, k), np.int64)
        self.n = 0

    def put(self, out):
        """Where `out` is kept (an index into the room, or `out` itself),
        or None once the room is full."""
        d, ids = (np.asarray(x) for x in out)
        if self.n == len(self.ids):
            return None
        if (d.shape != self.dists.shape[1:] or ids.shape != d.shape
                or d.dtype.kind != "f" or ids.dtype.kind not in "iu"):
            return out
        np.copyto(self.dists[self.n], d)
        np.copyto(self.ids[self.n], ids)
        self.n += 1
        return self.n - 1

    def get(self, where):
        if isinstance(where, (int, np.integer)):
            return self.dists[where], self.ids[where]
        return where


class Answers:
    def __init__(self, pool: int, k: int, rows: int):
        self.k, self.rows = k, rows
        self.ids = np.zeros((pool, k), np.int64)
        self.dists = np.zeros((pool, k), np.float32)
        self.times = np.zeros(pool, np.int64)   # answers equal to the first
        self.extra_q, self.extra_ids, self.extra_d = [], [], []
        self.extra_times = []
        self.malformed = 0

    def add(self, queries: np.ndarray, dists, ids) -> None:
        """One request's answer: `queries` pool indices, (dists, 1-based
        ids) as the program returned them."""
        q = len(queries)
        ids, dists = np.asarray(ids), np.asarray(dists)
        if (ids.shape != (q, self.k) or dists.shape != (q, self.k)
                or not np.isfinite(dists).all()
                or ids.min(initial=1) < 1 or ids.max(initial=1) > self.rows):
            self.malformed += 1
            return
        ids = ids.astype(np.int64)
        dists = dists.astype(np.float32)
        first = self.times[queries] == 0
        # a query twice in one request: its later rows are kept as extras
        _, once = np.unique(queries, return_index=True)
        first_once = np.zeros(q, bool)
        first_once[once] = True
        new = first & first_once
        self.ids[queries[new]] = ids[new]
        self.dists[queries[new]] = dists[new]
        same = ~new & (self.ids[queries] == ids).all(1) & (
            self.dists[queries] == dists).all(1) & (self.times[queries] > 0)
        np.add.at(self.times, queries[new | same], 1)
        other = ~(new | same)
        if other.any():
            self.extra_q.append(queries[other])
            self.extra_ids.append(ids[other])
            self.extra_d.append(dists[other])
            self.extra_times.append(np.ones(int(other.sum()), np.int64))

    def table(self):
        """(pool query, ids, dists, times counted) of every distinct
        answer."""
        seen = np.nonzero(self.times)[0]
        qs = [seen] + self.extra_q
        ids = [self.ids[seen]] + self.extra_ids
        ds = [self.dists[seen]] + self.extra_d
        times = [self.times[seen]] + self.extra_times
        return (np.concatenate(qs), np.concatenate(ids), np.concatenate(ds),
                np.concatenate(times))

    def pairs(self):
        """The distinct (pool query, 0-based row) pairs answered."""
        q, ids, _, _ = self.table()
        pq = np.repeat(q, self.k)
        pr = ids.reshape(-1) - 1
        key = np.unique(pq * self.rows + pr)
        return key // self.rows, key % self.rows


def judge(answers: Answers, truth: np.ndarray, pair_q, pair_row, pair_dist,
          failed: int, limits: dict) -> dict:
    """The numbers compared, each with its limit, and whether all hold."""
    q, ids, dists, times = answers.table()
    numbers = {}
    if len(q):
        rec = recall_rows(ids - 1, truth[q])
        recall = float(np.dot(rec, times) / times.sum())
        key = q[:, None] * answers.rows + (ids - 1)
        order = np.argsort(pair_q * answers.rows + pair_row)
        keys = (pair_q * answers.rows + pair_row)[order]
        ref = pair_dist[order][np.searchsorted(keys, key)]
        diff = np.abs(dists.astype(np.float64) - ref)
        gap = float(np.sqrt(np.mean(diff ** 2)))
        widest = float(diff.max())
    else:
        recall, gap, widest = 0.0, float("inf"), float("inf")
    numbers["recall_at_10"] = {"value": recall,
                               "min": limits["recall_at_10_min"]}
    numbers["dist_rms_gap"] = {"value": gap,
                               "max": limits["dist_rms_gap_max"]}
    numbers["failed"] = {"value": failed, "max": 0}
    numbers["malformed"] = {"value": answers.malformed, "max": 0}
    ok = all((n["value"] >= n["min"]) if "min" in n else
             (n["value"] <= n["max"]) for n in numbers.values())
    return {"correct": bool(ok), "numbers": numbers, "recall": recall,
            "widest_gap": widest, "answers": len(q)}
