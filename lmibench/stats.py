"""The benchmark's arithmetic: percentiles, recall, interval unions."""

import math
import statistics
from typing import Iterable, List, Tuple

import numpy as np


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of every value; a
    request never answered counts as +inf, so it lies past every answer."""
    v = np.sort(np.asarray(values, np.float64))
    if len(v) == 0:
        raise ValueError("no values")
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def spread(values: Iterable[float]) -> float:
    """The distance between the first and third quartile as a share of the
    median, as `statistics.quantiles(values, n=4)` gives the quartiles."""
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / abs(med)


def recall_rows(found: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Per row, the share of `truth`'s ids that `found` holds (ids of one
    base on both sides; found may hold a row twice, counted once)."""
    found = np.asarray(found)
    truth = np.asarray(truth)
    hit = (truth[:, :, None] == found[:, None, :]).any(axis=2)
    return hit.sum(axis=1) / truth.shape[1]


def union_length(intervals: List[Tuple[float, float]], lo: float = -math.inf,
                 hi: float = math.inf) -> float:
    """The length of the union of [start, end) intervals, clipped to
    [lo, hi): overlapping work on several streams counts once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """The idle stretches of [lo, hi) that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
