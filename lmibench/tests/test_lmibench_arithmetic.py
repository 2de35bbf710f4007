"""The benchmark's arithmetic on hand-made inputs: the work model, the
idle share, the tail over every request, recall, the spread."""

import math

import numpy as np
import pytest

from lmibench import readers, stats
from lmibench.traffic import Request, Served
from lmibench.workmodel import Layout, search_work


def test_work_model_counts_what_the_inputs_need():
    # 3 buckets of 100, 50 and 7 rows, d = 8; int8 rows with a scale and an
    # id (8 + 4 + 4 bytes), int8 queries with a scale (8 + 4)
    layout = Layout(rows=np.array([100, 50, 7]), d=8, row_bytes=16,
                    query_bytes=12, list_k=14)
    probes = np.array([[0, 1], [0, 1], [0, 0]])   # bucket 2 never probed
    w = search_work(probes, layout)
    assert w.ops == 2 * (4 * 100 + 2 * 50) * 8
    # buckets 0 and 1 read once each, whatever the slots
    assert w.bytes == (100 + 50) * 16 + 3 * 12 + 3 * 2 * 14 * 8
    assert w.least_seconds(1e3, 1e9) == w.ops / 1e3


def test_work_model_ignores_the_dump_bucket():
    layout = Layout(rows=np.array([10, 10]), d=4, row_bytes=8,
                    query_bytes=8, list_k=10)
    w = search_work(np.array([[0, 2]]), layout)   # 2: a truncated probe
    assert w.ops == 2 * 10 * 4


def test_idle_share_is_a_union_not_a_sum():
    # two streams overlapping on [2, 4): busy [1, 6) of [0, 10)
    intervals = [(1, 4), (2, 6), (3, 5)]
    assert stats.union_length(intervals) == 5
    assert stats.union_length(intervals, 0, 3) == 2
    assert stats.gaps(intervals, 0, 10) == [(0, 1), (6, 10)]
    ctx = type("Ctx", (), {"events": [("k", "kernel", s, e)
                                      for s, e in intervals],
                           "window_ns": (0, 10)})
    assert readers.device_idle_pct(ctx) == pytest.approx(50.0)


def test_p95_counts_unanswered_requests_as_missing():
    # 20 requests due at 0; 18 answered in 1..18 ms, 2 never
    reqs = [Request(0.0, np.arange(1)) for _ in range(20)]
    end = np.array([i / 1e3 for i in range(1, 19)] + [np.nan, np.nan])
    served = Served(reqs, np.zeros(20), end, [None] * 20, 1.0,
                    lateness=np.array([]))
    lat = readers.latencies_s(served)
    assert np.isinf(lat[-2:]).all()
    # the 19th of 20 by rank is a request never answered
    assert stats.percentile(lat, 95) == math.inf
    assert readers.p95_ms(served) is None
    end[-2:] = [0.5, 0.6]
    assert readers.p95_ms(served) == pytest.approx(500.0)


def test_recall_against_known_answers():
    truth = np.array([[1, 2, 3, 4], [5, 6, 7, 8]])
    found = np.array([[4, 3, 9, 1], [8, 8, 0, 0]])
    assert stats.recall_rows(found, truth).tolist() == [0.75, 0.25]


def test_spread_uses_python_quartiles():
    values = [10, 11, 12, 13, 14, 15]
    q1, med, q3 = __import__("statistics").quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / med)
