"""The readers of the program's own spans and counters
(`program_trace.py`, `metrics/*_pct.batch.py`, `rerank_dot_gbps.batch`) on
hand-made records, counters and device intervals: outer spans count once,
only the part in the window counts, the device's idle time is intersected
with the host's dispatch, and a program without the spans reads nothing."""

from types import SimpleNamespace

import pytest

from lmibench import cells, program_trace
from tpulmi_torch.utils import profiling

WINDOW = (1_000, 11_000)          # 10 us

NEW = ("stage_pct.batch", "dispatch_pct.batch", "dispatch_idle_pct.batch",
       "fetch_wait_pct.batch", "rerank_dot_pct.batch",
       "rerank_dot_gbps.batch")


def rec(name, start, end, parent=None, request=1, thread=1):
    return (name, request, parent, thread, start, end)


def ctx(events=()):
    return SimpleNamespace(window_ns=WINDOW, events=list(events))


@pytest.fixture
def program(monkeypatch):
    """Stand-in records and window counters for the program's registry."""
    state = SimpleNamespace(records=[], grown={})

    def counters(lo_ns=None, hi_ns=None):
        assert (lo_ns, hi_ns) == WINDOW
        return dict(state.grown)

    monkeypatch.setattr(profiling, "records", lambda: list(state.records))
    monkeypatch.setattr(profiling, "counters", counters)
    return state


def read(metric, c):
    return cells.reader(metric)(c)


def test_outer_spans_count_once_and_only_inside_the_window(program):
    program.records = [
        rec("search", 2_000, 6_000),
        # a split batch's parts inside the outer search: counted once
        rec("search", 2_500, 3_500, parent="search"),
        rec("search", 4_000, 5_000, parent="search"),
        # half before the window
        rec("search", 0, 2_000),
        # wholly after it: not read
        rec("search", 12_000, 13_000),
    ]
    assert program_trace.seconds(ctx(), "search") == pytest.approx(5e-6)
    assert program_trace.window_pct(ctx(), "search") == pytest.approx(50.0)
    assert len(program_trace.records(ctx(), "search")) == 4


@pytest.mark.parametrize("metric,span", [
    ("stage_pct.batch", "search.stage"),
    ("dispatch_pct.batch", "search.program"),
    ("fetch_wait_pct.batch", "search.fetch"),
    ("rerank_dot_pct.batch", "rerank.dot"),
])
def test_share_of_the_window(program, metric, span):
    program.records = [rec(span, 1_000, 2_000), rec(span, 1_500, 2_500),
                       rec(span, 10_500, 12_000),
                       rec("other", 3_000, 9_000)]
    assert read(metric, ctx()) == pytest.approx(100.0 * 2_000 / 10_000)


def test_dispatch_idle_is_the_device_idle_inside_the_dispatch(program):
    # the host dispatches over [2, 6) and [8, 10) us; the device runs
    # [1, 3) and [5, 9) on two streams (overlapping on [5, 7)): idle
    # inside the dispatch is [3, 5) and [9, 10)
    program.records = [rec("search.program", 2_000, 6_000),
                       rec("search.program", 8_000, 10_000)]
    events = [("k1", "kernel", 1_000, 3_000),
              ("k2", "kernel", 5_000, 7_000),
              ("copy", "gpu_memcpy", 5_000, 9_000)]
    got = read("dispatch_idle_pct.batch", ctx(events))
    assert got == pytest.approx(100.0 * 3_000 / 10_000)
    # a device busy through the whole dispatch: no idle time in it
    busy = [("k", "kernel", 0, 20_000)]
    assert read("dispatch_idle_pct.batch", ctx(busy)) == 0.0
    # no device trace (a run off the card): nothing to read
    assert read("dispatch_idle_pct.batch", ctx()) is None


def test_rerank_bandwidth_is_the_window_bytes_over_the_dot(program):
    program.records = [rec("rerank.dot", 2_000, 4_000),
                       rec("rerank.dot", 6_000, 8_000)]
    program.grown = {"rerank_bytes": 8_000, "rerank_candidates": 10}
    # 8000 bytes in 4 us
    assert read("rerank_dot_gbps.batch", ctx()) == pytest.approx(2.0)
    program.grown = {}
    assert read("rerank_dot_gbps.batch", ctx()) is None


@pytest.mark.parametrize("metric", NEW)
def test_no_such_span_reads_nothing(program, metric):
    program.records = [rec("search", 2_000, 3_000)]
    program.grown = {"rerank_bytes": 100}
    events = [("k", "kernel", 1_000, 2_000)]
    assert read(metric, ctx(events)) is None


@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_the_registry_reads_nothing(monkeypatch, metric):
    # the program as it was before it kept spans of its own
    monkeypatch.delattr(profiling, "records")
    events = [("k", "kernel", 1_000, 2_000)]
    assert read(metric, ctx(events)) is None


def test_each_new_metric_is_reported_where_its_spans_are():
    ten, three = "laion10m-int8.batch10k", "laion300k-bf16.batch10k"
    names = {c: {m["name"] for m in cells.find(c).per_layer}
             for c in (ten, three)}
    assert set(NEW) <= names[ten]
    assert set(NEW[:4]) <= names[three]
    assert not {"rerank_dot_pct.batch", "rerank_dot_gbps.batch"} & \
        names[three]
