"""The program's own spans and counters (`tpulmi_torch.utils.profiling`) on
``device="cpu"``: nothing recorded without a profiler, the span tree of a
quantized search with the host rerank (the native fused pass, and the numpy
path that orders in `rerank.order`) and a split batch under one request
id, a stream's finalize carrying its batch's id on the worker thread, the
spans on the profiler's clock, the counters' values, the bounded record
list and a span's self time."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
from tpulmi_torch.native import native_layout
from tpulmi_torch.ops import probe_topk as probe
from tpulmi_torch.utils import profiling

torch.set_num_threads(1)

N, D_NAV, D, Q, P, K = 2000, 32, 128, 40, 3, 5
K_EFF = K + 10        # an int8 store's rerank depth

# each span and the span it opens under
PARENTS = {
    "search.stage": "search", "search.plan": "search",
    "search.program": "search", "search.fetch": "search",
    "search.finalize": "search",
    "program.route": "search.program", "program.group": "search.program",
    "program.probe": "search.program", "program.merge": "search.program",
    "rerank": "search.finalize", "rerank.prep": "rerank",
    "rerank.shadow": "rerank", "rerank.dot": "rerank",
    "rerank.order": "rerank",     # the numpy path only
}


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(5)
    nav = rng.normal(size=(N, D_NAV)).astype(np.float32)
    data = rng.normal(size=(N, D)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    li = LearnedIndex(IndexConfig(n_categories=8, epochs=2, lr=0.003,
                                  batch_size=256, row_align=256),
                      device="cpu")
    li.build(nav, data)
    li.quantize(host_corpus=data, normalized=True, bits=8)
    return li, nav[:Q], data[:Q]


@pytest.fixture(autouse=True)
def clean():
    profiling.reset()
    yield
    profiling.reset()


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _inside(child, parent):
    return (child[3] == parent[3] and parent[4] <= child[4]
            and child[5] <= parent[5])


def test_no_profiler_records_nothing(index):
    li, qn, qs = index
    assert profiling.span("a") is profiling.span("b")
    assert not profiling.tracing()
    li.search(qn, qs, n_buckets=P, k=K)
    assert profiling.records() == []
    assert profiling.counters(0, 2**63) == {}     # no stamped increment
    assert profiling.counters()["searches"] == 1


@pytest.mark.parametrize("native", [True, False], ids=["fused", "numpy"])
@pytest.mark.parametrize("rerank_dtype", ["float32", "float16"])
@pytest.mark.parametrize("batch", [None, 16], ids=["whole", "split"])
def test_span_tree_of_a_search(index, rerank_dtype, batch, native,
                               monkeypatch):
    li, qn, qs = index
    li._rerank_shadow = None      # the float16 copy is made in the search
    if not native:                # the numpy path of a host without g++
        monkeypatch.setattr(type(native_layout), "available",
                            lambda self: False)
    scfg = SearchConfig(k=K, n_buckets=P, batch_queries=batch,
                        rerank_dtype=rerank_dtype)
    _traced(lambda: li.search(qn, qs, n_buckets=P, k=K, search_config=scfg))
    recs = profiling.records()
    names = {r[0] for r in recs}
    want = set(PARENTS) | {"search"}
    if rerank_dtype != "float16":
        want.discard("rerank.shadow")
    if native:                    # the fused pass orders in the library
        want.discard("rerank.order")
    assert names == want
    assert profiling.counters().get("rerank_fused", 0) == (Q if native
                                                           else 0)
    assert [r[0] for r in recs if r[2] is None] == ["search"]
    assert len({r[1] for r in recs}) == 1         # one request
    assert len({r[3] for r in recs}) == 1         # all on this thread
    parts = -(-Q // batch) if batch else 1
    inner = [r for r in recs if r[0] == "search" and r[2] == "search"]
    assert len(inner) == (parts if batch else 0)
    assert sum(r[0] == "search.program" for r in recs) == parts
    assert sum(r[0] == "rerank.shadow" for r in recs) == (
        rerank_dtype == "float16")
    for child in recs:
        if child[2] is None:
            continue
        assert child[2] == ("search" if child[0] == "search"
                            else PARENTS[child[0]])
        assert any(r[0] == child[2] and r is not child and _inside(child, r)
                   for r in recs), child
    if batch:
        # the parts nest under the outer search
        outer = next(r for r in recs if r[2] is None)
        assert all(_inside(r, outer) for r in recs)


def test_stream_finalize_carries_its_batch_request(index):
    li, qn, qs = index
    main = threading.get_ident()
    batches = [(qn, qs)] * 3
    got, _ = _traced(lambda: list(li.search_stream(
        batches, n_buckets=P, k=K, depth=2)))
    assert len(got) == 3
    recs = profiling.records()
    finals = [r for r in recs if r[0] == "search.finalize"
              and r[3] != main]
    assert finals                                  # on the worker thread
    for f in finals:
        mine = {r[0] for r in recs if r[1] == f[1] and r[3] == main}
        assert {"search.stage", "search.plan", "search.program",
                "search.fetch"} <= mine
        worker = {r[0] for r in recs if r[1] == f[1] and r[3] == f[3]}
        assert {"search.finalize", "rerank", "rerank.dot"} <= worker
    assert len({r[1] for r in recs}) == 3          # one id a batch
    assert not profiling.tracing()


def test_spans_lie_on_the_profilers_clock(index):
    li, qn, qs = index
    _, prof = _traced(lambda: li.search(qn, qs, n_buckets=P, k=K))
    marks = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.SPAN_PREFIX):
            name = e.name()[len(profiling.SPAN_PREFIX):]
            marks.setdefault(name, []).append(e.start_ns())
    recs = profiling.records()
    assert set(marks) == {r[0] for r in recs}
    for name, starts in marks.items():
        mine = sorted(r[4] for r in recs if r[0] == name)
        assert len(mine) == len(starts)
        for a, b in zip(mine, sorted(starts)):
            assert abs(a - b) < 1_000_000, (name, a - b)


def test_counters_of_a_search(index):
    li, qn, qs = index
    li.search(qn, qs, n_buckets=P, k=K)
    got = profiling.counters()
    assert got["searches"] == 1 and got["queries"] == Q
    assert got["slots"] == Q * P
    assert got["rerank_candidates"] == Q * K_EFF
    assert got["rerank_bytes"] == Q * K_EFF * D * 4       # float32 corpus
    assert got["rerank_fused"] == Q                       # the native pass
    assert got.get("reruns", 0) == 0


def test_rerank_bytes_of_the_float16_copy(index):
    li, qn, qs = index
    scfg = SearchConfig(k=K, n_buckets=P, rerank_dtype="float16")
    li.search(qn, qs, n_buckets=P, k=K, search_config=scfg)
    assert profiling.counters()["rerank_bytes"] == Q * K_EFF * D * 2


def test_program_builds_once_a_shape(index):
    li, qn, qs = index
    scfg = SearchConfig(k=K, n_buckets=P, compute_dtype="float32")
    li.search(qn[:7], qs[:7], n_buckets=P, k=K, search_config=scfg)
    assert profiling.counters()["program_builds"] == 1
    li.search(qn[:7], qs[:7], n_buckets=P, k=K, search_config=scfg)
    assert profiling.counters()["program_builds"] == 1


def test_reruns_on_a_worklist_overflow(index):
    li, qn, qs = index
    scfg = SearchConfig(k=K, n_buckets=P, pallas_worklist=True,
                        pallas_mc=256)
    want = li.search(qn, qs, n_buckets=P, k=K, search_config=scfg)
    assert profiling.counters().get("reruns", 0) == 0
    li._wl_pads[(Q, P)] = 1
    got = li.search(qn, qs, n_buckets=P, k=K, search_config=scfg)
    np.testing.assert_array_equal(got[1], want[1])
    assert profiling.counters()["reruns"] == 1


def test_counter_window_growth():
    profiling.count("x", 5)                  # not tracing: no stamp
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("x", 2)
        mid = time.time_ns()
        profiling.count("x", 3)
    assert profiling.counters()["x"] == 10
    assert profiling.counters(0, mid) == {"x": 2}
    assert profiling.counters(mid, 2**63) == {"x": 3}


def test_launch_counts_keep_their_names():
    names = list(probe.launch_counts())
    assert names == ["probe_topk", "probe_topk_quant_int8",
                     "probe_topk_quant_int4", "probe_topk_int8q_int8",
                     "probe_topk_int8q_int4", "probe_worklist",
                     "merge_items", "probe_pair", "probe_pool",
                     "probe_cluster"]
    assert list(probe.loop_launch_counts()) == list(probe.LOOPS)
    profiling.count(probe.LAUNCHES + "probe_pair", 2)
    profiling.count(probe.LOOP_LAUNCHES + "wgmma")
    profiling.count("slots", 9)
    assert probe.launch_counts()["probe_pair"] == 2
    assert probe.loop_launch_counts()["wgmma"] == 1
    probe.reset_launch_counts()
    assert not any(probe.launch_counts().values())
    assert not any(probe.loop_launch_counts().values())
    assert profiling.counters() == {"slots": 9}


def test_record_list_is_bounded(monkeypatch):
    from collections import deque

    monkeypatch.setattr(profiling, "RECORDS_MAX", 4)
    monkeypatch.setattr(profiling, "_records", deque(maxlen=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with profiling.span(f"s{i}"):
                pass
    assert [r[0] for r in profiling.records()] == ["s2", "s3", "s4", "s5"]
    assert profiling.counters()["span_records_dropped"] == 2


def test_self_time_leaves_out_the_children():
    t = 7
    recs = [("search", 1, None, t, 0, 100),
            ("search.stage", 1, "search", t, 10, 25),
            ("search.program", 1, "search", t, 25, 60),
            ("program.probe", 1, "search.program", t, 30, 50),
            ("search", 2, None, t + 1, 0, 100)]      # another thread
    assert profiling.self_ns(recs) == [100 - 15 - 35, 15, 35 - 20, 20, 100]
    assert profiling.self_ns([]) == []
