"""The hierarchical index of tpulmi_torch against the benchmark's plain
reference (`lmibench/hier_reference.py`) on the CPU, and the hierarchy's
spans, build stages and counter.

One clustered corpus (`lmibench.datagen`, 4096 rows, d_nav 16, d_search
64), 2 groups of 6 buckets, one epoch. Two builds of it: `build` (a
float32 store, searched in float32) and `build_with_host_store` (int8
codes, int8 queries, the float16 host rerank at depth 10), the second
under a profiler. The holds are `lmibench.hier_reference.compare`'s, with
the cell's tolerances: routed buckets equal except at joint scores tied
within 1e-5; ids equal as sets except where the reference's k-th and
(k+1)-th distances lie within 2e-4; the distances' root mean square gap
within 2e-4, the cell's ``dist_rms_gap_max``, which the int8 distances
without the rerank fail."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lmibench import datagen, hier_reference
from lmibench.hier_reference import buckets_of, compare, host_rows, router_of
from tpulmi_torch import (HierarchicalConfig, HierarchicalIndex, IndexConfig,
                          LearnedIndex, SearchConfig)
from tpulmi_torch import search as program_search
from tpulmi_torch.utils import profiling

torch.set_num_threads(1)

G, C, P, K, EXTRA = 2, 6, 4, 10, 10
DIST_TOL = 2.0e-4
SPEC = datagen.Spec(rows=4096, n_queries=200, d_search=64, d_nav=16,
                    n_clusters=12, cluster_std=0.9, skew=1.5)
INNER = dict(n_categories=C, epochs=1, lr=0.003, model_type="MLP-5",
             batch_size=256, row_align=64, seed=2023)
HIER = dict(n_groups=G, outer_epochs=1, outer_lr=0.003, seed=2023,
            calibrate_budget=P)
SEARCH = {
    "float32": SearchConfig(k=K, n_buckets=P, compute_dtype="float32"),
    "int8_rerank": SearchConfig(k=K, n_buckets=P, int8_queries=True,
                                rerank=True, rerank_dtype="float16",
                                rerank_extra=EXTRA),
}


def _config():
    return HierarchicalConfig(inner=IndexConfig(**INNER), **HIER)


@pytest.fixture(scope="module")
def data():
    corpus = datagen.Corpus(SPEC, 3000000029, "cpu")
    queries_nav, queries_search = corpus.queries()
    search_rows, nav_rows = datagen.host_arrays(corpus, "float32",
                                                "float32")
    # the generator's rows went through bfloat16; made unit again, they
    # are what ``normalized=True`` promises
    search_rows /= np.linalg.norm(search_rows, axis=1, keepdims=True)
    return nav_rows, search_rows, queries_nav, queries_search


@pytest.fixture(scope="module")
def built(data):
    """Both builds; the host-store build's span records and counters, taken
    under a profiler."""
    nav, rows, _, _ = data
    flat = HierarchicalIndex(_config(), device="cpu")
    flat.build(nav, rows)
    host = HierarchicalIndex(_config(), device="cpu")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        host.build_with_host_store(nav, rows, normalized=True,
                                   store_dtype="int8")
    recs = profiling.records()
    profiling.reset()
    return {"float32": flat, "int8_rerank": host, "records": recs}


def _search(index, data, scfg):
    """The program's routed buckets (its routing functions, as
    `search_program` calls them), distances and 0-based ids."""
    _, _, qn, qs = data
    with torch.no_grad():
        logits, _ = program_search.routing_logits(
            index.built.classifier.model, torch.from_numpy(qn),
            need_mass=False)
        routed = program_search.route_probes(logits, P)
    dists, ids = index.search(qn, qs, n_buckets=P, k=K, search_config=scfg)
    return routed.numpy(), dists, ids - 1


def _reference(index, data, store):
    _, rows, qn, qs = data
    return hier_reference.search(
        router_of(index), buckets_of(index), torch.from_numpy(qn),
        torch.from_numpy(qs), P, K, int8_queries=store == "int8_rerank",
        rerank_extra=EXTRA, host_rows=host_rows(rows), normalized=True)


@pytest.mark.parametrize("store", list(SEARCH))
def test_joint_routing_is_the_references_top_p(built, data, store):
    index = built[store]
    routed, dists, ids = _search(index, data, SEARCH[store])
    ref = _reference(index, data, store)
    got = compare(routed, dists, ids, ref, DIST_TOL)
    assert got["routed_differ_untied"] == 0, got
    # the program's scores are the reference's
    scores = index.built.classifier.model(torch.from_numpy(data[2]))
    np.testing.assert_allclose(scores.detach().numpy(),
                               ref.scores.numpy(), atol=1e-5)
    assert routed.shape == (SPEC.n_queries, P)


@pytest.mark.parametrize("store", list(SEARCH))
def test_search_holds_against_the_plain_reference(built, data, store):
    index = built[store]
    got = compare(*_search(index, data, SEARCH[store]),
                  _reference(index, data, store), DIST_TOL)
    assert got["held"], got
    assert index.built.store.is_quantized == (store == "int8_rerank")


def test_the_int8_distances_without_the_rerank_fail_the_hold(built, data):
    index = built["int8_rerank"]
    scfg = SearchConfig(k=K, n_buckets=P, int8_queries=True, rerank=False)
    got = compare(*_search(index, data, scfg),
                  _reference(index, data, "int8_rerank"), DIST_TOL)
    assert got["routed_differ_untied"] == 0
    assert got["dist_rms_gap"] > DIST_TOL, got
    assert not got["held"]


@pytest.mark.parametrize("normalized", [True, False])
def test_the_references_rerank_takes_rows_as_the_build_was_told(
        data, normalized):
    _, rows, _, qs = data
    q = torch.from_numpy(qs[:3])
    ids = torch.tensor([[0, 1], [2, 3], [4, -1]])
    unit = hier_reference.pair_dists(host_rows(rows), ids, q)
    longer = host_rows(rows * np.float32(1.5))
    got = hier_reference.pair_dists(longer, ids, q, normalized)
    # rows taken as unit: the dot of the longer rows; else the cosine
    want = 1.0 - 1.5 * (1.0 - unit) if normalized else unit
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert torch.isinf(got[2, 1])


def test_a_hierarchical_build_records_its_stages(built):
    names = {r[0] for r in built["records"]}
    assert {"hier.outer", "hier.inner", "hier.calibrate"} <= names
    stages = built["int8_rerank"].last_build_stages
    assert {"nav", "outer", "inner", "calibrate"} <= set(stages)
    assert 0 < stages["outer"] + stages["inner"] <= stages["nav"]
    assert stages["calibrate"] > 0
    # the device-store build keeps the hierarchy's stages too
    assert {"outer", "inner", "calibrate"} <= set(
        built["float32"].last_build_stages)


def test_a_search_records_the_joint_router(built, data):
    index = built["int8_rerank"]
    _, _, qn, qs = data
    profiling.reset()
    try:
        before = profiling.counters().get("route_joint_scores", 0)
        with profile(activities=[ProfilerActivity.CPU]):
            index.search(qn, qs, n_buckets=P, k=K,
                         search_config=SEARCH["int8_rerank"])
        recs = profiling.records()
        grown = profiling.counters()["route_joint_scores"] - before
    finally:
        profiling.reset()
    joint = [r for r in recs if r[0] == "route.joint"]
    assert len(joint) == 1 and joint[0][2] == "program.route"
    assert grown == len(qn) * G * C


def test_a_flat_index_records_neither(data):
    nav, rows, qn, qs = data
    flat = LearnedIndex(IndexConfig(**{**INNER, "n_categories": G * C}),
                        device="cpu")
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            flat.build_with_host_store(nav, rows, normalized=True,
                                       store_dtype="int8")
            flat.search(qn, qs, n_buckets=P, k=K,
                        search_config=SEARCH["int8_rerank"])
        names = {r[0] for r in profiling.records()}
        counted = profiling.counters()
    finally:
        profiling.reset()
    assert "search" in names
    assert not {n for n in names if n.startswith("hier.")}
    assert "route.joint" not in names
    assert "route_joint_scores" not in counted
    assert not {"outer", "inner", "calibrate"} & set(flat.last_build_stages)
