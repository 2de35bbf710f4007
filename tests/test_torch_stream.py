"""`LearnedIndex.search_stream` of tpulmi_torch on ``device="cpu"``: a pure
reordering of `search`, batch by batch and in order, through the warm-up,
steady, overflow and rerank paths, as tests/test_stream.py holds the JAX
package's. On the CPU the generator runs its dispatches inline (no streams,
no pinned memory); the CUDA staging is driven by chip_smoke.py's `serving`
phase. One case runs the JAX package's stream beside the port's on a carried
index."""

import threading

import jax
import numpy as np
import pytest
import torch

from tpulmi.index import LearnedIndex as JaxIndex
from tpulmi.utils.config import IndexConfig as JaxIndexConfig
from tpulmi.utils.config import SearchConfig as JaxSearchConfig
from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
from tpulmi_torch.convert import index_from_arrays

torch.set_num_threads(1)

CFG = dict(n_categories=24, epochs=8, lr=0.003, model_type="MLP-5")


@pytest.fixture(scope="module")
def built(synthetic_small):
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    li.build(synthetic_small["data_nav"], synthetic_small["data_search"])
    return li


def _batches(ds, sizes):
    lo, out = 0, []
    for s in sizes:
        out.append((ds["queries_nav"][lo:lo + s],
                    ds["queries_search"][lo:lo + s]))
        lo += s
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gi), (wd, wi) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, rtol=0, atol=0)


def test_stream_matches_search(built, synthetic_small):
    batches = _batches(synthetic_small, [50, 50, 50, 50])
    got = list(built.search_stream(batches, n_buckets=4, k=10, depth=2))
    _assert_same(got, [built.search(qn, qs, n_buckets=4, k=10)
                       for qn, qs in batches])
    assert got[0][0].dtype == np.float32 and got[0][1].dtype == np.int64


def test_stream_mixed_shapes_and_depth(built, synthetic_small):
    # a new shape mid-stream drains what is in flight and goes through
    # `search`; results stay in order
    batches = _batches(synthetic_small, [60, 60, 40, 40])
    got = list(built.search_stream(batches, n_buckets=3, k=5, depth=3))
    _assert_same(got, [built.search(qn, qs, n_buckets=3, k=5)
                       for qn, qs in batches])
    assert {(60, 3), (40, 3)} <= built._warm_shapes


def test_stream_single_batch_and_empty(built, synthetic_small):
    batches = _batches(synthetic_small, [80])
    got = list(built.search_stream(batches, n_buckets=4, k=10))
    _assert_same(got, [built.search(*batches[0], n_buckets=4, k=10)])
    assert list(built.search_stream([], n_buckets=4)) == []
    # a batch above batch_queries goes through `search`, which splits it
    scfg = SearchConfig(batch_queries=32)
    got = list(built.search_stream(batches * 2, n_buckets=4, k=10,
                                   search_config=scfg))
    _assert_same(got, [built.search(*batches[0], n_buckets=4, k=10,
                                    search_config=scfg)] * 2)


@pytest.mark.parametrize("options", [dict(), dict(pallas_pair=True)],
                         ids=["worklist", "worklist-pair"])
def test_stream_overflow_fallback(built, synthetic_small, options):
    """A poisoned (undersized) worklist pad: the result in flight overflows
    and that batch is redone through `search`; results stay exact and the
    cache heals."""
    qn = synthetic_small["queries_nav"][:100]
    qs = synthetic_small["queries_search"][:100]
    scfg = SearchConfig(pallas_worklist=True, pallas_mc=128, **options)
    want = built.search(qn, qs, n_buckets=6, k=10)
    first = built.search(qn, qs, n_buckets=6, k=10, search_config=scfg)
    np.testing.assert_array_equal(first[1], want[1])
    assert built._wl_pads[(100, 6)] >= 1024
    built._wl_pads[(100, 6)] = 1
    got = list(built.search_stream([(qn, qs)] * 3, n_buckets=6, k=10,
                                   search_config=scfg))
    for d_s, i_s in got:
        np.testing.assert_array_equal(i_s, want[1])
        np.testing.assert_allclose(d_s, want[0], atol=1e-6)
    assert built._wl_pads[(100, 6)] >= 1024


@pytest.mark.parametrize("options", [
    dict(), dict(int8_queries=True), dict(pallas_pool=True),
    dict(pallas_pool=True, pallas_worklist=True, pallas_mc=128)],
    ids=["int8", "int8q", "pool", "pool-worklist"])
def test_stream_quantized_rerank(synthetic_small, options):
    li = LearnedIndex(IndexConfig(n_categories=16, epochs=6, lr=0.003,
                                  model_type="MLP-5"), device="cpu")
    data = np.asarray(synthetic_small["data_search"], np.float32)
    data = data / np.maximum(np.linalg.norm(data, axis=1, keepdims=True),
                             1e-12)
    li.build(synthetic_small["data_nav"], data)
    li.quantize(host_corpus=data, normalized=True)
    scfg = SearchConfig(k=10, n_buckets=5, rerank=True, **options)
    batches = _batches(synthetic_small, [64, 64, 64])
    got = list(li.search_stream(batches, n_buckets=5, k=10,
                                search_config=scfg, depth=2))
    _assert_same(got, [li.search(qn, qs, n_buckets=5, k=10,
                                 search_config=scfg) for qn, qs in batches])


def test_stream_overlap_finalize_runs_off_thread(built, synthetic_small):
    """overlap_finalize moves the host post-processing of the steady
    batches to the worker thread; without it everything stays on the
    caller's thread. Both give `search`'s results."""
    batches = _batches(synthetic_small, [50, 50, 50, 50])
    want = [built.search(qn, qs, n_buckets=4, k=10) for qn, qs in batches]
    idents = []
    orig = built._finalize

    def recording_finalize(*a, **kw):
        idents.append(threading.get_ident())
        return orig(*a, **kw)

    built._finalize = recording_finalize
    try:
        got = list(built.search_stream(batches, n_buckets=4, k=10, depth=2))
        n_on = len(idents)
        assert any(t != threading.get_ident() for t in idents)
        off = list(built.search_stream(batches, n_buckets=4, k=10, depth=2,
                                       overlap_finalize=False))
        assert len(idents) > n_on
        assert all(t == threading.get_ident() for t in idents[n_on:])
    finally:
        del built._finalize
    _assert_same(got, want)
    _assert_same(off, want)


def test_stream_takes_tensors_and_host_mirror(built, synthetic_small):
    """Batches of torch tensors, and the three-element form with the host
    mirror of the search queries."""
    batches = _batches(synthetic_small, [50, 50, 50])
    want = [built.search(qn, qs, n_buckets=4, k=10) for qn, qs in batches]
    as_tensors = [(torch.from_numpy(qn), torch.from_numpy(qs), qs)
                  for qn, qs in batches]
    _assert_same(list(built.search_stream(as_tensors, n_buckets=4, k=10)),
                 want)
    nav_only = [(qs, None) for _, qs in batches]
    li = LearnedIndex(IndexConfig(n_categories=8, epochs=2), device="cpu")
    li.build(synthetic_small["data_search"][:3000])
    got = list(li.search_stream(nav_only, n_buckets=2, k=5))
    _assert_same(got, [li.search(qs, n_buckets=2, k=5)
                       for qs, _ in nav_only])


def test_stream_unbuilt_raises():
    with pytest.raises(ValueError, match="not built"):
        next(LearnedIndex(device="cpu").search_stream([], n_buckets=2))


def test_stream_matches_jax_stream(synthetic_small):
    """The JAX package's stream and the port's, on one index carried
    across: distances to 1e-5, ids equal where distances are apart."""
    ds = synthetic_small
    ji = JaxIndex(JaxIndexConfig(**CFG))
    ji.build(ds["data_nav"], ds["data_search"])
    s = ji.built.store
    ti = index_from_arrays(
        jax.device_get(ji.built.classifier.params), np.asarray(s.data_sorted),
        np.asarray(s.ids_sorted), np.asarray(s.offsets),
        np.asarray(s.counts), s.n, s.pad_rows, s.row_align,
        config=IndexConfig(**CFG), centroids=np.asarray(ji.built.centroids),
        pred_categories=np.asarray(ji.built.pred_categories), device="cpu")
    batches = _batches(ds, [50, 50, 50])
    jgot = list(ji.search_stream(
        batches, n_buckets=3, k=10,
        search_config=JaxSearchConfig(n_buckets=3, compute_dtype=None)))
    tgot = list(ti.search_stream(
        batches, n_buckets=3, k=10,
        search_config=SearchConfig(n_buckets=3, compute_dtype=None)))
    assert len(jgot) == len(tgot) == 3
    for (jd_, jids), (td, tids) in zip(jgot, tgot):
        np.testing.assert_allclose(td, jd_, atol=1e-5)
        gap = np.full(jd_.shape, np.inf)
        step = np.diff(jd_, axis=1)
        gap[:, :-1] = np.minimum(gap[:, :-1], step)
        gap[:, 1:] = np.minimum(gap[:, 1:], step)
        np.testing.assert_array_equal(tids[gap > 1e-5],
                                      np.asarray(jids)[gap > 1e-5])
