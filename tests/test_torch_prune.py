"""The xla backend's bucket scan and its threshold prune in tpulmi_torch,
against the JAX package: `pairwise_cosine_threshold` and
`compute_bucket_bounds` within 1e-6, the bound a true lower bound, the scan
(`_probe_search_core`, unpruned and pruned) with the JAX package's ids,
float32 distances within 1e-6 and equal scan counters; and, in the port,
pruned searches equal to the unpruned scan to the bit."""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
from tpulmi_torch.buckets import build_bucket_store, compute_bucket_bounds
from tpulmi_torch.convert import index_from_arrays, store_from_arrays
from tpulmi_torch.ops.distance import pairwise_cosine_threshold
from tpulmi_torch.search import (_probe_search_core, _probe_search_impl,
                                 _probe_search_pruned)

torch.set_num_threads(1)

CFG = dict(n_categories=12, epochs=8, lr=0.003, batch_size=512, row_align=1)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _tight_clusters(seed=11, n=6000, q=64, d_nav=12, d=24, n_clusters=12,
                    noise=0.03):
    """Tight low-dimensional clusters (the JAX package's prune fixture):
    the spherical-cap bound fires only when bucket radii are small against
    the angles between buckets."""
    rng = np.random.default_rng(seed)
    cents = _unit(rng, n_clusters, d)
    cents_nav = _unit(rng, n_clusters, d_nav)
    a = rng.integers(0, n_clusters, size=n)
    data = cents[a] + noise * rng.normal(size=(n, d))
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    nav = cents_nav[a] + noise * rng.normal(size=(n, d_nav))
    aq = rng.integers(0, n_clusters, size=q)
    qs = cents[aq] + noise * rng.normal(size=(q, d))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    qn = cents_nav[aq] + noise * rng.normal(size=(q, d_nav))
    return (nav.astype(np.float32), data.astype(np.float32),
            qn.astype(np.float32), qs.astype(np.float32))


def _stores(labels, data, n_cat, bits=None, pad_rows=64, row_align=1):
    """(JAX store, port store) of the same rows; a quantized port store
    takes the JAX package's codes and scales."""
    from tpulmi.buckets import build_bucket_store as jax_build
    from tpulmi.ops.quantize import quantize_store as jax_quantize

    js = jax_build(labels, data, n_cat, pad_rows=pad_rows,
                   row_align=row_align)
    if bits:
        js = jax_quantize(js, bits=bits)
    ts = store_from_arrays(
        np.asarray(js.data_sorted), np.asarray(js.ids_sorted),
        np.asarray(js.offsets), np.asarray(js.counts), js.n, js.pad_rows,
        js.row_align, device="cpu",
        scales=None if js.scales is None else np.asarray(js.scales),
        quant_bits=js.quant_bits)
    return js, ts


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("normalized", [True, False])
def test_pairwise_cosine_threshold_matches_jax(rng, normalized,
                                               compute_dtype):
    from tpulmi.ops.distance import pairwise_cosine_threshold as jax_fn

    x = rng.normal(size=(30, 40)).astype(np.float32) * 2
    y = rng.normal(size=(50, 40)).astype(np.float32)
    if normalized:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        y /= np.linalg.norm(y, axis=1, keepdims=True)
    thr = rng.uniform(0.6, 1.2, size=30).astype(np.float32)
    jdt = jax.numpy.bfloat16 if compute_dtype else None
    want = np.asarray(jax_fn(x, y, thr, normalized=normalized,
                             compute_dtype=jdt))
    got = pairwise_cosine_threshold(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(thr),
        normalized=normalized,
        compute_dtype=compute_dtype and torch.bfloat16).numpy()
    pruned = want == 10000.0
    assert 0 < pruned.mean() < 1
    np.testing.assert_array_equal(got == 10000.0, pruned)
    np.testing.assert_allclose(got[~pruned], want[~pruned], atol=1e-6)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_compute_bucket_bounds_matches_jax(rng, bits):
    from tpulmi.buckets import compute_bucket_bounds as jax_bounds

    n, d, n_cat = 3000, 32, 9
    data = _unit(rng, n, d) * 1.5
    labels = rng.integers(0, n_cat - 1, size=n).astype(np.int32)  # one empty
    js, ts = _stores(labels, data, n_cat, bits=bits, row_align=64)
    want = jax_bounds(js, chunk=700)
    got = compute_bucket_bounds(ts, chunk=700)
    assert got.has_bounds and not ts.has_bounds
    for name in ("bucket_centroids", "bucket_cos_r", "bucket_max_norm"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
    assert float(got.bucket_max_norm[n_cat - 1]) == 0.0    # the empty one
    # a quantized store drops its bounds: they describe other values
    from tpulmi_torch.ops.quantize import quantize_store

    if bits is None:
        assert not quantize_store(got, bits=8).has_bounds


def test_bound_is_a_true_lower_bound(rng):
    """For every (query, bucket): the least exact distance over the
    bucket's rows is at least the spherical-cap bound."""
    n, d, n_cat, q = 2000, 32, 8, 50
    data = _unit(rng, n, d)
    labels = rng.integers(0, n_cat, size=n).astype(np.int32)
    store = compute_bucket_bounds(build_bucket_store(
        torch.from_numpy(labels), torch.from_numpy(data), n_cat,
        pad_rows=64), chunk=512)
    queries = _unit(rng, q, d)
    cb = store.bucket_centroids.numpy()
    cr = store.bucket_cos_r.numpy()
    mn = store.bucket_max_norm.numpy()
    bound = _bound(queries, cb, cr, mn)
    dists = 1.0 - queries @ data.T
    for c in range(n_cat):
        rows = labels == c
        assert np.all(dists[:, rows].min(axis=1) >= bound[:, c] - 1e-5)


def _bound(queries, cb, cr, mn):
    cq = np.clip(queries @ cb.T, -1.0, 1.0)
    cos_delta = np.where(
        cq >= cr[None, :], 1.0,
        cq * cr[None, :] + np.sqrt(np.maximum(1 - cq ** 2, 0.0))
        * np.sqrt(np.maximum(1 - cr[None, :] ** 2, 0.0)))
    return 1.0 - mn[None, :] * np.maximum(cos_delta, 0.0)


@pytest.fixture(scope="module")
def scan_inputs():
    """Tight clusters in a store with a ragged tail, probes by centroid
    similarity (8 ranks), and thresholds of the first rank's kth best;
    no probed bound lies within 1e-5 of its threshold, so float32
    rounding cannot tip a skip either way."""
    from tpulmi.buckets import compute_bucket_bounds as jax_bounds

    _, data, _, qs = _tight_clusters(q=80)
    rng = np.random.default_rng(2)
    n_cat, p, k = 12, 8, 10
    cents = _unit(rng, n_cat, data.shape[1])
    labels = np.argmax(data @ cents.T, axis=1).astype(np.int32)
    labels[:30] = 11                        # a bucket across chunk edges
    out = {}
    for bits in (None, 8):
        js, ts = _stores(labels, data, n_cat, bits=bits, pad_rows=7)
        js = jax_bounds(js, chunk=1000)
        ts = replace(ts, **{name: torch.from_numpy(np.array(
            getattr(js, name))) for name in (
            "bucket_centroids", "bucket_cos_r", "bucket_max_norm")})
        out[bits] = (js, ts)
    probes = np.argsort(-(qs @ cents.T), axis=1, kind="stable")[:, :p]
    probes = probes.astype(np.int32)
    probes[3, 5] = n_cat                     # a dumped slot
    tau = np.sort(1.0 - qs @ data.T, axis=1)[:, k - 1] + 0.02
    js = out[None][0]
    bound = _bound(qs, np.asarray(js.bucket_centroids),
                   np.asarray(js.bucket_cos_r),
                   np.asarray(js.bucket_max_norm))
    probed = np.take_along_axis(bound, np.minimum(probes, n_cat - 1), 1)
    gap = np.abs(probed - 1e-4 - tau[:, None])
    assert gap.min() > 1e-5
    assert (probed - 1e-4 > tau[:, None]).mean() > 0.3   # the prune bites
    return out, probes, qs, tau.astype(np.float32), k


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("pruned", [False, True])
def test_probe_search_core_matches_jax(scan_inputs, pruned, bits,
                                       compute_dtype):
    from tpulmi.search import _probe_search_impl as jax_impl
    from tpulmi.search import _probe_search_pruned as jax_pruned

    stores, probes, qs, tau, k = scan_inputs
    js, ts = stores[bits]
    kw = dict(k=k, qpb_pad=128, data_chunk=256, max_chunks=4,
              query_chunk=16)
    jdt = jax.numpy.bfloat16 if compute_dtype else None
    tdt = torch.bfloat16 if compute_dtype else None
    tp, tq = torch.from_numpy(probes), torch.from_numpy(qs)
    if pruned:
        jd, ji, jm, jrows, jnom = jax_pruned(probes, qs, js, tau,
                                             compute_dtype=jdt,
                                             prune_eps=1e-4, **kw)
        td, ti, tm, trows, tnom = _probe_search_pruned(
            tp, tq, ts, torch.from_numpy(tau), compute_dtype=tdt,
            prune_eps=1e-4, **kw)
        assert (trows, tnom) == (int(jrows), int(jnom))
        assert trows < tnom
    else:
        jd, ji, jm = jax_impl(probes, qs, js, compute_dtype=jdt, **kw)
        td, ti, tm = _probe_search_impl(tp, tq, ts, compute_dtype=tdt, **kw)
        _, _, _, rows, nom = _probe_search_core(tp, tq, ts, None,
                                                compute_dtype=tdt, **kw)
        assert rows == nom > 0
    assert tm == int(jm)
    jd, ji = np.asarray(jd), np.asarray(ji)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    for r in range(len(qs)):
        assert set(ti[r].tolist()) == set(ji[r].tolist()), r
    np.testing.assert_allclose(td.numpy(), jd,
                               atol=1e-6 if compute_dtype is None else 1e-5)
    if compute_dtype is None and bits is None:
        np.testing.assert_array_equal(ti.numpy(), ji)


def test_core_reports_overflow_and_refuses_without_bounds(scan_inputs):
    stores, probes, qs, tau, k = scan_inputs
    _, ts = stores[None]
    tp, tq = torch.from_numpy(probes), torch.from_numpy(qs)
    d, i, mx, _, _ = _probe_search_core(tp, tq, ts, None, k=k, qpb_pad=16,
                                        data_chunk=256, max_chunks=4,
                                        query_chunk=16)
    assert mx > 16            # the caller re-runs with a larger pad
    with pytest.raises(ValueError, match="compute_bucket_bounds"):
        _probe_search_core(tp, tq, replace(ts, bucket_centroids=None),
                           torch.from_numpy(tau), k=k, qpb_pad=128,
                           data_chunk=256, max_chunks=4)


@pytest.fixture(scope="module")
def clustered_index():
    nav, data, qn, qs = _tight_clusters()
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    li.build(nav, data)
    li.compute_bounds(chunk=1024)
    return li, qn, qs, data


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prune_equals_unpruned(clustered_index, compute_dtype):
    li, qn, qs, _ = clustered_index
    base = SearchConfig(k=10, backend="xla", compute_dtype=compute_dtype)
    pruned = replace(base, prune_after=1)
    d0, i0 = li.search(qn, qs, n_buckets=8, k=10, search_config=base)
    assert li.last_scan_rows is None        # counted only when pruning
    d1, i1 = li.search(qn, qs, n_buckets=8, k=10, search_config=pruned)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)
    assert li.last_scan_rows < li.last_nominal_rows
    # the kernel's search (pruning is the xla scan's) finds the same ids
    d2, i2 = li.search(qn, qs, n_buckets=8, k=10, search_config=replace(
        base, backend="auto", prune_after=1))
    assert li.last_scan_rows is None
    np.testing.assert_array_equal(i2, i0)


def test_prune_equals_unpruned_int8():
    nav, data, qn, qs = _tight_clusters(seed=13)
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    li.build(nav, data)
    li.quantize(host_corpus=data, normalized=True)
    li.compute_bounds(chunk=1024)   # after quantize: bounds of the codes
    base = SearchConfig(k=10, backend="xla", compute_dtype="float32")
    for rerank in (False, True):
        d0, i0 = li.search(qn, qs, n_buckets=6, k=10,
                           search_config=replace(base, rerank=rerank))
        d1, i1 = li.search(qn, qs, n_buckets=6, k=10,
                           search_config=replace(base, rerank=rerank,
                                                 prune_after=1))
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_array_equal(d1, d0)
        assert li.last_scan_rows < li.last_nominal_rows


def test_bounds_survive_checkpoint(clustered_index, tmp_path):
    li, qn, qs, _ = clustered_index
    li.save(tmp_path / "ckpt")
    restored = LearnedIndex.load(tmp_path / "ckpt", device="cpu")
    st = restored.built.store
    assert st.has_bounds
    for name in ("bucket_centroids", "bucket_cos_r", "bucket_max_norm"):
        assert torch.equal(getattr(st, name),
                           getattr(li.built.store, name))
    pruned = SearchConfig(k=10, backend="xla", compute_dtype="float32",
                          prune_after=1)
    d0, i0 = li.search(qn[:32], qs[:32], n_buckets=8, k=10,
                       search_config=pruned)
    scans = li.last_scan_rows
    d1, i1 = restored.search(qn[:32], qs[:32], n_buckets=8, k=10,
                             search_config=pruned)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)
    assert restored.last_scan_rows == scans


def test_batched_queries_sum_scan_counters(clustered_index):
    li, qn, qs, _ = clustered_index
    pruned = SearchConfig(k=10, backend="xla", compute_dtype="float32",
                          prune_after=1)
    whole = li.search(qn, qs, n_buckets=8, k=10, search_config=pruned)
    counts = (li.last_scan_rows, li.last_nominal_rows)
    parts = []
    for lo in range(0, len(qs), 20):
        li.search(qn[lo:lo + 20], qs[lo:lo + 20], n_buckets=8, k=10,
                  search_config=pruned)
        parts.append((li.last_scan_rows, li.last_nominal_rows))
    batched = li.search(qn, qs, n_buckets=8, k=10,
                        search_config=replace(pruned, batch_queries=20))
    assert (li.last_scan_rows, li.last_nominal_rows) == tuple(
        map(sum, zip(*parts)))
    assert counts[0] < counts[1]
    np.testing.assert_array_equal(batched[1], whole[1])


def test_probe_mass_on_xla_counts_rows(clustered_index):
    li, qn, qs, _ = clustered_index
    base = SearchConfig(k=10, backend="xla", compute_dtype="float32")
    d0, i0 = li.search(qn, qs, n_buckets=6, k=10, search_config=base)
    d1, i1 = li.search(qn, qs, n_buckets=6, k=10,
                       search_config=replace(base, probe_mass=1.0))
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)
    assert li.last_scan_rows == li.last_nominal_rows > 0
    # truncation saves rows at query-chunk granularity: small chunks
    _, _, qn, qs = _tight_clusters(q=256)
    small = replace(base, query_chunk=16)
    li.search(qn, qs, n_buckets=6, k=10,
              search_config=replace(small, probe_mass=1.0))
    full = li.last_scan_rows
    li.search(qn, qs, n_buckets=6, k=10,
              search_config=replace(small, probe_mass=0.9))
    assert li.last_scan_rows < full


def test_qpb_pad_overflow_reruns(clustered_index):
    """A pad too small for this batch's busiest bucket is grown and the
    search run again; the result equals a search with room to spare."""
    li, qn, qs, _ = clustered_index
    base = SearchConfig(k=10, backend="xla", compute_dtype="float32")
    want = li.search(qn, qs, n_buckets=4, k=10, search_config=base)
    li._qpb_pads.clear()
    got = li.search(qn, qs, n_buckets=4, k=10, search_config=replace(
        base, queries_per_bucket_pad=8, query_chunk=8))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_carried_index_prunes_like_jax(compute_dtype):
    """A JAX-built index with its bounds, carried across: the port's pruned
    xla search gives the JAX package's ids, its distances (float32 within
    1e-6) and its scan counters."""
    from tpulmi.index import LearnedIndex as JaxIndex
    from tpulmi.utils.config import IndexConfig as JaxIndexConfig
    from tpulmi.utils.config import SearchConfig as JaxSearchConfig

    nav, data, qn, qs = _tight_clusters(seed=17)
    jli = JaxIndex(JaxIndexConfig(**CFG))
    jli.build(nav, data)
    jli.compute_bounds(chunk=1024)
    s = jli.built.store
    tli = index_from_arrays(
        jax.device_get(jli.built.classifier.params),
        np.asarray(s.data_sorted), np.asarray(s.ids_sorted),
        np.asarray(s.offsets), np.asarray(s.counts), s.n, s.pad_rows,
        s.row_align, config=IndexConfig(**CFG), device="cpu")
    tli.compute_bounds(chunk=1024)
    for name in ("bucket_centroids", "bucket_cos_r", "bucket_max_norm"):
        np.testing.assert_allclose(getattr(tli.built.store, name).numpy(),
                                   np.asarray(getattr(s, name)), atol=1e-6)
    opts = dict(k=10, backend="xla", compute_dtype=compute_dtype,
                prune_after=1)
    jd, ji = jli.search(qn, qs, n_buckets=8, k=10,
                        search_config=JaxSearchConfig(**opts))
    td, ti = tli.search(qn, qs, n_buckets=8, k=10,
                        search_config=SearchConfig(**opts))
    assert (tli.last_scan_rows, tli.last_nominal_rows) == (
        jli.last_scan_rows, jli.last_nominal_rows)
    assert tli.last_scan_rows < tli.last_nominal_rows
    for r in range(len(qs)):
        assert set(ti[r]) == set(ji[r]), r
    np.testing.assert_allclose(td, jd, atol=1e-6 if compute_dtype is None
                               else 1e-5)
