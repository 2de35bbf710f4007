"""bench_10m.py's flat configuration against the JAX package on the CPU, at
a small size: `synthetic_dataset_big(n=30_000, n_clusters=12,
backend="host")` (768 search and 96 navigation features, seed 2023, 100
queries), bench_10m.py's `IndexConfig` (:78-83: MLP-5, 8 epochs, lr 0.003,
batch 4096, row_align 1024) at 12 buckets, an int8 host store with the
exact host rerank, 4 probes.

The navigation rows go in as bfloat16, as bench_10m.py passes them
(`ds["data_nav"].astype(ml_dtypes.bfloat16)`, :97-100): the port's flat
`build_with_host_store` takes a `HostBF16` (in RAM or memory-mapped) or a
bfloat16 tensor, keeps it bfloat16 on the device, and builds what it builds
from the float32 upcast of the same rows, to the bit. Against the JAX
package's build fed the bfloat16 rows, the port lays out the same store
from the same pred, to the bit.

Then bench_10m.py's sequence of searches (:136-255) on the JAX build carried
into the port: the base search (int8 queries), the worklist, probe_mass
0.95 and 0.98, the float16 rerank copy, rerank_extra 6 and 4, rerank off,
and 4 `search_stream` batches carrying the host mirror of the queries. The
JAX package's CPU backend scores a quantized store with float32 queries
whatever `int8_queries` says, and so does the port with
``int8_queries=False``: after the rerank ids equal and distances within
1e-5, recall@10 equal; without it distances within 1e-5. The port's int8
query runs, which quantize the queries as the card's kernel does, are held
against its own float query runs: after the rerank at most 2% of the rows
hold other ids (a true neighbour within the query's int8 noise of the
candidate cut), rank by rank within 5e-3 on those rows and 1e-5 on the
rest, recall@10 within 0.01; without the rerank distances within 5e-3.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import tpulmi_torch.build as port_build
from test_torch_native import ref_native  # noqa: F401
from tpulmi.index import LearnedIndex as JaxIndex
from tpulmi.utils.config import IndexConfig as JaxIndexConfig
from tpulmi.utils.config import SearchConfig as JaxSearchConfig
from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
from tpulmi_torch.convert import index_from_arrays
from tpulmi_torch.evaluate import recall_at_k
from tpulmi_torch.hoststore import HostBF16
from tpulmi_torch.ops.distance import exact_knn

torch.set_num_threads(2)

N, N_QUERIES, CLUSTERS, PROBES, K = 30_000, 100, 12, 4, 10
CFG = dict(n_categories=CLUSTERS, epochs=8, lr=0.003, model_type="MLP-5",
           batch_size=4096, seed=2023, row_align=1024)
ROWS_DIFFER_MAX = 0.02      # of the queries, with int8 queries
DIST_NOISE = 5e-3           # int8 query codes: ~1/127 of a unit norm
RECALL_TOL = 0.01
# bench_10m.py's variants (:136-225), as SearchConfig fields
VARIANTS = {"base": {}, "worklist": dict(pallas_worklist=True),
            "probe_mass_0.95": dict(probe_mass=0.95),
            "probe_mass_0.98": dict(probe_mass=0.98),
            "rerank_float16": dict(rerank_dtype="float16"),
            "rerank_extra_6": dict(rerank_extra=6),
            "rerank_extra_4": dict(rerank_extra=4),
            "rerank_off": dict(rerank=False)}


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    from tpulmi.data import synthetic_dataset_big

    return synthetic_dataset_big(
        n=N, n_queries=N_QUERIES, d_nav=96, d_search=768,
        n_clusters=CLUSTERS, seed=2023,
        cache_dir=str(tmp_path_factory.mktemp("big10m")), backend="host")


@pytest.fixture(scope="module")
def nav_bf16(big):
    """The navigation rows rounded to bfloat16, as bench_10m.py rounds
    them."""
    return np.asarray(big["data_nav"]).astype(ml_dtypes.bfloat16)


@pytest.fixture(scope="module")
def corpus(big):
    """The port's view of the bfloat16 corpus memory map."""
    return HostBF16(big["data_search"].view(np.uint16))


@pytest.fixture(scope="module")
def jax_built(big, nav_bf16, ref_native):  # noqa: F811
    import tpulmi.native

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpulmi.native, "native_layout", ref_native)
        jli = JaxIndex(JaxIndexConfig(**CFG))
        pred, _ = jli.build_with_host_store(
            nav_bf16, big["data_search"], normalized=True,
            store_dtype="int8")
    return jli, np.asarray(pred)


@pytest.fixture(scope="module")
def f32_build(nav_bf16, corpus):
    """The port's build fed the float32 upcast of the rounded rows."""
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    pred, _ = li.build_with_host_store(nav_bf16.astype(np.float32), corpus,
                                       normalized=True, store_dtype="int8")
    return li, pred


@pytest.fixture(scope="module")
def carried(jax_built, corpus):
    """The JAX build carried into the port, the bfloat16 corpus attached."""
    jli, pred = jax_built
    s = jli.built.store
    tli = index_from_arrays(
        jax.device_get(jli.built.classifier.params),
        np.asarray(s.data_sorted), np.asarray(s.ids_sorted),
        np.asarray(s.offsets), np.asarray(s.counts), s.n, s.pad_rows,
        s.row_align, config=IndexConfig(**CFG), device="cpu",
        scales=np.asarray(s.scales), quant_bits=8,
        centroids=np.asarray(jli.built.centroids), pred_categories=pred)
    tli.attach_host_corpus(corpus, normalized=True)
    return tli


@pytest.fixture(scope="module")
def oracle(big, corpus):
    _, ids = exact_knn(torch.from_numpy(big["queries_search"]),
                       torch.from_numpy(np.asarray(corpus)), K)
    return ids.numpy()


def _bf16_nav(kind, nav_bf16, tmp_path):
    bits = nav_bf16.view(np.uint16)
    if kind == "host_bf16":
        return HostBF16(np.array(bits))
    if kind == "tensor":
        return torch.from_numpy(np.array(bits)).view(torch.bfloat16)
    np.save(tmp_path / "nav.npy", bits)
    return HostBF16(np.load(tmp_path / "nav.npy", mmap_mode="r"))


@pytest.mark.parametrize("kind", ["host_bf16", "tensor", "memmap"])
def test_bfloat16_navigation_builds_the_float32_upcast(
        kind, nav_bf16, corpus, f32_build, tmp_path, monkeypatch):
    """A `HostBF16`, a bfloat16 tensor and a bfloat16 memory map each give
    the build of the float32 upcast of the same rows, to the bit; the rows
    reach the build stages as bfloat16 on the index's device."""
    seen = []
    real = port_build.fused_build

    def spy(data_nav, *a, **kw):
        seen.append((data_nav.dtype, data_nav.device.type))
        return real(data_nav, *a, **kw)

    monkeypatch.setattr(port_build, "fused_build", spy)
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    pred, _ = li.build_with_host_store(_bf16_nav(kind, nav_bf16, tmp_path),
                                       corpus, normalized=True,
                                       store_dtype="int8")
    assert seen == [(torch.bfloat16, "cpu")]
    want, want_pred = f32_build
    np.testing.assert_array_equal(pred, want_pred)
    got_st, want_st = li.built.store, want.built.store
    for name in ("data_sorted", "scales", "ids_sorted", "offsets",
                 "counts"):
        assert torch.equal(getattr(got_st, name), getattr(want_st, name)), \
            name
    assert torch.equal(li.built.centroids, want.built.centroids)
    for a, b in zip(li.built.classifier.model.state_dict().values(),
                    want.built.classifier.model.state_dict().values()):
        assert torch.equal(a, b)


def test_layout_of_the_jax_pred_equals_jax(jax_built, corpus):
    """The JAX package's build fed bench_10m.py's bfloat16 navigation rows:
    the port lays out the same int8 store from its pred, to the bit."""
    jli, pred = jax_built
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    got, arrays, _ = li._host_store_to_built(
        pred, corpus, CLUSTERS, store_dtype="int8", normalized=True,
        overlap_upload=True, mesh=None)
    want = jli.built.store
    for name in ("data_sorted", "scales", "ids_sorted", "offsets",
                 "counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert (got.n, got.pad_rows, got.row_align, got.quant_bits) == (
        want.n, want.pad_rows, want.row_align, want.quant_bits)


def _configs(opts):
    """(JAX config, the port's float query config, its int8 query config)
    of one variant: bench_10m.py's SearchConfig(k=10, int8_queries=True)
    with `opts`, float32 queries where the queries are not quantized."""
    base = dict(k=K, n_buckets=PROBES, compute_dtype=None, **opts)
    return (JaxSearchConfig(backend="xla", int8_queries=True, **base),
            SearchConfig(int8_queries=False, **base),
            SearchConfig(int8_queries=True, **base))


def _queries(big):
    return big["queries_nav"], big["queries_search"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bench_10m_variant_equals_jax(variant, jax_built, carried, big,
                                      oracle):
    jli, _ = jax_built
    jcfg, fcfg, icfg = _configs(VARIANTS[variant])
    q, host = _queries(big), big["queries_search"]
    jd, ji = (np.asarray(x) for x in jli.search(
        *q, n_buckets=PROBES, k=K, search_config=jcfg,
        queries_search_host=host))
    fd, fi = carried.search(*q, n_buckets=PROBES, k=K, search_config=fcfg,
                            queries_search_host=host)
    idd, ii = carried.search(*q, n_buckets=PROBES, k=K, search_config=icfg,
                             queries_search_host=host)
    np.testing.assert_allclose(fd, jd, atol=1e-5)
    if fcfg.rerank:
        np.testing.assert_array_equal(fi, ji)
        assert recall_at_k(fi - 1, oracle, K) == recall_at_k(ji - 1,
                                                            oracle, K)
        same = np.array([set(a) == set(b) for a, b in zip(ii, fi)])
        assert (~same).mean() <= ROWS_DIFFER_MAX, (~same).sum()
        np.testing.assert_allclose(idd[~same], fd[~same], atol=DIST_NOISE)
        np.testing.assert_allclose(idd[same], fd[same], atol=1e-5)
        rec_i, rec_f = (recall_at_k(x - 1, oracle, K) for x in (ii, fi))
        assert abs(rec_i - rec_f) <= RECALL_TOL and rec_i > 0.9, (rec_i,
                                                                  rec_f)
    else:
        assert (fi == ji).mean() >= 0.99
        np.testing.assert_allclose(idd, fd, atol=DIST_NOISE)
    if variant == "worklist":
        assert carried._wl_pads[(N_QUERIES, PROBES)] > 0


def test_bench_10m_stream_equals_search(jax_built, carried, big):
    """4 `search_stream` batches of (nav, search, host mirror), depth 2:
    with float queries each equal to the JAX package's search of the batch,
    with int8 queries each equal to the port's own search, to the bit."""
    jli, _ = jax_built
    jcfg, fcfg, icfg = _configs({})
    batches = [tuple(np.roll(x, -25 * i, axis=0) for x in (
        big["queries_nav"], big["queries_search"], big["queries_search"]))
        for i in range(4)]
    for cfg in (fcfg, icfg):
        got = list(carried.search_stream(batches, n_buckets=PROBES, k=K,
                                         search_config=cfg, depth=2))
        assert len(got) == len(batches)
        for (gd, gi), (qn, qs, host) in zip(got, batches):
            if cfg is fcfg:
                wd, wi = (np.asarray(x) for x in jli.search(
                    qn, qs, n_buckets=PROBES, k=K, search_config=jcfg,
                    queries_search_host=host))
                np.testing.assert_allclose(gd, wd, atol=1e-5)
            else:
                wd, wi = carried.search(qn, qs, n_buckets=PROBES, k=K,
                                        search_config=cfg,
                                        queries_search_host=host)
                np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gi, wi)
