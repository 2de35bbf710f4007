"""LearnedIndex.quantize and the exact host rerank of tpulmi_torch against
the JAX package: the same candidates give the same reranked result, a
quantized index probed in full returns the exact oracle, and a JAX-built,
JAX-quantized index carried across searches like the JAX package."""

import jax
import numpy as np
import pytest
import torch

from tpulmi.index import LearnedIndex as JaxIndex
from tpulmi.utils.config import IndexConfig as JaxIndexConfig
from tpulmi.utils.config import SearchConfig as JaxSearchConfig
from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
from tpulmi_torch.convert import index_from_arrays
from tpulmi_torch.ops.distance import exact_knn

torch.set_num_threads(1)

CFG = dict(n_categories=16, epochs=4, lr=0.003, batch_size=512, row_align=1)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _with_corpus(cls, corpus, normalized):
    li = cls.__new__(cls)
    li._host_corpus = (corpus, normalized)
    li._rerank_shadow = None
    return li


@pytest.mark.parametrize("normalized", [True, False])
def test_rerank_host_matches_jax(rng, normalized):
    """Same candidate ids (with repeated ids and -1s among them) through
    both `_rerank_host`s: ids equal, distances to 1e-6."""
    n, d, q, k_eff, k = 3000, 64, 40, 20, 10
    corpus = _unit(rng, n, d) * (1.0 if normalized else 3.0)
    queries = _unit(rng, q, d) * 2.0       # renormalised by the rerank
    ids = rng.integers(0, n, size=(q, k_eff)).astype(np.int32)
    ids[:, 5] = ids[:, 2]                  # a repeated id in every row
    ids[3, 7:] = -1
    ids[4, :] = -1
    ids[5, 1] = ids[5, 0] = ids[5, 9]
    jli = _with_corpus(JaxIndex, corpus, normalized)
    tli = _with_corpus(LearnedIndex, corpus, normalized)
    want_d, want_i = jli._rerank_host(None, ids.copy(), None, k,
                                      host_queries=queries)
    got_d, got_i = tli._rerank_host(None, ids.copy(), None, k,
                                    host_queries=queries)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, atol=1e-6)
    assert got_d.dtype == np.float32 and got_d.shape == (q, k)
    for row in got_i:                      # no id comes back twice
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    assert (got_i[4] == -1).all() and (got_d[4] == 10000.0).all()
    # queries on a device tensor instead of the host mirror: same result
    dev_d, dev_i = tli._rerank_host(None, ids.copy(),
                                    torch.from_numpy(queries), k)
    np.testing.assert_array_equal(dev_i, got_i)
    np.testing.assert_allclose(dev_d, got_d, atol=1e-6)


def test_rerank_float16_shadow(rng, monkeypatch):
    n, d, q, k = 2000, 64, 24, 10
    corpus, queries = _unit(rng, n, d), _unit(rng, q, d)
    ids = np.stack([rng.permutation(n)[:20] for _ in range(q)]).astype(
        np.int32)
    # this test holds the gather + bmm path; the fused native branch, which
    # the port takes whenever its library loads, is held to the JAX
    # package's to the bit in tests/test_torch_native.py
    from tpulmi_torch.native import native_layout as port_native

    monkeypatch.setattr(type(port_native), "available", lambda self: False)
    tli = _with_corpus(LearnedIndex, corpus, True)
    d32, i32 = tli._rerank_host(None, ids, None, k, host_queries=queries)
    d16, i16 = tli._rerank_host(None, ids, None, k, host_queries=queries,
                                rerank_dtype="float16")
    assert np.abs(d16 - d32).max() < 1e-3
    # held against the JAX package's gather + bmm path, which this one
    # ports (its C++ rerank_dot keeps the queries in float32 and differs
    # from its own bmm path by ~1e-4)
    from tpulmi.native import native_layout

    monkeypatch.setattr(type(native_layout), "available", lambda self: False)
    want16, _ = _with_corpus(JaxIndex, corpus, True)._rerank_host(
        None, ids, None, k, host_queries=queries, rerank_dtype="float16")
    np.testing.assert_allclose(d16, want16, atol=1e-6)
    assert tli._rerank_shadow[0] is corpus
    assert tli._rerank_shadow[1].dtype == np.float16
    shadow = tli._rerank_shadow[1]
    tli._rerank_host(None, ids, None, k, host_queries=queries,
                     rerank_dtype="float16")
    assert tli._rerank_shadow[1] is shadow          # cached, not rebuilt
    tli._host_corpus = (np.array(corpus), True)     # another corpus
    tli._rerank_host(None, ids, None, k, host_queries=queries,
                     rerank_dtype="float16")
    assert tli._rerank_shadow[1] is not shadow
    # the RAM guard refuses a shadow that host memory cannot hold
    import tpulmi_torch.index as index_mod

    monkeypatch.setattr(index_mod, "_host_mem_available", lambda: 1 << 20)
    tli._rerank_shadow = None
    with pytest.raises(RuntimeError, match="rerank shadow"):
        tli._rerank_host(None, ids, None, k, host_queries=queries,
                         rerank_dtype="float16")
    assert index_mod._host_mem_available.__name__ == "<lambda>"


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "float64"])
def test_float16_shadow_is_made_slice_by_slice(rng, monkeypatch, kind):
    """The shadow of a float32, bfloat16 (`HostBF16`) or float64 corpus is
    built a slice at a time, never through a float32 copy of the whole
    corpus, and equals numpy's cast of the whole to the bit."""
    import tpulmi_torch.index as index_mod
    from tpulmi_torch.hoststore import HostBF16

    x = _unit(rng, 1000, 48) * 3.0
    x[0, :3] = (70000.0, 1e-6, -3e-8)     # past float16's range, subnormals
    corpus = {"bfloat16": HostBF16.from_float32(x), "float32": x,
              "float64": x.astype(np.float64) / 3.0}[kind]
    with np.errstate(over="ignore"):       # 70000 is past float16's range
        want = np.asarray(corpus, np.float64 if kind == "float64"
                          else np.float32).astype(np.float16)
    monkeypatch.setattr(index_mod, "SHADOW_SLICE_BYTES", 48 * 4 * 64)
    sizes = []
    real = index_mod.host_tensor

    def spy(a):
        sizes.append(len(a))
        return real(a)

    monkeypatch.setattr(index_mod, "host_tensor", spy)
    got = index_mod._float16_copy(corpus)
    assert got.dtype == np.float16 and got.shape == x.shape
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    if kind == "float64":
        assert sizes == []
    else:
        assert max(sizes) == 64 and len(sizes) == -(-1000 // 64)


@pytest.fixture(scope="module")
def corpus_queries():
    rng = np.random.default_rng(11)
    return _unit(rng, 5000, 128), _unit(rng, 48, 128)


@pytest.mark.parametrize("bits,int8q", [(8, False), (8, True), (4, False),
                                        (4, True)])
def test_quantized_full_probe_equals_exact(corpus_queries, bits, int8q):
    """Probing every bucket of a quantized index with the corpus attached
    returns the exact oracle's ids and distances: the rerank erases the
    quantization error."""
    data, queries = corpus_queries
    c, k = CFG["n_categories"], 10
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    li.build(data, data)
    li._search_programs["stale"] = None
    li.quantize(host_corpus=data, normalized=True, bits=bits)
    assert li._search_programs == {}       # the program cache is dropped
    st = li.built.store
    assert st.is_quantized and st.quant_bits == bits and st.dim == 128
    # int4 takes a deeper pool here, as the JAX package's own test does
    extra = 60 if bits == 4 else None
    scfg = SearchConfig(k=k, n_buckets=c, compute_dtype=None,
                        int8_queries=int8q, rerank_extra=extra)
    d_q, i_q = li.search(queries, queries, n_buckets=c, k=k,
                         search_config=scfg)
    want_d, want_i = exact_knn(torch.from_numpy(queries),
                               torch.from_numpy(data), k=k, normalized=True)
    np.testing.assert_array_equal(i_q, want_i.numpy() + 1)
    np.testing.assert_allclose(d_q, want_d.numpy(), atol=1e-5)
    assert d_q.dtype == np.float32 and i_q.dtype == np.int64
    # without the rerank the distances are near but approximate
    d_nr, i_nr = li.search(
        queries, queries, n_buckets=c, k=k,
        search_config=SearchConfig(k=k, n_buckets=c, compute_dtype=None,
                                   int8_queries=int8q, rerank=False))
    err = np.abs(d_nr - want_d.numpy()).max()
    assert 0 < err < (5e-3 if bits == 8 else 5e-2)
    assert d_nr.shape == (48, k)


def test_host_mirror_and_batches(corpus_queries, monkeypatch):
    """numpy queries are captured as the rerank's host mirror; tensors on
    the device are copied back instead; both give one result, and so does
    a batched search."""
    data, queries = corpus_queries
    c, k = CFG["n_categories"], 10
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    li.build(data, data)
    li.quantize(host_corpus=data, normalized=True)
    seen = []
    orig = LearnedIndex._rerank_host

    def spy(self, dists, ids, qs, k, host_queries=None,
            rerank_dtype="float32"):
        seen.append((dists is None, host_queries is not None, ids.shape[1]))
        return orig(self, dists, ids, qs, k, host_queries=host_queries,
                    rerank_dtype=rerank_dtype)

    monkeypatch.setattr(LearnedIndex, "_rerank_host", spy)
    qt = torch.from_numpy(queries)
    d_dev, i_dev = li.search(qt, qt, n_buckets=4, k=k)
    assert seen[-1] == (True, False, k + 10)    # no quantized distances
    d_np, i_np = li.search(queries, queries, n_buckets=4, k=k)
    assert seen[-1] == (True, True, k + 10)
    np.testing.assert_array_equal(i_np, i_dev)
    np.testing.assert_allclose(d_np, d_dev, atol=1e-6)
    d_m, i_m = li.search(qt, qt, n_buckets=4, k=k,
                         queries_search_host=queries)
    assert seen[-1][1] is True
    np.testing.assert_array_equal(i_m, i_dev)
    n_calls = len(seen)
    d_b, i_b = li.search(queries, queries, n_buckets=4, k=k,
                         search_config=SearchConfig(k=k, n_buckets=4,
                                                    batch_queries=20))
    assert len(seen) == n_calls + 3 and all(s[1] for s in seen[n_calls:])
    np.testing.assert_array_equal(i_b, i_dev)
    # rerank=False and a detached corpus search the codes only
    li.search(queries, queries, n_buckets=4, k=k,
              search_config=SearchConfig(k=k, n_buckets=4, rerank=False))
    li._host_corpus = None
    li.search(queries, queries, n_buckets=4, k=k)
    assert len(seen) == n_calls + 3


@pytest.mark.parametrize("bits,int8q", [(8, False), (8, True), (4, False)])
def test_carried_quantized_index_searches_like_jax(synthetic_small, bits,
                                                   int8q):
    """A JAX-built, JAX-quantized index carried across: the quantized
    search and the reranked search give the JAX package's ids. The JAX
    package's CPU backend scores int8 stores with float32 queries whatever
    `int8_queries` says (only its TPU kernel quantizes them), so with int8
    queries the unreranked distances are held to the query quantization
    noise (5e-3) and the reranked result, which is exact, to 1e-5."""
    ds = synthetic_small
    cfg = dict(n_categories=24, epochs=4, lr=0.003, model_type="MLP-5",
               row_align=1024)
    jli = JaxIndex(JaxIndexConfig(**cfg))
    jli.build(ds["data_nav"], ds["data_search"])
    jli.quantize(host_corpus=ds["data_search"], bits=bits)
    s = jli.built.store
    tli = index_from_arrays(
        jax.device_get(jli.built.classifier.params),
        np.asarray(s.data_sorted), np.asarray(s.ids_sorted),
        np.asarray(s.offsets), np.asarray(s.counts), s.n, s.pad_rows,
        s.row_align, config=IndexConfig(**cfg), device="cpu",
        scales=np.asarray(s.scales), quant_bits=bits)
    assert tli.built.store.packed == (bits == 4)
    tli.attach_host_corpus(ds["data_search"])
    for rerank in (True, False):
        jd, ji = jli.search(
            ds["queries_nav"], ds["queries_search"], n_buckets=3, k=10,
            search_config=JaxSearchConfig(
                n_buckets=3, compute_dtype=None, backend="xla",
                int8_queries=int8q, rerank=rerank))
        td, ti = tli.search(
            ds["queries_nav"], ds["queries_search"], n_buckets=3, k=10,
            search_config=SearchConfig(
                n_buckets=3, compute_dtype=None, int8_queries=int8q,
                rerank=rerank))
        if rerank:      # exact distances: ids differ only on exact ties
            np.testing.assert_allclose(td, jd, atol=1e-5)
            np.testing.assert_array_equal(ti, ji)
        elif int8q:
            np.testing.assert_allclose(td, jd, atol=5e-3)
        else:
            np.testing.assert_allclose(td, jd, atol=1e-5)
            assert (ti == ji).mean() >= 0.99


def test_resolve_rerank_extra(rng):
    data = _unit(rng, 600, 32)
    li = LearnedIndex(IndexConfig(n_categories=4, epochs=1, row_align=1),
                      device="cpu")
    assert li._resolve_rerank_extra(SearchConfig()) == 10    # not built
    li.build(data, data)
    assert li._resolve_rerank_extra(SearchConfig()) == 10
    assert li._resolve_rerank_extra(SearchConfig(rerank_extra=7)) == 7
    full = li.built.store
    li.quantize(bits=8)
    assert li._resolve_rerank_extra(SearchConfig()) == 10
    with pytest.raises(ValueError, match="already int8"):
        li.quantize(bits=4)
    li.built.store = full
    li.quantize(host_corpus=data, normalized=True, bits=4)
    assert li._resolve_rerank_extra(SearchConfig()) == 30
    assert li._resolve_rerank_extra(SearchConfig(rerank_extra=0)) == 0
    plan = li._plan_search(torch.zeros((3, 32)), 2, 10, SearchConfig())
    assert plan.rerank and plan.k_eff == 40 and not plan.int8_queries
    plan = li._plan_search(torch.zeros((3, 32)), 2, 10,
                           SearchConfig(rerank=False, int8_queries=True))
    assert not plan.rerank and plan.k_eff == 10 and plan.int8_queries
    with pytest.raises(ValueError, match="not built"):
        LearnedIndex(device="cpu").quantize()
