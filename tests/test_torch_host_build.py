"""LearnedIndex.build_with_host_store of tpulmi_torch: the store laid out on
the host lands on the index's device as the JAX package's
`_host_store_to_built` lays it out (to the bit, on the same `pred`); the
navigation stages give `build`'s `pred` to the bit; a quantized host store
is reranked through the native library; and a bfloat16 store and corpus
survive save / load."""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_native import ref_native, use_ref_native  # noqa: F401
from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
from tpulmi_torch.data import synthetic_dataset
from tpulmi_torch.hoststore import HostBF16, is_memory_mapped
from tpulmi_torch.native import native_layout
from tpulmi_torch.ops.distance import exact_knn

torch.set_num_threads(1)

CFG = dict(n_categories=12, epochs=2, lr=0.003, batch_size=512, row_align=64)


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(n=4000, n_queries=60, d_nav=16, d_search=64,
                             n_clusters=12, seed=4)


@pytest.fixture(scope="module")
def built(ds):
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    pred, _ = li.build(ds["data_nav"], ds["data_search"])
    return li, pred


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("store_dtype", ["bfloat16", "float32", "int8",
                                         "int4"])
def test_host_store_to_built_equals_reference(use_ref_native, ds, built,
                                              store_dtype, overlap):
    from tpulmi.index import LearnedIndex as JaxIndex
    from tpulmi.utils.config import IndexConfig as JaxIndexConfig

    _, pred = built
    data = ds["data_search"]
    jli = JaxIndex(JaxIndexConfig(**CFG))
    want, want_arrays, _ = jli._host_store_to_built(
        pred, data, CFG["n_categories"], store_dtype=store_dtype,
        normalized=True, overlap_upload=overlap, mesh=None)
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    got, arrays, corpus = li._host_store_to_built(
        pred, data, CFG["n_categories"], store_dtype=store_dtype,
        normalized=True, overlap_upload=overlap, mesh=None)
    assert corpus is data
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(_bits(got.data_sorted),
                                  _jax_bits(want.data_sorted))
    for name in ("ids_sorted", "offsets", "counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    if want.scales is None:
        assert got.scales is None
    else:
        np.testing.assert_array_equal(got.scales.numpy(),
                                      np.asarray(want.scales))
    assert (got.n, got.pad_rows, got.row_align, got.quant_bits) == (
        want.n, want.pad_rows, want.row_align, want.quant_bits)
    assert got.dim == want.dim and got.is_quantized == want.is_quantized
    with pytest.raises(NotImplementedError, match="A7"):
        li._host_store_to_built(pred, data, CFG["n_categories"],
                                store_dtype=store_dtype, normalized=True,
                                overlap_upload=overlap, mesh=object())


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16"])
def test_host_store_build_equals_build(ds, built, store_dtype):
    """The navigation stages are `build`'s to the bit; the layout is the
    same store (rows within 1e-6: the native layout normalizes with a
    double sum); searches give build's ids except at bfloat16 ties."""
    li, pred = built
    hli = LearnedIndex(IndexConfig(**CFG), device="cpu")
    hpred, secs = hli.build_with_host_store(
        ds["data_nav"], ds["data_search"], store_dtype=store_dtype,
        overlap_upload=store_dtype == "bfloat16")
    assert secs > 0 and set(hli.last_build_stages) >= {"nav", "total"}
    np.testing.assert_array_equal(hpred, pred)
    assert torch.equal(hli.built.pred_categories, li.built.pred_categories)
    assert torch.equal(hli.built.centroids, li.built.centroids)
    for a, b in zip(hli.built.classifier.model.state_dict().values(),
                    li.built.classifier.model.state_dict().values()):
        assert torch.equal(a, b)
    hs, s = hli.built.store, li.built.store
    for name in ("ids_sorted", "offsets", "counts"):
        assert torch.equal(getattr(hs, name), getattr(s, name))
    assert hli.built.max_bucket == li.built.max_bucket
    tol = 1e-6 if store_dtype == "float32" else 4e-3
    assert (hs.data_sorted.float() - s.data_sorted).abs().max() <= tol
    assert hs.data_sorted.dtype == {"float32": torch.float32,
                                    "bfloat16": torch.bfloat16}[store_dtype]
    q = (ds["queries_nav"], ds["queries_search"])
    want_d, want_i = li.search(*q, n_buckets=3, k=10)
    got_d, got_i = hli.search(*q, n_buckets=3, k=10)
    np.testing.assert_allclose(got_d, want_d, atol=5e-3)
    # every id clearly inside build's top-k (not tied with its kth within
    # bfloat16 rounding) is found by the host-store index too
    for r in range(len(want_i)):
        sure = want_d[r] < want_d[r, -1] - 5e-3
        assert set(want_i[r][sure]) <= set(got_i[r]), r
    assert (got_i != want_i).mean() < 0.1
    with pytest.raises(NotImplementedError, match="A7"):
        hli.build_with_host_store(ds["data_nav"], ds["data_search"],
                                  mesh=object())


def test_int8_host_store_reranks_natively(ds, tmp_path, monkeypatch):
    """An int8 host store built from a bfloat16 memory map that stays on
    disk (source-sequential layout; the rerank reads the map): probing
    every bucket, the native rerank returns the exact oracle over the
    bfloat16 corpus."""
    bits = HostBF16.from_float32(ds["data_search"]).bits
    np.save(tmp_path / "corpus.npy", bits)
    corpus = HostBF16(np.load(tmp_path / "corpus.npy", mmap_mode="r"))
    monkeypatch.setenv("TPULMI_MATERIALIZE_MAX_FRAC", "0")
    monkeypatch.setenv("TPULMI_RERANK_MATERIALIZE_MAX_FRAC", "0")
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    li.build_with_host_store(ds["data_nav"], corpus, normalized=True,
                             store_dtype="int8")
    assert li._host_corpus[0] is corpus and is_memory_mapped(corpus)
    st = li.built.store
    assert st.is_quantized and st.quant_bits == 8 and st.dim == 64
    c, k = CFG["n_categories"], 10
    before = native_layout.calls["rerank_dot"]
    d, ids = li.search(ds["queries_nav"], ds["queries_search"], n_buckets=c,
                       k=k, search_config=SearchConfig(compute_dtype=None))
    assert native_layout.calls["rerank_dot"] == before + 1
    want_d, want_i = exact_knn(torch.from_numpy(ds["queries_search"]),
                               torch.from_numpy(np.asarray(corpus)), k=k,
                               normalized=True)
    np.testing.assert_array_equal(ids, want_i.numpy() + 1)
    np.testing.assert_allclose(d, want_d.numpy(), atol=1e-5)


def test_save_load_bfloat16_store_and_corpus(ds, tmp_path):
    """The repair of `save`: a bfloat16 store (and a bfloat16 corpus in the
    checkpoint) is written as its uint16 bits, named in meta.json, and
    comes back to the bit; searches of the restored index are equal."""
    corpus = HostBF16.from_float32(ds["data_search"])
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    li.build_with_host_store(ds["data_nav"], corpus, normalized=True,
                             store_dtype="bfloat16")
    li.compute_bounds(chunk=1000)
    assert li.built.store.data_sorted.dtype == torch.bfloat16
    li.save(tmp_path / "ckpt", include_corpus=True)
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["bfloat16"] == ["store.data_sorted"]
    assert meta["version"] == 2
    assert meta["rerank"]["corpus_dtype"] == "bfloat16"
    assert np.load(tmp_path / "ckpt" / "corpus.npy").dtype == np.uint16
    back = LearnedIndex.load(tmp_path / "ckpt", device="cpu")
    st, want = back.built.store, li.built.store
    assert st.data_sorted.dtype == torch.bfloat16
    assert torch.equal(st.data_sorted.view(torch.int16),
                       want.data_sorted.view(torch.int16))
    assert st.has_bounds and torch.equal(st.bucket_cos_r, want.bucket_cos_r)
    got_corpus = back._host_corpus[0]
    assert isinstance(got_corpus, HostBF16)
    np.testing.assert_array_equal(got_corpus.bits, corpus.bits)
    q = (ds["queries_nav"], ds["queries_search"])
    for scfg in (SearchConfig(), SearchConfig(backend="xla",
                                              prune_after=1)):
        a = li.search(*q, n_buckets=4, k=10, search_config=scfg)
        b = back.search(*q, n_buckets=4, k=10, search_config=scfg)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[0], b[0])
    # a quantized index over the bfloat16 corpus reattaches it from the
    # checkpoint and reranks the same
    li.quantize(host_corpus=corpus, normalized=True)
    li.save(tmp_path / "q", include_corpus=True)
    back = LearnedIndex.load(tmp_path / "q", device="cpu")
    assert isinstance(back._host_corpus[0], HostBF16)
    a = li.search(*q, n_buckets=4, k=10)
    b = back.search(*q, n_buckets=4, k=10)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])
