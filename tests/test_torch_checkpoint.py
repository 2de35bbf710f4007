"""save / load of tpulmi_torch.LearnedIndex: the round trip, the packed
store, and the rerank-corpus contract of the JAX package's checkpoints
(fingerprint, reattach or warn, opt-in include_corpus)."""

import json
import logging

import numpy as np
import pytest
import torch

from tpulmi.index import LearnedIndex as JaxIndex
from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
from tpulmi_torch.ops.distance import exact_knn

torch.set_num_threads(1)

C, K = 12, 10
CFG = dict(n_categories=C, epochs=4, lr=0.003, batch_size=512, row_align=64)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def corpus_queries():
    rng = np.random.default_rng(5)
    return _unit(rng, 4000, 64), _unit(rng, 40, 64)


@pytest.fixture
def warnings_of_index():
    """Messages the index logs at WARNING (its logger does not propagate)."""
    seen = []

    class Catch(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    logger, handler = logging.getLogger("tpulmi_torch.index"), Catch()
    handler.setLevel(logging.WARNING)
    logger.addHandler(handler)
    yield seen
    logger.removeHandler(handler)


def _built(data, bits=None, corpus=None):
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    li.build(data, data)
    if bits:
        li.quantize(host_corpus=corpus, normalized=True, bits=bits)
    return li


def _search(li, queries, n_buckets=C, **kw):
    return li.search(queries, queries, n_buckets=n_buckets, k=K,
                     search_config=SearchConfig(k=K, n_buckets=n_buckets,
                                                compute_dtype=None, **kw))


def test_full_precision_round_trip(corpus_queries, tmp_path):
    data, queries = corpus_queries
    li = _built(data)
    want = _search(li, queries, 3)
    li.save(str(tmp_path / "ckpt"))
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "meta.json", "state.npz"]
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["version"] == 2 and meta["store_quant_bits"] == 8
    assert meta["store_row_align"] == 64 and meta["store_n"] == 4000
    assert meta["config"] == li.config.to_dict() and "rerank" not in meta
    # the same keys as the JAX package's meta.json
    import inspect
    src = inspect.getsource(JaxIndex.save)
    for key in meta:
        assert f'"{key}"' in src, key
    li2 = LearnedIndex.load(str(tmp_path / "ckpt"), device="cpu")
    assert li2.config == li.config and li2._host_corpus is None
    b, b2 = li.built, li2.built
    assert not b2.store.is_quantized and b2.max_bucket == b.max_bucket
    for name in ("data_sorted", "ids_sorted", "offsets", "counts"):
        assert torch.equal(getattr(b2.store, name), getattr(b.store, name))
        assert getattr(b2.store, name).dtype == getattr(b.store, name).dtype
    assert torch.equal(b2.pred_categories, b.pred_categories)
    assert torch.equal(b2.centroids, b.centroids)
    got = _search(li2, queries, 3)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_save_needs_a_built_index_and_load_defaults_to_the_card(
        corpus_queries, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="Nothing to save"):
        LearnedIndex(device="cpu").save(str(tmp_path / "none"))
    _built(corpus_queries[0][:600]).save(str(tmp_path / "ckpt"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LearnedIndex.load(str(tmp_path / "ckpt"))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_round_trip_with_corpus(corpus_queries, tmp_path, bits,
                                          warnings_of_index):
    """include_corpus=True: the checkpoint reattaches its corpus by itself
    and the restored index returns the same, exact, result."""
    data, queries = corpus_queries
    li = _built(data, bits, data)
    extra = dict(rerank_extra=60) if bits == 4 else {}
    want = _search(li, queries, **extra)
    exact_d, exact_i = exact_knn(torch.from_numpy(queries),
                                 torch.from_numpy(data), k=K, normalized=True)
    np.testing.assert_array_equal(want[1], exact_i.numpy() + 1)
    li.save(str(tmp_path / "ckpt"), include_corpus=True)
    assert (tmp_path / "ckpt" / "corpus.npy").exists()
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["store_quant_bits"] == bits
    assert meta["rerank"]["normalized"] is True
    assert meta["rerank"]["corpus_path"] is None      # not a memmap
    assert meta["rerank"]["fingerprint"] == {
        "n": 4000, "d": 64,
        "rows_sha1": JaxIndex._corpus_fingerprint(data)["rows_sha1"]}
    li2 = LearnedIndex.load(str(tmp_path / "ckpt"), device="cpu")
    st, st2 = li.built.store, li2.built.store
    assert st2.quant_bits == bits and st2.packed == (bits == 4)
    assert st2.data_sorted.dtype == torch.int8
    assert torch.equal(st2.data_sorted, st.data_sorted)
    assert torch.equal(st2.scales, st.scales)
    assert li2._host_corpus is not None and li2._host_corpus[1] is True
    assert not warnings_of_index
    got = _search(li2, queries, **extra)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)


def test_quantized_load_without_corpus_warns_then_reattaches(
        corpus_queries, tmp_path, warnings_of_index):
    """Saved without the corpus: load warns loudly and searches the codes
    only; attach_host_corpus restores the exact result; another corpus is
    refused by the fingerprint."""
    data, queries = corpus_queries
    li = _built(data, 4, data)
    want = _search(li, queries, rerank_extra=60)
    li.save(str(tmp_path / "ckpt"))
    assert not (tmp_path / "ckpt" / "corpus.npy").exists()
    li2 = LearnedIndex.load(str(tmp_path / "ckpt"), device="cpu")
    assert li2._host_corpus is None
    assert any("WITHOUT its rerank corpus" in m for m in warnings_of_index)
    codes_only = _search(li2, queries, rerank_extra=60)
    assert np.abs(codes_only[0] - want[0]).max() > 1e-4    # approximate
    wrong = data.copy()
    wrong[0, 0] += 0.5
    with pytest.raises(ValueError, match="fingerprint"):
        li2.attach_host_corpus(wrong)
    with pytest.raises(ValueError, match="fingerprint"):
        li2.attach_host_corpus(data[:-1])
    assert li2._host_corpus is None
    li2.attach_host_corpus(data)       # `normalized` comes from the contract
    assert li2._host_corpus[1] is True
    got = _search(li2, queries, rerank_extra=60)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)


def test_memmap_corpus_reattaches_from_its_path(corpus_queries, tmp_path,
                                                warnings_of_index):
    """A memmap corpus is recorded by path and found again on load; once
    the file is gone, or holds other rows, load warns instead."""
    data, queries = corpus_queries
    np.save(tmp_path / "corpus_src.npy", data)
    mm = np.load(tmp_path / "corpus_src.npy", mmap_mode="r")
    li = _built(data, 8, mm)
    want = _search(li, queries)
    li.save(str(tmp_path / "ckpt"))
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["rerank"]["corpus_path"] == str(tmp_path / "corpus_src.npy")
    li2 = LearnedIndex.load(str(tmp_path / "ckpt"), device="cpu")
    assert li2._host_corpus is not None and not warnings_of_index
    got = _search(li2, queries)
    np.testing.assert_array_equal(got[1], want[1])
    del mm, li2
    np.save(tmp_path / "corpus_src.npy", data[::-1].copy())
    li3 = LearnedIndex.load(str(tmp_path / "ckpt"), device="cpu")
    assert li3._host_corpus is None
    assert any("rejected" in m for m in warnings_of_index)
    assert any("WITHOUT its rerank corpus" in m for m in warnings_of_index)
    (tmp_path / "corpus_src.npy").unlink()
    li4 = LearnedIndex.load(str(tmp_path / "ckpt"), device="cpu")
    assert li4._host_corpus is None


def test_state_file_holds_no_pickle(corpus_queries, tmp_path):
    data, _ = corpus_queries
    li = _built(data[:600], 8, data[:600])
    li.save(str(tmp_path / "ckpt"))
    with np.load(tmp_path / "ckpt" / "state.npz", allow_pickle=False) as z:
        names = set(z.files)
        assert z["store.data_sorted"].dtype == np.int8
        assert z["store.scales"].dtype == np.float32
    assert {"centroids", "pred_categories", "store.data_sorted",
            "store.ids_sorted", "store.offsets", "store.counts",
            "store.scales"} <= names
    assert any(n.startswith("params.layers.") for n in names)
