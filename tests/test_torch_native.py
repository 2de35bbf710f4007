"""The port's native host library (tpulmi_torch/native.py over its copy of
layout.cpp) against the JAX package's: scatter_rows and rerank_dot equal to
the bit in every dtype case, and `_rerank_host`'s fused native branch equal
to the JAX package's to the bit.

The JAX package's library is compiled by the `ref_native` fixture from
tpulmi/native/layout.cpp, with that package's own flags, into a temporary
directory (never into tpulmi/), and loaded through its own loader."""

import subprocess

import ml_dtypes
import numpy as np
import pytest
import torch

from tpulmi_torch.hoststore import HostBF16
from tpulmi_torch.native import native_layout

torch.set_num_threads(1)


@pytest.fixture(scope="session")
def ref_native(tmp_path_factory):
    """The JAX package's `_NativeLayout`, loaded from a copy of its library
    built with its flags in a temporary directory."""
    import tpulmi.native as ref

    so = tmp_path_factory.mktemp("ref_native") / "layout_ref.so"
    base = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
            ref._SRC, "-o", str(so)]
    try:
        subprocess.run(base[:2] + ["-march=native"] + base[2:], check=True,
                       capture_output=True, timeout=120)
    except subprocess.CalledProcessError:
        subprocess.run(base, check=True, capture_output=True, timeout=120)
    lib = ref._NativeLayout()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "_so_path", lambda: str(so))
        assert lib.available()
    return lib


@pytest.fixture
def use_ref_native(monkeypatch, ref_native):
    """The JAX package's modules call the temporary library."""
    import tpulmi.native

    monkeypatch.setattr(tpulmi.native, "native_layout", ref_native)
    return ref_native


def as_ref(x: np.ndarray, dtype: str):
    """(JAX package's array, port's array) of float32 `x` in `dtype`."""
    if dtype == "bfloat16":
        ref = x.astype(ml_dtypes.bfloat16)
        return ref, HostBF16(ref.view(np.uint16))
    ref = x.astype(dtype)
    return ref, ref


def _rows(rng, n, d, scale=1.0):
    return (rng.normal(size=(n, d)) * scale).astype(np.float32)


def test_library_builds_once_and_counts():
    assert native_layout.available()
    path = native_layout.build_info.get("path")
    assert path is None or path.endswith(".so")
    before = dict(native_layout.calls)
    rng = np.random.default_rng(0)
    corpus = _rows(rng, 50, 16)
    native_layout.rerank_dot(corpus, np.zeros((2, 3), np.int64),
                             _rows(rng, 2, 16))
    assert native_layout.calls["rerank_dot"] == before["rerank_dot"] + 1
    with pytest.raises(ValueError, match="unsupported"):
        native_layout.rerank_dot(corpus.astype(np.float64),
                                 np.zeros((2, 3), np.int64),
                                 _rows(rng, 2, 16))


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("store", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("src", ["float32", "float16", "bfloat16"])
def test_scatter_rows_equals_reference(ref_native, src, store, normalized):
    rng = np.random.default_rng(1)
    n, d, rows = 700, 100, 900
    x = _rows(rng, n, d, 3.0)
    x[5] = 0.0                                   # a zero row
    ref_src, port_src = as_ref(x, src)
    order = rng.permutation(n).astype(np.int32)
    pos = np.sort(rng.choice(rows, size=n, replace=False)).astype(np.int64)

    def out():
        if store == "bfloat16":
            ref = np.zeros((rows, d), ml_dtypes.bfloat16)
            return ref, HostBF16(ref.view(np.uint16))
        ref = np.zeros((rows, d), store)
        return ref, ref

    ref_dst, _ = out()
    _, port_dst = out()
    scales = [np.zeros(rows, np.float32) if store == "int8" else None
              for _ in range(2)]
    ids = [np.full(rows, -1, np.int32) for _ in range(2)]
    ref_native.scatter_rows(ref_src, order, pos, ref_dst, scales[0], ids[0],
                            normalized=normalized, n_threads=3)
    native_layout.scatter_rows(port_src, order, pos, port_dst, scales[1],
                               ids[1], normalized=normalized, n_threads=3)
    got = port_dst.bits if store == "bfloat16" else port_dst
    np.testing.assert_array_equal(got.view(np.uint8),
                                  ref_dst.view(np.uint8))
    np.testing.assert_array_equal(ids[1], ids[0])
    if store == "int8":
        np.testing.assert_array_equal(scales[1], scales[0])
    assert np.abs(got.view(np.uint8)).sum() > 0


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_rerank_dot_equals_reference(ref_native, dtype, normalized):
    rng = np.random.default_rng(2)
    n, d, q, k = 500, 100, 13, 17
    x = _rows(rng, n, d, 1.0 if normalized else 2.5)
    if normalized:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    ref_corpus, port_corpus = as_ref(x, dtype)
    ids = rng.integers(0, n, size=(q, k)).astype(np.int64)
    ids[0, :4] = -1                              # clamped to row 0
    ids[3, 2] = -7
    queries = _rows(rng, q, d)
    want = ref_native.rerank_dot(ref_corpus, ids, queries,
                                 normalized=normalized, n_threads=2)
    got = native_layout.rerank_dot(port_corpus, ids, queries,
                                   normalized=normalized, n_threads=2)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.view(np.uint32))
    row0 = native_layout.rerank_dot(port_corpus, np.zeros((q, 1), np.int64),
                                    queries, normalized=normalized)
    np.testing.assert_array_equal(got[0, :4], np.repeat(row0[0], 4))


def _with_corpus(cls, corpus, normalized):
    li = cls.__new__(cls)
    li._host_corpus = (corpus, normalized)
    li._rerank_shadow = None
    return li


@pytest.mark.parametrize("corpus_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rerank_dtype", ["float32", "float16"])
@pytest.mark.parametrize("normalized", [True, False])
def test_rerank_host_native_equals_reference(use_ref_native, corpus_dtype,
                                             rerank_dtype, normalized):
    """The same candidates (repeated ids and -1s among them) through both
    `_rerank_host`s, each on its own library: equal to the bit, and the
    port's library was called."""
    from tpulmi.index import LearnedIndex as JaxIndex
    from tpulmi_torch import LearnedIndex

    rng = np.random.default_rng(3)
    n, d, q, k_eff, k = 3000, 64, 40, 20, 10
    x = _rows(rng, n, d)
    x = x / np.linalg.norm(x, axis=1, keepdims=True) * (
        1.0 if normalized else 3.0)
    ref_corpus, port_corpus = as_ref(x, corpus_dtype)
    queries = _rows(rng, q, d) * 2.0
    ids = rng.integers(0, n, size=(q, k_eff)).astype(np.int32)
    ids[:, 5] = ids[:, 2]                        # a repeated id in every row
    ids[3, 7:] = -1
    ids[4, :] = -1
    jli = _with_corpus(JaxIndex, ref_corpus, normalized)
    tli = _with_corpus(LearnedIndex, port_corpus, normalized)
    before = native_layout.calls["rerank_dot"]
    want_d, want_i = jli._rerank_host(None, ids.copy(), None, k,
                                      host_queries=queries,
                                      rerank_dtype=rerank_dtype)
    got_d, got_i = tli._rerank_host(None, ids.copy(), None, k,
                                    host_queries=queries,
                                    rerank_dtype=rerank_dtype)
    assert native_layout.calls["rerank_dot"] == before + 1
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d.view(np.uint32),
                                  want_d.view(np.uint32))
    assert (got_i[4] == -1).all() and (got_d[4] == 10000.0).all()
    for row in got_i:                            # no id comes back twice
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


def test_rerank_host_without_library_takes_bmm(monkeypatch):
    """With no library the port's rerank gathers and multiplies in torch,
    and stays within float rounding of the native result."""
    from tpulmi_torch import LearnedIndex

    rng = np.random.default_rng(4)
    n, d, q = 1000, 48, 16
    x = _rows(rng, n, d)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    ids = rng.integers(0, n, size=(q, 15)).astype(np.int32)
    queries = _rows(rng, q, d)
    tli = _with_corpus(LearnedIndex, x, True)
    nat_d, nat_i = tli._rerank_host(None, ids, None, 10,
                                    host_queries=queries)
    monkeypatch.setattr(type(native_layout), "available", lambda self: False)
    before = native_layout.calls["rerank_dot"]
    bmm_d, bmm_i = tli._rerank_host(None, ids, None, 10,
                                    host_queries=queries)
    assert native_layout.calls["rerank_dot"] == before
    np.testing.assert_allclose(bmm_d, nat_d, atol=1e-6)
    # ids equal except where two distances tie within rounding
    apart = (np.diff(nat_d, axis=1) > 1e-5).all(axis=1)
    assert apart.sum() > q // 2
    np.testing.assert_array_equal(bmm_i[apart], nat_i[apart])


def test_layout_source_is_the_jax_packages():
    """The port's layout.cpp is the JAX package's source byte for byte
    (rerank_fused.cpp includes it: the two libraries' shared functions
    compute the same bits)."""
    from pathlib import Path

    import tpulmi.native as ref
    from tpulmi_torch import native

    port = native.BUILD_DIR.parent / "csrc" / "layout.cpp"
    assert port in native.SOURCES
    assert port.read_bytes() == Path(ref._SRC).read_bytes()
    assert b'#include "layout.cpp"' in native.SOURCE.read_bytes()


def _fused_inputs(k_eff, d=100, n=400, q=12, seed=6):
    """Candidates that hold every case the fused pass must order as numpy
    does: ids twice and three times in a row, a row of -1s, trailing -1s,
    an id past the corpus (clamped), a zero query, and two equal corpus
    rows under different ids (an exact tie)."""
    rng = np.random.default_rng(seed)
    x = _rows(rng, n, d, 2.0)
    x[7] = x[3]                                  # a tie: ids 3 and 7
    ids = np.stack([rng.permutation(n)[:k_eff] for _ in range(q)]).astype(
        np.int32)
    ids[0, 1] = ids[0, 0]                        # twice
    ids[1, [2, 4, k_eff - 1]] = ids[1, 0]        # three times
    ids[2, :] = -1                               # nothing
    ids[3, k_eff // 2:] = -1                     # trailing empties
    ids[4, :2] = [7, 3]                          # the tie, 7 first
    ids[5, :2] = [3, 7]
    ids[6, 0] = -5                               # another empty mark
    ids[8, 1] = n + 3                            # read as the last row
    queries = _rows(rng, q, d)
    queries[4] = x[3] * 0.5                      # the tie ranks first
    queries[5] = x[3]
    queries[9] = 0.0                             # the 1e-12 clamp
    return x, ids, queries


@pytest.mark.parametrize("k_eff", [10, 14, 40], ids=lambda k: f"k_eff{k}")
@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_rerank_fused_equals_numpy_composition(dtype, normalized, k_eff):
    """`rerank_fused` against the numpy steps it replaces (dedup, divide
    by the clamped norm, `rerank_dot`, `_rerank_order`): the same ids and
    the same distance bits, on 1 and 3 threads, with int32 and int64
    ids."""
    from tpulmi_torch.index import LearnedIndex, _dedup_rows, _row_norms

    k = 10
    x, ids, queries = _fused_inputs(k_eff)
    if normalized:
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    _, corpus = as_ref(x, dtype)
    kept = _dedup_rows(ids)
    qs = np.array(queries)
    qs /= np.maximum(np.linalg.norm(qs, axis=1, keepdims=True), 1e-12)
    sims = native_layout.rerank_dot(corpus, kept, qs, normalized=normalized)
    want_d, want_i = LearnedIndex._rerank_order(1.0 - sims, kept, k)
    norms = _row_norms(queries)
    before = native_layout.calls["rerank_fused"]
    for threads in (1, 3):
        for id_type in (np.int32, np.int64):
            got_d, got_i = native_layout.rerank_fused(
                corpus, ids.astype(id_type), queries, norms, k,
                normalized=normalized, n_threads=threads)
            assert got_i.dtype == id_type and got_d.dtype == np.float32
            np.testing.assert_array_equal(got_i, want_i)
            np.testing.assert_array_equal(got_d.view(np.uint32),
                                          want_d.view(np.uint32))
    assert native_layout.calls["rerank_fused"] == before + 4
    assert (got_i[2] == -1).all() and (got_d[2] == 10000.0).all()
    assert list(got_i[4, :2]) == [7, 3] and list(got_i[5, :2]) == [3, 7]
    assert got_d[4, 0] == got_d[4, 1]
    assert (got_i[3] >= 0).sum() == min(k, k_eff // 2)
    for row in got_i:                            # no id comes back twice
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


def test_rerank_fused_orders_nan_last():
    """A NaN distance sorts after every number, ties in candidate order,
    as numpy's stable argsort puts it; a k above the candidates keeps
    them all."""
    from tpulmi_torch.index import LearnedIndex, _row_norms

    rng = np.random.default_rng(7)
    x = _rows(rng, 50, 24)
    x[4] = np.nan
    ids = np.array([[4, 1, 2, -1, 3, 4], [5, 4, 6, 7, 8, 9]], np.int64)
    queries = _rows(rng, 2, 24)
    qs = queries / _row_norms(queries)
    sims = native_layout.rerank_dot(x, ids, qs, normalized=False)
    kept = ids.copy()
    kept[0, 5] = -1                              # the repeat of id 4
    want_d, want_i = LearnedIndex._rerank_order(1.0 - sims, kept, 8)
    got_d, got_i = native_layout.rerank_fused(
        x, ids, queries, _row_norms(queries), 8, normalized=False)
    assert got_d.shape == (2, 6)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d.view(np.uint32),
                                  want_d.view(np.uint32))
    assert got_i[1, -1] == 4 and np.isnan(got_d[1, -1])


@pytest.mark.parametrize("q", [1, 511, 1300])
def test_row_norms_equal_whole_array_norms(q):
    """The rerank's query norms, slice by slice from the caller's array,
    equal numpy's norms of a whole copy to the bit."""
    from tpulmi_torch.index import _row_norms

    x = _rows(np.random.default_rng(q), q, 768, 0.3)
    x[0] = 0.0
    want = np.maximum(np.linalg.norm(np.array(x, np.float32), axis=1,
                                     keepdims=True), 1e-12)
    got = _row_norms(x)
    assert got.shape == (q, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_rerank_fused_checks_its_inputs():
    rng = np.random.default_rng(8)
    x, queries = _rows(rng, 20, 8), _rows(rng, 3, 8)
    norms = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="int32 or int64"):
        native_layout.rerank_fused(x, np.zeros((3, 4), np.float32), queries,
                                   norms, 2)
    with pytest.raises(ValueError, match="norms"):
        native_layout.rerank_fused(x, np.zeros((3, 4), np.int32), queries,
                                   norms[:2], 2)
    with pytest.raises(ValueError, match="unsupported"):
        native_layout.rerank_fused(x.astype(np.int8),
                                   np.zeros((3, 4), np.int32), queries,
                                   norms, 2)
