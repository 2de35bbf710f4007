"""tpulmi_torch.baseline against tpulmi.baseline: `Baseline` (1-based ids,
distances within 1e-6), `exact_knn_streamed` over float32 arrays, memory
maps and bfloat16 host corpora with a ragged last block (ids equal but for
ties; distances within 1e-6 in float32, 1e-3 in bfloat16), its resume after
an injected failure, and each package resuming the other's checkpoint."""

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpulmi.baseline as jbase
import tpulmi_torch.baseline as tbase
from tpulmi_torch.hoststore import HostBF16

torch.set_num_threads(1)

N, D, Q, K, CHUNK = 3000, 64, 40, 10, 512      # 6 blocks, the last of 440
_PORT_MERGE, _JAX_MERGE = tbase._merge_block, jbase._merge_chunk


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    return _unit(rng, N, D), _unit(rng, Q, D)


def _equal_but_ties(ids_a, d_a, ids_b, d_b, queries, data, tol):
    """Distances within `tol` place by place; an id that only one list
    holds lies within `tol` of the row's kth distance."""
    np.testing.assert_allclose(d_a, d_b, atol=tol)
    for r in np.where((ids_a != ids_b).any(axis=1))[0]:
        only = np.setxor1d(ids_a[r], ids_b[r])
        exact = 1.0 - data[only] @ queries[r]
        assert np.all(np.abs(exact - d_a[r, -1]) <= tol), (r, only)


def test_baseline_matches_jax_and_is_one_based(corpus):
    data, queries = corpus
    jb, tb = jbase.Baseline(), tbase.Baseline(device="cpu")
    assert tb.build(data) >= 0 and jb.build(data) >= 0
    jd, ji, _ = jb.search(queries, k=5)
    td, ti, secs = tb.search(queries, k=5)
    assert secs >= 0 and ti.dtype == np.int64
    assert ti.min() >= 1 and ti.max() <= N
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, atol=1e-6)
    # data given at the call, not built
    td2, ti2, _ = tbase.Baseline(device="cpu").search(queries, data, k=5)
    np.testing.assert_array_equal(ti2, ti)
    with pytest.raises(ValueError, match="No data"):
        tbase.Baseline(device="cpu").search(queries)


@pytest.mark.parametrize("dtype,host", [
    ("float32", "array"), ("float32", "memmap"), ("float32", "bf16"),
    ("bfloat16", "array"), ("bfloat16", "memmap"), ("bfloat16", "bf16")])
def test_streamed_matches_jax(corpus, tmp_path, dtype, host):
    data, queries = corpus
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    if host == "bf16":
        bf = data.astype(ml_dtypes.bfloat16)
        j_host, t_host = bf, HostBF16(bf.view(np.uint16))
        ref = bf.astype(np.float32)
    else:
        j_host = t_host = ref = data
        if host == "memmap":
            path = tmp_path / "corpus.npy"
            np.save(path, data)
            j_host = t_host = np.load(path, mmap_mode="r")
    jd, ji = jbase.exact_knn_streamed(queries, j_host, k=K, chunk=CHUNK,
                                      compute_dtype=jdt)
    td, ti = tbase.exact_knn_streamed(queries, t_host, k=K, chunk=CHUNK,
                                      compute_dtype=tdt, device="cpu")
    assert td.dtype == np.float32 and ti.dtype == np.int32
    assert td.shape == ti.shape == (Q, K)
    assert (np.diff(td, axis=1) >= 0).all()
    if dtype == "bfloat16":
        bq = torch.from_numpy(queries).bfloat16().float().numpy()
        ref = torch.from_numpy(ref).bfloat16().float().numpy()
    else:
        bq = queries
    _equal_but_ties(ti, td, np.asarray(ji), np.asarray(jd), bq, ref,
                    1e-6 if dtype == "float32" else 1e-3)


def test_streamed_ties_go_to_the_lower_id(corpus):
    """Rows repeated across blocks and inside one: equal distances keep
    the lower id, as the JAX package's running `lax.top_k` does."""
    data, queries = corpus
    # triples inside a block (a tie across the kth place at k=10) and
    # copies across blocks
    dup = np.concatenate([np.repeat(data[:300], 3, axis=0), data[:500]])
    jd, ji = jbase.exact_knn_streamed(queries[:8], dup, k=K, chunk=256,
                                      compute_dtype=jnp.float32)
    td, ti = tbase.exact_knn_streamed(queries[:8], dup, k=K, chunk=256,
                                      compute_dtype=torch.float32,
                                      device="cpu")
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), atol=1e-6)
    # a tiny corpus: the padding's ids and the sentinel, as JAX gives them
    jd, ji = jbase.exact_knn_streamed(queries[:3], data[:4], k=6, chunk=8,
                                      compute_dtype=jnp.float32)
    td, ti = tbase.exact_knn_streamed(queries[:3], data[:4], k=6, chunk=8,
                                      compute_dtype=torch.float32,
                                      device="cpu")
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), atol=1e-6)


def test_unnormalized_queries(corpus):
    data, queries = corpus
    jd, ji = jbase.exact_knn_streamed(queries * 3.0, data, k=K, chunk=CHUNK,
                                      compute_dtype=jnp.float32,
                                      normalized=False)
    td, ti = tbase.exact_knn_streamed(queries * 3.0, data, k=K, chunk=CHUNK,
                                      compute_dtype=torch.float32,
                                      normalized=False, device="cpu")
    _equal_but_ties(ti, td, np.asarray(ji), np.asarray(jd), queries, data,
                    1e-6)


def _crash_port(monkeypatch, after):
    """Make the port's block merge raise after `after` blocks; returns the
    list of block starts merged."""
    merged = []
    orig = _PORT_MERGE

    def crashy(best_d, best_i, q, block, base, valid, k):
        if after is not None and len(merged) == after:
            raise RuntimeError("injected failure")
        merged.append(int(base))
        return orig(best_d, best_i, q, block, base, valid, k)

    monkeypatch.setattr(tbase, "_merge_block", crashy)
    return merged


def _crash_jax(monkeypatch, after):
    merged = []
    orig = _JAX_MERGE

    def crashy(best_d, best_i, q, block, base, valid, *, k):
        if after is not None and len(merged) == after:
            raise RuntimeError("injected failure")
        merged.append(int(base))
        return orig(best_d, best_i, q, block, base, valid, k=k)

    monkeypatch.setattr(jbase, "_merge_chunk", crashy)
    return merged


def _port(queries, data, **kw):
    return tbase.exact_knn_streamed(queries, data, k=5, chunk=256,
                                    compute_dtype=torch.float32,
                                    device="cpu", **kw)


def _jax(queries, data, **kw):
    return jbase.exact_knn_streamed(queries, data, k=5, chunk=256,
                                    compute_dtype=jnp.float32, **kw)


def test_streamed_resume_after_failure(corpus, tmp_path, monkeypatch):
    """Crashed after 5 of 8 blocks with a checkpoint every 2: the rerun
    resumes at row 4 x 256 and ends equal to an uninterrupted run to the
    bit; a checkpoint of other queries is ignored."""
    data, queries = corpus[0][:2048], corpus[1][:16]
    part = str(tmp_path / "gt.part")
    d_ref, i_ref = _port(queries, data)
    merged = _crash_port(monkeypatch, 5)
    with pytest.raises(RuntimeError, match="injected"):
        _port(queries, data, resume_path=part, checkpoint_every=2)
    assert merged == [0, 256, 512, 768, 1024] and os.path.exists(part)
    assert not os.path.exists(part + ".tmp.npz")
    with np.load(part) as z:
        assert set(z.files) == {"best_d", "best_i", "lo", "n", "k", "chunk",
                                "q_sum"}
        assert int(z["lo"]) == 4 * 256
    merged = _crash_port(monkeypatch, None)
    d_r, i_r = _port(queries, data, resume_path=part, checkpoint_every=2)
    assert merged[0] == 4 * 256
    np.testing.assert_array_equal(d_r, d_ref)
    np.testing.assert_array_equal(i_r, i_ref)

    # other queries: the checkpoint is stale and the scan starts at 0
    merged = _crash_port(monkeypatch, None)
    q2 = np.roll(queries, 1, axis=0) * 0.5
    d2, i2 = _port(q2, data, resume_path=part, checkpoint_every=2)
    assert merged[0] == 0
    d2_ref, i2_ref = _port(q2, data)
    np.testing.assert_array_equal(d2, d2_ref)
    np.testing.assert_array_equal(i2, i2_ref)
    # a torn file is ignored too
    with open(part, "wb") as f:
        f.write(b"PK\x03\x04torn")
    merged = _crash_port(monkeypatch, None)
    _port(queries, data, resume_path=part, checkpoint_every=2)
    assert merged[0] == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_resume(corpus, tmp_path, monkeypatch, writer):
    """A checkpoint written by one package after an injected failure is
    resumed by the other at row 4 x 256, and the result is the
    uninterrupted one's (ids equal, distances within 1e-6)."""
    data, queries = corpus[0][:2048], corpus[1][:16]
    part = str(tmp_path / "gt.part")
    d_ref, i_ref = _port(queries, data)
    jd_ref, ji_ref = _jax(queries, data)
    np.testing.assert_array_equal(i_ref, np.asarray(ji_ref))
    crash, run = (_crash_jax, _jax) if writer == "jax" else (_crash_port,
                                                               _port)
    resume, resume_run = ((_crash_port, _port) if writer == "jax"
                          else (_crash_jax, _jax))
    crash(monkeypatch, 5)
    with pytest.raises(RuntimeError, match="injected"):
        run(queries, data, resume_path=part, checkpoint_every=2)
    merged = resume(monkeypatch, None)
    d, i = resume_run(queries, data, resume_path=part, checkpoint_every=2)
    assert merged[0] == 4 * 256
    np.testing.assert_array_equal(np.asarray(i), i_ref)
    np.testing.assert_allclose(np.asarray(d), d_ref, atol=1e-6)


@pytest.mark.parametrize("host", ["memmap", "bf16-memmap", "array"])
def test_streamed_releases_each_blocks_pages(corpus, tmp_path, monkeypatch,
                                             host):
    """Over a memory map the pass drops the pages of every block once it is
    in the pinned buffer (`hoststore.release_pages`, counted by a spy); the
    result equals a pass that releases nothing, to the bit. An array in RAM
    is never released."""
    from tpulmi_torch import hoststore

    data, queries = corpus
    if host == "array":
        t_host = data
    else:
        bits = (data.astype(ml_dtypes.bfloat16).view(np.uint16)
                if host == "bf16-memmap" else data)
        np.save(tmp_path / "corpus.npy", bits)
        t_host = np.load(tmp_path / "corpus.npy", mmap_mode="r")
        if host == "bf16-memmap":
            t_host = HostBF16(t_host)
    real, calls = hoststore.release_pages, []

    def spy(arr):
        calls.append(arr)
        real(arr)

    monkeypatch.setattr(hoststore, "release_pages", spy)
    got = tbase.exact_knn_streamed(queries, t_host, k=K, chunk=CHUNK,
                                   compute_dtype=torch.float32, device="cpu")
    blocks = -(-N // CHUNK)
    assert len(calls) == (0 if host == "array" else blocks)
    assert all(a is t_host for a in calls)
    monkeypatch.setattr(hoststore, "release_pages", lambda arr: None)
    kept = tbase.exact_knn_streamed(queries, t_host, k=K, chunk=CHUNK,
                                    compute_dtype=torch.float32,
                                    device="cpu")
    for a, b in zip(got, kept):
        np.testing.assert_array_equal(a, b)
