"""tpulmi_torch.search.probe_search against tpulmi.search.probe_search:
the same signature and (dists, ids) return with 0-based ids and -1 for
empty places, the tail-bucket case of tests/test_guards.py (no duplicate
ids, equal to the exact search), random stores at several padding classes,
and queries whose probed buckets hold fewer than k rows."""

import inspect

import numpy as np
import pytest
import torch

from tpulmi.buckets import build_bucket_store as jax_build_store
from tpulmi.ops.distance import exact_knn as jax_exact_knn
from tpulmi.search import probe_search as jax_probe_search
from tpulmi_torch.buckets import build_bucket_store
from tpulmi_torch.search import probe_search

torch.set_num_threads(1)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _stores(labels, data, c, **kw):
    return (jax_build_store(labels, data, c, **kw),
            build_bucket_store(torch.from_numpy(labels),
                               torch.from_numpy(data), c, **kw))


def _both(probes, queries, jstore, tstore, **kw):
    jd, ji = jax_probe_search(probes, queries, jstore, **kw)
    td, ti = probe_search(probes, queries, tstore, **kw)
    assert isinstance(td, torch.Tensor) and td.dtype == torch.float32
    assert ti.dtype == torch.int32
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


def test_signature_is_jax():
    want = inspect.signature(jax_probe_search).parameters
    got = inspect.signature(probe_search).parameters
    assert list(got) == list(want)
    assert all(got[n].default == want[n].default for n in want
               if n != "store")


def test_tail_bucket_no_duplicates():
    """A 3000-row bucket at the store's tail after a 100-row one, both
    probed: the exact answer, every id once (tests/test_guards.py)."""
    rng = np.random.default_rng(0)
    data = _unit(rng, 3100, 32)
    labels = np.concatenate([np.zeros(100, np.int32), np.ones(3000, np.int32)])
    jstore, tstore = _stores(labels, data, 2, pad_rows=0)
    queries = data[:8]
    probes = np.zeros((8, 2), np.int32)
    probes[:, 1] = 1
    (jd, ji), (td, ti) = _both(probes, queries, jstore, tstore, k=10,
                               data_chunk=2048)
    for row in ti:
        assert len(set(row.tolist())) == 10
    want_d, want_i = jax_exact_knn(queries, data, k=10, normalized=True)
    np.testing.assert_array_equal(ti, np.asarray(want_i))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, atol=1e-6)


@pytest.mark.parametrize("data_chunk,qpb_pad,query_chunk,dtype", [
    (2048, None, 512, None), (128, None, 512, None), (256, 64, 32, None),
    (64, 256, 128, None), (512, None, 16, "bfloat16")])
def test_random_store(data_chunk, qpb_pad, query_chunk, dtype):
    rng = np.random.default_rng(1)
    n, d, c, q, p = 2500, 48, 9, 60, 3
    data = _unit(rng, n, d)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    jstore, tstore = _stores(labels, data, c, row_align=64)
    queries = _unit(rng, q, d)
    probes = np.stack([rng.permutation(c)[:p] for _ in range(q)]).astype(
        np.int32)
    kw = dict(k=10, data_chunk=data_chunk, qpb_pad=qpb_pad,
              query_chunk=query_chunk)
    if dtype is None:
        (jd, ji), (td, ti) = _both(probes, queries, jstore, tstore, **kw)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, atol=1e-6)
        return
    import jax.numpy as jnp

    jd, ji = jax_probe_search(probes, queries, jstore,
                              compute_dtype=jnp.bfloat16, **kw)
    td, ti = probe_search(probes, torch.from_numpy(queries), tstore,
                          compute_dtype=torch.bfloat16, **kw)
    jd, ji, td, ti = (np.asarray(jd), np.asarray(ji), td.numpy(),
                      ti.numpy())
    np.testing.assert_allclose(td, jd, atol=1e-3)
    # ids equal but for ties at bfloat16 precision
    rounded = torch.from_numpy(data).bfloat16().float().numpy()
    bq = torch.from_numpy(queries).bfloat16().float().numpy()
    for r in np.where((ti != ji).any(axis=1))[0]:
        only = np.setxor1d(ti[r], ji[r])
        exact = 1.0 - rounded[only] @ bq[r]
        assert np.all(np.abs(exact - td[r, -1]) <= 1e-3)


def test_fewer_rows_than_k_gives_minus_one():
    """Probed buckets holding 3 + 2 rows at k=8: five real ids, then -1 at
    the sentinel distance, as JAX gives them; the same for a bucket probed
    at two ranks."""
    rng = np.random.default_rng(2)
    data = _unit(rng, 300, 16)
    labels = np.full(300, 2, np.int32)
    labels[:3] = 0
    labels[3:5] = 1
    jstore, tstore = _stores(labels, data, 3, row_align=16)
    probes = np.array([[0, 1], [1, 0], [0, 0], [2, 1]], np.int32)
    (jd, ji), (td, ti) = _both(probes, data[:4], jstore, tstore, k=8)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, atol=1e-6)
    assert (ti[0, 5:] == -1).all() and (ti[0, :5] >= 0).all()
    # a bucket probed twice gives its rows twice, as in JAX
    assert sorted(ti[2, :6].tolist()) == [0, 0, 1, 1, 2, 2]
    assert (ti[2, 6:] == -1).all()
    assert (td[0, 5:] == 10_000.0).all()
