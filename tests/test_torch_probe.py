"""The probe of tpulmi_torch (slot grouping, the plain version of the CUDA
kernel, the merge) against the JAX package's Pallas kernel in interpret
mode, on the same store and probes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulmi.buckets import build_bucket_store
from tpulmi.ops.pallas_topk import pallas_probe_search
from tpulmi_torch.convert import store_from_arrays
from tpulmi_torch.ops.probe_topk import (BLOCK_SLOTS, group_slots,
                                         launch_counts, probe_search,
                                         probe_topk, probe_topk_plain)

torch.set_num_threads(1)

MC = 256  # the Pallas kernel's data block; the store's row_align


def _setup(rng, n=4000, d=128, c=13, q=64, labels=None, data=None):
    if data is None:
        data = rng.normal(size=(n, d)).astype(np.float32)
        data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    if labels is None:
        labels = rng.integers(0, c, size=n).astype(np.int32)
    js = build_bucket_store(labels, data, c, pad_rows=MC, row_align=MC)
    ts = store_from_arrays(np.asarray(js.data_sorted),
                           np.asarray(js.ids_sorted), np.asarray(js.offsets),
                           np.asarray(js.counts), js.n, js.pad_rows,
                           js.row_align, device="cpu")
    return data, queries, labels, js, ts


def _both(js, ts, probes, queries, mode, jdtype, tdtype, k=10):
    max_bucket = int(np.asarray(js.counts).max())
    jd_, ji, jm = pallas_probe_search(
        jnp.asarray(probes), jnp.asarray(queries), js, k=k, qc=128, mc=MC,
        max_chunks=max(-(-max_bucket // MC), 1), compute_dtype=jdtype,
        extract_mode=mode, interpret=True)
    td, ti, tm = probe_search(torch.from_numpy(probes),
                              torch.from_numpy(queries), ts, k=k,
                              compute_dtype=tdtype)
    assert int(tm) == int(jm)
    return (np.asarray(jd_), np.asarray(ji)), (td.numpy(), ti.numpy())


def _apart(d, tol):
    """Places whose distance differs from both neighbours by more than
    tol (ties may come back in either order)."""
    gap = np.full(d.shape, np.inf)
    step = np.diff(d, axis=1)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    return gap > tol


@pytest.mark.parametrize("n_probes", [1, 3])
@pytest.mark.parametrize("mode", ["scalar", "group", "group2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(rng, n_probes, mode, dtype):
    _, queries, _, js, ts = _setup(rng)
    c = ts.n_categories
    probes = np.stack([rng.permutation(c)[:n_probes]
                       for _ in range(queries.shape[0])]).astype(np.int32)
    (jd_, ji), (td, ti) = _both(js, ts, probes, queries, mode,
                                getattr(jnp, dtype), getattr(torch, dtype))
    np.testing.assert_allclose(td, jd_, atol=1e-5)
    if dtype == "float32":
        assert (ti == ji).mean() >= 0.99
    apart = _apart(jd_, 1e-5)
    np.testing.assert_array_equal(ti[apart], ji[apart])


@pytest.mark.parametrize("mode", ["scalar", "group", "group2"])
def test_plain_probe_all_equals_exact(rng, mode):
    from tpulmi_torch.ops.distance import exact_knn

    data, queries, _, js, ts = _setup(rng, n=2000, c=7, q=32)
    probes = np.tile(np.arange(7, dtype=np.int32), (32, 1))
    td, ti, _ = probe_search(torch.from_numpy(probes),
                             torch.from_numpy(queries), ts, k=10,
                             compute_dtype=torch.float32)
    want_d, _ = exact_knn(torch.from_numpy(queries), torch.from_numpy(data),
                          k=10, normalized=True)
    np.testing.assert_allclose(td.numpy(), want_d.numpy(), atol=1e-5)
    chosen = 1.0 - np.einsum("qkd,qd->qk", data[ti.numpy()], queries)
    np.testing.assert_allclose(chosen, want_d.numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", ["scalar", "group", "group2"])
def test_subk_sentinels_match_pallas(rng, mode):
    # tiny buckets: fewer than k rows probed -> distance 10000, id -1
    _, queries, labels, js, ts = _setup(rng, n=40, c=10, q=8)
    probes = rng.integers(0, 10, size=(8, 1)).astype(np.int32)
    (jd_, ji), (td, ti) = _both(js, ts, probes, queries, mode, jnp.float32,
                                torch.float32)
    for i in range(8):
        cnt = int((labels == probes[i, 0]).sum())
        assert (ti[i, cnt:] == -1).all() and (td[i, cnt:] == 10000.0).all()
    np.testing.assert_array_equal(ti == -1, ji == -1)
    np.testing.assert_allclose(td, jd_, atol=1e-5)


def test_dump_ids_match_pallas(rng):
    """Dropped probes carry the dump id (== n_categories) and contribute
    nothing; a query whose every probe is dumped gets all sentinels."""
    _, queries, _, js, ts = _setup(rng)
    c = ts.n_categories
    probes = np.stack([rng.permutation(c)[:4]
                       for _ in range(queries.shape[0])]).astype(np.int32)
    drop = rng.random(probes.shape) < 0.5
    drop[:, 0] = False
    drop[0, :] = True
    probes = np.where(drop, c, probes).astype(np.int32)
    (jd_, ji), (td, ti) = _both(js, ts, probes, queries, "group",
                                jnp.float32, torch.float32)
    np.testing.assert_allclose(td, jd_, atol=1e-5)
    assert (ti == ji).mean() >= 0.99
    assert (ti[0] == -1).all() and (td[0] == 10000.0).all()


def test_group_collisions_exact(rng):
    """Every true neighbour of a query in one 128-row column class of one
    chunk (the case that forces the TPU kernel's collision fallback)."""
    n, d = 2048, 128
    data = rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = rng.normal(size=(4, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    for qi in range(4):
        for r in range(10):
            row = qi * 8 + r * 128
            v = queries[qi] + (0.01 + 0.002 * r) * data[row]
            data[row] = v / np.linalg.norm(v)
    _, _, _, _, ts = _setup(rng, c=1, labels=np.zeros(n, np.int32),
                            data=data)
    td, ti, _ = probe_search(torch.zeros((4, 1), dtype=torch.int32),
                             torch.from_numpy(queries), ts, k=10,
                             compute_dtype=torch.float32)
    for qi in range(4):
        np.testing.assert_array_equal(ti[qi].numpy(),
                                      qi * 8 + 128 * np.arange(10))


def test_group_slots_layout(rng):
    """Blocks of one bucket each, live slots first, dumps discarded."""
    offsets = torch.tensor([0, 100, 100, 300], dtype=torch.int32)
    counts = torch.tensor([90, 0, 150], dtype=torch.int32)
    probes = torch.tensor([[2, 0], [2, 3], [1, 2]] * 30, dtype=torch.int32)
    lay = group_slots(probes, offsets, counts)
    q, p = probes.shape
    assert lay.slot_counts.tolist() == [30, 30, 90]
    assert lay.qidx.shape[0] == lay.blocks.shape[0] * BLOCK_SLOTS
    live = lay.slot_of_row < q * p
    assert int(live.sum()) == 150      # 30 of 180 slots dumped
    for j, (start, cnt, qlim) in enumerate(lay.blocks.tolist()):
        rows = lay.slot_of_row[j * BLOCK_SLOTS:(j + 1) * BLOCK_SLOTS]
        n_live = int((rows < q * p).sum())
        assert n_live == max(0, min(qlim, BLOCK_SLOTS))
        buckets = probes.reshape(-1)[rows[rows < q * p]]
        assert (buckets == buckets[:1]).all() if n_live else True
        if n_live:
            b = int(buckets[0])
            assert (start, cnt) == (int(offsets[b]), int(counts[b]))
    np.testing.assert_array_equal(
        lay.qidx[live].numpy(), (lay.slot_of_row[live] // p).numpy())


def test_wrapper_takes_plain_version_on_cpu(rng):
    _, queries, _, js, ts = _setup(rng)
    probes = torch.from_numpy(rng.integers(0, 13, (64, 2)).astype(np.int32))
    lay = group_slots(probes, ts.offsets, ts.counts)
    q = torch.from_numpy(queries).bfloat16()
    data = ts.data_as(torch.bfloat16)
    before = launch_counts()["probe_topk"]
    a = probe_topk(q, lay.qidx, data, lay.blocks, 10)
    b = probe_topk_plain(q, lay.qidx, data, lay.blocks, 10)
    # nothing launched on the CPU
    assert launch_counts()["probe_topk"] == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        probe_topk(q, lay.qidx, data, lay.blocks, 129)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    _, queries, _, js, ts = _setup(rng, n=20000, d=256, c=13, q=500)
    dev = torch.device("cuda")
    probes = torch.from_numpy(rng.integers(0, 13, (500, 3)).astype(
        np.int32)).to(dev)
    offsets, counts = ts.offsets.to(dev), ts.counts.to(dev)
    lay = group_slots(probes, offsets, counts)
    for dtype, k in ((torch.bfloat16, 1), (torch.bfloat16, 10),
                     (torch.bfloat16, 100), (torch.float16, 10),
                     (torch.float32, 10)):
        q = torch.from_numpy(queries).to(dev, dtype)
        data = ts.data_sorted.to(dev, dtype)
        kd, ki = probe_topk(q, lay.qidx, data, lay.blocks, k)
        pd, pi = probe_topk_plain(q, lay.qidx, data, lay.blocks, k)
        torch.cuda.synchronize()
        live = lay.slot_of_row < probes.numel()
        torch.testing.assert_close(kd[live], pd[live], atol=1e-4, rtol=0)
        apart = torch.from_numpy(_apart(pd[live].cpu().numpy(), 1e-4))
        apart[:, -1] = False
        assert torch.equal(ki[live].cpu()[apart], pi[live].cpu()[apart])
