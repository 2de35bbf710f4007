"""The flat worklist of tpulmi_torch (item list, plain version of the item
and merge kernels, the facade's sizing and overflow re-run) against the JAX
package's Pallas kernel on its worklist grid in interpret mode.

The JAX side runs with qc=64, the port's block size, so that both count the
same work items. The kernels themselves are held against these plain
versions on a card by tests/test_torch_kernels_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulmi.buckets import build_bucket_store
from tpulmi.ops.pallas_topk import pallas_probe_search
from tpulmi.ops.quantize import quantize_store
from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
from tpulmi_torch.convert import store_from_arrays
from tpulmi_torch.ops import probe_topk as probe
from tpulmi_torch.ops.probe_topk import (BLOCK_SLOTS, build_worklist,
                                         group_slots, probe_search,
                                         probe_topk, probe_topk_plain)

torch.set_num_threads(1)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _setup(rng, mc, quantized=False, n=4000, d=128, c=13, q=64):
    data, queries = _unit(rng, n, d), _unit(rng, q, d)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    labels[labels == 5] = 6                       # bucket 5 is empty
    js = build_bucket_store(labels, data, c, pad_rows=mc, row_align=mc)
    kw = {}
    if quantized:
        js = quantize_store(js)
        kw = dict(scales=np.asarray(js.scales), quant_bits=8)
    ts = store_from_arrays(np.asarray(js.data_sorted),
                           np.asarray(js.ids_sorted), np.asarray(js.offsets),
                           np.asarray(js.counts), js.n, js.pad_rows,
                           js.row_align, device="cpu", **kw)
    return queries, js, ts


def _skewed_probes(rng, c, q):
    """Everyone probes bucket 0, then random others of which ~40% are
    dumped; the empty bucket 5 is probed by the first eight queries."""
    probes = np.stack([rng.permutation(c)[:4] for _ in range(q)]).astype(
        np.int32)
    probes[:, 0] = 0
    drop = rng.random(probes.shape) < 0.4
    drop[:, 0] = False
    probes = np.where(drop, c, probes).astype(np.int32)
    probes[:8, 1] = 5
    return probes


def _closed_form(probes, counts, c, span):
    slots = np.bincount(probes.reshape(-1)[probes.reshape(-1) < c],
                        minlength=c)
    steps = np.maximum(-(-np.asarray(counts) // span), 1)
    return int(np.sum(-(-slots // BLOCK_SLOTS) * steps * (slots > 0)))


def _same(got, want):
    """Two plain runs that cut the rows differently: the same ids, and
    distances to 1e-6 (the CPU matmul's summing order depends on the
    operands' shapes; the CUDA kernels agree to the bit, which
    tests/test_torch_kernels_card.py holds them to)."""
    (gd, gi), (wd, wi) = got, want
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gd, wd, atol=1e-6, rtol=0)


def _apart(d, tol):
    gap = np.full(d.shape, np.inf)
    step = np.diff(d, axis=1)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    return gap > tol


@pytest.mark.parametrize("int8q", [False, True], ids=["f32", "int8q"])
def test_plain_worklist_matches_pallas(rng, int8q):
    """float32: sums taken in another order, 1e-5. int8 queries: exact
    integer dots, but raw scores of hundreds before the query's scale
    brings them back, so one rounding there is 1e-4 / 127 afterwards:
    1e-4."""
    mc = 1024 if int8q else 256       # the Pallas int8 path needs mc % 1024
    tol = 1e-4 if int8q else 1e-5
    queries, js, ts = _setup(rng, mc, quantized=int8q)
    c = ts.n_categories
    probes = _skewed_probes(rng, c, queries.shape[0])
    want = _closed_form(probes, js.counts, c, mc)
    max_bucket = int(np.asarray(js.counts).max())
    jd_, ji, jm, jtotal = pallas_probe_search(
        jnp.asarray(probes), jnp.asarray(queries), js, k=10, qc=BLOCK_SLOTS,
        mc=mc, max_chunks=-(-max_bucket // mc), compute_dtype=jnp.float32,
        int8_queries=int8q, extract_mode="group", interpret=True,
        wl_pad=4096)
    kw = dict(k=10, compute_dtype=torch.float32, int8_queries=int8q,
              backend="torch")
    tp, tq = torch.from_numpy(probes), torch.from_numpy(queries)
    td, ti, tm, total = probe_search(tp, tq, ts, wl_pad=4096, item_rows=mc,
                                     **kw)
    assert int(total) == want == int(jtotal)
    assert int(tm) == int(jm)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd_), atol=tol)
    apart = _apart(np.asarray(jd_), tol)
    np.testing.assert_array_equal(ti.numpy()[apart], np.asarray(ji)[apart])

    # the worklist changes no result: equal to the dense plain version
    dd, di, _ = probe_search(tp, tq, ts, **kw)
    _same((td, ti), (dd, di))
    # a pad equal to the total suffices
    d3, i3, _, t3 = probe_search(tp, tq, ts, wl_pad=want, item_rows=mc, **kw)
    assert int(t3) == want
    _same((d3, i3), (dd, di))
    # an undersized pad still reports the true total (results invalid)
    *_, t4 = probe_search(tp, tq, ts, wl_pad=max(want // 2, 1), item_rows=mc,
                          **kw)
    assert int(t4) == want


def test_all_dumped_queries_come_back_sentinel(rng):
    queries, js, ts = _setup(rng, 256)
    c = ts.n_categories
    probes = _skewed_probes(rng, c, queries.shape[0])
    probes[:8, :] = c
    td, ti, _, _ = probe_search(
        torch.from_numpy(probes), torch.from_numpy(queries), ts, k=10,
        compute_dtype=torch.float32, backend="torch", wl_pad=4096,
        item_rows=256)
    assert (ti[:8] == -1).all() and (td[:8] == 10000.0).all()
    assert (ti[8:, 0] >= 0).all()


def test_build_worklist_items():
    """Block-major items; an empty probed bucket keeps one, a block without
    live slots none; the total is true also when the pad is short."""
    # (first row, rows, live slots): 3 chunks, empty bucket, dead, 1 chunk
    blocks = torch.tensor([[0, 600, 64], [0, 600, 7], [1024, 0, 3],
                           [2048, 300, 0], [2048, 300, -64], [4096, 256, 64]],
                          dtype=torch.int32)
    items, block_items, total = build_worklist(blocks, 12, 256)
    assert int(total) == 3 + 3 + 1 + 0 + 0 + 1
    assert items[:8].tolist() == [[0, 0], [0, 1], [0, 2], [1, 0], [1, 1],
                                  [1, 2], [2, 0], [5, 0]]
    assert (items[8:, 0] == -1).all()
    assert block_items.tolist() == [[0, 3], [3, 3], [6, 1], [7, 0], [7, 0],
                                    [7, 1]]
    # twice the span (the 128-row tile): ceil(3 / 2) = 2 chunks
    _, _, total2 = build_worklist(blocks, 12, 512)
    assert int(total2) == 2 + 2 + 1 + 1
    short, _, total3 = build_worklist(blocks, 4, 256)
    assert int(total3) == 8 and short.tolist() == [[0, 0], [0, 1], [0, 2],
                                                   [1, 0]]


def test_worklist_options_are_checked(rng):
    queries, js, ts = _setup(rng, 256, n=600, c=3, q=8)
    probes = torch.zeros((8, 1), dtype=torch.int32)
    lay = group_slots(probes, ts.offsets, ts.counts)
    args = (torch.from_numpy(queries), lay.qidx, ts.data_sorted, lay.blocks)
    with pytest.raises(ValueError, match="multiple of 128"):
        probe_topk_plain(*args, 10, wl_pad=64, item_rows=100)
    with pytest.raises(ValueError, match="k_out"):
        probe_topk_plain(*args, 10, k_out=5)
    # on the CPU the wrapper takes the plain version, worklist included
    before = probe.launch_counts()
    a = probe_topk(*args, 10, wl_pad=64, item_rows=128)
    b = probe_topk_plain(*args, 10, wl_pad=64, item_rows=128)
    assert probe.launch_counts() == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="CUDA tensors"):
        probe._launch("probe_topk", args, 128, 10, 10, (2,))


def _small_index(rng):
    n, d_nav, d = 2000, 32, 128
    nav = rng.normal(size=(n, d_nav)).astype(np.float32)
    data = _unit(rng, n, d)
    li = LearnedIndex(IndexConfig(n_categories=8, epochs=2, lr=0.003,
                                  batch_size=256, row_align=256),
                      device="cpu")
    li.build(nav, data)
    return li, nav[:40], data[:40]


def test_index_worklist_end_to_end(rng):
    """SearchConfig.pallas_worklist through the facade: the dense search's
    results, the pad cached, a poisoned pad healed by the re-run."""
    li, qn, qs = _small_index(rng)
    base = SearchConfig(k=5, compute_dtype="float32")
    wl = SearchConfig(k=5, compute_dtype="float32", pallas_mc=256,
                      pallas_worklist=True)
    d0, i0 = li.search(qn, qs, n_buckets=3, k=5, search_config=base)
    d1, i1 = li.search(qn, qs, n_buckets=3, k=5, search_config=wl)
    np.testing.assert_allclose(d1, d0, atol=1e-6)
    np.testing.assert_array_equal(i1, i0)
    assert li._wl_pads[(40, 3)] >= 1024
    li._wl_pads[(40, 3)] = 1
    d2, i2 = li.search(qn, qs, n_buckets=3, k=5, search_config=wl)
    np.testing.assert_allclose(d2, d0, atol=1e-6)
    np.testing.assert_array_equal(i2, i0)
    assert li._wl_pads[(40, 3)] >= 1024
    # with the 128-row tile an item spans two chunks; same results
    pair = SearchConfig(k=5, compute_dtype="float32", pallas_mc=256,
                        pallas_worklist=True, pallas_pair=True)
    d3, i3 = li.search(qn, qs, n_buckets=3, k=5, search_config=pair)
    np.testing.assert_allclose(d3, d0, atol=1e-6)
    np.testing.assert_array_equal(i3, i0)


def test_worklist_byte_budget_disables(rng, monkeypatch, caplog):
    """Past the scratch budget the estimator keeps one CTA per block, says
    so, and caches the decision; the search still answers."""
    li, qn, qs = _small_index(rng)
    base = SearchConfig(k=5, compute_dtype="float32")
    wl = SearchConfig(k=5, compute_dtype="float32", pallas_mc=256,
                      pallas_worklist=True)
    d0, i0 = li.search(qn, qs, n_buckets=3, k=5, search_config=base)
    monkeypatch.setattr(probe, "WL_SCRATCH_BYTES_MAX",
                        probe.worklist_scratch_bytes(1024, 5, 0, False) - 1)
    with caplog.at_level("INFO", logger="tpulmi_torch.index"):
        d1, i1 = li.search(qn, qs, n_buckets=3, k=5, search_config=wl)
    assert "keeping one CTA per block" in caplog.text
    np.testing.assert_array_equal(i1, i0)
    assert li._wl_pads[(40, 3)] == -1
    plan = li._plan_search(torch.zeros((40, 32)), 3, 5, wl)
    assert plan.wl_pad == 0            # reused, not estimated again
    d2, i2 = li.search(qn, qs, n_buckets=3, k=5, search_config=wl)
    np.testing.assert_array_equal(i2, i0)
