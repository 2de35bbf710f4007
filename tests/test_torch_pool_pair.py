"""The rerank pool and the 128-row ("paired") tile of tpulmi_torch against
the JAX package's Pallas kernel in interpret mode.

The pool's rows [k, k_out) are defined deterministically in the port and are
not the TPU kernel's best-effort extras row for row; what both promise, and
what is held here, is: the first k rows exact, the whole row ascending, every
live id carrying its distance, no id twice. The tile height cannot change a
result, so on the CPU the paired variants are checked where they do change
something: the worklist's item span and count."""

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
from tpulmi_torch.ops.distance import exact_knn
from tpulmi_torch.ops.probe_topk import (BLOCK_SLOTS, group_slots,
                                         probe_search, probe_topk_plain,
                                         resolve_tiling, smem_bytes)

torch.set_num_threads(1)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _setup(rng, mc=256, bits=0, n=4000, d=128, c=13, q=64):
    """Bucket sizes around 300: odd counts of 64-row and of 128-row tiles,
    and (c=13, n=4000) none a multiple of either."""
    data, queries = _unit(rng, n, d), _unit(rng, q, d)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    labels[:n - 40][labels[:n - 40] == 3] = 4     # bucket 3: 0..40 rows
    js = build_bucket_store(labels, data, c, pad_rows=mc, row_align=mc)
    kw = {}
    if bits:
        js = quantize_store(js, bits=bits)
        kw = dict(scales=np.asarray(js.scales), quant_bits=bits)
    ts = store_from_arrays(np.asarray(js.data_sorted),
                           np.asarray(js.ids_sorted), np.asarray(js.offsets),
                           np.asarray(js.counts), js.n, js.pad_rows,
                           js.row_align, device="cpu", **kw)
    return data, queries, js, ts


def _same(got, want):
    """Two plain runs that cut the rows differently: the same ids, and
    distances to 1e-6 (the CPU matmul's summing order depends on the
    operands' shapes; the CUDA kernels agree to the bit, which
    tests/test_torch_kernels_card.py holds them to)."""
    (gd, gi), (wd, wi) = got, want
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gd, wd, atol=1e-6, rtol=0)


def _probes(rng, c, q, p, dump=0.0):
    probes = np.stack([rng.permutation(c)[:p] for _ in range(q)]).astype(
        np.int32)
    if dump:
        drop = rng.random(probes.shape) < dump
        drop[:, 0] = False
        probes = np.where(drop, c, probes).astype(np.int32)
    return probes


# ------------------------------------------------------------- paired tile
@pytest.mark.parametrize("store", ["full", "int8", "int4"])
def test_pair_worklist_matches_dense(rng, store):
    """pair x worklist x dumps on each store type (int8 queries on the
    quantized ones): the dense results, and a worklist total in
    pair units, Σ ceil(slots/64) · max(ceil(chunks/2), 1), equal to the
    Pallas kernel's at qc=64."""
    bits = {"full": 0, "int8": 8, "int4": 4}[store]
    mc = 1024 if bits else 256
    d = 256 if bits == 4 else 128
    _, queries, js, ts = _setup(rng, mc, bits, n=9000 if bits else 4000, d=d,
                                c=5 if bits else 13, q=48)
    c = ts.n_categories
    probes = _probes(rng, c, 48, 3, dump=0.3)
    tp, tq = torch.from_numpy(probes), torch.from_numpy(queries)
    kw = dict(k=10, compute_dtype=torch.float32, int8_queries=bool(bits),
              backend="torch")
    d0, i0, _ = probe_search(tp, tq, ts, **kw)
    d1, i1, _ = probe_search(tp, tq, ts, pair=True, **kw)
    assert torch.equal(d1, d0) and torch.equal(i1, i0)
    dw, iw, _, total = probe_search(tp, tq, ts, pair=True, wl_pad=2048,
                                    item_rows=mc, **kw)
    _same((dw, iw), (d0, i0))
    slots = np.bincount(probes.reshape(-1)[probes.reshape(-1) < c],
                        minlength=c)
    chunks = -(-np.asarray(js.counts) // mc)
    want = int(np.sum(-(-slots // BLOCK_SLOTS)
                      * np.maximum(-(-chunks // 2), 1) * (slots > 0)))
    assert int(total) == want
    max_bucket = int(np.asarray(js.counts).max())
    jd_, ji, _, jtotal = pallas_probe_search(
        jnp.asarray(probes), jnp.asarray(queries), js, k=10, qc=BLOCK_SLOTS,
        mc=mc, max_chunks=-(-max_bucket // mc), compute_dtype=jnp.float32,
        int8_queries=bool(bits), extract_mode="group2", interpret=True,
        pair=True, wl_pad=2048)
    assert int(jtotal) == want
    # int8 queries: 1e-4, see test_torch_probe_quant.py
    np.testing.assert_allclose(dw.numpy(), np.asarray(jd_),
                               atol=1e-4 if bits else 1e-5)


def test_shared_memory_model():
    # the 64-row tile at k <= 32: the 69 KB that ptxas reports per CTA
    assert smem_bytes(10, 64, False) == 69376
    assert smem_bytes(10, 64, True) == 69376 + 64 * 128 * 8
    # every variant fits an H100's 227 KB, the widest one included
    assert smem_bytes(128, 128, True) <= probe.SMEM_OPTIN_H100
    assert probe.smem_budget("cpu") == probe.SMEM_OPTIN_H100
    assert resolve_tiling(True, k=128, pool=True, device="cpu")
    assert not resolve_tiling(False, k=10, pool=False, device="cpu")


def test_pair_declined_on_a_small_budget(rng, monkeypatch, caplog):
    """A card whose blocks hold less shared memory than the 128-row tile
    needs: pair is declined with one logged line and the search answers
    from the 64-row tile."""
    monkeypatch.setattr(probe, "smem_budget", lambda device: 120_000)
    with caplog.at_level("WARNING", logger="tpulmi_torch.probe"):
        assert not resolve_tiling(True, k=10, pool=True, device="cpu")
        assert not resolve_tiling(True, k=10, pool=True, device="cpu")
    assert caplog.text.count("pallas_pair declined") == 1
    assert resolve_tiling(True, k=10, pool=False, device="cpu")

    n = 2000
    nav = rng.normal(size=(n, 32)).astype(np.float32)
    data = _unit(rng, n, 128)
    li = LearnedIndex(IndexConfig(n_categories=8, epochs=2, lr=0.003,
                                  batch_size=256, row_align=256),
                      device="cpu")
    li.build(nav, data)
    li.quantize(host_corpus=data, normalized=True)
    scfg = SearchConfig(k=5, pallas_pair=True, pallas_pool=True)
    plan = li._plan_search(torch.zeros((40, 32)), 3, 5, scfg)
    assert plan.pool_k == 5 and not plan.pair
    d0, i0 = li.search(nav[:40], data[:40], n_buckets=3, k=5,
                       search_config=SearchConfig(k=5, pallas_pool=True))
    d1, i1 = li.search(nav[:40], data[:40], n_buckets=3, k=5,
                       search_config=scfg)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)


# ------------------------------------------------------------- rerank pool
@pytest.mark.parametrize("mode", ["group", "group2"])
def test_pool_prefix_matches_pallas(rng, mode):
    data, queries, js, ts = _setup(rng)
    c = ts.n_categories
    probes = _probes(rng, c, queries.shape[0], 3)
    max_bucket = int(np.asarray(js.counts).max())
    jd_, ji, _ = pallas_probe_search(
        jnp.asarray(probes), jnp.asarray(queries), js, k=5, k_out=16, qc=128,
        mc=256, max_chunks=-(-max_bucket // 256), compute_dtype=jnp.float32,
        extract_mode=mode, interpret=True)
    td, ti, _ = probe_search(torch.from_numpy(probes),
                             torch.from_numpy(queries), ts, k=16, pool_k=5,
                             compute_dtype=torch.float32, backend="torch")
    td, ti = td.numpy(), ti.numpy()
    assert td.shape == (queries.shape[0], 16)
    # the exact prefix: the Pallas kernel's first k
    np.testing.assert_allclose(td[:, :5], np.asarray(jd_)[:, :5], atol=1e-5)
    np.testing.assert_array_equal(ti[:, :5], np.asarray(ji)[:, :5])
    # and the no-pool search's first k, to the bit
    ed, ei, _ = probe_search(torch.from_numpy(probes),
                             torch.from_numpy(queries), ts, k=5,
                             compute_dtype=torch.float32, backend="torch")
    np.testing.assert_array_equal(td[:, :5], ed.numpy())
    np.testing.assert_array_equal(ti[:, :5], ei.numpy())
    # the whole row ascends, live ids carry their distances, none twice
    assert np.all(np.diff(td, axis=1) >= 0)
    live = ti >= 0
    assert live[:, :5].all() and live.mean() > 0.9
    chosen = 1.0 - np.einsum("qkd,qd->qk", data[np.maximum(ti, 0)], queries)
    np.testing.assert_allclose(np.where(live, chosen, 0.0),
                               np.where(live, td, 0.0), atol=1e-5)
    assert (td[~live] == 10000.0).all()
    for row in ti:
        assert len(set(row[row >= 0].tolist())) == int((row >= 0).sum())


def test_pool_extras_follow_their_definition(rng):
    """Rows [k, k_out) of a slot against a direct reading of the
    definition: the best row of each class (row - bucket start) % 128, the
    exact top-k's rows taken out, the smallest k_out - k by (distance,
    row)."""
    _, queries, js, ts = _setup(rng, n=3000, c=4, q=16)
    probes = torch.from_numpy(_probes(rng, 4, 16, 1))
    lay = group_slots(probes, ts.offsets, ts.counts)
    q = torch.from_numpy(queries)
    k, k_out = 5, 24
    out_d, out_i = probe_topk_plain(q, lay.qidx, ts.data_sorted, lay.blocks,
                                    k, k_out=k_out)
    assert out_d.shape[1] == k_out
    checked = 0
    for row in torch.nonzero(lay.slot_of_row < 16).flatten().tolist():
        start, cnt, _ = lay.blocks[row // BLOCK_SLOTS].tolist()
        dist = (1.0 - ts.data_sorted[start:start + cnt]
                @ q[lay.qidx[row]]).numpy()
        order = np.argsort(dist, kind="stable")
        top = set((order[:k] + start).tolist())
        assert out_i[row, :k].tolist() == (order[:k] + start).tolist()
        best = {}
        for r in range(cnt):          # ascending rows: strict < keeps the
            if r % 128 not in best or dist[r] < dist[best[r % 128]]:  # lower
                best[r % 128] = r
        cands = sorted((dist[r], r + start) for r in best.values()
                       if r + start not in top)[:k_out - k]
        want_i = [r for _, r in cands] + [-1] * (k_out - k - len(cands))
        assert out_i[row, k:].tolist() == want_i
        # the products here are summed row by row, there by a matmul
        np.testing.assert_allclose(
            out_d[row, k:k + len(cands)].numpy(),
            np.array([d for d, _ in cands], np.float32), atol=1e-6)
        checked += 1
    assert checked == 16


@pytest.mark.parametrize("pair", [False, True])
def test_pool_worklist_matches_dense(rng, pair):
    """pool x worklist (x pair), skew and dumps included: equal to the
    dense pool, extras too."""
    _, queries, js, ts = _setup(rng)
    c = ts.n_categories
    probes = _probes(rng, c, queries.shape[0], 4, dump=0.4)
    probes[:, 0] = 0
    tp, tq = torch.from_numpy(probes), torch.from_numpy(queries)
    kw = dict(k=16, pool_k=5, compute_dtype=torch.float32, backend="torch")
    d0, i0, _ = probe_search(tp, tq, ts, **kw)
    d1, i1, _, _ = probe_search(tp, tq, ts, wl_pad=4096, item_rows=128,
                                pair=pair, **kw)
    _same((d1, i1), (d0, i0))


def test_pool_keys_order_like_their_pairs(rng):
    """The 64-bit keys of the pool: unsigned key order is (distance, row)
    order, for distances of either sign (the int8 x int8 kernel ranks raw
    scores of hundreds below zero), and a key gives its pair back."""
    dist = torch.from_numpy(np.concatenate([
        rng.normal(size=200).astype(np.float32) * 300.0,
        np.array([0.0, -0.0, 1.0, 1.0, 1.0, 9999.0], np.float32)]))
    rows = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, size=dist.shape[0]
                                         ).astype(np.int32))
    keys = probe.pool_keys(dist, rows)
    back_d, back_i = probe.pool_pairs(keys)
    assert torch.equal(back_i, rows)
    assert torch.equal(back_d.view(torch.int32), dist.view(torch.int32))
    by_key = torch.argsort(keys ^ probe._SIGN, stable=True)
    pairs = sorted(zip((dist + 0.0).tolist(), rows.tolist(),
                       range(dist.shape[0])))
    # -0.0 sorts before 0.0 as a key and equal to it as a float
    assert [d for d, _, _ in pairs] == dist[by_key].tolist()
    empty = torch.full((3,), -1, dtype=torch.int64)
    ed, ei = probe.pool_pairs(empty)
    assert torch.isinf(ed).all() and (ei == -1).all()
    assert bool(((keys ^ probe._SIGN) < (empty[0] ^ probe._SIGN)).all())


def test_merge_items_on_item_parts(rng):
    """The two stages of the worklist apart: the items' parts
    (``merge=False``), then `merge_items` (on the CPU its plain version),
    give the one-call result; an undersized scratch merges only the items
    it holds."""
    _, queries, js, ts = _setup(rng)
    c = ts.n_categories
    probes = torch.from_numpy(_probes(rng, c, queries.shape[0], 3, dump=0.3))
    lay = group_slots(probes, ts.offsets, ts.counts)
    args = (torch.from_numpy(queries), lay.qidx, ts.data_sorted, lay.blocks,
            5)
    opts = dict(k_out=12, wl_pad=1024, item_rows=128)
    whole = probe_topk_plain(*args, **opts)
    parts = probe_topk_plain(*args, merge=False, **opts)
    assert isinstance(parts, probe.WorklistParts)
    assert int(parts.total) == int(whole[2])
    assert parts.part_d.shape == (1024 * BLOCK_SLOTS, 5)
    assert parts.keys.shape == (lay.qidx.shape[0], 128)
    before = probe.launch_counts()
    md, mi = probe.merge_items(lay.blocks, parts, 5, 12)
    assert probe.launch_counts() == before
    assert torch.equal(md, whole[0]) and torch.equal(mi, whole[1])
    # the keys are the per-class best rows: with the exact prefix they
    # give the extras back
    ed, ei = probe.pool_extras(whole[0][:, :5], whole[1][:, :5],
                               *probe.pool_pairs(parts.keys), 12)
    assert torch.equal(ed, whole[0]) and torch.equal(ei, whole[1])
    # half the scratch: the blocks whose items all fit are still right
    short = probe_topk_plain(*args, merge=False,
                             **{**opts, "wl_pad": int(parts.total) // 2})
    sd, si = probe.merge_items_plain(lay.blocks, short, 5, 12)
    first, cnt = short.block_items[:, 0], short.block_items[:, 1]
    fits = (first + cnt <= int(parts.total) // 2).repeat_interleave(
        BLOCK_SLOTS)
    assert 0 < int(fits.sum()) < fits.numel()
    assert torch.equal(si[fits][:, :5], whole[1][fits][:, :5])


def _quantized_index(rng):
    n, d = 6000, 128
    nav = rng.normal(size=(n, 24)).astype(np.float32)
    data = _unit(rng, n, d)
    li = LearnedIndex(IndexConfig(n_categories=12, epochs=4, lr=0.003,
                                  batch_size=512, row_align=1024),
                      device="cpu")
    li.build(nav, data)
    li.quantize(host_corpus=data, normalized=True)
    return li, nav, data


def test_index_pool_rerank(rng):
    """pallas_pool end to end on a quantized index: the kernel's list is k
    wide, the rerank extras come from the pool; no id twice in a row, and
    the exact rerank keeps the recall."""
    li, nav, data = _quantized_index(rng)
    qn, qs = nav[:32], data[:32]
    scfg = SearchConfig(k=10, compute_dtype=None, pallas_pool=True,
                        rerank_extra=10)
    plan = li._plan_search(torch.from_numpy(qn), 12, 10, scfg)
    assert (plan.pool_k, plan.k_eff, plan.rerank) == (10, 20, "host")
    d_p, i_p = li.search(qn, qs, n_buckets=12, k=10, search_config=scfg)
    assert all(len(set(row.tolist())) == 10 for row in i_p)
    _, want = exact_knn(torch.from_numpy(qs), torch.from_numpy(data), k=10,
                        normalized=True)
    recall = np.mean([len(set(i_p[i]) & set(want[i].numpy() + 1)) / 10
                      for i in range(32)])
    assert recall >= 0.98
    # without a rerank the pool does not apply
    plain = li._plan_search(torch.from_numpy(qn), 12, 10,
                            SearchConfig(k=10, pallas_pool=True,
                                         rerank=False))
    assert plain.pool_k == 0 and plain.k_eff == 10


def test_scalar_extract_with_pool_is_refused(rng):
    li, nav, data = _quantized_index(rng)
    with pytest.raises(ValueError, match="rerank pool"):
        li.search(nav[:8], data[:8], n_buckets=3, k=10,
                  search_config=SearchConfig(pallas_pool=True,
                                             pallas_extract="scalar"))
