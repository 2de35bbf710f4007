"""The persistent schedule of the worklist's item kernel
(csrc/probe_wgmma.cuh: `cta_range`, `next_piece`), modelled in plain torch
and held against the dense probe.

On a persistent grid of G CTAs, CTA c takes the block-major items
[c N / G, (c + 1) N / G), N = min(true total, the pad), and within its range
every run of one block's items with consecutive chunks is a piece: the
block's lists and pool are carried across the run and written once, to the
rows of the piece's first item, which is marked in `written`. The merge
reads the written pieces of a block in chunk order. Here the stores are
drawn by hypothesis (skewed and empty buckets, dumped slots, item spans of
128 to 2048 rows, the 128-row tile, the pool, G from 1 to more than the
items, pads shorter than the total), and the vectors are small integers, so
that every distance is exact whatever rows a product spans: the merged
pieces must equal the dense plain probe to the bit. The plain worklist is
held against the Pallas kernel on its worklist grid in interpret mode on
one case. The CUDA kernel is held against these on a card by
tests/test_torch_kernels_card.py (`test_persistent_worklist_equals_dense`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpulmi.buckets import build_bucket_store
from tpulmi.ops.pallas_topk import pallas_probe_search
from tpulmi_torch.convert import store_from_arrays
from tpulmi_torch.ops.probe_topk import (BLOCK_SLOTS, build_worklist,
                                         group_slots, merge_items_plain,
                                         merge_slots, probe_search, probe_topk,
                                         probe_topk_int8q_plain,
                                         probe_topk_plain,
                                         probe_topk_quant_plain,
                                         worklist_pieces)
from tpulmi_torch.ops.quantize import pack_int4

torch.set_num_threads(1)

D = 16


def _owners(items, total, blocks, span, tile_rows, ctas):
    """The CTA of each kept item, found tile by tile: the items' tiles laid
    end to end (an item scans its rows in tiles of `tile_rows`; an empty
    bucket's item none), T in all; CTA c owns the items that start at a
    tile in [c T / G, (c + 1) T / G), the last CTA the rest."""
    n = min(int(total), items.shape[0])
    g = min(ctas, n)
    rows = {j: (cnt, live) for j, (_, cnt, live) in enumerate(blocks.tolist())}
    starts, tiles = [], 0
    for b, c in items.tolist()[:n]:
        starts.append(tiles)
        cnt, _ = rows[b]
        tiles += -(-max(0, min(span, cnt - c * span)) // tile_rows)
    # every block's items are kept or dropped whole in these tests' tiles
    # count: the kernel weighs all blocks, kept or not
    tiles = sum(-(-cnt // tile_rows) for cnt, live in rows.values()
                if live > 0)
    bounds = [c * tiles // g for c in range(g)]
    return [max(c for c in range(g) if bounds[c] <= s or c == 0)
            for s in starts], g


def _model_starts(items, total, blocks, span, tile_rows, ctas):
    """The items that start a piece, found item by item: the first of a
    CTA's range, or one whose block differs from the item before it, or
    whose chunk does not follow that item's."""
    owner, _ = _owners(items, total, blocks, span, tile_rows, ctas)
    il = items.tolist()
    return [i for i in range(len(owner))
            if i == 0 or owner[i] != owner[i - 1] or il[i][0] != il[i - 1][0]
            or il[i][1] != il[i - 1][1] + 1]


@st.composite
def stores(draw):
    """A store of small-integer vectors: bucket sizes from 0 to a few
    spans (one possibly much longer), probes that hit an empty bucket and
    dump some slots, and the worklist's options."""
    n_cat = draw(st.integers(2, 6))
    item_rows = 128 * draw(st.integers(1, 16))
    sizes = draw(st.lists(st.integers(0, 3 * item_rows), min_size=n_cat,
                          max_size=n_cat))
    if draw(st.booleans()):
        sizes[0] = draw(st.integers(4 * item_rows, 9 * item_rows))
    q = draw(st.integers(1, 150))
    p = draw(st.integers(1, 3))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    return dict(sizes=sizes, item_rows=item_rows, q=q, p=p, seed=seed,
                k=draw(st.sampled_from([1, 3, 10])),
                pair=draw(st.booleans()), pool=draw(st.booleans()),
                ctas=draw(st.integers(1, 40)),
                pad_cut=draw(st.sampled_from([0, 1, 2])))


def _make(case):
    gen = np.random.default_rng(case["seed"])
    sizes = case["sizes"]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    data = gen.integers(-3, 4, size=(int(offsets[-1]) + 8, D)).astype(
        np.float32)
    queries = gen.integers(-3, 4, size=(case["q"], D)).astype(np.float32)
    n_cat = len(sizes)
    probes = gen.integers(0, n_cat + 1, size=(case["q"], case["p"]))
    probes[:, 0] = np.minimum(probes[:, 0], n_cat - 1)   # one probe lives
    counts = torch.tensor(sizes, dtype=torch.int32)
    lay = group_slots(torch.from_numpy(probes.astype(np.int32)),
                      torch.from_numpy(offsets), counts)
    return (torch.from_numpy(queries), lay, torch.from_numpy(data),
            case["q"] * case["p"])


def _options(case, lay):
    span = case["item_rows"] * (2 if case["pair"] else 1)
    _, _, total = build_worklist(lay.blocks, 1, span)
    total = int(total)
    pad = max(total >> case["pad_cut"], 1)
    k = case["k"]
    opts = dict(wl_pad=pad, item_rows=case["item_rows"], pair=case["pair"],
                ctas=case["ctas"])
    if case["pool"]:
        opts["k_out"] = min(k + 7, 128)
    return k, span, total, pad, opts


@settings(max_examples=60, deadline=None)
@given(stores())
def test_schedule_ranges_and_pieces(case):
    """Ranges are contiguous and cut by tiles as the model cuts them, tile
    by tile; every kept item lies in exactly one piece; a piece is one
    block's consecutive chunks; its starts are the model's; the written
    field marks them."""
    q, lay, data, n_slots = _make(case)
    k, span, total, pad, opts = _options(case, lay)
    items, block_items, t = build_worklist(lay.blocks, pad, span)
    assert int(t) == total
    tile_rows = 128 if case["pair"] else 64
    owner, g = _owners(items, t, lay.blocks, span, tile_rows, case["ctas"])
    n = min(total, pad)
    assert owner == sorted(owner) and len(owner) == n
    # balanced by tiles to within one item: a CTA's tiles differ from its
    # share of them by less than one item's
    per = span // tile_rows
    cnts = [cnt for _, cnt, _ in lay.blocks.tolist()]
    mine = [0] * g
    for i, (b, c) in enumerate(items.tolist()[:n]):
        mine[owner[i]] += -(-max(0, min(span, cnts[b] - c * span))
                           // tile_rows)
    if pad >= total:
        tiles = sum(mine)
        share = [(c + 1) * tiles // g - c * tiles // g for c in range(g)]
        assert all(abs(m - s) < per for m, s in zip(mine, share))
    pieces = worklist_pieces(items, t, lay.blocks, span, tile_rows,
                             case["ctas"])
    firsts = block_items[:, 0].tolist()
    il = items.tolist()
    covered, starts = [], []
    for c, blk, c0, c1 in pieces:
        first = firsts[blk] + c0
        mine = range(first, first + c1 - c0 + 1)
        starts.append(first)
        covered += mine
        assert all(il[i] == [blk, c0 + i - first] and owner[i] == c
                   for i in mine)
    assert covered == list(range(n))
    assert starts == _model_starts(items, t, lay.blocks, span, tile_rows,
                                   case["ctas"])
    parts = probe_topk_plain(q, lay.qidx, data, lay.blocks, k, merge=False,
                             **opts)
    assert parts.written.dtype == torch.int8
    assert torch.nonzero(parts.written).flatten().tolist() == starts


@settings(max_examples=50, deadline=None)
@given(stores())
def test_persistent_pieces_merge_to_the_dense_probe(case):
    """The merged pieces equal the dense plain probe to the bit, pool
    extras included; the total is build_worklist's. With a short pad the
    total stays true and the blocks whose items all fit are still right."""
    q, lay, data, n_slots = _make(case)
    k, span, total, pad, opts = _options(case, lay)
    live = lay.slot_of_row < n_slots
    args = (q, lay.qidx, data, lay.blocks, k)
    dense = probe_topk_plain(*args, k_out=opts.get("k_out", 0))
    got_d, got_i, got_total = probe_topk_plain(*args, **opts)
    assert int(got_total) == total
    if pad >= total:
        assert torch.equal(got_d[live], dense[0][live])
        assert torch.equal(got_i[live], dense[1][live])
        # one piece an item (the staged loop's layout) merges the same
        one = probe_topk_plain(*args, **{**opts, "ctas": 0})
        assert torch.equal(one[0], got_d) and torch.equal(one[1], got_i)
    else:
        first, cnt = build_worklist(lay.blocks, pad, span)[1].unbind(1)
        fits = (first + cnt <= pad).repeat_interleave(BLOCK_SLOTS) & live
        assert torch.equal(got_i[fits], dense[1][fits])


@pytest.mark.parametrize("kind", ["int8", "int4", "int8q"])
@settings(max_examples=15, deadline=None)
@given(case=stores())
def test_persistent_pieces_over_codes(kind, case):
    """The same over a quantized store, with float queries and with int8
    query codes: codes and queries are small integers, so the sums are
    exact and each column's scale is applied alike on both sides."""
    q, lay, data, n_slots = _make(case)
    k, span, total, pad, opts = _options(case, lay)
    live = lay.slot_of_row < n_slots
    bits = 4 if kind == "int4" else 8
    codes = data.to(torch.int8)
    if bits == 4:
        codes = pack_int4(codes)
    gen = torch.Generator().manual_seed(case["seed"])
    scales = torch.rand(data.shape[0], generator=gen) + 0.5
    tail = (lay.qidx, codes, scales, lay.blocks, k, bits)
    if kind == "int8q":
        head = (q.to(torch.int8), torch.rand(q.shape[0], generator=gen) + 0.5)
        fn = probe_topk_int8q_plain
    else:
        head, fn = (q,), probe_topk_quant_plain
    dense = fn(*head, *tail, k_out=opts.get("k_out", 0))
    got = fn(*head, *tail, **{**opts, "wl_pad": max(pad, total)})
    assert int(got[2]) == total
    assert torch.equal(got[0][live], dense[0][live])
    assert torch.equal(got[1][live], dense[1][live])


def test_merge_skips_items_no_piece_starts():
    """Rows of items that start no piece are never read: poisoned, they
    change nothing."""
    gen = torch.Generator().manual_seed(5)
    data = torch.randint(-3, 4, (3000, D), generator=gen).float()
    q = torch.randint(-3, 4, (200, D), generator=gen).float()
    probes = torch.randint(0, 3, (200, 2), generator=gen).int()
    lay = group_slots(probes, torch.tensor([0, 1500, 1600, 3000],
                                           dtype=torch.int32),
                      torch.tensor([1500, 100, 1400], dtype=torch.int32))
    args = (q, lay.qidx, data, lay.blocks, 10)
    parts = probe_topk_plain(*args, wl_pad=256, item_rows=128, ctas=3,
                             merge=False)
    unread = parts.written == 0
    assert bool(unread[:int(parts.total)].any())
    rows = unread.repeat_interleave(BLOCK_SLOTS)
    parts.part_d[rows] = -1.0
    parts.part_i[rows] = 7
    got = merge_items_plain(lay.blocks, parts, 10)
    want = probe_topk_plain(*args)
    live = lay.slot_of_row < 400
    assert torch.equal(got[0][live], want[0][live])
    assert torch.equal(got[1][live], want[1][live])


def test_ctas_option(rng):
    """`ctas` is checked; on the CPU the wrapper takes the plain version,
    which lays its parts out by the schedule of that many CTAs."""
    q = torch.from_numpy(rng.normal(size=(16, D)).astype(np.float32))
    data = torch.from_numpy(rng.normal(size=(700, D)).astype(np.float32))
    lay = group_slots(torch.zeros((16, 1), dtype=torch.int32),
                      torch.tensor([0, 700], dtype=torch.int32),
                      torch.tensor([700], dtype=torch.int32))
    args = (q, lay.qidx, data, lay.blocks, 5)
    with pytest.raises(ValueError, match="ctas"):
        probe_topk_plain(*args, wl_pad=64, item_rows=128, ctas=-1)
    one = probe_topk(*args, wl_pad=64, item_rows=128, ctas=1, merge=False)
    # one CTA, one block of 6 items: one piece, written at item 0
    assert one.written.tolist()[:7] == [1, 0, 0, 0, 0, 0, 0]
    each = probe_topk(*args, wl_pad=64, item_rows=128, merge=False)
    assert each.written.tolist()[:7] == [1, 1, 1, 1, 1, 1, 0]
    # 700 rows: items of 2, 2, 2, 2, 2 and 1 tiles of 64 rows, 11 in all;
    # 4 CTAs cut at tiles 0, 2, 5 and 8
    pieces = [(0, 0, 0, 0), (1, 0, 1, 2), (2, 0, 3, 3), (3, 0, 4, 5)]
    assert worklist_pieces(one.items, one.total, lay.blocks, 128, 64,
                           1) == [(0, 0, 0, 5)]
    assert worklist_pieces(one.items, one.total, lay.blocks, 128, 64,
                           4) == pieces
    # in tiles of 128 rows: 1 tile an item, 6 in all, cut at 0, 1, 3, 4
    assert worklist_pieces(one.items, one.total, lay.blocks, 128, 128,
                           4) == [(0, 0, 0, 0), (1, 0, 1, 2), (2, 0, 3, 3),
                                  (3, 0, 4, 5)]
    # 5 CTAs over 11 tiles cut at 0, 2, 4, 6, 8: one item each but the last
    assert [p[2:] for p in worklist_pieces(one.items, one.total, lay.blocks,
                                           128, 64, 5)] == [
        (0, 0), (1, 1), (2, 2), (3, 3), (4, 5)]


def test_persistent_plain_matches_pallas(rng):
    """The plain worklist laid out by a persistent schedule of 5 CTAs
    against the Pallas kernel on its worklist grid (qc = 64, the port's
    block), in interpret mode: the same total, distances within float32
    rounding (1e-5: sums taken in another order), the same ids wherever
    distances are apart."""
    n, c, d, mc = 4000, 11, 128, 256
    data = rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = rng.normal(size=(48, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    labels[labels == 3] = 0                       # a long bucket, one empty
    js = build_bucket_store(labels, data, c, pad_rows=mc, row_align=mc)
    ts = store_from_arrays(np.asarray(js.data_sorted),
                           np.asarray(js.ids_sorted), np.asarray(js.offsets),
                           np.asarray(js.counts), js.n, js.pad_rows,
                           js.row_align, device="cpu")
    probes = np.stack([rng.permutation(c)[:3] for _ in range(48)]).astype(
        np.int32)
    probes[:6, 1] = 3
    probes[6:12, 2] = c                           # dumped
    max_bucket = int(np.asarray(js.counts).max())
    jd, ji, _, jtotal = pallas_probe_search(
        jnp.asarray(probes), jnp.asarray(queries), js, k=10, qc=BLOCK_SLOTS,
        mc=mc, max_chunks=-(-max_bucket // mc), compute_dtype=jnp.float32,
        extract_mode="group", interpret=True, wl_pad=2048)
    tp = torch.from_numpy(probes)
    lay = group_slots(tp, ts.offsets, ts.counts)
    parts = probe_topk_plain(torch.from_numpy(queries), lay.qidx,
                             ts.data_sorted, lay.blocks, 10, wl_pad=2048,
                             item_rows=mc, ctas=5, merge=False)
    assert int(parts.written.sum()) < int(parts.total)   # pieces of items
    td, ti, _, total = probe_search(tp, torch.from_numpy(queries), ts, k=10,
                                    compute_dtype=torch.float32,
                                    backend="torch", wl_pad=2048,
                                    item_rows=mc)
    assert int(total) == int(jtotal) == int(parts.total)
    md, mi = merge_items_plain(lay.blocks, parts, 10)
    fd, fi = merge_slots(md, mi, lay, 48, 3, 10, ts.ids_sorted)
    np.testing.assert_allclose(fd.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    gap = np.full(fd.shape, np.inf)
    step = np.diff(np.asarray(jd), axis=1)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    apart = gap > 1e-5
    np.testing.assert_array_equal(fi.numpy()[apart], np.asarray(ji)[apart])
