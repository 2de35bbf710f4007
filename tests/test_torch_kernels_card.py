"""The CUDA kernels of tpulmi_torch against their plain versions, on a
card. Every test here carries the `cuda` marker and skips without one.

This file imports nothing of the JAX package, so that it also runs where
only torch is installed:

    python -m pytest tests/test_torch_kernels_card.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from tpulmi_torch.buckets import build_bucket_store
from tpulmi_torch.ops.probe_topk import (CLUSTER_CTAS, apply_query_scale,
                                         build_worklist, cluster_reads,
                                         common_loop, group_slots,
                                         launch_counts,
                                         loop_launch_counts, pool_extras,
                                         pool_pairs, probe_cluster,
                                         probe_loop, probe_topk,
                                         probe_topk_int8q,
                                         probe_topk_int8q_plain,
                                         probe_topk_plain, probe_topk_quant,
                                         probe_topk_quant_plain,
                                         worklist_pieces)
from tpulmi_torch.ops.quantize import (quantize_rows, quantize_rows_int4,
                                       quantize_store)

pytestmark = pytest.mark.cuda

N, C, Q, P = 20000, 13, 500, 3


def _apart(d, tol):
    gap = np.full(d.shape, np.inf)
    step = np.diff(d, axis=1)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    return gap > tol


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _setup(rng, d, dev):
    def unit(n):
        x = rng.normal(size=(n, d)).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))

    labels = rng.integers(0, C, size=N).astype(np.int32)
    labels[labels == 4] = 5                      # an empty bucket
    labels[:N - 3][labels[:N - 3] == 7] = 8      # a bucket of < k rows
    store = build_bucket_store(torch.from_numpy(labels).to(dev),
                               unit(N).to(dev), C, row_align=8)
    probes = torch.from_numpy(rng.integers(0, C + 1, (Q, P)).astype(
        np.int32)).to(dev)                       # id C: a dumped slot
    return store, unit(Q).to(dev), group_slots(probes, store.offsets,
                                               store.counts), probes.numel()


def _check(kern, plain, lay, n_slots, tol):
    torch.cuda.synchronize()
    live = lay.slot_of_row < n_slots
    (kd, ki), (pd, pi) = ((t[live].cpu() for t in pair)
                          for pair in (kern, plain))
    torch.testing.assert_close(kd, pd, atol=tol, rtol=0)
    assert torch.equal(ki < 0, pi < 0)
    assert (kd[ki < 0] == 10000.0).all()
    apart = torch.from_numpy(_apart(pd.numpy(), tol))
    apart[:, -1] = False       # the k-th place may tie with the next row
    assert torch.equal(ki[apart], pi[apart])


@pytest.mark.parametrize("d", [256, 40])
def test_full_precision_kernel(rng, card, d):
    store, q, lay, n_slots = _setup(rng, d, card)
    before = launch_counts()["probe_topk"]
    for dtype, k in ((torch.bfloat16, 1), (torch.bfloat16, 10),
                     (torch.bfloat16, 100), (torch.float16, 10),
                     (torch.float32, 10)):
        args = (q.to(dtype), lay.qidx, store.data_sorted.to(dtype),
                lay.blocks, k)
        _check(probe_topk(*args), probe_topk_plain(*args), lay, n_slots,
               1e-4)
    assert launch_counts()["probe_topk"] == before + 5


# d = 96: half the width is no multiple of a staged slice
@pytest.mark.parametrize("d", [256, 96])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_kernels(rng, card, bits, d):
    full, q, lay, n_slots = _setup(rng, d, card)
    store = quantize_store(full, bits=bits)
    assert store.data_sorted.is_cuda and store.scales.is_cuda
    before = launch_counts()
    tail = (lay.qidx, store.data_sorted, store.scales, lay.blocks)
    for dtype, k in ((torch.bfloat16, 10), (torch.bfloat16, 100),
                     (torch.float16, 40), (torch.float32, 10)):
        args = (q.to(dtype), *tail, k, bits)
        _check(probe_topk_quant(*args), probe_topk_quant_plain(*args), lay,
               n_slots, 1e-4)
    qc, qs = quantize_rows(q)
    for k in (10, 100):
        args = (qc, qs, *tail, k, bits)
        # exact integer sums on both sides
        _check(probe_topk_int8q(*args), probe_topk_int8q_plain(*args), lay,
               n_slots, 1e-5)
    after = launch_counts()
    assert after[f"probe_topk_quant_int{bits}"] == (
        before[f"probe_topk_quant_int{bits}"] + 4)
    assert after[f"probe_topk_int8q_int{bits}"] == (
        before[f"probe_topk_int8q_int{bits}"] + 2)


def _variants(full, q, lay, store_kind):
    """(wrapper, plain version, their arguments up to k, tolerance) for a
    store kind: bf16 / float32 vectors, int8 / int4 codes with bf16
    queries, int8 codes with int8 queries."""
    if store_kind in ("bf16", "f32"):
        dtype = torch.bfloat16 if store_kind == "bf16" else torch.float32
        return (probe_topk, probe_topk_plain,
                (q.to(dtype), lay.qidx, full.data_sorted.to(dtype),
                 lay.blocks), (), 1e-4)
    bits = 4 if store_kind == "int4" else 8
    store = quantize_store(full, bits=bits)
    tail = (lay.qidx, store.data_sorted, store.scales, lay.blocks)
    if store_kind == "int8q":
        qc, qs = quantize_rows(q)
        return (probe_topk_int8q, probe_topk_int8q_plain, (qc, qs, *tail),
                (bits,), 1e-5)
    return (probe_topk_quant, probe_topk_quant_plain,
            (q.bfloat16(), *tail), (bits,), 1e-4)


STORE_KINDS = ["bf16", "f32", "int8", "int4", "int8q"]
# (bytes of a query value, code width of the store) of each kind
LAUNCH_KIND = {"bf16": (2, 0), "f32": (4, 0), "int8": (2, 8), "int4": (2, 4),
               "int8q": (1, 8)}


def _held_together(kind, d, launches):
    """The `loop` option under which launches of (k, pool, tile rows) take
    one main loop, so that they can be equal to the bit (the two loops sum
    a product in different orders)."""
    return common_loop(*LAUNCH_KIND[kind], d, launches)


@pytest.mark.parametrize("kind", STORE_KINDS)
def test_pair_tile_equals_dense(rng, card, kind):
    """The 128-row tile changes no result: equal to the 64-row tile to the
    bit, on buckets of odd and of sub-tile size, for every store type."""
    full, q, lay, n_slots = _setup(rng, 256, card)
    fn, plain, args, tail, tol = _variants(full, q, lay, kind)
    before = launch_counts()["probe_pair"]
    for k in (10, 100):
        loop = _held_together(kind, 256, [(k, False, 64), (k, False, 128)])
        dense = fn(*args, k, *tail, loop=loop)
        pair = fn(*args, k, *tail, pair=True, loop=loop)
        torch.cuda.synchronize()
        live = lay.slot_of_row < n_slots
        assert torch.equal(pair[0][live], dense[0][live])
        assert torch.equal(pair[1][live], dense[1][live])
        _check(pair, plain(*args, k, *tail), lay, n_slots, tol)
    assert launch_counts()["probe_pair"] == before + 2


@pytest.mark.parametrize("kind", STORE_KINDS)
def test_worklist_kernels_equal_dense(rng, card, kind):
    """The item kernel and the merge kernel: the one-CTA-per-block kernel's
    result to the bit, for every store type, item span, tile height and a
    tight pad; the plain worklist's total; an undersized pad reports the
    true total."""
    full, q, lay, n_slots = _setup(rng, 256, card)
    fn, plain, args, tail, tol = _variants(full, q, lay, kind)
    live = lay.slot_of_row < n_slots
    before = launch_counts()
    runs = 0
    for k in (10, 40):
        loop = _held_together(kind, 256, [(k, False, 64), (k, False, 128)])
        dense = fn(*args, k, *tail, loop=loop)
        for item_rows, pair in ((128, False), (1024, False), (256, True)):
            opts = dict(item_rows=item_rows, pair=pair, loop=loop)
            *_, want = plain(*args, k, *tail, wl_pad=8192, **opts)
            for pad in (8192, int(want)):
                wd, wi, total = fn(*args, k, *tail, wl_pad=pad, **opts)
                torch.cuda.synchronize()
                runs += 1
                assert int(total) == int(want)
                assert torch.equal(wd[live], dense[0][live])
                assert torch.equal(wi[live], dense[1][live])
            *_, total = fn(*args, k, *tail, wl_pad=int(want) // 2, **opts)
            runs += 1
            assert int(total) == int(want)
        _check((wd, wi), plain(*args, k, *tail, wl_pad=8192, **opts)[:2],
               lay, n_slots, tol)
    after = launch_counts()
    assert after["probe_worklist"] == before["probe_worklist"] + runs
    assert after["merge_items"] == before["merge_items"] + runs


@pytest.mark.parametrize("kind", STORE_KINDS)
def test_pool_kernel(rng, card, kind):
    """k_out > k: the exact prefix as without a pool (to the bit); the
    extras as the definition gives them for the kernel's own prefix and
    the plain version's per-class best rows (distances to the tolerance;
    ids where distances are apart, but for the few classes whose two best
    rows lie within a rounding of each other); no id twice; worklist and
    128-row tile equal the dense pool to the bit."""
    full, q, lay, n_slots = _setup(rng, 256, card)
    fn, plain, args, tail, tol = _variants(full, q, lay, kind)
    live = lay.slot_of_row < n_slots
    before = launch_counts()["probe_pool"]
    for k, k_out in ((10, 20), (10, 40), (40, 128)):
        loop = _held_together(kind, 256, [(k, pl, nb) for pl in (False, True)
                                          for nb in (64, 128)])
        exact = fn(*args, k, *tail, loop=loop)
        kd, ki = fn(*args, k, *tail, k_out=k_out, loop=loop)
        pd, pi = plain(*args, k, *tail, k_out=k_out)
        torch.cuda.synchronize()
        assert kd.shape[1] == k_out
        assert torch.equal(kd[live][:, :k], exact[0][live])
        assert torch.equal(ki[live][:, :k], exact[1][live])
        # the extras: the definition applied to the kernel's own prefix and
        # the plain per-class best rows (the keys of the plain worklist)
        parts = plain(*args, k, *tail, k_out=k_out, wl_pad=8192,
                      item_rows=128, merge=False)
        want = pool_extras(kd[:, :k], ki[:, :k], *pool_pairs(parts.keys),
                           k_out)
        if kind == "int8q":
            want = apply_query_scale(want, args[1], lay.qidx)
        kd_, ki_, pd_, pi_ = (t[live].cpu()[:, k:]
                              for t in (kd, ki, want[0], want[1]))
        torch.testing.assert_close(kd_, pd_, atol=tol, rtol=0)
        assert torch.equal(ki_ < 0, pi_ < 0)
        assert bool((kd[live][:, 1:] >= kd[live][:, :-1]).all())
        assert bool((kd_[ki_ < 0] == 10000.0).all())
        apart = torch.from_numpy(_apart(pd_.numpy(), tol))
        apart[:, -1] = False
        assert (ki_ == pi_)[apart].float().mean() >= 0.999
        ki_ = ki[live].cpu()
        srt = torch.sort(ki_, dim=1).values
        assert not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
                         ).any())
        for opts in (dict(pair=True), dict(wl_pad=8192, item_rows=128),
                     dict(wl_pad=8192, item_rows=256, pair=True)):
            od, oi, *_ = fn(*args, k, *tail, k_out=k_out, loop=loop, **opts)
            torch.cuda.synchronize()
            assert torch.equal(od[live], kd[live])
            assert torch.equal(oi[live], ki[live])
    assert launch_counts()["probe_pool"] == before + 3 * 4


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("d", [768, 96, 1536])
def test_both_main_loops(rng, card, kind, d):
    """The loop that the rule chooses (wgmma at 768 and 96, where the last
    64-feature slice is half empty; staged at 1536, whose queries cannot
    be resident) and the staged loop asked for by name, each against the
    plain version; asking for the wgmma loop where it does not fit raises."""
    full, q, lay, n_slots = _setup(rng, d, card)
    fn, plain, args, tail, tol = _variants(full, q, lay, kind)
    want = "staged" if d == 1536 else "wgmma"
    assert probe_loop(*LAUNCH_KIND[kind], d, 10, False, 64) == want
    for k, opts in ((10, {}), (10, dict(pair=True)), (24, {}), (40, {}),
                    (10, dict(loop="staged"))):
        before = loop_launch_counts()
        out = fn(*args, k, *tail, **opts)
        after = loop_launch_counts()
        ran = opts.get("loop") or probe_loop(
            *LAUNCH_KIND[kind], d, k, False, 128 if opts.get("pair") else 64)
        assert after[ran] == before[ran] + 1
        _check(out, plain(*args, k, *tail), lay, n_slots, tol)
    if want == "staged":
        with pytest.raises(ValueError, match="wgmma loop"):
            fn(*args, 10, *tail, loop="wgmma")


def test_narrow_width_full_precision(rng, card):
    """d = 40: less than one 64-feature slice, zero-filled by the loads."""
    full, q, lay, n_slots = _setup(rng, 40, card)
    fn, plain, args, tail, tol = _variants(full, q, lay, "bf16")
    before = loop_launch_counts()["wgmma"]
    _check(fn(*args, 10, *tail), plain(*args, 10, *tail), lay, n_slots, tol)
    assert loop_launch_counts()["wgmma"] == before + 1


TWINS = (10, 40, 63, 127)   # bucket rows j and j + 1 hold one vector


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "f32", "int8q"])
@pytest.mark.parametrize("d", [768, 1536])
def test_equal_rows_and_the_stores_end(rng, card, kind, d):
    """Equal rows inside a tile and across the edges of tiles and work
    items come back lower store row first, in either main loop and every
    configuration; the last bucket ends with the store in a ragged tile
    (130 rows), so its last tile reaches past the store's end."""
    counts = [300, 50, 129, 1000, 130]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    x = rng.normal(size=(offsets[-1], d)).astype(np.float32)
    lo = np.array([o + j for o, c in zip(offsets, counts) for j in TWINS
                   if j + 1 < c])
    x[lo + 1] = x[lo]
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    pick = rng.choice(lo, size=400)
    qv = x[pick] + 0.05 * rng.normal(size=(400, d)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    home = np.searchsorted(offsets[1:], pick, side="right")
    probes = np.stack([home, (home + 1) % len(counts)], 1).astype(np.int32)
    lay = group_slots(torch.from_numpy(probes).to(card),
                      torch.from_numpy(offsets.astype(np.int32)).to(card),
                      torch.tensor(counts, dtype=torch.int32, device=card))
    n_slots = probes.size

    class Full:
        data_sorted = torch.from_numpy(x).to(card)
    if kind in ("int8", "int4", "int8q"):
        from tpulmi_torch.ops.quantize import quantize_rows_int4
        bits = 4 if kind == "int4" else 8
        codes, scales = (quantize_rows_int4 if bits == 4
                         else quantize_rows)(Full.data_sorted)
        tail_args = (lay.qidx, codes, scales, lay.blocks)
        qt = torch.from_numpy(qv).to(card)
        if kind == "int8q":
            fn, plain, tol = probe_topk_int8q, probe_topk_int8q_plain, 1e-5
            args, tail = (*quantize_rows(qt), *tail_args), (bits,)
        else:
            fn, plain, tol = probe_topk_quant, probe_topk_quant_plain, 1e-4
            args, tail = (qt.bfloat16(), *tail_args), (bits,)
    else:
        fn, plain, args, tail, tol = _variants(
            Full, torch.from_numpy(qv).to(card), lay, kind)
    live = lay.slot_of_row < n_slots
    hi_of = torch.full((int(offsets[-1]) + 1,), -1, device=card)
    hi_of[torch.from_numpy(lo).to(card)] = torch.from_numpy(lo + 1).to(card)
    for opts in ({}, dict(pair=True), dict(wl_pad=256, item_rows=128),
                 dict(wl_pad=256, item_rows=128, pair=True),
                 dict(loop="staged")):
        out = fn(*args, 10, *tail, **opts)
        torch.cuda.synchronize()
        assert "wl_pad" not in opts or int(out[2]) <= opts["wl_pad"]
        _check(out[:2], plain(*args, 10, *tail)[:2], lay, n_slots, tol)
        ids = out[1][live].long()
        follows = hi_of[torch.clamp(ids[:, :-1], min=0)]
        is_lo = (ids[:, :-1] >= 0) & (follows >= 0)
        assert int(is_lo.sum()) >= 400
        assert bool((ids[:, 1:] == follows)[is_lo].all())
        is_hi = torch.isin(ids, torch.from_numpy(lo + 1).to(card))
        ahead = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], 1)
        assert bool((ahead == ids - 1)[is_hi].all())


def test_kernels_refuse_what_they_do_not_take(rng, card):
    """On CUDA tensors a wrapper launches or raises; it never falls back."""
    full, q, lay, _ = _setup(rng, 40, card)       # 40 % 16 != 0
    store = quantize_store(full, bits=8)
    before = launch_counts()
    with pytest.raises(ValueError, match="d % 16"):
        probe_topk_quant(q.bfloat16(), lay.qidx, store.data_sorted,
                         store.scales, lay.blocks, 10, 8)
    with pytest.raises(ValueError, match="queries of"):
        probe_topk_quant(q.double(), lay.qidx, store.data_sorted,
                         store.scales, lay.blocks, 10, 8)
    with pytest.raises(ValueError, match="several devices"):
        probe_topk_quant(q.bfloat16().cpu(), lay.qidx, store.data_sorted,
                         store.scales, lay.blocks, 10, 8)
    with pytest.raises(ValueError, match="multiple of 128"):
        probe_topk(q.bfloat16(), lay.qidx, full.data_sorted.bfloat16(),
                   lay.blocks, 10, wl_pad=64, item_rows=96)
    with pytest.raises(ValueError, match="k_out"):
        probe_topk(q.bfloat16(), lay.qidx, full.data_sorted.bfloat16(),
                   lay.blocks, 10, k_out=129)
    assert launch_counts() == before


# ------------------------------------------- int8 queries in the wgmma loop
def _int8q(full, q, lay, bits):
    store = quantize_store(full, bits=bits)
    qc, qs = quantize_rows(q)
    return (qc, qs, lay.qidx, store.data_sorted, store.scales, lay.blocks)


@pytest.mark.parametrize("k", [10, 24])
@pytest.mark.parametrize("d", [768, 96, 32])
@pytest.mark.parametrize("bits", [8, 4])
def test_int8q_wgmma_equals_staged(rng, card, bits, d, k):
    """K3 in the wgmma loop (s8 x s8 sums, exact) equals the staged loop
    to the bit: dense, 128-row tile, worklist, the pool and their
    combinations; and it is the loop that the rule gives every one of
    them."""
    full, q, lay, n_slots = _setup(rng, d, card)
    args = _int8q(full, q, lay, bits)
    live = lay.slot_of_row < n_slots
    for opts in ({}, dict(pair=True), dict(wl_pad=8192, item_rows=128),
                 dict(wl_pad=8192, item_rows=256, pair=True),
                 dict(k_out=2 * k), dict(k_out=2 * k, pair=True),
                 dict(k_out=2 * k, wl_pad=8192, item_rows=128)):
        pool = "k_out" in opts
        nb = 128 if opts.get("pair") else 64
        assert probe_loop(1, bits, d, k, pool, nb) == "wgmma"
        before = loop_launch_counts()
        got = probe_topk_int8q(*args, k, bits, **opts)
        assert loop_launch_counts()["wgmma"] == before["wgmma"] + 1
        want = probe_topk_int8q(*args, k, bits, loop="staged", **opts)
        torch.cuda.synchronize()
        assert torch.equal(got[0][live], want[0][live]), opts
        assert torch.equal(got[1][live], want[1][live]), opts
        _check(got[:2], probe_topk_int8q_plain(*args, k, bits, **opts)[:2],
               lay, n_slots, 1e-5)


@pytest.mark.parametrize("k, k_out", [(10, 20), (10, 40), (40, 128)])
@pytest.mark.parametrize("bits", [8, 4])
def test_pool_gate_equals_staged(rng, card, bits, k, k_out):
    """K5 behind its gate, under int8 queries (exact sums): rows [0,
    k_out) equal to the staged loop's (which keeps no gate) and to the
    one-CTA-per-block kernel's to the bit, dense, with the worklist and
    with the 128-row tile; the exact prefix also to the plain version's
    to rounding (torch divides the scales by 127 through its reciprocal on
    a card, the kernels by a rounded division, so a near tie at rank k may
    move an extra: test_pool_kernel holds the extras to the definition)."""
    full, q, lay, n_slots = _setup(rng, 768, card)
    args = _int8q(full, q, lay, bits)
    live = lay.slot_of_row < n_slots
    want = probe_topk_int8q_plain(*args, k, bits, k_out=k_out)
    staged = probe_topk_int8q(*args, k, bits, k_out=k_out, loop="staged")
    dense = None
    for opts in ({}, dict(pair=True), dict(wl_pad=8192, item_rows=128),
                 dict(wl_pad=8192, item_rows=256, pair=True)):
        before = loop_launch_counts()
        got = probe_topk_int8q(*args, k, bits, k_out=k_out, **opts)
        assert loop_launch_counts()["wgmma"] == before["wgmma"] + 1
        torch.cuda.synchronize()
        dense = got if dense is None else dense
        # the exact prefix against the plain version; the extras against
        # the definition are test_pool_kernel's
        _check((got[0][:, :k], got[1][:, :k]), (want[0][:, :k],
                                                want[1][:, :k]),
               lay, n_slots, 1e-5)
        for other in (staged, dense):
            assert torch.equal(got[0][live], other[0][live]), opts
            assert torch.equal(got[1][live], other[1][live]), opts


@pytest.mark.parametrize("kind", ["int8q"])
@pytest.mark.parametrize("d", [96, 32])
def test_equal_rows_under_int8_queries(rng, card, kind, d):
    """Equal rows come back lower row first under int8 queries, in the
    wgmma loop, at narrow widths too (d = 32: one slice of 128 features,
    three quarters empty)."""
    test_equal_rows_and_the_stores_end(rng, card, kind, d)


# ------------------------------------------------- the build, reproducibly
# one build of the main path's shape cut to 50K rows: the k-means sample of
# 256 x 122 rows, two epochs of the router, the store laid out in 2048-row
# buckets
BUILD = dict(model_type="MLP-5", lr=0.003, n_categories=122, epochs=2,
             batch_size=1024, row_align=2048, seed=2023)
BUILD_SCRIPT = """
import sys, torch
from tpulmi_torch.build import build_digest, fused_build
from tpulmi_torch.data import synthetic_dataset
torch.use_deterministic_algorithms(True)
ds = synthetic_dataset(n={n}, n_queries=10, d_nav=96, d_search=768,
                       n_clusters=122, seed=2023)
nav, search = (torch.from_numpy(ds[k]).cuda() for k in ("data_nav",
                                                         "data_search"))
r = fused_build(nav, search, **{build})
torch.cuda.synchronize()
print(build_digest(r.centroids, r.model, r.data_sorted, r.ids_sorted,
                   r.offsets))
"""


def _build(dev, n=50_000):
    from tpulmi_torch.build import fused_build
    from tpulmi_torch.data import synthetic_dataset

    ds = synthetic_dataset(n=n, n_queries=10, d_nav=96, d_search=768,
                           n_clusters=122, seed=2023)
    nav, search = (torch.from_numpy(ds[k]).to(dev)
                   for k in ("data_nav", "data_search"))
    out = fused_build(nav, search, **BUILD)
    torch.cuda.synchronize()
    return out


def test_build_is_bit_reproducible(card):
    """Two builds in one process: centroids, router parameters and store
    equal to the bit (k-means sums each cluster in a fixed order)."""
    from tpulmi_torch.build import build_digest

    a, b = _build(card), _build(card)
    for name in ("centroids", "data_sorted", "ids_sorted", "offsets",
                 "counts", "pred_categories", "losses"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[n], sb[n]) for n in sa)
    assert build_digest(a.centroids, a.model, a.data_sorted, a.ids_sorted,
                        a.offsets) == build_digest(
        b.centroids, b.model, b.data_sorted, b.ids_sorted, b.offsets)


def test_build_under_deterministic_algorithms(card):
    """The same build with torch.use_deterministic_algorithms(True), in a
    process of its own so that the setting reaches no other test: no op of
    the build is one that torch knows to be order-dependent on CUDA."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    out = subprocess.run(
        [sys.executable, "-c", BUILD_SCRIPT.format(n=50_000, build=BUILD)],
        cwd=Path(__file__).resolve().parent.parent, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert len(out.stdout.split()[-1]) == 64


# ------------------------------------------- the persistent worklist (K4)
# (queries, store) of each variant that the wgmma loop's worklist takes:
# bfloat16 and float16 queries over a store of their type, over int8 and
# over packed-int4 codes; int8 queries over int8 and int4 codes
PERSISTENT_KINDS = {"bf16": (torch.bfloat16, 0), "f16": (torch.float16, 0),
                    "bf16-int8": (torch.bfloat16, 8),
                    "bf16-int4": (torch.bfloat16, 4),
                    "f16-int8": (torch.float16, 8),
                    "int8q-int8": (torch.int8, 8),
                    "int8q-int4": (torch.int8, 4)}


def _persistent_variant(full, q, lay, kind):
    """(wrapper, arguments up to k, after k, bytes of a query value, code
    bits) of a PERSISTENT_KINDS entry."""
    dtype, bits = PERSISTENT_KINDS[kind]
    if not bits:
        return (probe_topk, (q.to(dtype), lay.qidx,
                             full.data_sorted.to(dtype), lay.blocks), (), 2,
                0)
    store = quantize_store(full, bits=bits)
    tail = (lay.qidx, store.data_sorted, store.scales, lay.blocks)
    if dtype == torch.int8:
        qc, qs = quantize_rows(q)
        return probe_topk_int8q, (qc, qs, *tail), (bits,), 1, bits
    return probe_topk_quant, (q.to(dtype), *tail), (bits,), 2, bits


@pytest.mark.parametrize("ctas", [1, 7, 0], ids=["ctas1", "ctas7", "grid"])
@pytest.mark.parametrize("kind", list(PERSISTENT_KINDS))
def test_persistent_worklist_equals_dense(rng, card, kind, ctas):
    """The wgmma loop's worklist on a persistent grid of 1, 7 or (0) as
    many CTAs as the card holds: item kernel and merge equal the
    one-CTA-per-block wgmma launch to the bit, with and without the pool,
    with 64- and 128-row tiles, items of 128 and 1024 rows, a tight pad;
    the pieces it marks are those of the plain schedule; an undersized pad
    reports the true total."""
    full, q, lay, n_slots = _setup(rng, 256, card)
    fn, args, tail, qbytes, bits = _persistent_variant(full, q, lay, kind)
    live = lay.slot_of_row < n_slots
    for k, k_out in ((10, 0), (10, 20), (40, 0)):
        for pair, item_rows in ((False, 128), (False, 1024), (True, 128)):
            tile = 128 if pair else 64
            assert probe_loop(qbytes, bits, 256, k, k_out > k, tile) == \
                "wgmma"
            opts = dict(k_out=k_out, pair=pair, item_rows=item_rows)
            dense = fn(*args, k, *tail, k_out=k_out, pair=pair)
            want = int(build_worklist(lay.blocks, 1,
                                      item_rows * (2 if pair else 1))[2])
            for pad in (8192, want):
                before = loop_launch_counts()["wgmma"]
                parts = fn(*args, k, *tail, wl_pad=pad, ctas=ctas,
                           merge=False, **opts)
                assert loop_launch_counts()["wgmma"] == before + 1
                got = fn(*args, k, *tail, wl_pad=pad, ctas=ctas, **opts)
                torch.cuda.synchronize()
                assert int(got[2]) == int(parts.total) == want
                assert torch.equal(got[0][live], dense[0][live]), (k, opts)
                assert torch.equal(got[1][live], dense[1][live]), (k, opts)
                if ctas:
                    # the pieces of the plain schedule, at their first items
                    firsts = parts.block_items[:, 0].tolist()
                    starts = [firsts[b] + c0 for _, b, c0, _ in
                              worklist_pieces(parts.items, parts.total,
                                              lay.blocks,
                                              item_rows * (2 if pair else 1),
                                              tile, ctas)]
                    assert torch.nonzero(parts.written).flatten().tolist() \
                        == starts
                else:
                    # at least one piece a CTA, at most one an item
                    assert 0 < int(parts.written.sum()) <= want
            *_, total = fn(*args, k, *tail, wl_pad=max(want // 2, 1),
                           ctas=ctas, **opts)
            assert int(total) == want


# ----------------------------------------- the 128-row tile in clusters
# the variants whose 128-row tile takes the wgmma loop, and so the cluster:
# queries' dtype (int8: int8 query codes) and the store's code bits
CLUSTER_KINDS = {"bf16": (torch.bfloat16, 0), "f16": (torch.float16, 0),
                 "bf16-int8": (torch.bfloat16, 8),
                 "bf16-int4": (torch.bfloat16, 4),
                 "int8q-int8": (torch.int8, 8),
                 "int8q-int4": (torch.int8, 4)}
CLUSTER_TWINS = (31, 63, 127)   # across box edges (32 rows) and tile edges


def _cluster_store(rng, d, dev):
    """40 buckets of 60 to 400 rows in store order, but bucket 0 of 25
    times their mean, bucket 3 empty and bucket 7 of 5 rows; the last ends
    with the store in a ragged tile. Bucket rows j, j + 1 (j in
    CLUSTER_TWINS) are equal. 600 queries, noisy copies of twins, probe
    their twin's bucket first (a third of them the long one) and another
    second: fifty the empty bucket, a fifth dumped."""
    counts = rng.integers(60, 400, size=40)
    counts[0], counts[3], counts[7] = 25 * int(counts.mean()), 0, 5
    counts[-1] = 130
    offsets = np.concatenate([[0], np.cumsum(counts)])
    x = rng.normal(size=(offsets[-1], d)).astype(np.float32)
    lo = np.array([o + j for o, c in zip(offsets, counts)
                   for j in CLUSTER_TWINS if j + 1 < c])
    x[lo + 1] = x[lo]
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    n_q = 600
    pick = rng.choice(lo, size=n_q)
    pick[: n_q // 3] = rng.choice(lo[lo < counts[0]], size=n_q // 3)
    qv = x[pick] + 0.05 * rng.normal(size=(n_q, d)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    home = np.searchsorted(offsets[1:], pick, side="right")
    second = rng.integers(0, 40, size=n_q)
    second[n_q // 3: n_q // 3 + 50] = 3
    second = np.where(rng.random(n_q) < 0.2, 40, second)
    probes = np.stack([home, second], 1).astype(np.int32)
    lay = group_slots(torch.from_numpy(probes).to(dev),
                      torch.from_numpy(offsets[:-1].astype(np.int32)).to(dev),
                      torch.from_numpy(counts.astype(np.int32)).to(dev))
    return (torch.from_numpy(x).to(dev), torch.from_numpy(qv).to(dev), lay,
            probes.size, lo)


def _cluster_variant(x, qv, lay, kind):
    """(wrapper, plain version, arguments up to k, after k, tolerance,
    bytes of a query value, code bits) of a CLUSTER_KINDS entry."""
    dtype, bits = CLUSTER_KINDS[kind]
    if not bits:
        return (probe_topk, probe_topk_plain,
                (qv.to(dtype), lay.qidx, x.to(dtype), lay.blocks), (), 1e-4,
                2, 0)
    codes, scales = (quantize_rows_int4 if bits == 4 else quantize_rows)(x)
    tail = (lay.qidx, codes, scales, lay.blocks)
    if dtype == torch.int8:
        return (probe_topk_int8q, probe_topk_int8q_plain,
                (*quantize_rows(qv), *tail), (bits,), 1e-5, 1, bits)
    return (probe_topk_quant, probe_topk_quant_plain, (qv.to(dtype), *tail),
            (bits,), 1e-4, 2, bits)


@pytest.mark.parametrize("pool", [False, True], ids=["list", "pool"])
@pytest.mark.parametrize("kind", list(CLUSTER_KINDS))
def test_cluster_equals_one_cta_a_block(rng, card, kind, pool):
    """The 128-row tile's launch in clusters (the rule's, and 2 and 4 each
    asked for) equals its launch without a cluster (cluster=1) to the bit,
    with and without the pool, on a store with a bucket of 25 times the
    mean (its blocks fill clusters), an empty probed bucket, a bucket
    smaller than k, dumped slots, and equal rows across box and tile edges
    and in a ragged last tile past the store's end: the lower row first.
    It equals its plain version within the tolerance (the exact prefix),
    and under int8 queries the staged loop to the bit. The grouping reads
    the long bucket fewer times than one CTA a block."""
    d, k = 256, 10
    x, qv, lay, n_slots, lo = _cluster_store(rng, d, card)
    fn, plain, args, tail, tol, qbytes, bits = _cluster_variant(x, qv, lay,
                                                                kind)
    extra = dict(k_out=2 * k) if pool else {}
    assert probe_loop(qbytes, bits, d, k, pool, 128) == "wgmma"
    assert probe_cluster(qbytes, bits, d, k, pool, 128) == CLUSTER_CTAS
    reads = [cluster_reads(lay.blocks, c)["groups"] for c in (1, 2, 4)]
    assert reads[0] > reads[1] > reads[2]
    live = lay.slot_of_row < n_slots
    one = fn(*args, k, *tail, pair=True, cluster=1, **extra)
    before = launch_counts()["probe_cluster"]
    for c in (None, 2, 4):
        opts = {} if c is None else dict(cluster=c)
        got = fn(*args, k, *tail, pair=True, **opts, **extra)
        torch.cuda.synchronize()
        assert torch.equal(got[0][live], one[0][live]), c
        assert torch.equal(got[1][live], one[1][live]), c
    assert launch_counts()["probe_cluster"] == before + 3
    _check((one[0][:, :k], one[1][:, :k]), plain(*args, k, *tail), lay,
           n_slots, tol)
    if qbytes == 1:
        staged = fn(*args, k, *tail, pair=True, loop="staged", **extra)
        torch.cuda.synchronize()
        assert torch.equal(staged[0][live], one[0][live])
        assert torch.equal(staged[1][live], one[1][live])
    ids = one[1][live][:, :k].long()
    hi_of = torch.full((x.shape[0] + 1,), -1, device=card)
    hi_of[torch.from_numpy(lo).to(card)] = torch.from_numpy(lo + 1).to(card)
    follows = hi_of[torch.clamp(ids[:, :-1], min=0)]
    is_lo = (ids[:, :-1] >= 0) & (follows >= 0)
    assert int(is_lo.sum()) >= 500
    assert bool((ids[:, 1:] == follows)[is_lo].all())


def test_cluster_refused_where_it_does_not_apply(rng, card):
    """A cluster is the wgmma loop's one-CTA-per-block launch: asked for
    with the staged loop or a worklist it raises; the 64-row libraries
    refuse it (they are built without it); nothing falls back."""
    x, qv, lay, _, _ = _cluster_store(rng, 256, card)
    args = (qv.bfloat16(), lay.qidx, x.bfloat16(), lay.blocks, 10)
    before = launch_counts()
    with pytest.raises(ValueError, match="cluster"):
        probe_topk(*args, pair=True, cluster=2, loop="staged")
    with pytest.raises(ValueError, match="cluster"):
        probe_topk(*args, pair=True, cluster=4, wl_pad=4096)
    with pytest.raises(ValueError, match="cluster="):
        probe_topk(*args, pair=True, cluster=3)
    assert launch_counts() == before
    with pytest.raises(RuntimeError, match="CUDA error"):
        probe_topk(*args, cluster=2)


# ------------------------------------------------- host-store builds, prune
def _host_build_data():
    from tpulmi_torch.data import synthetic_dataset

    return synthetic_dataset(n=20000, n_queries=300, d_nav=32, d_search=128,
                             n_clusters=16, seed=5)


def _as_bits(t):
    t = t.detach().cpu()
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32,
                   torch.int8: torch.int8}[t.dtype])


@pytest.mark.parametrize("store_dtype", ["bfloat16", "float32", "int8",
                                         "int4"])
def test_host_store_build_on_card_equals_cpu_layout(card, store_dtype):
    """build_with_host_store on the card: `build`'s pred to the bit, and
    the store on the card is the host layout of that pred, byte for
    byte."""
    from tpulmi_torch import IndexConfig, LearnedIndex
    from tpulmi_torch.hoststore import host_tensor, layout_host_store

    ds = _host_build_data()
    cfg = IndexConfig(n_categories=16, epochs=2, row_align=256)
    ref = LearnedIndex(cfg, device=card)
    want_pred, _ = ref.build(ds["data_nav"], ds["data_search"])
    li = LearnedIndex(cfg, device=card)
    pred, _ = li.build_with_host_store(ds["data_nav"], ds["data_search"],
                                       store_dtype=store_dtype,
                                       overlap_upload=True)
    np.testing.assert_array_equal(pred, want_pred)
    arrays = layout_host_store(pred, ds["data_search"], 16, row_align=256,
                               store_dtype=store_dtype)
    st = li.built.store
    assert st.data_sorted.device.type == "cuda"
    assert torch.equal(_as_bits(st.data_sorted),
                       _as_bits(host_tensor(arrays.data_sorted)))
    for name in ("ids_sorted", "offsets", "counts"):
        np.testing.assert_array_equal(getattr(st, name).cpu().numpy(),
                                      getattr(arrays, name))
    if arrays.scales is not None:
        np.testing.assert_array_equal(st.scales.cpu().numpy(), arrays.scales)
    d, ids = li.search(ds["queries_nav"], ds["queries_search"], n_buckets=3)
    assert d.shape == (300, 10) and np.isfinite(d).all()


def test_overlapped_upload_equals_blocking_on_card(card):
    """The uploader thread's slabs on the copy stream give the blocking
    upload's bytes, also when the caller runs on a stream of its own."""
    from tpulmi_torch.hoststore import layout_and_upload

    rng = np.random.default_rng(3)
    pred = rng.integers(0, 9, size=30000).astype(np.int32)
    x = rng.normal(size=(30000, 96)).astype(np.float32)
    for store_dtype in ("bfloat16", "int8"):
        kw = dict(device=card, row_align=128, store_dtype=store_dtype,
                  chunk=4000)
        a_b, dev_b = layout_and_upload(pred, x, 9, overlap=False,
                                       slab_rows=1000, **kw)
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            a_o, dev_o = layout_and_upload(pred, x, 9, overlap=True,
                                           slab_rows=777, **kw)
            got = _as_bits(dev_o)
        assert torch.equal(got, _as_bits(dev_b))
        np.testing.assert_array_equal(a_o.ids_sorted, a_b.ids_sorted)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_xla_prune_equals_unpruned_on_card(card, kind):
    """The xla scan's threshold prune on the card: the unpruned scan's
    distances and ids to the bit, with rows skipped."""
    from dataclasses import replace

    from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig

    rng = np.random.default_rng(11)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
            np.float32)

    n, q, c = 20000, 256, 16
    cents, cents_nav = unit(rng.normal(size=(c, 24))), unit(
        rng.normal(size=(c, 12)))
    a, aq = rng.integers(0, c, size=n), rng.integers(0, c, size=q)
    data = unit(cents[a] + 0.03 * rng.normal(size=(n, 24)))
    nav = (cents_nav[a] + 0.03 * rng.normal(size=(n, 12))).astype(np.float32)
    qs = unit(cents[aq] + 0.03 * rng.normal(size=(q, 24)))
    qn = (cents_nav[aq] + 0.03 * rng.normal(size=(q, 12))).astype(np.float32)
    li = LearnedIndex(IndexConfig(n_categories=c, epochs=4, row_align=1),
                      device=card)
    li.build(nav, data)
    if kind == "int8":
        li.quantize()
    li.compute_bounds(chunk=4096)
    base = SearchConfig(k=10, backend="xla", compute_dtype=None
                        if kind != "bfloat16" else "bfloat16")
    d0, i0 = li.search(qn, qs, n_buckets=8, k=10, search_config=base)
    d1, i1 = li.search(qn, qs, n_buckets=8, k=10,
                       search_config=replace(base, prune_after=1))
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)
    assert li.last_scan_rows < li.last_nominal_rows
