"""The plan of the probe kernel's two main loops (which loop a launch
takes, its rings, its shared memory), reckoned in Python as the CUDA header
reckons it, and the tie rule that either loop's epilogue must keep: the
plain version against the JAX package's Pallas kernel in interpret mode on
a store with equal rows."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulmi.buckets import build_bucket_store
from tpulmi.ops.pallas_topk import pallas_probe_search
from tpulmi_torch.convert import store_from_arrays
from tpulmi_torch.ops import probe_topk as probe
from tpulmi_torch.ops.probe_topk import (SMEM_OPTIN_H100, common_loop,
                                         probe_loop, probe_search,
                                         smem_bytes, wgmma_stages)

torch.set_num_threads(1)

WIDTHS = [40, 96, 128, 256, 768, 1536]
MC = 256  # the Pallas kernel's data block; the store's row_align


def _codes_ok(d, bits):
    """The widths a store of `bits`-bit codes (0: full precision) takes."""
    return d % {0: 8, 8: 16, 4: 32}[bits] == 0


@pytest.mark.parametrize("tile_rows", [64, 128])
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("k", [10, 40, 128])
@pytest.mark.parametrize("d", WIDTHS)
def test_every_plan_fits(d, k, pool, tile_rows):
    """Whatever the rule chooses fits the card; the wgmma loop's rings have
    at least two stages and no stage more would fit; the staged loop is
    chosen only where the wgmma loop cannot run."""
    for bits in (0, 8, 4):
        if not _codes_ok(d, bits):
            continue
        loop = probe_loop(2, bits, d, k, pool, tile_rows)
        need = smem_bytes(k, tile_rows, pool, loop, d, bits)
        assert need <= SMEM_OPTIN_H100, (bits, loop, need)
        stages = wgmma_stages(d, bits, k, pool, tile_rows)
        most, most_codes, fewest = probe.WGMMA_STAGES
        if loop == "staged":
            assert stages == 0
            assert smem_bytes(k, tile_rows, pool, "wgmma", d, bits,
                              fewest) > SMEM_OPTIN_H100
            continue
        top = most_codes if bits else most
        assert fewest <= stages <= top
        if bits:
            assert stages in (8, 4, 3, 2)
        if stages < top:
            more = 8 if bits and stages == 4 else stages + 1
            assert smem_bytes(k, tile_rows, pool, "wgmma", d, bits,
                              more) > SMEM_OPTIN_H100
        # float32 queries never take the wgmma loop; int8 queries take it
        # over codes whenever their (half as wide) plan fits
        assert probe_loop(4, bits, d, k, pool, tile_rows) == "staged"
        int8q = bits and _wgmma_need(d, bits, 1, k, pool, tile_rows,
                                     fewest) <= SMEM_OPTIN_H100
        assert probe_loop(1, bits, d, k, pool, tile_rows) == (
            "wgmma" if int8q else "staged")


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("tile_rows", [64, 128])
def test_main_path_takes_the_wgmma_loop(bits, tile_rows):
    """300K x 768, k = 10, bfloat16 queries: the new loop, with the
    queries' 96 KB resident and rings beside them."""
    assert probe_loop(2, bits, 768, 10, False, tile_rows) == "wgmma"
    assert wgmma_stages(768, bits, 10, False, tile_rows) >= 3
    need = smem_bytes(10, tile_rows, False, "wgmma", 768, bits)
    assert 12 * 8192 < need <= SMEM_OPTIN_H100


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("k", [10, 128])
def test_wide_vectors_take_the_staged_loop(bits, k):
    """d = 1536: 192 KB of resident queries cannot fit beside anything."""
    assert probe_loop(2, bits, 1536, k, False, 64) == "staged"
    assert probe_loop(2, bits, 1536, k, True, 128) == "staged"
    assert smem_bytes(k, 64, False) == smem_bytes(k, 64, False, "staged",
                                                  1536, bits)


def test_plan_sizes():
    # the staged loop's need does not depend on the width
    assert smem_bytes(10, 64, False) == 69376
    # K1 on the main path: 1 KB + 96 KB of queries + 12 stages of 8 KB +
    # the barriers + the tile + 10 keys a slot + thresholds, rows, scales
    assert wgmma_stages(768, 0, 10, False, 64) == 12
    assert smem_bytes(10, 64, False, "wgmma", 768) == (
        1024 + 98304 + 12 * 8192 + 512 + 64 * 68 * 4 + 64 * 10 * 8 + 512
        + 1024)
    # K2: 8 stages of 8 KB of operands and 4 KB (int8) or 2 KB of codes
    assert wgmma_stages(768, 8, 10, False, 64) == 8
    assert wgmma_stages(768, 4, 10, False, 64) == 8
    # the pool's 64 KB leave short rings beside 96 KB of queries
    assert wgmma_stages(768, 8, 10, True, 64) == 3
    with pytest.raises(ValueError, match="main loop"):
        smem_bytes(10, 64, False, "other")


def test_common_loop_and_variant_option():
    # all launches alike under the rule: nothing to force
    assert common_loop(2, 0, 768, [(10, False, 64), (10, False, 128)]) is None
    assert common_loop(4, 0, 768, [(10, False, 64), (10, True, 128)]) is None
    # a pool with the 128-row tile over int4 codes at d = 768 cannot take
    # the wgmma loop, the plain launch can: held together under "staged"
    assert probe_loop(2, 4, 768, 10, True, 128) == "staged"
    assert common_loop(2, 4, 768, [(10, False, 64), (10, True, 128)]
                       ) == "staged"
    # the plain versions take the option and ignore it; a wrong name raises
    q = torch.zeros((1, 8))
    lay = probe.group_slots(torch.zeros((1, 1), dtype=torch.int32),
                            torch.tensor([0, 4], dtype=torch.int32),
                            torch.tensor([4], dtype=torch.int32))
    data = torch.ones((4, 8))
    a = probe.probe_topk_plain(q, lay.qidx, data, lay.blocks, 2)
    b = probe.probe_topk(q, lay.qidx, data, lay.blocks, 2, loop="staged")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="loop="):
        probe.probe_topk_plain(q, lay.qidx, data, lay.blocks, 2, loop="tma")


def test_pair_is_planned_with_the_launch_sizes(monkeypatch):
    """`resolve_tiling` holds the 128-row tile's need, in the loop that the
    launch would take, against the card's limit."""
    kw = dict(k=10, pool=False, device="cpu")
    assert probe.resolve_tiling(True, query_bytes=2, d=768, **kw)
    assert probe.resolve_tiling(True, query_bytes=2, code_bits=8, d=768, **kw)
    # a card with less shared memory than the wgmma plan assumes
    monkeypatch.setattr(probe, "smem_budget", lambda device: 150_000)
    assert not probe.resolve_tiling(True, query_bytes=2, d=768, **kw)
    assert probe.resolve_tiling(True, query_bytes=4, d=768, **kw)


# ------------------------------------------------------------ the tie rule
TWINS = (10, 40, 63, 127)   # bucket rows j and j + 1 hold one vector


def _twin_store(rng, d=128, sizes=(300, 129, 200), whole=False):
    """Buckets in store order whose rows j, j + 1 (j in TWINS) are equal:
    inside a tile, and across the edges of 64- and 128-row tiles. `whole`:
    small whole numbers instead of unit vectors, so that every product is
    exact in float32 whatever the order of its sum."""
    n = sum(sizes)
    data = (rng.integers(-3, 4, size=(n, d)) if whole
            else rng.normal(size=(n, d))).astype(np.float32)
    labels = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    starts = np.cumsum((0,) + sizes[:-1])
    lo = np.array([s + j for s, c in zip(starts, sizes) for j in TWINS
                   if j + 1 < c])
    data[lo + 1] = data[lo]
    if not whole:
        data /= np.linalg.norm(data, axis=1, keepdims=True)
    js = build_bucket_store(labels, data, len(sizes), pad_rows=MC,
                            row_align=MC)
    ts = store_from_arrays(np.asarray(js.data_sorted),
                           np.asarray(js.ids_sorted), np.asarray(js.offsets),
                           np.asarray(js.counts), js.n, js.pad_rows,
                           js.row_align, device="cpu")
    return data, labels, lo, js, ts


@pytest.mark.parametrize("mode", ["scalar", "group", "group2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_equal_rows_keep_the_lower_store_row(mode, dtype):
    rng = np.random.default_rng(2023)   # its own, whatever ran before
    data, labels, lo, js, ts = _twin_store(rng)
    # each query is a noisy copy of a twin and probes the twin's bucket
    pick = np.repeat(lo, 3)
    queries = data[pick] + 0.05 * rng.normal(
        size=(pick.size, data.shape[1])).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    probes = labels[pick][:, None].astype(np.int32)
    k = 10
    jd_, ji, _ = pallas_probe_search(
        jnp.asarray(probes), jnp.asarray(queries), js, k=k, qc=128, mc=MC,
        max_chunks=2, compute_dtype=getattr(jnp, dtype), extract_mode=mode,
        interpret=True)
    td, ti, _ = probe_search(torch.from_numpy(probes),
                             torch.from_numpy(queries), ts, k=k,
                             compute_dtype=getattr(torch, dtype))
    jd_, ji, td, ti = np.asarray(jd_), np.asarray(ji), td.numpy(), ti.numpy()
    np.testing.assert_allclose(td, jd_, atol=1e-5)
    # the twins lead each list with one distance, the lower row first (a
    # bucket keeps the dataset's order, so the lower id is the lower row)
    np.testing.assert_array_equal(ti[:, 0], pick)
    np.testing.assert_array_equal(ti[:, 1], pick + 1)
    np.testing.assert_array_equal(td[:, 0], td[:, 1])
    # and so says the Pallas kernel in its "scalar" mode: ids equal on the
    # twins and wherever distances are apart (its harvesting modes return
    # both twins too, in either order)
    if mode == "scalar":
        np.testing.assert_array_equal(ji[:, :2], ti[:, :2])
    np.testing.assert_array_equal(np.sort(ji[:, :2], axis=1), ti[:, :2])
    gap = np.full(td.shape, np.inf)
    step = np.diff(jd_, axis=1)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    apart = gap > 1e-5
    np.testing.assert_array_equal(ti[apart], ji[apart])
    # every twin in a list stands right before its equal of higher index
    hi = {int(r) + 1 for r in lo}
    for row in ti:
        for place, i in enumerate(row):
            if int(i) in hi:
                assert place > 0 and row[place - 1] == i - 1


@pytest.mark.parametrize("item_rows", [128, 256])
@pytest.mark.parametrize("pair", [False, True])
def test_equal_rows_across_work_items(item_rows, pair):
    """The worklist's merge keeps the rule across an item's edge (bucket
    rows 127/128 lie in two items of 128 rows). Whole-number vectors: the
    scores are exact and many rows tie, so every place must agree."""
    data, labels, lo, _, ts = _twin_store(np.random.default_rng(2023),
                                          whole=True)
    pick = np.repeat(lo, 2)
    queries = torch.from_numpy(data[pick])
    probes = torch.from_numpy(labels[pick][:, None].astype(np.int32))
    want = probe_search(probes, queries, ts, k=10,
                        compute_dtype=torch.float32)
    got = probe_search(probes, queries, ts, k=10, compute_dtype=torch.float32,
                       wl_pad=64, item_rows=item_rows, pair=pair)
    assert int(got[3]) <= 64
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1][:, 0].numpy(), pick)
    np.testing.assert_array_equal(got[1][:, 1].numpy(), pick + 1)


# ------------------------------------- int8 queries (K3) and the pool (K5)
def _header_constant(name):
    text = (Path(__file__).resolve().parent.parent / "tpulmi_torch" / "csrc"
            / "probe_wgmma.cuh").read_text()
    return int(re.search(rf"\b{name} = (\d+)", text).group(1))


def test_plan_constants_are_the_headers():
    """The Python plan reckons with the CUDA header's own constants."""
    assert probe.WGMMA_STAGES == (_header_constant("MAX_STAGES"),
                                  _header_constant("MAX_CODE_STAGES"),
                                  _header_constant("MIN_STAGES"))
    assert probe.SLICE_BYTES == _header_constant("SLICE_BYTES")
    assert SMEM_OPTIN_H100 == _header_constant("SMEM_LIMIT")
    assert _header_constant("BARRIER_BYTES") == 512


def _wgmma_need(d, bits, qb, k, pool, tile_rows, stages):
    """probe_wgmma.cuh::smem_bytes written out: alignment, resident
    queries (8 KB a slice of 128 bytes), the operand ring and a raw ring
    (over int4 codes under int8 queries: 64 bytes a row; over int8 codes
    none, the codes are the operand), barriers, pool, tile, lists,
    thresholds and rows, column scales."""
    raw = {(1, 8): 0, (1, 4): 64, (2, 8): 64, (2, 4): 32}[(qb, bits)]
    return (1024 + -(-d // (128 // qb)) * 8192
            + stages * tile_rows * (128 + raw) + 512
            + (64 * 128 * 8 if pool else 0) + 64 * (tile_rows + 4) * 4
            + 64 * k * 8 + 64 * 8 + 4 * tile_rows * 4)


@pytest.mark.parametrize("tile_rows", [64, 128])
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("k", [10, 24, 64])
@pytest.mark.parametrize("d", [768, 96])
@pytest.mark.parametrize("bits", [8, 4])
def test_int8_query_plan(bits, d, k, pool, tile_rows):
    """1-byte queries over int8 and int4 codes: the rule's loop, its rings
    and its shared memory as the header reckons them, and every plan
    within 232,448 bytes. Resident int8 queries take half the bytes of
    bfloat16 ones, so all of these launches but one take the wgmma loop:
    lists of 64 with the pool and the 128-row tile over int4 codes at
    d = 768, whose 64-byte raw ring leaves room for no 2 stages."""
    loop = probe_loop(1, bits, d, k, pool, tile_rows)
    stages = wgmma_stages(d, bits, k, pool, tile_rows, 1)
    misfit = (bits, d, k, pool, tile_rows) == (4, 768, 64, True, 128)
    assert loop == ("staged" if misfit else "wgmma")
    if misfit:
        assert stages == 0 and _wgmma_need(d, bits, 1, k, pool, tile_rows,
                                           2) > SMEM_OPTIN_H100
        assert smem_bytes(k, tile_rows, pool, loop) <= SMEM_OPTIN_H100
        return
    assert stages >= 2
    raw = probe.raw_row_bytes(bits, 1)
    assert raw == (0 if bits == 8 else 64)
    need = smem_bytes(k, tile_rows, pool, loop, d, bits, query_bytes=1)
    assert need == _wgmma_need(d, bits, 1, k, pool, tile_rows, stages)
    assert need <= SMEM_OPTIN_H100
    most, most_codes, _ = probe.WGMMA_STAGES
    if raw:     # converters: 8, 4, 3 or 2 stages
        assert stages in (8, 4, 3, 2)
        more = 8 if stages == 4 else stages + 1
        top = most_codes
    else:       # the loads land in the operand ring: any count up to 12
        assert stages <= most
        more, top = stages + 1, most
    if stages < top:
        assert _wgmma_need(d, bits, 1, k, pool, tile_rows,
                           more) > SMEM_OPTIN_H100
    # the queries' bytes: half of bfloat16's at the same width
    assert (smem_bytes(k, tile_rows, pool, "wgmma", d, bits, 2, 2)
            - smem_bytes(k, tile_rows, pool, "wgmma", d, bits, 2, 1)
            - 2 * tile_rows * (probe.raw_row_bytes(bits, 2) - raw)
            == (-(-d // 64) - -(-d // 128)) * 8192)


@pytest.mark.parametrize("tile_rows", [64, 128])
@pytest.mark.parametrize("bits", [8, 4])
def test_main_path_int8_queries_take_the_wgmma_loop(bits, tile_rows):
    """300K x 768, k = 10, int8 queries: 48 KB of resident queries, and
    over int8 codes a ring fed by TMA alone (12 stages at the 64-row
    tile), over int4 codes the converters' 8 or 4."""
    assert probe_loop(1, bits, 768, 10, False, tile_rows) == "wgmma"
    stages = wgmma_stages(768, bits, 10, False, tile_rows, 1)
    assert stages == {(8, 64): 12, (8, 128): 8, (4, 64): 8,
                      (4, 128): 4}[(bits, tile_rows)]
    need = smem_bytes(10, tile_rows, False, "wgmma", 768, bits,
                      query_bytes=1)
    assert 6 * 8192 < need <= SMEM_OPTIN_H100


# (query bytes, code bits, tile rows) -> stages of the pool's plan at
# d = 768, k = 10; 0: the staged loop
K5_STAGES = {(2, 8, 64): 3, (2, 8, 128): 0, (2, 4, 64): 4, (2, 4, 128): 0,
             (1, 8, 64): 11, (1, 8, 128): 4, (1, 4, 64): 4, (1, 4, 128): 3}


@pytest.mark.parametrize("qb, bits, tile_rows", sorted(K5_STAGES))
def test_pool_plan_stages(qb, bits, tile_rows):
    """K5's rings beside its 64 KB of keys: the gate and the swizzle take
    no shared memory, so bfloat16 queries keep 3 or 4 stages at the 64-row
    tile and none at the 128-row tile (the staged loop), while int8
    queries now fit at both."""
    stages = wgmma_stages(768, bits, 10, True, tile_rows, qb)
    assert stages == K5_STAGES[(qb, bits, tile_rows)]
    assert probe_loop(qb, bits, 768, 10, True, tile_rows) == (
        "wgmma" if stages else "staged")
