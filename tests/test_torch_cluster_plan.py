"""The thread-block cluster of the 128-row tile's launch, planned in plain
Python as csrc/probe_wgmma.cuh plans it: which CTAs of a cluster share a
bucket's store tiles (groups), which boxes of a stage each CTA loads, the
multicast masks, the barriers' counts and the rule that gives a launch its
cluster, held on real `group_slots` layouts against `bucket_runs`; the plain
versions, which ignore `cluster=`; and the slice's plain version against
the JAX package's paired Pallas kernel in interpret mode."""

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
from tpulmi_torch.ops.probe_topk import (BLOCK_SLOTS, CLUSTER_CTAS,
                                         CLUSTER_SIZES, block_rows,
                                         bucket_runs, cluster_groups,
                                         cluster_of, cluster_reads,
                                         cta_group, group_slots,
                                         probe_cluster, probe_loop,
                                         probe_search)
from tpulmi_torch.ops.quantize import quantize_rows, quantize_rows_int4

torch.set_num_threads(1)

N_CAT = 40
LAYOUTS = ["skewed", "empty", "dumped", "spanning", "sparse"]


def _layout(kind):
    """A `group_slots` layout of one kind, from its own seed:
    - skewed: one bucket of 25 times the others' mean, probed by a third of
      the slots, so that its blocks fill whole clusters;
    - empty: an empty bucket probed by a hundred slots, beside a bucket of
      fewer rows than a box;
    - dumped: a fifth of the later probes dumped (probe id N_CAT);
    - spanning: eight buckets probed by hundreds of slots each, so that
      each spans clusters;
    - sparse: few slots over many buckets, so that most blocks hold a few
      live slots and the clusters mix buckets and empty blocks.
    Every layout ends in blocks without live slots (`group_slots` sizes it
    for the worst case)."""
    g = torch.Generator().manual_seed(LAYOUTS.index(kind) + 11)
    sizes = (torch.rand(N_CAT, generator=g) * 3000).long() + 100
    q, p = 1200, 2
    if kind == "skewed":
        sizes[0] = 25 * int(sizes.float().mean())
    if kind == "empty":
        sizes[3], sizes[5] = 0, 20
    if kind == "spanning":
        sizes = sizes[:8]
    if kind == "sparse":
        q = 40
    n_cat = int(sizes.numel())
    probes = torch.multinomial(sizes.float().clamp(min=1).expand(q, -1), p,
                               generator=g)
    if kind == "skewed":
        probes[: q // 3, 0] = 0
    if kind == "empty":
        probes[:100, 1] = 3
    if kind == "dumped":
        drop = torch.rand((q, p), generator=g) < 0.2
        drop[:, 0] = False
        probes = torch.where(drop, n_cat, probes)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long),
                         torch.cumsum(sizes, 0)])
    lay = group_slots(probes.int(), offsets[:-1].int(), sizes.int())
    return lay, sizes, q * p


def _run_blocks(rows):
    return sorted({int(r) // BLOCK_SLOTS for r in rows.tolist()})


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("kind", LAYOUTS)
def test_groups_read_each_bucket_once_a_cluster(kind, cluster):
    """The groups of a launch are the probed buckets (`bucket_runs`) cut at
    the clusters' edges: a bucket's live blocks, each in exactly one group,
    every group a contiguous run of ranks of one cluster with the bucket's
    rows; so a bucket is read once for each cluster its blocks touch. The
    kernel's own walk (`cta_group`) puts every CTA where the plan does,
    and leaves alone every block without rows and every CTA past the
    last block."""
    lay, _, _ = _layout(kind)
    blocks = lay.blocks
    n_blocks = int(blocks.shape[0])
    rows = block_rows(blocks)
    groups = cluster_groups(blocks, cluster)
    runs = bucket_runs(blocks)
    by_rows = {}
    for g in groups:
        by_rows.setdefault((g.start, g.rows), []).append(g)
        assert 0 <= g.first and g.first + g.size <= cluster
        assert g.mask == sum(1 << r for r in range(g.first,
                                                   g.first + g.size))
        assert g.mask < 1 << cluster
        for j, b in enumerate(g.blocks(cluster)):
            assert b // cluster == g.cluster
            assert rows[b] == (g.start, g.rows)
            assert cta_group(rows, b, cluster) == (g.first, g.size, j)
    assert len(by_rows) == len(runs)
    grouped = set()
    for start, cnt, slot_rows in runs:
        mine = _run_blocks(slot_rows)
        got = [b for g in by_rows[(start, cnt)] for b in g.blocks(cluster)]
        assert sorted(got) == mine            # each live block once
        assert len(by_rows[(start, cnt)]) == len({b // cluster
                                                  for b in mine})
        grouped.update(mine)
    for b in range(-(-n_blocks // cluster) * cluster):
        if b not in grouped:
            assert cta_group(rows, b, cluster)[1:] == (1, 0)
    reads = cluster_reads(blocks, cluster)
    assert reads == {"groups": len(groups), "buckets": len(runs),
                     "rows_read": sum(g.rows for g in groups),
                     "bucket_rows": sum(cnt for _, cnt, _ in runs)}
    if cluster == 1:
        assert reads["groups"] == len(grouped)   # one read a live block


def test_layouts_hold_the_edges():
    """What the layouts above are for: a bucket of more than 20 times the
    mean, an empty probed bucket, dumped slots, buckets whose blocks span
    clusters, clusters that hold both a group and an empty block, and a
    grid that is no multiple of the cluster."""
    lay, sizes, _ = _layout("skewed")
    assert int(sizes[0]) > 20 * float(sizes[1:].float().mean())
    lay, _, _ = _layout("empty")
    b = lay.blocks
    assert bool(((b[:, 1] == 0) & (b[:, 2] > 0)).any())
    lay, _, n_slots = _layout("dumped")
    assert int(lay.slot_counts.sum()) < n_slots
    for c in (2, 4):
        lay, _, _ = _layout("spanning")
        spans = [len({blk // c for blk in _run_blocks(r)})
                 for _, _, r in bucket_runs(lay.blocks)]
        assert max(spans) >= 3
        mixed = 0
        for kind in LAYOUTS:
            lay, _, _ = _layout(kind)
            rows = block_rows(lay.blocks)
            live = {b for g in cluster_groups(lay.blocks, c)
                    for b in g.blocks(c)}
            mixed += sum(1 for k in range(-(-len(rows) // c))
                         if any(b in live for b in range(k * c, k * c + c))
                         and not all(b in live
                                     for b in range(k * c, k * c + c)))
        assert mixed > 0
    assert any(_layout(k)[0].blocks.shape[0] % 4 for k in LAYOUTS)


def box_loads(tile_rows, cluster_ctas, group_size, rows_left):
    """The boxes of one stage that each rank of a group loads
    (probe_wgmma.cuh, the loader): a stage is `cluster_ctas` boxes of
    tile_rows / cluster_ctas store rows; those that hold a row of the
    bucket (`rows_left` from the tile's first row) are loaded, rank j the
    j-th, j + G-th, ...; every CTA of the group counts all of them on its
    full barrier."""
    box = tile_rows // cluster_ctas
    n = min(cluster_ctas, -(-rows_left // box))
    return [list(range(j, n, group_size)) for j in range(group_size)]


# warps that arrive on a stage's empty barrier: the consumers and, over
# codes that are not the operand, the converters (probe_wgmma.cuh)
CONSUMER_WARPS = CONVERTER_WARPS = 4


def barrier_counts(group_size, raw):
    """The counts probe_wgmma.cuh initialises a CTA's barriers with in a
    group of `group_size`: an operand stage's empty barrier takes every
    consumer warp of the group where the loads land in the operand ring,
    and only the CTA's own where converters fill it; a raw stage's empty
    barrier one converter warp of each CTA of the group; `done` every
    arriving warp of the group."""
    return {"op_empty": CONSUMER_WARPS * (1 if raw else group_size),
            "raw_empty": group_size,
            "done": group_size * (CONSUMER_WARPS
                                  + (CONVERTER_WARPS if raw else 0))}


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
def test_box_loads_split_each_stage(cluster):
    """A stage is `cluster` boxes of 128 / cluster rows; the boxes that hold
    a row of the bucket are loaded, each by exactly one rank of the group,
    rank j every G-th from j; the rows they hold cover the tile's rows of
    the bucket, and no box lies wholly past them."""
    box = 128 // cluster
    for size in range(1, cluster + 1):
        for left in (1, 15, 16, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129,
                     500):
            shares = box_loads(128, cluster, size, left)
            assert len(shares) == size
            loaded = sorted(i for s in shares for i in s)
            n = len(loaded)
            assert loaded == list(range(n))
            for j, share in enumerate(shares):
                assert all(i % size == j for i in share)
            assert n * box >= min(left, 128) > (n - 1) * box
    # without a cluster, one box: the whole tile, as before
    assert box_loads(128, 1, 1, 5) == [[0]]


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_barrier_counts_are_the_arrivals(size, raw):
    """Each barrier's count is what one phase brings to each CTA of a
    group: every consumer warp of every CTA of the group arrives on each
    CTA's operand empty barrier where the loads land there; where
    converters fill the operand ring, the consumers arrive on their own
    CTA's only and one converter warp of every CTA on each CTA's raw empty
    barrier; at the end every arriving warp of every CTA on each CTA's
    `done`. A group of one keeps the counts of a launch without a
    cluster."""
    arrive = {"op_empty": [0] * size, "raw_empty": [0] * size,
              "done": [0] * size}
    for cta in range(size):
        for _ in range(CONSUMER_WARPS):
            for peer in range(size) if not raw else [cta]:
                arrive["op_empty"][peer] += 1
            for peer in range(size):
                arrive["done"][peer] += 1
        if raw:
            for peer in range(size):     # the one warp that took the stage
                arrive["raw_empty"][peer] += 1
            for _ in range(CONVERTER_WARPS):
                for peer in range(size):
                    arrive["done"][peer] += 1
    want = barrier_counts(size, raw)
    for name, counts in arrive.items():
        if name == "raw_empty" and not raw:
            continue
        assert counts == [want[name]] * size, name
    if size == 1:
        assert want["op_empty"] == CONSUMER_WARPS
        assert want["raw_empty"] == 1


def _header_constant(name):
    text = (Path(__file__).resolve().parent.parent / "tpulmi_torch" / "csrc"
            / "probe_wgmma.cuh").read_text()
    return int(re.search(rf"\b{name} = (\d+)", text).group(1))


# probe_common.cuh::cluster_of, written down: (main loop, tile rows,
# worklist) -> CTAs of a cluster
CLUSTER_RULE = {("wgmma", 128, False): 2, ("wgmma", 128, True): 1,
                ("wgmma", 64, False): 1, ("wgmma", 64, True): 1,
                ("staged", 128, False): 1, ("staged", 128, True): 1,
                ("staged", 64, False): 1, ("staged", 64, True): 1}
# (query bytes, code bits, pool) -> the cluster of the 128-row tile's
# dense launch at d = 768, k = 10: every variant that takes the wgmma loop
# there (bfloat16 / float16 queries over their own type and over int8 and
# int4 codes, int8 queries over int8 and int4 codes; the pool only under
# int8 queries, bfloat16 queries with the pool take the staged loop)
MAIN_SHAPE = {(2, 0, False): 2, (2, 8, False): 2, (2, 4, False): 2,
              (1, 8, False): 2, (1, 4, False): 2, (2, 0, True): 1,
              (2, 8, True): 1, (2, 4, True): 1, (1, 8, True): 2,
              (1, 4, True): 2, (4, 0, False): 1, (4, 8, False): 1}


def test_cluster_rule_is_the_headers():
    """The Python rule reckons with the CUDA header's constants and gives
    the table written down from probe_common.cuh::cluster_of; at the main
    path's shape each variant's cluster follows its main loop."""
    assert CLUSTER_CTAS == _header_constant("CLUSTER_CTAS")
    assert CONSUMER_WARPS == _header_constant("CONSUMER_WARPS")
    assert CONVERTER_WARPS == _header_constant("CONVERTER_WARPS")
    header = (Path(__file__).resolve().parent.parent / "tpulmi_torch" / "csrc"
              / "probe_wgmma.cuh").read_text()
    ok = re.search(r"cluster_ok\(int c\) \{\s*return ([^;]*);", header)
    assert sorted(int(c) for c in re.findall(r"c == (\d+)", ok.group(1))) \
        == list(CLUSTER_SIZES)
    for (loop, tile, worklist), c in CLUSTER_RULE.items():
        assert cluster_of(loop, tile, worklist) == c
    for (qb, bits, pool), c in MAIN_SHAPE.items():
        assert probe_cluster(qb, bits, 768, 10, pool, 128) == c
        assert c == cluster_of(probe_loop(qb, bits, 768, 10, pool, 128),
                               128, False)
        assert probe_cluster(qb, bits, 768, 10, pool, 128, True) == 1
        assert probe_cluster(qb, bits, 768, 10, pool, 64) == 1


def _tiny(seed=5, d=64):
    g = torch.Generator().manual_seed(seed)
    sizes = torch.tensor([300, 0, 20, 700, 129])
    x = torch.randn((int(sizes.sum()), d), generator=g)
    x = x / x.norm(dim=1, keepdim=True)
    q = torch.randn((90, d), generator=g)
    q = q / q.norm(dim=1, keepdim=True)
    probes = torch.stack([torch.randperm(5, generator=g)[:2]
                          for _ in range(90)])
    probes[:10, 1] = 5                           # dumped
    offsets = torch.cat([torch.zeros(1, dtype=torch.long),
                         torch.cumsum(sizes, 0)])[:-1]
    lay = group_slots(probes.int(), offsets.int(), sizes.int())
    return x, q, lay


def test_plain_versions_ignore_cluster():
    """On CPU tensors every wrapper takes `cluster=` and returns what it
    returns without it; a size the kernel does not take raises."""
    x, q, lay = _tiny()
    codes, scales = quantize_rows(x)
    c4, s4 = quantize_rows_int4(x)
    qc, qs = quantize_rows(q)
    calls = [(probe.probe_topk, (q.bfloat16(), lay.qidx, x.bfloat16(),
                                 lay.blocks, 10)),
             (probe.probe_topk_quant, (q, lay.qidx, codes, scales,
                                       lay.blocks, 10, 8)),
             (probe.probe_topk_int8q, (qc, qs, lay.qidx, c4, s4, lay.blocks,
                                       10, 4))]
    for fn, args in calls:
        want = fn(*args, pair=True)
        for c in CLUSTER_SIZES:
            for extra in ({}, dict(k_out=20)):
                got = fn(*args, pair=True, cluster=c, **extra)
                base = fn(*args, pair=True, **extra) if extra else want
                assert torch.equal(got[0], base[0])
                assert torch.equal(got[1], base[1])
        for bad in (3, -1, 8):
            with pytest.raises(ValueError, match="cluster="):
                fn(*args, pair=True, cluster=bad)


MC = 256  # the Pallas kernel's data block; the store's row_align


def test_slice_against_the_pallas_pair_kernel():
    """The 128-row tile's search (on the card: the cluster launch; here its
    plain version) against the JAX package's paired Pallas kernel, on a
    store with one bucket of 25 times the others' mean, an empty probed
    bucket and dumped slots."""
    rng = np.random.default_rng(23)
    c, d, q = 9, 128, 80
    counts = rng.integers(40, 120, size=c)
    counts[0], counts[4] = 25 * int(counts[1:].mean()), 0
    labels = np.repeat(np.arange(c), counts).astype(np.int32)
    data = rng.normal(size=(labels.size, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    probes = np.stack([rng.permutation(c)[:2] for _ in range(q)]).astype(
        np.int32)
    probes[: q // 2, 0] = 0
    probes[q // 2: q // 2 + 10, 1] = 4
    probes[-10:, 1] = c                           # dumped
    js = build_bucket_store(labels, data, c, pad_rows=MC, row_align=MC)
    ts = store_from_arrays(np.asarray(js.data_sorted),
                           np.asarray(js.ids_sorted), np.asarray(js.offsets),
                           np.asarray(js.counts), js.n, js.pad_rows,
                           js.row_align, device="cpu")
    max_bucket = int(np.asarray(js.counts).max())
    jd_, ji, _ = pallas_probe_search(
        jnp.asarray(probes), jnp.asarray(queries), js, k=10, qc=BLOCK_SLOTS,
        mc=MC, max_chunks=-(-max_bucket // MC), compute_dtype=jnp.float32,
        extract_mode="group2", interpret=True, pair=True)
    td, ti, _ = probe_search(torch.from_numpy(probes),
                             torch.from_numpy(queries), ts, k=10,
                             compute_dtype=torch.float32, pair=True)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd_), atol=1e-5)
    gap = np.full(td.shape, np.inf)
    step = np.diff(np.asarray(jd_), axis=1)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    apart = gap > 1e-5
    apart[:, -1] = False
    np.testing.assert_array_equal(ti.numpy()[apart], np.asarray(ji)[apart])
