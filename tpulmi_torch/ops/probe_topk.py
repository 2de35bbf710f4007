"""The probe phase: every (query, probe) slot's exact top-k over its probed
bucket, then the per-query merge.

Counterpart of ``tpulmi/ops/pallas_topk.py::pallas_probe_search``. The work
around the kernel is plain torch, as it is plain JAX there:

1. `group_slots`: a stable argsort of the slots by bucket, laid out in
   blocks of `BLOCK_SLOTS` so each block belongs to one bucket; dump slots
   (probe id == n_categories) go to the discard row. Per block: the bucket's
   first store row, its row count and the block's live slots.
2. `probe_topk`: the kernel (csrc/probe_topk.cu) on CUDA tensors; its plain
   version, `probe_topk_plain`, on CPU tensors. A quantized store goes to
   `probe_topk_quant` (int8 or packed int4 codes, queries in a float type)
   or, with int8 queries, to `probe_topk_int8q` (int8 x int8 with int32
   sums; the query's scale is applied to the finished lists here, outside
   the kernel); both are csrc/probe_topk_quant.cu, each with its plain
   version.
3. `merge_slots`: scatter per-slot results to (query, rank), a stable
   rank-major merge (ties go to the earlier probe rank), and the
   store-row -> dataset-id gather.

Every wrapper and every plain version takes the same four variant options,
which select further configurations of the one kernel
(csrc/probe_common.cuh) and replace the `pair`, `pool` and flat-worklist
configurations of the TPU kernel:

- ``pair``: tiles of 128 store rows instead of 64 (the ``*_pair``
  libraries). The result does not depend on the tile height, so the plain
  version ignores it (outside a worklist, where it doubles an item's rows).
- ``k_out > k``, the rerank pool: columns [0, k) of a slot are its exact
  top-k; columns [k, k_out) are rerank candidates, defined here as follows.
  ``pool[c]`` is the row of smallest distance (ties to the lower row) among
  the bucket's rows with ``(row - bucket start) % 128 == c``; the extras are
  the ``k_out - k`` smallest pool entries whose row is not in the exact
  top-k, ascending, ``(10000, -1)`` where fewer exist. The TPU kernel fills
  its pool lanes only from the tiles it happens to harvest, so its extras
  depend on its tile sizes and are not these row for row; both meet the
  same contract (exact prefix, ascending row, ids carry their distances,
  no id of the prefix repeated), which is all the exact rerank needs.
- ``wl_pad > 0``, the flat worklist: one work item per live (slot block,
  chunk of ``item_rows`` store rows) pair, block-major, built on the device
  (`build_worklist`). The wgmma loop walks it on a persistent grid: each
  CTA takes a contiguous range of the items, balanced by the tiles they
  scan (`worklist_pieces` is its schedule in plain Python), keeps a
  block's queries, lists and pool across the block's consecutive items,
  and writes the partial lists of each such run, a piece, once, to the
  rows of the piece's first item, which it marks in ``written``; the
  staged loop runs one CTA per item and marks each. A second kernel (csrc/merge_items.cu) merges a block's written pieces in
  chunk order. The call then also returns the true item total; when it
  exceeds ``wl_pad`` the trailing items were dropped, the result is invalid
  and the caller runs again with a larger pad. With ``pair`` an item spans
  ``2 * item_rows`` rows. ``ctas`` (checks only) fixes the persistent
  grid's CTA count, which is otherwise what the card holds at once; the
  plain version with ``ctas`` lays out its parts by that schedule, without
  it as one piece per item.
- ``cluster``: the 128-row tile's one-CTA-per-block launch in the wgmma
  loop runs as thread-block clusters of `CLUSTER_CTAS` CTAs
  (`cluster_of`), in which the CTAs of one bucket's blocks read each store
  tile once, by TMA multicast, where each block read it before
  (`cluster_groups` is the grouping in plain Python). ``cluster`` (checks
  and timing) forces the CTAs of a cluster: 1 for none, 2 or 4; the 64-row
  libraries take more than 1 only when built with ``PROBE_CLUSTER_ALL``.
  The result does not depend on it, so the plain versions ignore it. The
  clusters are slower than the launch without one on an H100 (PERF.md):
  what holds the loop is not the reads they save.

The kernel has two main loops that compute one function
(csrc/probe_wgmma.cuh, csrc/probe_common.cuh). `probe_loop` is the rule
that chooses, from the sizes of a launch alone: the wgmma loop for bfloat16
and float16 queries, and for int8 queries over int8 or int4 codes, whenever
its shared memory (`smem_bytes`, with the block's queries resident) fits,
else the staged loop. ``loop="staged"`` or
``"wgmma"`` asks for one by name, for checks that hold the two against each
other; the wgmma loop raises where the rule would not choose it.
"""

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import torch

from tpulmi_torch.ops.distance import SENTINEL_DIST
from tpulmi_torch.ops.quantize import int_dot, quantize_rows, unpack_int4
from tpulmi_torch.utils.logging import get_logger
from tpulmi_torch.utils.profiling import count, counters, reset, span

log = get_logger("tpulmi_torch.probe")

BLOCK_SLOTS = 64   # slots per kernel block (QB in csrc/probe_common.cuh)
MAX_K = 128        # the kernel keeps at most 128 candidates per slot
POOL_CLASSES = 128  # residue classes of the rerank pool (POOL in the header)
# opt-in shared memory per block of an H100, the kernels' target; a CUDA
# device is asked for its own value (`smem_budget`)
SMEM_OPTIN_H100 = 232448
# most device bytes the worklist's scratch may take (`worklist_scratch_bytes`);
# past it the caller keeps the one-CTA-per-block launch
WL_SCRATCH_BYTES_MAX = 2 << 30
# input dtypes of the kernel, by the code its C entry point takes
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
INT8_QUERY_CODE = 3   # the quantized kernel's code for int8 query codes
Q_LEVELS = {8: 127.0, 4: 7.0}   # dequantization divisor by code width


@dataclass
class SlotLayout:
    qidx: torch.Tensor        # (n_blocks*BLOCK_SLOTS,) int32 query of each row
    slot_of_row: torch.Tensor  # (n_blocks*BLOCK_SLOTS,) int64 slot; n_slots = discard
    blocks: torch.Tensor      # (n_blocks, 3) int32: first store row, rows, live slots
    slot_counts: torch.Tensor  # (n_categories,) int64 slots per bucket


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])


def group_slots(probe_buckets: torch.Tensor, offsets: torch.Tensor,
                counts: torch.Tensor, qb: int = BLOCK_SLOTS) -> SlotLayout:
    """Bucket-grouped, block-aligned slot layout. Sized for the worst case
    (n_slots + n_categories*qb rows), so it needs no host sync."""
    q, p = probe_buckets.shape
    n_slots = q * p
    n_cat = int(counts.shape[0])
    dev = probe_buckets.device
    slots = probe_buckets.reshape(n_slots).to(torch.int64)
    order = torch.argsort(slots, stable=True)
    # dump slots carry id n_cat: count them in an extra bin and drop it
    # (scatter_add_, not bincount: bincount reads its size back to the host)
    slot_counts = torch.zeros(n_cat + 1, dtype=torch.int64, device=dev
                              ).scatter_add_(0, slots, torch.ones_like(slots)
                                             )[:n_cat]
    raw_off = _exclusive_cumsum(slot_counts)
    aligned_off = _exclusive_cumsum(-(-slot_counts // qb) * qb)
    s_align = -(-(n_slots + n_cat * qb) // qb) * qb
    n_blocks = s_align // qb
    sorted_b = slots[order]
    # dump slots sort last; their positions fall past every live bucket
    pos = (aligned_off[sorted_b] + torch.arange(n_slots, device=dev)
           - raw_off[sorted_b])
    slot_of_row = torch.full((s_align,), n_slots, dtype=torch.int64,
                             device=dev)
    slot_of_row[pos] = torch.where(sorted_b < n_cat, order,
                                   torch.full_like(order, n_slots))
    qidx = torch.clamp(slot_of_row // p, max=q - 1).to(torch.int32)

    blk_start = torch.arange(n_blocks, device=dev) * qb
    blk_bucket = torch.clamp(
        torch.searchsorted(aligned_off[1:].contiguous(), blk_start,
                           right=True), max=n_cat - 1)
    qlim = slot_counts[blk_bucket] - (blk_start - aligned_off[blk_bucket])
    blocks = torch.stack([offsets.to(dev)[blk_bucket].to(torch.int64),
                          counts.to(dev)[blk_bucket].to(torch.int64), qlim],
                         dim=1).to(torch.int32).contiguous()
    return SlotLayout(qidx, slot_of_row, blocks, slot_counts)


def list_lanes(k: int) -> int:
    """List entries per lane (KPL in the header): 32 of them hold k."""
    return 1 if k <= 32 else (2 if k <= 64 else 4)


LOOPS = ("staged", "wgmma")   # the kernel's main loops, by their C code
# query types by the code the C entry points take -> bytes of one value
_QUERY_BYTES = {0: 2, 1: 2, 2: 4, 3: 1}


# the wgmma loop's rings (probe_wgmma.cuh): most stages where the loads land
# in the operand ring and where converters fill it, fewest of either
WGMMA_STAGES = (12, 8, 2)
SLICE_BYTES = 128   # one operand row of a ring stage


def raw_row_bytes(code_bits: int, query_bytes: int = 2) -> int:
    """Code bytes of one row and slice in the wgmma loop's raw ring
    (probe_wgmma.cuh::raw_row_bytes); 0 where the loads land in the
    operand ring: a store of the queries' type, or int8 codes under int8
    queries. A slice is 128 bytes of the queries' type."""
    if not code_bits or (code_bits == 8 and query_bytes == 1):
        return 0
    return SLICE_BYTES // query_bytes // (1 if code_bits == 8 else 2)


def smem_bytes(k: int, tile_rows: int, pool: bool, loop: str = "staged",
               d: int = 0, code_bits: int = 0, stages: int = 0,
               query_bytes: int = 2) -> int:
    """Shared memory of one probe CTA. The staged loop
    (probe_common.cuh::smem_bytes): the staged query and store slices, the
    product tile, the lists, thresholds and query rows, the column scales,
    and the pool's keys. The wgmma loop (probe_wgmma.cuh::smem_bytes), for
    queries of `query_bytes` a value and width `d` over a store of the
    queries' type (`code_bits` 0) or of 8- or 4-bit codes, with rings of
    `stages` (`wgmma_stages`'s when 0): 1 KB of alignment, the resident
    queries (8 KB per slice of 128 bytes), the operand ring and the raw
    ring where there is one, the barriers, the pool's keys, the distance
    tile, the lists (k keys a slot), thresholds and query rows, and the
    consumer warps' column scales."""
    keys = BLOCK_SLOTS * POOL_CLASSES * 8 if pool else 0
    tile = BLOCK_SLOTS * (tile_rows + 4) * 4
    if loop == "staged":
        return ((BLOCK_SLOTS + tile_rows) * 272 + tile
                + BLOCK_SLOTS * 32 * list_lanes(k) * 8 + BLOCK_SLOTS * 8
                + tile_rows * 4 + keys)
    if loop != "wgmma":
        raise ValueError(f"unknown main loop {loop!r}")
    stages = stages or wgmma_stages(d, code_bits, k, pool, tile_rows,
                                    query_bytes)
    slice_features = SLICE_BYTES // query_bytes
    return (1024 + -(-d // slice_features) * BLOCK_SLOTS * SLICE_BYTES
            + stages * tile_rows * (SLICE_BYTES
                                    + raw_row_bytes(code_bits, query_bytes))
            + 512 + keys + tile + BLOCK_SLOTS * k * 8 + BLOCK_SLOTS * 8
            + 4 * tile_rows * 4)


@lru_cache(maxsize=None)
def wgmma_stages(d: int, code_bits: int, k: int, pool: bool,
                 tile_rows: int, query_bytes: int = 2) -> int:
    """Stages of the wgmma loop's rings (probe_wgmma.cuh::stages): as many
    as fit the opt-in limit of an H100 beside the rest, up to the most
    (with converters 8, 4, 3 or 2, so that each of the four converter
    warps keeps its stages); 0 when not even the fewest fit."""
    most, most_codes, fewest = WGMMA_STAGES
    raw = raw_row_bytes(code_bits, query_bytes) > 0
    for n in range(most_codes if raw else most, fewest - 1, -1):
        if raw and n > 4 and n % 4:
            continue    # with converters 8, 4, 3 or 2: the four warps
        if smem_bytes(k, tile_rows, pool, "wgmma", d, code_bits, n,
                      query_bytes) <= SMEM_OPTIN_H100:
            return n
    return 0


def probe_loop(query_bytes: int, code_bits: int, d: int, k: int, pool: bool,
               tile_rows: int) -> str:
    """The main loop a launch takes (probe_common.cuh::loop_of): the wgmma
    loop for 2-byte queries (bfloat16, float16), and for int8 queries over
    int8 or packed-int4 codes, whenever its shared memory, which grows with
    d, fits the opt-in limit of an H100 with rings of at least 2 stages;
    else the staged loop, which also serves float32 queries. A function of
    these sizes alone: no launch is tried and caught."""
    takes = query_bytes == 2 or (query_bytes == 1 and code_bits != 0)
    fits = takes and wgmma_stages(d, code_bits, k, pool, tile_rows,
                                  query_bytes) > 0
    return "wgmma" if fits else "staged"


# thread-block clusters (probe_wgmma.cuh): the CTAs of a cluster where the
# rule gives one, and the sizes a launch may ask for
CLUSTER_CTAS = 2
CLUSTER_SIZES = (1, 2, 4)


def cluster_of(loop: str, tile_rows: int, worklist: bool) -> int:
    """The CTAs of a cluster that a launch takes, 1 for none
    (probe_common.cuh::cluster_of): `CLUSTER_CTAS` for the 128-row tile's
    one-CTA-per-block launch in the wgmma loop, whose CTAs on one bucket
    then read each store tile once; none for the worklist's persistent
    grid, the 64-row tile and the staged loop."""
    wgmma_dense = loop == "wgmma" and not worklist
    return CLUSTER_CTAS if wgmma_dense and tile_rows == 128 else 1


def probe_cluster(query_bytes: int, code_bits: int, d: int, k: int,
                  pool: bool, tile_rows: int, worklist: bool = False) -> int:
    """`cluster_of` under the main loop that `probe_loop` gives these
    sizes: what the C entry points ``*_cluster`` report."""
    return cluster_of(probe_loop(query_bytes, code_bits, d, k, pool,
                                 tile_rows), tile_rows, worklist)


@dataclass(frozen=True)
class ClusterGroup:
    """CTAs of one cluster that share each store tile
    (probe_wgmma.cuh::Group): ranks [first, first + size) of cluster
    `cluster` (CTAs ``cluster * C + rank``), whose blocks have live slots
    and the same store rows [start, start + rows)."""
    cluster: int
    first: int
    size: int
    start: int
    rows: int

    @property
    def mask(self) -> int:
        """The multicast's CTA mask: one bit a rank of the group."""
        return ((1 << self.size) - 1) << self.first

    def blocks(self, cluster_ctas: int) -> range:
        base = self.cluster * cluster_ctas + self.first
        return range(base, base + self.size)


def block_rows(blocks: torch.Tensor):
    """(first store row, rows) of every block whose slots scan rows, else
    None: a block without live slots or of an empty bucket joins no
    group."""
    return [(start, cnt) if live > 0 and cnt > 0 else None
            for start, cnt, live in blocks.tolist()]


def cta_group(rows, block: int, cluster_ctas: int):
    """The kernel's `cluster_group` for CTA `block` of a launch in clusters
    of `cluster_ctas` (`rows`: `block_rows` of its blocks; a CTA past the
    last block has no block): (first rank, size, place) of its group; a
    block without rows, and every block outside a cluster, alone."""
    rank = block % cluster_ctas
    if cluster_ctas == 1 or block >= len(rows) or rows[block] is None:
        return rank, 1, 0
    base, lo, hi = block - rank, rank, rank + 1

    def same(r):
        b = base + r
        return b < len(rows) and rows[b] == rows[block]

    while lo > 0 and same(lo - 1):
        lo -= 1
    while hi < cluster_ctas and same(hi):
        hi += 1
    return lo, hi - lo, rank - lo


def cluster_groups(blocks: torch.Tensor, cluster_ctas: int):
    """Every group of a one-CTA-per-block launch of `blocks` in clusters of
    `cluster_ctas`, in block order: each reads its bucket's tiles once, so
    a bucket is read once per group (without clusters, once per live
    block)."""
    rows = block_rows(blocks)
    groups = []
    for b, r in enumerate(rows):
        first, size, place = cta_group(rows, b, cluster_ctas)
        if r is not None and place == 0:
            groups.append(ClusterGroup(b // cluster_ctas, first, size, *r))
    return groups


def cluster_reads(blocks: torch.Tensor, cluster_ctas: int) -> dict:
    """What one launch reads of the store: `groups` tile walks (one a group)
    over `buckets` probed buckets, `rows_read` store rows against the
    `bucket_rows` that each bucket read once would take."""
    groups = cluster_groups(blocks, cluster_ctas)
    buckets = {(g.start, g.rows) for g in groups}
    return {"groups": len(groups), "buckets": len(buckets),
            "rows_read": sum(g.rows for g in groups),
            "bucket_rows": sum(rows for _, rows in buckets)}


def common_loop(query_bytes: int, code_bits: int, d: int, launches):
    """The `loop` option under which every launch of `launches` ((k, pool,
    tile rows) each) takes one and the same main loop: None when the rule
    already gives them the same, else "staged", which takes every launch.
    Checks that hold two configurations against each other to the bit
    compare like with like under it."""
    loops = {probe_loop(query_bytes, code_bits, d, *one) for one in launches}
    return None if len(loops) == 1 else "staged"


def smem_budget(device) -> int:
    """Opt-in shared memory per block of `device`, as CUDA reports it; for a
    CPU device (which launches nothing) the H100's."""
    device = torch.device(device)
    if device.type != "cuda":
        return SMEM_OPTIN_H100
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin",
                       SMEM_OPTIN_H100))


_declined = set()


def resolve_tiling(pair: bool, *, k: int, pool: bool, device,
                   query_bytes: int = 4, code_bits: int = 0,
                   d: int = 0) -> bool:
    """Whether the 128-row tile can be launched for lists of `k` entries,
    with or without the pool: the shared memory of the main loop that the
    launch would take (`probe_loop`; without the sizes, the staged loop)
    against the card's opt-in limit. A request that does not fit is
    declined with one logged line per (k, pool), and the 64-row tile serves
    it, instead of a refused launch. The TPU kernel's other answer to a
    tight budget, halving the query block (``pallas_qc``), has no
    counterpart: the block is fixed at 64 slots."""
    if not pair:
        return False
    loop = probe_loop(query_bytes, code_bits, d, k, pool, 128)
    need = smem_bytes(k, 128, pool, loop, d, code_bits,
                      query_bytes=query_bytes)
    have = smem_budget(device)
    if need <= have:
        return True
    if (k, pool, have) not in _declined:
        _declined.add((k, pool, have))
        log.warning("pallas_pair declined: the 128-row tile needs %d bytes of "
                    "shared memory per block (k=%d, pool=%s), the card allows "
                    "%d; running the 64-row tile", need, k, pool, have)
    return False


def worklist_scratch_bytes(wl_pad: int, k: int, n_blocks: int,
                           pool: bool) -> int:
    """Device bytes the worklist adds: every item's partial lists and, with
    a pool, one key per slot and class."""
    return (wl_pad * BLOCK_SLOTS * k * 8
            + (n_blocks * BLOCK_SLOTS * POOL_CLASSES * 8 if pool else 0))


def _variant(k, k_out=0, pair=False, wl_pad=0, item_rows=1024, loop=None,
             ctas=0, cluster=0):
    """Check the variant options; returns (k_out, pool, rows of an item).
    `loop` asks the kernel for one of `LOOPS` instead of `probe_loop`'s
    choice (the checks on the card hold one loop against the other); a
    plain version has no loops and ignores it. `ctas` and `cluster` as in
    the module docstring."""
    ko = k_out or k
    if loop is not None and loop not in LOOPS:
        raise ValueError(f"loop={loop!r} must be None or one of {LOOPS}")
    if ctas < 0:
        raise ValueError(f"ctas={ctas} must not be negative")
    if cluster and cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster={cluster} must be 0 (the rule's) or one "
                         f"of {CLUSTER_SIZES}")
    if not k <= ko <= POOL_CLASSES:
        raise ValueError(f"k_out={ko} must lie in [k={k}, {POOL_CLASSES}]")
    if wl_pad < 0:
        raise ValueError(f"wl_pad={wl_pad} must not be negative")
    if wl_pad and (item_rows < 1 or item_rows % POOL_CLASSES != 0):
        raise ValueError(f"a work item spans a multiple of {POOL_CLASSES} "
                         f"store rows, got item_rows={item_rows}")
    return ko, ko > k, item_rows * (2 if pair else 1)


def _check(q, qidx, data, blocks, k, d_store=None):
    """`d_store`: the store's logical width (its stored width when None)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"probe kernel keeps k <= {MAX_K} candidates; k={k}")
    devs = {t.device for t in (q, qidx, data, blocks)}
    if len(devs) != 1:
        raise ValueError(f"probe inputs on several devices: {devs}")
    if d_store is None:
        d_store = data.shape[-1]
    if q.dim() != 2 or data.dim() != 2 or q.shape[1] != d_store:
        raise ValueError(f"queries {tuple(q.shape)} and store "
                         f"{tuple(data.shape)} (logical width {d_store}) "
                         f"widths differ")
    if qidx.dtype != torch.int32 or blocks.dtype != torch.int32:
        raise ValueError("qidx and blocks must be int32")
    if blocks.dim() != 2 or blocks.shape[1] != 3:
        raise ValueError(f"blocks must be (n_blocks, 3), got {tuple(blocks.shape)}")
    if qidx.shape[0] != blocks.shape[0] * BLOCK_SLOTS:
        raise ValueError("qidx must hold BLOCK_SLOTS rows per block")


def bucket_runs(blocks: torch.Tensor):
    """(first store row, rows, output rows of its live slots) of every
    bucket that a block of `blocks` probes, in block order."""
    runs = {}
    for j, (start, cnt, live) in enumerate(blocks.tolist()):
        nq = min(max(live, 0), BLOCK_SLOTS)
        if nq and cnt:
            runs.setdefault((start, cnt), []).append(
                torch.arange(j * BLOCK_SLOTS, j * BLOCK_SLOTS + nq))
    return [(start, cnt, torch.cat(rows).to(blocks.device))
            for (start, cnt), rows in runs.items()]


def build_worklist(blocks: torch.Tensor, wl_pad: int, span: int):
    """The flat worklist of `blocks`, on their device and without a host
    read: one item per live block and chunk of `span` store rows,
    block-major. A live block of an empty bucket keeps one item (its rows
    get the sentinel); a block without live slots gets none. Returns
    (items (wl_pad, 2) int32: block and chunk, block -1 past the total;
    block_items (n_blocks, 2) int32: first item and item count of each
    block; the true total, a 0-dim int64 tensor, which may exceed wl_pad:
    the items past the pad are dropped)."""
    dev = blocks.device
    cnt, live = blocks[:, 1].long(), blocks[:, 2] > 0
    n_items = torch.where(live, torch.clamp(-(-cnt // span), min=1),
                          torch.zeros_like(cnt))
    cum = torch.cumsum(n_items, 0)
    first = cum - n_items
    total = cum[-1]
    i = torch.arange(wl_pad, device=dev)
    blk = torch.clamp(torch.searchsorted(cum, i, right=True),
                      max=blocks.shape[0] - 1)
    items = torch.stack([torch.where(i < total, blk, torch.full_like(blk, -1)),
                         i - first[blk]], dim=1).to(torch.int32).contiguous()
    block_items = torch.stack([first, n_items], dim=1).to(
        torch.int32).contiguous()
    return items, block_items, total


def worklist_pieces(items: torch.Tensor, total, blocks: torch.Tensor,
                    span: int, tile_rows: int, ctas: int):
    """The persistent item kernel's schedule (csrc/probe_wgmma.cuh,
    `cta_range` and `next_piece`) in plain Python. Item (b, j) starts at
    tile off_b + j span / tile_rows of the tiles of all items, off_b the
    tiles of the live blocks before b (an empty bucket's item scans none);
    with T tiles in all and N = min(total, items) items, CTA c of G =
    min(ctas, N) takes the items that start in [c T / G, (c + 1) T / G), the
    last CTA up to N. Within a range, each run of one block's items with
    consecutive chunks is a piece. Returns (cta, block, first chunk, last
    chunk) of every piece, in order."""
    n = min(int(total), int(items.shape[0]))
    g = min(int(ctas), n)
    per = span // tile_rows
    off, tiles = [], 0
    for _, cnt, live in blocks.tolist():
        off.append(tiles)
        tiles += -(-cnt // tile_rows) if live > 0 else 0
    il = items[:n].tolist()
    starts = [off[b] + j * per for b, j in il]
    cuts = [sum(s < c * tiles // g for s in starts) for c in range(g)] + [n]
    pieces = []
    for c in range(g):
        pos, end = cuts[c], cuts[c + 1]
        while pos < end:
            blk, c0 = il[pos]
            c1 = c0
            pos += 1
            while pos < end and il[pos] == [blk, c1 + 1]:
                c1 += 1
                pos += 1
            pieces.append((c, blk, c0, c1))
    return pieces


@dataclass
class WorklistParts:
    """What the worklist's item kernel leaves for the merge kernel."""
    items: torch.Tensor        # (wl_pad, 2) int32, `build_worklist`
    block_items: torch.Tensor  # (n_blocks, 2) int32
    total: torch.Tensor        # 0-dim int64: the true item total
    part_d: torch.Tensor       # (wl_pad*BLOCK_SLOTS, k) float32 sorted partial
    part_i: torch.Tensor       # lists of each written piece, at the rows of
    #                            its first item; (10000, -1) when short
    keys: Optional[torch.Tensor]  # (n_blocks*BLOCK_SLOTS, 128) int64 pool
    #                               keys, all bits set = empty; None: no pool
    written: torch.Tensor      # (wl_pad,) int8: 1 where an item starts a
    #                            written piece; other items' rows are unset


_SIGN = -(1 << 63)   # flips a key's top bit: unsigned order as signed order


def pool_keys(dist: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(distance, row) pairs as the kernel's 64-bit keys (int64 bit
    patterns): the float's bits made to order like the float, then the
    row; unsigned key order is (distance, row) order."""
    bits = dist.contiguous().view(torch.int32).to(torch.int64) & 0xffffffff
    u = torch.where(bits >= 1 << 31, ~bits & 0xffffffff, bits | (1 << 31))
    return (u << 32) | (rows.to(torch.int64) & 0xffffffff)


def pool_pairs(keys: torch.Tensor):
    """The (distance float32, row int32) of keys; an empty key gives
    (inf, -1)."""
    u = (keys >> 32) & 0xffffffff
    bits = torch.where(u >= 1 << 31, u & 0x7fffffff, ~u & 0xffffffff)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    dist = bits.to(torch.int32).view(torch.float32)
    rows = (keys & 0xffffffff).to(torch.int32)   # wraps 0xffffffff to -1
    empty = keys == -1
    return (torch.where(empty, torch.full_like(dist, float("inf")), dist),
            torch.where(empty, torch.full_like(rows, -1), rows))


def _class_best(dist: torch.Tensor, first_row: int):
    """Per slot and class c the smallest distance, and its row (ties to the
    lower), over the columns j of `dist` with j % 128 == c; column j is
    store row first_row + j. (inf, -1) for a class without columns."""
    x = torch.nn.functional.pad(
        dist, (0, -dist.shape[1] % POOL_CLASSES), value=float("inf")
    ).view(dist.shape[0], -1, POOL_CLASSES)
    best = x.amin(1)
    # argmax of the equality: the first, so the lowest, such row
    chunk = (x == best[:, None, :]).to(torch.int8).argmax(1)
    rows = (chunk * POOL_CLASSES + first_row
            + torch.arange(POOL_CLASSES, device=dist.device)).to(torch.int32)
    return best, torch.where(torch.isinf(best), torch.full_like(rows, -1),
                             rows)


def pool_extras(out_d, out_i, pool_d, pool_i, k_out):
    """Append columns [k, k_out) to the exact lists (out_d, out_i): the
    smallest entries of the per-class pool (pool_d, pool_i), by (distance,
    row), whose row is not in the exact top-k of `out_i`."""
    k = out_d.shape[1]
    taken = pool_i < 0
    for t in range(k):
        taken |= pool_i == out_i[:, t:t + 1]
    d = torch.where(taken, torch.full_like(pool_d, float("inf")), pool_d)
    # order by row first, so that the stable sort by distance breaks ties
    # to the lower row
    by_row = torch.argsort(pool_i, dim=1, stable=True)
    d, i = torch.gather(d, 1, by_row), torch.gather(pool_i, 1, by_row)
    order = torch.sort(d, dim=1, stable=True).indices[:, :k_out - k]
    d, i = torch.gather(d, 1, order), torch.gather(i, 1, order)
    empty = torch.isinf(d)
    d = torch.where(empty, torch.full_like(d, SENTINEL_DIST), d)
    i = torch.where(empty, torch.full_like(i, -1), i)
    return torch.cat([out_d, d], 1), torch.cat([out_i, i], 1)


def _empty_lists(rows: int, k: int, dev):
    return (torch.full((rows, k), SENTINEL_DIST, dtype=torch.float32,
                       device=dev),
            torch.full((rows, k), -1, dtype=torch.int32, device=dev))


def _topk_of(dist: torch.Tensor, k: int, first_row: int):
    """The k smallest of each row of `dist`, ascending, ties to the lower
    column (a stable sort), with their store rows."""
    order = torch.sort(dist, dim=1, stable=True).indices[:, :k]
    return torch.gather(dist, 1, order), (order + first_row).to(torch.int32)


def _plain_items(qidx, blocks, k, dist_of, pool, wl_pad, span, ctas=0,
                 tile_rows=64):
    """The item kernel in plain torch: the partial lists of every piece
    and, with a pool, the blocks' folded pool keys. Pieces as the
    persistent grid of `ctas` CTAs with tiles of `tile_rows` takes them
    (`worklist_pieces`), or with ``ctas=0`` one per item, as the staged
    loop takes them."""
    dev = qidx.device
    items, block_items, total = build_worklist(blocks, wl_pad, span)
    part_d, part_i = _empty_lists(wl_pad * BLOCK_SLOTS, k, dev)
    written = torch.zeros(wl_pad, dtype=torch.int8, device=dev)
    keys = (torch.full((qidx.shape[0], POOL_CLASSES), -1, dtype=torch.int64,
                       device=dev) if pool else None)
    blk, firsts = blocks.tolist(), block_items[:, 0].tolist()
    if ctas:
        pieces = [p[1:] for p in worklist_pieces(items, total, blocks, span,
                                                 tile_rows, ctas)]
    else:
        pieces = [(j, c, c) for j, c in items[:int(total)].tolist()]
    for j, c0, c1 in pieces:
        start, cnt, live = blk[j]
        nq = min(max(live, 0), BLOCK_SLOTS)
        first = firsts[j] + c0
        written[first] = 1
        lo, hi = c0 * span, min(cnt, (c1 + 1) * span)
        if hi <= lo:
            continue
        slots = slice(j * BLOCK_SLOTS, j * BLOCK_SLOTS + nq)
        dist = dist_of(qidx[slots].long(), start + lo, hi - lo)
        kk = min(k, hi - lo)
        out = slice(first * BLOCK_SLOTS, first * BLOCK_SLOTS + nq)
        part_d[out, :kk], part_i[out, :kk] = _topk_of(dist, kk, start + lo)
        if pool:
            # lo is a multiple of the class count: classes line up
            best, rows = _class_best(dist, start + lo)
            new = torch.where(rows < 0, torch.full_like(keys[slots], -1),
                              pool_keys(best, rows))
            old = keys[slots]
            keys[slots] = torch.where((new ^ _SIGN) < (old ^ _SIGN), new, old)
    return WorklistParts(items, block_items, total, part_d, part_i, keys,
                         written)


def merge_items_plain(blocks: torch.Tensor, parts: WorklistParts, k: int,
                      k_out: int = 0):
    """The merge kernel (csrc/merge_items.cu) in plain torch: per block a
    stable sort of its written pieces' partial lists laid end to end in
    chunk order (equal distances keep the earlier piece and place, so the
    lower store row), the first k; then, with ``k_out > k``, the extras
    from the block's pool keys. Items that start no written piece, and
    items past the scratch (dropped on overflow), are not read. Returns
    (out_d, out_i) of shape (n_blocks*BLOCK_SLOTS, k_out or k)."""
    ko = k_out or k
    n_blocks = int(blocks.shape[0])
    n_items = parts.part_d.shape[0] // BLOCK_SLOTS
    out_d, out_i = _empty_lists(n_blocks * BLOCK_SLOTS, k, blocks.device)
    lives = blocks[:, 2].tolist()
    written = parts.written.bool()
    for j, (first, cnt) in enumerate(parts.block_items.tolist()):
        last = min(first + cnt, n_items)
        nq = min(max(lives[j], 0), BLOCK_SLOTS)
        if last <= first or nq == 0:
            continue
        rows = slice(first * BLOCK_SLOTS, last * BLOCK_SLOTS)
        mine = written[first:last]
        d = parts.part_d[rows].view(last - first, BLOCK_SLOTS, k)[mine]
        i = parts.part_i[rows].view(last - first, BLOCK_SLOTS, k)[mine]
        d = d.permute(1, 0, 2).reshape(BLOCK_SLOTS, -1)[:nq]
        i = i.permute(1, 0, 2).reshape(BLOCK_SLOTS, -1)[:nq]
        order = torch.sort(d, dim=1, stable=True).indices[:, :k]
        slots = slice(j * BLOCK_SLOTS, j * BLOCK_SLOTS + nq)
        out_d[slots] = torch.gather(d, 1, order)
        out_i[slots] = torch.gather(i, 1, order)
    if ko > k:
        out_d, out_i = pool_extras(out_d, out_i, *pool_pairs(parts.keys), ko)
    return out_d, out_i


def merge_items(blocks: torch.Tensor, parts: WorklistParts, k: int,
                k_out: int = 0):
    """Launch the merge kernel (csrc/merge_items.cu) on CUDA tensors; CPU
    tensors take `merge_items_plain`. Same arguments and results."""
    if blocks.device.type == "cpu":
        return merge_items_plain(blocks, parts, k, k_out)
    ko = k_out or k
    if not (1 <= k <= MAX_K and k <= ko <= POOL_CLASSES):
        raise ValueError(f"merge kernel takes 1 <= k <= k_out <= "
                         f"{POOL_CLASSES}, got k={k}, k_out={ko}")
    if ko > k and parts.keys is None:
        raise ValueError("k_out > k needs the items' pool keys")
    tensors = [blocks, parts.block_items, parts.written, parts.part_d,
               parts.part_i]
    tensors += [parts.keys] if parts.keys is not None else []
    if not all(t.is_cuda and t.device == blocks.device and t.is_contiguous()
               for t in tensors):
        raise ValueError("merge kernel inputs must be contiguous tensors on "
                         "one CUDA device")
    from tpulmi_torch.ops import _kernels

    lib = _kernels.load("merge_items")
    if lib.merge_items_block_slots() != BLOCK_SLOTS:
        raise RuntimeError("csrc/merge_items.cu block size differs from "
                           "BLOCK_SLOTS")
    dev = blocks.device
    n_blocks = int(blocks.shape[0])
    out_d = torch.empty((n_blocks * BLOCK_SLOTS, ko), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((n_blocks * BLOCK_SLOTS, ko), dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):
        _raise_on(lib.merge_items_launch(
            blocks.data_ptr(), parts.block_items.data_ptr(),
            parts.written.data_ptr(), parts.part_d.data_ptr(), parts.part_i.data_ptr(),
            parts.keys.data_ptr() if parts.keys is not None else None,
            out_d.data_ptr(), out_i.data_ptr(), n_blocks,
            parts.part_d.shape[0] // BLOCK_SLOTS, k, ko,
            torch.cuda.current_stream(dev).cuda_stream), "merge_items")
    count(LAUNCHES + "merge_items")
    return out_d, out_i


def _plain_topk(qidx, blocks, k, dist_of, merge=True, **variant):
    """The kernels' function in plain torch. `dist_of(query rows, first
    store row, rows)` gives the (slots, rows) float32 distances of a row
    range. Dense: per probed bucket the k smallest of each slot (stable
    sort: ties to the lower store row), (10000, -1) where the bucket holds
    fewer, and with a pool the per-class best rows and the extras. With a
    worklist: `_plain_items`, then `merge_items_plain`; ``merge=False``
    stops after the items and returns their `WorklistParts`."""
    ko, pool, span = _variant(k, **variant)
    wl_pad = variant.get("wl_pad", 0)
    if wl_pad:
        parts = _plain_items(qidx, blocks, k, dist_of, pool, wl_pad, span,
                             variant.get("ctas", 0),
                             128 if variant.get("pair") else 64)
        if not merge:
            return parts
        return (*merge_items_plain(blocks, parts, k, ko), parts.total)
    n_rows, dev = qidx.shape[0], qidx.device
    out_d, out_i = _empty_lists(n_rows, k, dev)
    if pool:
        pool_d = torch.full((n_rows, POOL_CLASSES), float("inf"),
                            dtype=torch.float32, device=dev)
        pool_i = torch.full((n_rows, POOL_CLASSES), -1, dtype=torch.int32,
                            device=dev)
    for start, cnt, rows in bucket_runs(blocks):
        dist = dist_of(qidx[rows].long(), start, cnt)
        kk = min(k, cnt)
        out_d[rows, :kk], out_i[rows, :kk] = _topk_of(dist, kk, start)
        if pool:
            pool_d[rows], pool_i[rows] = _class_best(dist, start)
    if pool:
        out_d, out_i = pool_extras(out_d, out_i, pool_d, pool_i, ko)
    return out_d, out_i


def probe_topk_plain(q: torch.Tensor, qidx: torch.Tensor, data: torch.Tensor,
                     blocks: torch.Tensor, k: int, **variant):
    """The kernel's function in plain torch, one bucket at a time: for each
    live slot, the k smallest ``1 - q.x`` (inputs in their dtype, products in
    float32) over its bucket's rows, ascending, ties to the lower store row,
    with (10000, -1) past the bucket's size. Returns (out_d, out_i) of shape
    (n_blocks*BLOCK_SLOTS, k_out or k), and the item total with a worklist
    (`variant`: the options of the module docstring)."""
    _check(q, qidx, data, blocks, k)

    def dist_of(qrows, start, cnt):
        return 1.0 - q[qrows].float() @ data[start:start + cnt].float().T

    return _plain_topk(qidx, blocks, k, dist_of, **variant)


# launch counters (`utils.profiling.count`): ``probe_launches.<name>``, by
# store and query type (the wrappers below) and by configuration: the
# worklist's item kernel and its merge kernel, the 128-row tile, the pool,
# launches in clusters of more than one CTA; ``probe_loop_launches.<loop>``
# by the main loop the probe kernel took
LAUNCHES = "probe_launches."
LOOP_LAUNCHES = "probe_loop_launches."
_LAUNCH_NAMES = ("probe_topk", "probe_topk_quant_int8",
                 "probe_topk_quant_int4", "probe_topk_int8q_int8",
                 "probe_topk_int8q_int4", "probe_worklist", "merge_items",
                 "probe_pair", "probe_pool", "probe_cluster")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def _launch(source: str, inputs, d: int, n_rows: int, k: int, codes,
            k_out=0, pair=False, wl_pad=0, item_rows=1024, merge=True,
            loop=None, ctas=0, cluster=0):
    """Run the launch entry point of csrc/`source`.cu (its 128-row library
    with `pair`) on the current stream: the inputs' pointers (the last one
    is `blocks`), the worklist, outputs and pool allocated here, the sizes,
    then `codes` (the entry point's type codes: the queries' type and, for
    a quantized store, its code width), the main loop (`probe_loop`'s
    choice unless `loop` names one) and the CTAs of a cluster
    (`cluster_of`'s unless `cluster` names them). With a worklist the
    items' partial lists go on through `merge_items` (``merge=False``
    returns them as they are, as `WorklistParts`). Raises on what the
    kernel cannot take; there is no fallback."""
    ko, pool, span = _variant(k, k_out, pair, wl_pad, item_rows, loop, ctas,
                              cluster)
    dev = inputs[0].device
    if dev.type != "cuda":
        raise ValueError(f"probe kernel runs on CUDA tensors, not {dev}")
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("probe kernel inputs must be contiguous")
    from tpulmi_torch.ops import _kernels

    lib = _kernels.load(source + ("_pair" if pair else ""))
    tile_rows = 128 if pair else 64
    code_bits = codes[1] if len(codes) > 1 else 0
    query_bytes = _QUERY_BYTES[codes[0]]
    rule = probe_loop(query_bytes, code_bits, d, k, pool, tile_rows)
    if loop == "wgmma" and rule != "wgmma":
        raise ValueError(f"the wgmma loop does not take this launch "
                         f"(d={d}, k={k}, pool={pool}, tile of {tile_rows})")
    loop = loop or rule
    worklist = bool(wl_pad)
    if cluster > 1 and (loop != "wgmma" or worklist):
        raise ValueError(f"a cluster of {cluster} CTAs takes the wgmma loop's "
                         f"one-CTA-per-block launch, not the {loop} loop"
                         f"{' with a worklist' if worklist else ''}")
    cluster = cluster or cluster_of(loop, tile_rows, worklist)
    if (getattr(lib, f"{source}_block_slots")() != BLOCK_SLOTS
            or getattr(lib, f"{source}_tile_rows")() != tile_rows
            or LOOPS[getattr(lib, f"{source}_loop")(*codes, d, k, int(pool))]
            != rule
            or getattr(lib, f"{source}_smem_bytes")(
                LOOPS.index(loop), *codes, d, k, int(pool))
            != smem_bytes(k, tile_rows, pool, loop, d, code_bits,
                          query_bytes=query_bytes)
            or getattr(lib, f"{source}_cluster")(*codes, d, k, int(pool),
                                                 int(worklist))
            != probe_cluster(query_bytes, code_bits, d, k, pool, tile_rows,
                             worklist)):
        raise RuntimeError("csrc/probe_common.cuh and ops/probe_topk.py "
                           "differ on block, tile or shared-memory sizes, "
                           "on the main loop or on the cluster")
    blocks = inputs[-1]
    n_blocks = int(blocks.shape[0])
    parts = None
    if wl_pad:
        # every pool key empty (all bits set), no item written; the pieces
        # fold their keys in and mark their first items
        parts = WorklistParts(
            *build_worklist(blocks, wl_pad, span),
            torch.empty((wl_pad * BLOCK_SLOTS, k), dtype=torch.float32,
                        device=dev),
            torch.empty((wl_pad * BLOCK_SLOTS, k), dtype=torch.int32,
                        device=dev),
            torch.full((n_blocks * BLOCK_SLOTS, POOL_CLASSES), -1,
                       dtype=torch.int64, device=dev) if pool else None,
            torch.zeros(wl_pad, dtype=torch.int8, device=dev))
        out_d, out_i = parts.part_d, parts.part_i
    else:
        out_d = torch.empty((n_blocks * BLOCK_SLOTS, ko), dtype=torch.float32,
                            device=dev)
        out_i = torch.empty((n_blocks * BLOCK_SLOTS, ko), dtype=torch.int32,
                            device=dev)
    with torch.cuda.device(dev):
        wl = ((parts.items, parts.block_items, parts.written) if parts
              else (None,) * 3)
        _raise_on(getattr(lib, f"{source}_launch")(
            *(t.data_ptr() for t in inputs),
            *(t.data_ptr() if parts else None for t in wl), out_d.data_ptr(),
            out_i.data_ptr(),
            parts.keys.data_ptr() if parts and pool else None,
            wl_pad or n_blocks, ctas, n_blocks, d, n_rows, k, ko,
            span if parts else 0,
            *codes, LOOPS.index(loop), cluster,
            torch.cuda.current_stream(dev).cuda_stream), source)
    count(LOOP_LAUNCHES + loop)
    for name, on in (("probe_worklist", parts is not None),
                     ("probe_pair", pair), ("probe_pool", pool),
                     ("probe_cluster", cluster > 1)):
        if on:
            count(LAUNCHES + name)
    if parts is None:
        return out_d, out_i
    if not merge:
        return parts
    return (*merge_items(blocks, parts, k, ko), parts.total)


def probe_topk(q: torch.Tensor, qidx: torch.Tensor, data: torch.Tensor,
               blocks: torch.Tensor, k: int, **variant):
    """Launch the probe kernel (csrc/probe_topk.cu) on CUDA tensors; CPU
    tensors take `probe_topk_plain`. Same arguments and results as
    `probe_topk_plain`; queries and store share one dtype of
    `KERNEL_DTYPES` (float32 is multiplied in float32)."""
    if q.device.type == "cpu":
        return probe_topk_plain(q, qidx, data, blocks, k, **variant)
    _check(q, qidx, data, blocks, k)
    if q.dtype != data.dtype or q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"probe kernel takes queries and store of one dtype "
                         f"of {list(KERNEL_DTYPES)}, got {q.dtype} and "
                         f"{data.dtype}")
    d = int(q.shape[1])
    if d % 8 != 0:
        raise ValueError(f"probe kernel needs d % 8 == 0, got d={d}")
    out = _launch("probe_topk", (q, qidx, data, blocks), d,
                  int(data.shape[0]), k, (KERNEL_DTYPES[q.dtype],), **variant)
    count(LAUNCHES + "probe_topk")
    return out


# ------------------------------------------------------- quantized stores
def _check_quant(q, qidx, codes, scales, blocks, k, bits):
    if bits not in Q_LEVELS:
        raise ValueError(f"quantized probe takes bits in (8, 4), got {bits}")
    if codes.dtype != torch.int8:
        raise ValueError(f"quantized store holds int8 codes, got {codes.dtype}")
    _check(q, qidx, codes, blocks, k,
           d_store=codes.shape[-1] * (2 if bits == 4 else 1))
    if (scales.dtype != torch.float32 or scales.dim() != 1
            or scales.shape[0] != codes.shape[0]
            or scales.device != codes.device):
        raise ValueError("scales must be float32, one per store row, on the "
                         "store's device")


def _codes(codes, bits):
    return unpack_int4(codes) if bits == 4 else codes


def probe_topk_quant_plain(q: torch.Tensor, qidx: torch.Tensor,
                           codes: torch.Tensor, scales: torch.Tensor,
                           blocks: torch.Tensor, k: int, bits: int = 8,
                           **variant):
    """`probe_topk_plain` over a quantized store: per bucket the codes
    (unpacked when int4) are cast to the query dtype, multiplied with
    float32 sums, and each column is scaled by ``scales[row] / q_levels``
    before ``1 - sims``."""
    _check_quant(q, qidx, codes, scales, blocks, k, bits)
    if not q.dtype.is_floating_point:
        raise ValueError(f"queries must be floating point, got {q.dtype}")

    def dist_of(qrows, start, cnt):
        x = _codes(codes[start:start + cnt], bits).to(q.dtype).float()
        sc = scales[start:start + cnt] / Q_LEVELS[bits]
        return 1.0 - (q[qrows].float() @ x.T) * sc[None, :]

    return _plain_topk(qidx, blocks, k, dist_of, **variant)


def apply_query_scale(out, q_scales, qidx):
    """The int8 query's scale, left out of the ranking (positive and
    constant per slot), applied to the finished lists; empty places keep
    the sentinel. `out`: (out_d, out_i) and, with a worklist, the item
    total, which passes through; unmerged `WorklistParts` pass as they
    are (their lists are still the kernel's raw scores)."""
    if isinstance(out, WorklistParts):
        return out
    out_d, out_i = out[:2]
    qs = (q_scales / 127.0)[qidx.long()][:, None]
    scaled = torch.where(out_i >= 0, 1.0 - (1.0 - out_d) * qs,
                         torch.full_like(out_d, SENTINEL_DIST))
    return (scaled, out_i, *out[2:])


def _check_int8q(q_codes, q_scales, qidx, codes, scales, blocks, k, bits):
    _check_quant(q_codes, qidx, codes, scales, blocks, k, bits)
    if q_codes.dtype != torch.int8:
        raise ValueError(f"int8 queries are int8 codes, got {q_codes.dtype}")
    if (q_scales.dtype != torch.float32 or q_scales.dim() != 1
            or q_scales.shape[0] != q_codes.shape[0]
            or q_scales.device != q_codes.device):
        raise ValueError("q_scales must be float32, one per query, on the "
                         "queries' device")


def probe_topk_int8q_plain(q_codes: torch.Tensor, q_scales: torch.Tensor,
                           qidx: torch.Tensor, codes: torch.Tensor,
                           scales: torch.Tensor, blocks: torch.Tensor, k: int,
                           bits: int = 8, **variant):
    """int8 x int8 in plain torch: the exact integer dot as float32, times
    ``scales[row] / q_levels``, ranked without the query's scale; then
    ``d = 1 - (1 - d) * q_scale / 127`` on the finished lists."""
    _check_int8q(q_codes, q_scales, qidx, codes, scales, blocks, k, bits)

    def dist_of(qrows, start, cnt):
        x = _codes(codes[start:start + cnt], bits)
        sc = scales[start:start + cnt] / Q_LEVELS[bits]
        return 1.0 - int_dot(q_codes[qrows], x) * sc[None, :]

    return apply_query_scale(
        _plain_topk(qidx, blocks, k, dist_of, **variant), q_scales, qidx)


def _launch_quant(q, qidx, codes, scales, blocks, k, bits, qcode, variant):
    d = int(q.shape[1])
    need = 32 if bits == 4 else 16
    if d % need != 0:
        raise ValueError(f"int{bits} probe kernel needs d % {need} == 0 "
                         f"(16-byte row loads), got d={d}")
    return _launch("probe_topk_quant", (q, qidx, codes, scales, blocks), d,
                   int(codes.shape[0]), k, (qcode, bits), **variant)


def probe_topk_quant(q: torch.Tensor, qidx: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor, blocks: torch.Tensor, k: int,
                     bits: int = 8, **variant):
    """Launch the quantized-store probe kernel (csrc/probe_topk_quant.cu)
    on CUDA tensors; CPU tensors take `probe_topk_quant_plain`. Queries in
    a dtype of `KERNEL_DTYPES`, codes int8 ((rows, d), or (rows, d/2)
    packed when ``bits=4``), scales float32 (rows,)."""
    if q.device.type == "cpu":
        return probe_topk_quant_plain(q, qidx, codes, scales, blocks, k, bits,
                                      **variant)
    _check_quant(q, qidx, codes, scales, blocks, k, bits)
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"quantized probe kernel takes queries of "
                         f"{list(KERNEL_DTYPES)}, got {q.dtype}")
    out = _launch_quant(q, qidx, codes, scales, blocks, k, bits,
                        KERNEL_DTYPES[q.dtype], variant)
    count(f"{LAUNCHES}probe_topk_quant_int{bits}")
    return out


def probe_topk_int8q(q_codes: torch.Tensor, q_scales: torch.Tensor,
                     qidx: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor, blocks: torch.Tensor, k: int,
                     bits: int = 8, **variant):
    """Launch the int8 x int8 probe kernel (csrc/probe_topk_quant.cu) on
    CUDA tensors and apply the queries' scales to its lists; CPU tensors
    take `probe_topk_int8q_plain`. `q_codes` (Q, d) int8 and `q_scales`
    (Q,) float32 are `quantize_rows` of the queries."""
    if q_codes.device.type == "cpu":
        return probe_topk_int8q_plain(q_codes, q_scales, qidx, codes, scales,
                                      blocks, k, bits, **variant)
    _check_int8q(q_codes, q_scales, qidx, codes, scales, blocks, k, bits)
    out = _launch_quant(q_codes, qidx, codes, scales, blocks, k, bits,
                        INT8_QUERY_CODE, variant)
    count(f"{LAUNCHES}probe_topk_int8q_int{bits}")
    return apply_query_scale(out, q_scales, qidx)


def launch_counts() -> dict:
    """Kernel launches so far: the probe kernel by store and query type (in
    any configuration), then by configuration: worklist launches of it,
    launches of the items' merge kernel, of the 128-row tile, with a pool,
    in clusters."""
    got = counters()
    return {name: got.get(LAUNCHES + name, 0) for name in _LAUNCH_NAMES}


def loop_launch_counts() -> dict:
    """Launches of the probe kernel so far by the main loop they took."""
    got = counters()
    return {name: got.get(LOOP_LAUNCHES + name, 0) for name in LOOPS}


def reset_launch_counts() -> None:
    reset(LAUNCHES)
    reset(LOOP_LAUNCHES)


def merge_slots(out_d: torch.Tensor, out_i: torch.Tensor,
                layout: SlotLayout, q: int, p: int, k: int,
                ids_sorted: torch.Tensor):
    """Per-slot results -> (query, rank) -> a stable rank-major top-k per
    query -> dataset ids (0-based, -1 where fewer than k were found)."""
    n_slots = q * p
    dev = out_d.device
    slot_d = torch.full((n_slots + 1, k), SENTINEL_DIST, dtype=torch.float32,
                        device=dev)
    slot_i = torch.full((n_slots + 1, k), -1, dtype=torch.int32, device=dev)
    slot_d[layout.slot_of_row] = out_d
    slot_i[layout.slot_of_row] = out_i
    slot_d = slot_d[:n_slots].reshape(q, p * k)
    slot_i = slot_i[:n_slots].reshape(q, p * k)
    order = torch.sort(slot_d, dim=1, stable=True).indices[:, :k]
    final_d = torch.gather(slot_d, 1, order)
    rows = torch.gather(slot_i, 1, order).to(torch.int64)
    final_i = torch.where(rows >= 0, ids_sorted[torch.clamp(rows, min=0)],
                          torch.full_like(rows, -1, dtype=ids_sorted.dtype))
    return final_d, final_i


def probe_search(probe_buckets: torch.Tensor, queries: torch.Tensor, store,
                 *, k: int = 10, compute_dtype=torch.bfloat16,
                 backend: str = "cuda", int8_queries: bool = False,
                 pool_k: int = 0, pair: bool = False, wl_pad: int = 0,
                 item_rows: int = 1024):
    """Top-k of every query over its probed buckets. Returns (dists (Q, k)
    float32 ascending, ids (Q, k) 0-based with -1 for empty places, max
    slots routed to one bucket) and, with ``wl_pad > 0``, the worklist's
    true item total (results are invalid when it exceeds ``wl_pad``).

    ``backend="cuda"`` goes through the kernel wrappers (the kernels on
    CUDA tensors); ``"torch"`` calls their plain versions. A quantized
    store is scored from its codes and scales; ``int8_queries`` (quantized
    stores only, ignored otherwise) also quantizes the queries, once per
    query, for the int8 x int8 kernel. ``pool_k > 0`` (< k) keeps only the
    first ``pool_k`` columns exact and draws the other ``k - pool_k`` from
    the rerank pool; ``pair``, ``wl_pad`` and ``item_rows`` as in the
    module docstring."""
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown probe backend {backend!r}")
    kernel = backend == "cuda"
    q, p = probe_buckets.shape
    with span("program.group"):
        layout = group_slots(probe_buckets, store.offsets, store.counts)
    variant = dict(pair=pair, wl_pad=wl_pad, item_rows=item_rows)
    k_exact = k
    if pool_k:
        if not 0 < pool_k < k:
            raise ValueError(f"pool_k={pool_k} must lie in (0, k={k})")
        k_exact, variant["k_out"] = pool_k, k
    with span("program.probe"):
        if not store.is_quantized:
            fn = probe_topk if kernel else probe_topk_plain
            out = fn(queries.to(compute_dtype).contiguous(), layout.qidx,
                     store.data_as(compute_dtype), layout.blocks, k_exact,
                     **variant)
        elif int8_queries:
            fn = probe_topk_int8q if kernel else probe_topk_int8q_plain
            q_codes, q_scales = quantize_rows(queries)
            out = fn(q_codes, q_scales, layout.qidx, store.data_sorted,
                     store.scales, layout.blocks, k_exact, store.quant_bits,
                     **variant)
        else:
            fn = probe_topk_quant if kernel else probe_topk_quant_plain
            out = fn(queries.to(compute_dtype).contiguous(), layout.qidx,
                     store.data_sorted, store.scales, layout.blocks, k_exact,
                     store.quant_bits, **variant)
    with span("program.merge"):
        final_d, final_i = merge_slots(out[0], out[1], layout, q, p, k,
                                       store.ids_sorted)
    return (final_d, final_i, layout.slot_counts.max(), *out[2:])
