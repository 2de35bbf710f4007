"""The probe phase: every (query, probe) slot's exact top-k over its probed
bucket, then the per-query merge.

Counterpart of ``tpulmi/ops/pallas_topk.py::pallas_probe_search``. The work
around the kernel is plain torch, as it is plain JAX there:

1. `group_slots`: a stable argsort of the slots by bucket, laid out in
   blocks of `BLOCK_SLOTS` so each block belongs to one bucket; dump slots
   (probe id == n_categories) go to the discard row. Per block: the bucket's
   first store row, its row count and the block's live slots.
2. `probe_topk`: the kernel (csrc/probe_topk.cu) on CUDA tensors; its plain
   version, `probe_topk_plain`, on CPU tensors.
3. `merge_slots`: scatter per-slot results to (query, rank), a stable
   rank-major merge (ties go to the earlier probe rank), and the
   store-row -> dataset-id gather.
"""

from dataclasses import dataclass

import torch

from tpulmi_torch.ops.distance import SENTINEL_DIST

BLOCK_SLOTS = 64   # slots per kernel block (QB in csrc/probe_topk.cu)
MAX_K = 128        # the kernel keeps at most 128 candidates per slot
# input dtypes of the kernel, by the code its C entry point takes
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


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
    slot_counts = torch.bincount(slots, minlength=n_cat + 1)[:n_cat]
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


def _check(q, qidx, data, blocks, k):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"probe kernel keeps k <= {MAX_K} candidates; k={k}")
    devs = {t.device for t in (q, qidx, data, blocks)}
    if len(devs) != 1:
        raise ValueError(f"probe inputs on several devices: {devs}")
    if q.dim() != 2 or data.dim() != 2 or q.shape[1] != data.shape[1]:
        raise ValueError(f"queries {tuple(q.shape)} and store "
                         f"{tuple(data.shape)} widths differ")
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


def probe_topk_plain(q: torch.Tensor, qidx: torch.Tensor, data: torch.Tensor,
                     blocks: torch.Tensor, k: int):
    """The kernel's function in plain torch, one bucket at a time: for each
    live slot, the k smallest ``1 - q.x`` (inputs in their dtype, products in
    float32) over its bucket's rows, ascending, ties to the lower store row,
    with (10000, -1) past the bucket's size. Returns (out_d, out_i) of shape
    (n_blocks*BLOCK_SLOTS, k)."""
    _check(q, qidx, data, blocks, k)
    n_rows = qidx.shape[0]
    out_d = torch.full((n_rows, k), SENTINEL_DIST, dtype=torch.float32,
                       device=q.device)
    out_i = torch.full((n_rows, k), -1, dtype=torch.int32, device=q.device)
    for start, cnt, rows in bucket_runs(blocks):
        x = data[start:start + cnt].float()
        dist = 1.0 - q[qidx[rows].long()].float() @ x.T
        kk = min(k, cnt)
        order = torch.sort(dist, dim=1, stable=True).indices[:, :kk]
        out_d[rows, :kk] = torch.gather(dist, 1, order)
        out_i[rows, :kk] = (order + start).to(torch.int32)
    return out_d, out_i


def probe_topk(q: torch.Tensor, qidx: torch.Tensor, data: torch.Tensor,
               blocks: torch.Tensor, k: int):
    """Launch the probe kernel (csrc/probe_topk.cu) on CUDA tensors; CPU
    tensors take `probe_topk_plain`. Same arguments and results as
    `probe_topk_plain`; queries and store share one dtype of
    `KERNEL_DTYPES` (float32 is multiplied in float32)."""
    if q.device.type == "cpu":
        return probe_topk_plain(q, qidx, data, blocks, k)
    _check(q, qidx, data, blocks, k)
    if q.device.type != "cuda":
        raise ValueError(f"probe kernel runs on CUDA tensors, not {q.device}")
    if q.dtype != data.dtype or q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"probe kernel takes queries and store of one dtype "
                         f"of {list(KERNEL_DTYPES)}, got {q.dtype} and "
                         f"{data.dtype}")
    d = int(q.shape[1])
    if d % 8 != 0:
        raise ValueError(f"probe kernel needs d % 8 == 0, got d={d}")
    if not (q.is_contiguous() and data.is_contiguous()
            and qidx.is_contiguous() and blocks.is_contiguous()):
        raise ValueError("probe kernel inputs must be contiguous")
    from tpulmi_torch.ops import _kernels

    lib = _kernels.load("probe_topk")
    if lib.probe_topk_block_slots() != BLOCK_SLOTS:
        raise RuntimeError("csrc/probe_topk.cu block size differs from "
                           "BLOCK_SLOTS")
    n_blocks = int(blocks.shape[0])
    out_d = torch.empty((n_blocks * BLOCK_SLOTS, k), dtype=torch.float32,
                        device=q.device)
    out_i = torch.empty((n_blocks * BLOCK_SLOTS, k), dtype=torch.int32,
                        device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.probe_topk_launch(
            q.data_ptr(), qidx.data_ptr(), data.data_ptr(), blocks.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), n_blocks, d,
            int(data.shape[0]), k, KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"probe_topk launch failed with CUDA error {err}")
    probe_topk.launches += 1
    return out_d, out_i


probe_topk.launches = 0


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
                 backend: str = "cuda"):
    """Exact top-k of every query over its probed buckets. Returns
    (dists (Q, k) float32 ascending, ids (Q, k) 0-based with -1 for empty
    places, max slots routed to one bucket).

    ``backend="cuda"`` goes through `probe_topk` (the kernel on CUDA
    tensors); ``"torch"`` calls `probe_topk_plain`."""
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown probe backend {backend!r}")
    q, p = probe_buckets.shape
    layout = group_slots(probe_buckets, store.offsets, store.counts)
    qc = queries.to(compute_dtype).contiguous()
    data = store.data_as(compute_dtype)
    fn = probe_topk if backend == "cuda" else probe_topk_plain
    out_d, out_i = fn(qc, layout.qidx, data, layout.blocks, k)
    final_d, final_i = merge_slots(out_d, out_i, layout, q, p, k,
                                   store.ids_sorted)
    return final_d, final_i, layout.slot_counts.max()
