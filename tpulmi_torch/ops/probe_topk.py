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
"""

from dataclasses import dataclass

import torch

from tpulmi_torch.ops.distance import SENTINEL_DIST
from tpulmi_torch.ops.quantize import int_dot, quantize_rows, unpack_int4

BLOCK_SLOTS = 64   # slots per kernel block (QB in csrc/probe_topk.cu)
MAX_K = 128        # the kernel keeps at most 128 candidates per slot
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


def _plain_topk(qidx, blocks, k, dist_of):
    """Per probed bucket: `dist_of(query rows, first store row, rows)` gives
    the (slots, rows) float32 distances; a stable sort keeps the k smallest,
    ties to the lower store row, (10000, -1) past the bucket's size."""
    n_rows = qidx.shape[0]
    out_d = torch.full((n_rows, k), SENTINEL_DIST, dtype=torch.float32,
                       device=qidx.device)
    out_i = torch.full((n_rows, k), -1, dtype=torch.int32, device=qidx.device)
    for start, cnt, rows in bucket_runs(blocks):
        dist = dist_of(qidx[rows].long(), start, cnt)
        kk = min(k, cnt)
        order = torch.sort(dist, dim=1, stable=True).indices[:, :kk]
        out_d[rows, :kk] = torch.gather(dist, 1, order)
        out_i[rows, :kk] = (order + start).to(torch.int32)
    return out_d, out_i


def probe_topk_plain(q: torch.Tensor, qidx: torch.Tensor, data: torch.Tensor,
                     blocks: torch.Tensor, k: int):
    """The kernel's function in plain torch, one bucket at a time: for each
    live slot, the k smallest ``1 - q.x`` (inputs in their dtype, products in
    float32) over its bucket's rows, ascending, ties to the lower store row,
    with (10000, -1) past the bucket's size. Returns (out_d, out_i) of shape
    (n_blocks*BLOCK_SLOTS, k)."""
    _check(q, qidx, data, blocks, k)

    def dist_of(qrows, start, cnt):
        return 1.0 - q[qrows].float() @ data[start:start + cnt].float().T

    return _plain_topk(qidx, blocks, k, dist_of)


def _launch(source: str, inputs, d: int, n_rows: int, k: int, codes):
    """Run the launch entry point of csrc/`source`.cu on the current
    stream: the inputs' pointers (the last one is `blocks`), the two
    outputs allocated here, the sizes, then `codes` (the entry point's type
    codes). Raises on what the kernel cannot take; there is no fallback."""
    dev = inputs[0].device
    if dev.type != "cuda":
        raise ValueError(f"probe kernel runs on CUDA tensors, not {dev}")
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("probe kernel inputs must be contiguous")
    from tpulmi_torch.ops import _kernels

    lib = _kernels.load(source)
    if getattr(lib, f"{source}_block_slots")() != BLOCK_SLOTS:
        raise RuntimeError("csrc/probe_common.cuh block size differs from "
                           "BLOCK_SLOTS")
    n_blocks = int(inputs[-1].shape[0])
    out_d = torch.empty((n_blocks * BLOCK_SLOTS, k), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((n_blocks * BLOCK_SLOTS, k), dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"{source}_launch")(
            *(t.data_ptr() for t in inputs), out_d.data_ptr(),
            out_i.data_ptr(), n_blocks, d, n_rows, k, *codes,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{source} launch failed with CUDA error {err}")
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
    if q.dtype != data.dtype or q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"probe kernel takes queries and store of one dtype "
                         f"of {list(KERNEL_DTYPES)}, got {q.dtype} and "
                         f"{data.dtype}")
    d = int(q.shape[1])
    if d % 8 != 0:
        raise ValueError(f"probe kernel needs d % 8 == 0, got d={d}")
    out = _launch("probe_topk", (q, qidx, data, blocks), d,
                  int(data.shape[0]), k, (KERNEL_DTYPES[q.dtype],))
    probe_topk.launches += 1
    return out


probe_topk.launches = 0


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
                           blocks: torch.Tensor, k: int, bits: int = 8):
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

    return _plain_topk(qidx, blocks, k, dist_of)


def _apply_query_scale(out_d, out_i, q_scales, qidx):
    """The int8 query's scale, left out of the ranking (positive and
    constant per slot), applied to the finished lists; empty places keep
    the sentinel."""
    qs = (q_scales / 127.0)[qidx.long()][:, None]
    return torch.where(out_i >= 0, 1.0 - (1.0 - out_d) * qs,
                       torch.full_like(out_d, SENTINEL_DIST)), out_i


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
                           bits: int = 8):
    """int8 x int8 in plain torch: the exact integer dot as float32, times
    ``scales[row] / q_levels``, ranked without the query's scale; then
    ``d = 1 - (1 - d) * q_scale / 127`` on the finished lists."""
    _check_int8q(q_codes, q_scales, qidx, codes, scales, blocks, k, bits)

    def dist_of(qrows, start, cnt):
        x = _codes(codes[start:start + cnt], bits)
        sc = scales[start:start + cnt] / Q_LEVELS[bits]
        return 1.0 - int_dot(q_codes[qrows], x) * sc[None, :]

    out_d, out_i = _plain_topk(qidx, blocks, k, dist_of)
    return _apply_query_scale(out_d, out_i, q_scales, qidx)


def _launch_quant(q, qidx, codes, scales, blocks, k, bits, qcode):
    d = int(q.shape[1])
    need = 32 if bits == 4 else 16
    if d % need != 0:
        raise ValueError(f"int{bits} probe kernel needs d % {need} == 0 "
                         f"(16-byte row loads), got d={d}")
    return _launch("probe_topk_quant", (q, qidx, codes, scales, blocks), d,
                   int(codes.shape[0]), k, (qcode, bits))


def probe_topk_quant(q: torch.Tensor, qidx: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor, blocks: torch.Tensor, k: int,
                     bits: int = 8):
    """Launch the quantized-store probe kernel (csrc/probe_topk_quant.cu)
    on CUDA tensors; CPU tensors take `probe_topk_quant_plain`. Queries in
    a dtype of `KERNEL_DTYPES`, codes int8 ((rows, d), or (rows, d/2)
    packed when ``bits=4``), scales float32 (rows,)."""
    if q.device.type == "cpu":
        return probe_topk_quant_plain(q, qidx, codes, scales, blocks, k, bits)
    _check_quant(q, qidx, codes, scales, blocks, k, bits)
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"quantized probe kernel takes queries of "
                         f"{list(KERNEL_DTYPES)}, got {q.dtype}")
    out = _launch_quant(q, qidx, codes, scales, blocks, k, bits,
                        KERNEL_DTYPES[q.dtype])
    probe_topk_quant.launches += 1
    probe_topk_quant.launches_by_bits[bits] += 1
    return out


probe_topk_quant.launches = 0
probe_topk_quant.launches_by_bits = {8: 0, 4: 0}


def probe_topk_int8q(q_codes: torch.Tensor, q_scales: torch.Tensor,
                     qidx: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor, blocks: torch.Tensor, k: int,
                     bits: int = 8):
    """Launch the int8 x int8 probe kernel (csrc/probe_topk_quant.cu) on
    CUDA tensors and apply the queries' scales to its lists; CPU tensors
    take `probe_topk_int8q_plain`. `q_codes` (Q, d) int8 and `q_scales`
    (Q,) float32 are `quantize_rows` of the queries."""
    if q_codes.device.type == "cpu":
        return probe_topk_int8q_plain(q_codes, q_scales, qidx, codes, scales,
                                      blocks, k, bits)
    _check_int8q(q_codes, q_scales, qidx, codes, scales, blocks, k, bits)
    out_d, out_i = _launch_quant(q_codes, qidx, codes, scales, blocks, k,
                                 bits, INT8_QUERY_CODE)
    probe_topk_int8q.launches += 1
    probe_topk_int8q.launches_by_bits[bits] += 1
    return _apply_query_scale(out_d, out_i, q_scales, qidx)


probe_topk_int8q.launches = 0
probe_topk_int8q.launches_by_bits = {8: 0, 4: 0}


def launch_counts() -> dict:
    """Kernel launches so far, by kernel variant."""
    return {
        "probe_topk": probe_topk.launches,
        "probe_topk_quant_int8": probe_topk_quant.launches_by_bits[8],
        "probe_topk_quant_int4": probe_topk_quant.launches_by_bits[4],
        "probe_topk_int8q_int8": probe_topk_int8q.launches_by_bits[8],
        "probe_topk_int8q_int4": probe_topk_int8q.launches_by_bits[4],
    }


def reset_launch_counts() -> None:
    probe_topk.launches = 0
    for fn in (probe_topk_quant, probe_topk_int8q):
        fn.launches = 0
        fn.launches_by_bits = {8: 0, 4: 0}


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
                 backend: str = "cuda", int8_queries: bool = False):
    """Exact top-k of every query over its probed buckets. Returns
    (dists (Q, k) float32 ascending, ids (Q, k) 0-based with -1 for empty
    places, max slots routed to one bucket).

    ``backend="cuda"`` goes through the kernel wrappers (the kernels on
    CUDA tensors); ``"torch"`` calls their plain versions. A quantized
    store is scored from its codes and scales; ``int8_queries`` (quantized
    stores only, ignored otherwise) also quantizes the queries, once per
    query, for the int8 x int8 kernel."""
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown probe backend {backend!r}")
    kernel = backend == "cuda"
    q, p = probe_buckets.shape
    layout = group_slots(probe_buckets, store.offsets, store.counts)
    if not store.is_quantized:
        fn = probe_topk if kernel else probe_topk_plain
        out_d, out_i = fn(queries.to(compute_dtype).contiguous(), layout.qidx,
                          store.data_as(compute_dtype), layout.blocks, k)
    elif int8_queries:
        fn = probe_topk_int8q if kernel else probe_topk_int8q_plain
        q_codes, q_scales = quantize_rows(queries)
        out_d, out_i = fn(q_codes, q_scales, layout.qidx, store.data_sorted,
                          store.scales, layout.blocks, k, store.quant_bits)
    else:
        fn = probe_topk_quant if kernel else probe_topk_quant_plain
        out_d, out_i = fn(queries.to(compute_dtype).contiguous(), layout.qidx,
                          store.data_sorted, store.scales, layout.blocks, k,
                          store.quant_bits)
    final_d, final_i = merge_slots(out_d, out_i, layout, q, p, k,
                                   store.ids_sorted)
    return final_d, final_i, layout.slot_counts.max()
