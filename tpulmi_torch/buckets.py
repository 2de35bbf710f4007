"""Bucket store: label-sorted CSR layout of the search-space vectors.

- ``data_sorted``: the normalized search vectors permuted into
  bucket-contiguous order, so each bucket is one contiguous row range;
- ``ids_sorted``: the original 0-based row id of every sorted row, -1 on
  padding rows;
- ``offsets``/``counts``: CSR bucket boundaries.

A quantized store (`tpulmi_torch/ops/quantize.py::quantize_store`) holds
int8 codes in ``data_sorted`` (two packed int4 codes per byte when
``quant_bits == 4``) and one float32 scale per row in ``scales``, with
``x ~ codes * (scales / q_levels)[:, None]``.

With ``row_align > 1`` every bucket starts on a multiple of ``row_align``
rows (sentinel rows fill the gaps), and the store holds the static worst case
``n + n_categories*row_align`` rows, rounded, plus ``pad_rows`` — the same
row count as the JAX package's store.

`compute_bucket_bounds` adds per-bucket pruning bounds: the unit centroid
``c_b``, ``cos r_b`` = the least ``x̂ . c_b`` over the bucket's rows, and the
largest row norm ``m_b``. For a unit query q and any row x of bucket b,

    q . x <= m_b * max(0, cos(max(0, theta_qc - r_b))),  cos theta_qc = q . c_b

the spherical-cap bound behind the threshold prune of
`tpulmi_torch.search._probe_search_core`.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch


@dataclass
class BucketStore:
    data_sorted: torch.Tensor  # (rows, d) float32 search vectors, bucket-sorted;
    #                            int8 codes, (rows, d/2) when packed int4
    ids_sorted: torch.Tensor   # (rows,) int32 original row ids; -1 on padding
    offsets: torch.Tensor      # (n_categories + 1,) int32 CSR offsets
    counts: torch.Tensor       # (n_categories,) int32 bucket sizes
    n: int = 0
    pad_rows: int = 0
    row_align: int = 1
    # (rows,) float32 per-row scales of a quantized store; None when the
    # store is full precision
    scales: Optional[torch.Tensor] = None
    # code width of a quantized store: 8, or 4 (two codes per stored byte);
    # means something only when scales is not None
    quant_bits: int = 8
    # data_sorted cast to the probe's compute dtype, made once per dtype.
    # The bfloat16 copy on the main path costs rows * d * 2 bytes beside the
    # float32 store (the JAX package casts the store on every search call).
    _casts: Dict[torch.dtype, torch.Tensor] = field(
        default_factory=dict, repr=False, compare=False)
    # per-bucket pruning bounds (compute_bucket_bounds), float32: unit
    # centroids (n_categories, d), cos r_b (n_categories,), and the largest
    # row norm (n_categories,); None until computed
    bucket_centroids: Optional[torch.Tensor] = None
    bucket_cos_r: Optional[torch.Tensor] = None
    bucket_max_norm: Optional[torch.Tensor] = None

    @property
    def n_categories(self) -> int:
        return int(self.counts.shape[0])

    @property
    def is_quantized(self) -> bool:
        return self.scales is not None

    @property
    def packed(self) -> bool:
        """True for a packed int4 store (two codes per stored byte)."""
        return self.is_quantized and self.quant_bits == 4

    @property
    def q_levels(self) -> float:
        """Dequantization divisor: x ~ codes * (scales / q_levels)."""
        return 7.0 if self.quant_bits == 4 else 127.0

    @property
    def has_bounds(self) -> bool:
        return self.bucket_centroids is not None

    @property
    def dim(self) -> int:
        """Logical vector width (a packed int4 store holds dim/2 bytes)."""
        d = int(self.data_sorted.shape[1])
        return d * 2 if self.packed else d

    @property
    def device(self) -> torch.device:
        return self.data_sorted.device

    def data_as(self, dtype: torch.dtype) -> torch.Tensor:
        """`data_sorted` in `dtype`, cast once and kept. Codes are never
        cast: a quantized store raises."""
        if self.is_quantized:
            raise ValueError("a quantized store holds codes, not vectors: "
                             "the probe reads data_sorted and scales")
        if dtype == self.data_sorted.dtype:
            return self.data_sorted
        if dtype not in self._casts:
            self._casts[dtype] = self.data_sorted.to(dtype)
        return self._casts[dtype]


def aligned_rows(n: int, n_categories: int, pad_rows: int,
                 row_align: int) -> Tuple[int, int]:
    """(rows for the buckets, rows of tail padding) of an aligned store."""
    n_total = -(-(n + n_categories * row_align) // row_align) * row_align
    return n_total, -(-pad_rows // row_align) * row_align


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0).to(x.dtype)])


def layout_store(labels: torch.Tensor, data_search: torch.Tensor,
                 n_categories: int, pad_rows: int, row_align: int):
    """Stable sort by label into the CSR layout. Returns
    (data_sorted, ids_sorted, offsets, counts, pad_rows)."""
    labels = labels.to(torch.int64)
    n, d = data_search.shape
    dev = data_search.device
    order = torch.argsort(labels, stable=True)
    counts = torch.bincount(labels, minlength=n_categories).to(torch.int32)
    if row_align <= 1:
        offsets = _exclusive_cumsum(counts)
        data_sorted = torch.cat(
            [data_search[order], data_search.new_zeros((pad_rows, d))])
        ids_sorted = torch.cat(
            [order.to(torch.int32),
             torch.full((pad_rows,), -1, dtype=torch.int32, device=dev)])
        return data_sorted, ids_sorted, offsets, counts, pad_rows
    aligned = -(-counts // row_align) * row_align
    offsets = _exclusive_cumsum(aligned)
    raw_offsets = _exclusive_cumsum(counts)
    n_total, pad_rows = aligned_rows(n, n_categories, pad_rows, row_align)
    sorted_labels = labels[order]
    rank = torch.arange(n, device=dev) - raw_offsets[sorted_labels]
    pos = offsets[sorted_labels].to(torch.int64) + rank
    data_sorted = data_search.new_zeros((n_total + pad_rows, d))
    data_sorted[pos] = data_search[order]
    ids_sorted = torch.full((n_total + pad_rows,), -1, dtype=torch.int32,
                            device=dev)
    ids_sorted[pos] = order.to(torch.int32)
    return data_sorted, ids_sorted, offsets, counts, pad_rows


def build_bucket_store(labels, data_search, n_categories: int,
                       pad_rows: int = 4096, row_align: int = 1) -> BucketStore:
    """Construct the store from per-row bucket labels (the model's argmax
    assignment, not the raw k-means labels)."""
    data_search = torch.as_tensor(data_search)
    labels = torch.as_tensor(labels, device=data_search.device)
    data_sorted, ids_sorted, offsets, counts, pad_rows = layout_store(
        labels, data_search, n_categories, pad_rows, row_align)
    return BucketStore(
        data_sorted=data_sorted, ids_sorted=ids_sorted, offsets=offsets,
        counts=counts, n=int(data_search.shape[0]), pad_rows=int(pad_rows),
        row_align=int(max(row_align, 1)))


def compute_bucket_bounds(store: BucketStore,
                          chunk: int = 65536) -> BucketStore:
    """The store with its per-bucket pruning bounds (see the module
    docstring), from two streaming passes over fixed-size row chunks: the
    first sums each bucket's rows and takes their largest norm, the second
    the least cosine of a row to its unit centroid. A quantized store is
    dequantized chunk by chunk, so the bound holds for the distances the
    scan computes from the codes. Sentinel rows (id -1) count nowhere; an
    empty bucket gets max norm 0, which makes its bound 1 (always pruned).

    Bucket sums are one-hot products, in a fixed order (as the build's
    k-means update), so the bounds are the same in every run."""
    from dataclasses import replace

    from tpulmi_torch.ops.quantize import unpack_int4

    dev = store.device
    rows_total = int(store.data_sorted.shape[0])
    chunk = min(chunk, rows_total)
    n_chunks = -(-rows_total // chunk)
    n_cat, d = store.n_categories, store.dim
    offsets = store.offsets.to(torch.int64)
    cats = torch.arange(n_cat, device=dev)

    def load(j):
        nominal = j * chunk
        start = min(nominal, rows_total - chunk)
        rows = store.data_sorted[start:start + chunk]
        if store.packed:
            rows = unpack_int4(rows)
        rows = rows.float()
        if store.is_quantized:
            s = store.scales[start:start + chunk]
            rows = rows * (s / store.q_levels)[:, None]
        rid = store.ids_sorted[start:start + chunk]
        gidx = start + torch.arange(chunk, device=dev)
        # real rows only, and never twice: a clamped tail chunk re-reads
        # rows of the chunk before it
        valid = (rid >= 0) & (gidx >= nominal)
        labels = torch.clamp(
            torch.searchsorted(offsets, gidx, right=True) - 1, 0, n_cat - 1)
        return rows, labels, valid

    c_sum = torch.zeros((n_cat, d), dtype=torch.float32, device=dev)
    max_norm = torch.zeros((n_cat,), dtype=torch.float32, device=dev)
    for j in range(n_chunks):
        rows, labels, valid = load(j)
        w = valid.float()
        onehot = (labels[None, :] == cats[:, None]).float() * w[None, :]
        c_sum += onehot @ rows
        max_norm = max_norm.scatter_reduce(
            0, labels, torch.linalg.vector_norm(rows, dim=1) * w, "amax")
    centroids = c_sum / torch.clamp(
        torch.linalg.vector_norm(c_sum, dim=1, keepdim=True), min=1e-12)

    cos_r = torch.full((n_cat,), float("inf"), dtype=torch.float32,
                       device=dev)
    for j in range(n_chunks):
        rows, labels, valid = load(j)
        rhat = rows / torch.clamp(
            torch.linalg.vector_norm(rows, dim=1, keepdim=True), min=1e-12)
        cosv = (rhat * centroids[labels]).sum(dim=1)
        cosv = torch.where(valid, cosv, torch.full_like(cosv, float("inf")))
        cos_r = cos_r.scatter_reduce(0, labels, cosv, "amin")
    cos_r = torch.clamp(torch.where(torch.isfinite(cos_r), cos_r,
                                    torch.ones_like(cos_r)), -1.0, 1.0)
    return replace(store, bucket_centroids=centroids, bucket_cos_r=cos_r,
                   bucket_max_norm=max_norm)


def bucket_stats(store: BucketStore) -> Tuple[int, int, float]:
    """(max, min, mean) bucket size."""
    counts = store.counts.to(torch.float64)
    return int(counts.max()), int(counts.min()), float(counts.mean())
