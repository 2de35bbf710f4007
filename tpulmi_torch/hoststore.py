"""Host-side bucket-store layout for corpora too large to lay out on the card.

The counterpart of ``tpulmi/hoststore.py``. `layout_host_store` writes the
bucket-sorted, ``row_align``-aligned store (bfloat16, float32, int8 or
packed int4 codes with per-row scales) straight into host buffers, so that
the card holds only the final store: the card-side layout of
``tpulmi_torch/buckets.py`` needs the source and the sorted copy at once.
`layout_and_upload` copies the store to the card in slabs through pinned
buffers on a copy stream of its own, and with ``overlap=True`` does so
while the layout is still writing the store's tail.

The layout takes one of three paths, chosen up front:

- the native gather (``tpulmi_torch/native.py``, several threads) when the
  library has loaded and takes the dtypes (float32 / float16 / bfloat16
  sources; float32 / bfloat16 / int8 stores);
- the numpy gather otherwise (float64 sources, int4 stores, no compiler);
- the source-sequential scatter when the corpus is a memory map that
  `ensure_in_ram` did not copy into RAM: the corpus is read in sequential
  chunks and scattered into the store, since a random gather over a disk
  memory map is an IO storm.

The native path rounds int8 codes as ``nearbyintf(x * (127 / amax))``, the
numpy paths as ``rint(x / amax * 127)``; a code can differ by one between
them, so each path is held to its own twin in the JAX package.

**bfloat16 on the host.** numpy has no bfloat16 and this package imports no
``ml_dtypes``. A bfloat16 host array is a `HostBF16`: its uint16 bit
patterns (``.bits``, a numpy array, possibly a ``np.memmap`` or a view of
one, so the memory-map test above still sees it) with the dtype carried
beside them. ``str(x.dtype)`` is ``"bfloat16"``; indexing gives another
`HostBF16`; ``np.asarray(x)`` decodes to float32, exactly. These are the
bits of the JAX package's ``ml_dtypes.bfloat16`` arrays and of its ``.npy``
caches (bfloat16 saved as uint16), and the native library reads them as
dtype code 2.
"""

import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tpulmi_torch.ops.quantize import quantize_rows_int4_host
from tpulmi_torch.utils.logging import get_logger

log = get_logger("tpulmi_torch.hoststore")


# ------------------------------------------------------------ bfloat16 host
def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounded to nearest even,
    NaNs quieted as XLA does (the JAX package's ``_f32_to_bf16_bits``)."""
    x = np.ascontiguousarray(x, np.float32)
    v = x.view(np.uint32)
    rounded = (v + np.uint32(0x7FFF) + ((v >> np.uint32(16)) & np.uint32(1)))
    out = (rounded >> np.uint32(16)).astype(np.uint16)
    nan = ~np.isfinite(x) & ((v & np.uint32(0x007FFFFF)) != 0)
    if nan.any():
        out[nan] = np.uint16(0x7FC1)
    return out


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns -> float32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32)
            << np.uint32(16)).view(np.float32)


class _BF16Type:
    """The ``dtype`` of a `HostBF16`: prints as "bfloat16", 2 bytes."""

    name = "bfloat16"
    itemsize = 2

    def __str__(self):
        return "bfloat16"

    __repr__ = __str__


class HostBF16:
    """A bfloat16 host array held as its uint16 bit patterns (see the
    module docstring)."""

    dtype = _BF16Type()

    def __init__(self, bits):
        if np.dtype(bits.dtype) != np.uint16:
            raise TypeError(f"bfloat16 bits must be uint16, not {bits.dtype}")
        self.bits = bits

    @classmethod
    def zeros(cls, shape) -> "HostBF16":
        return cls(np.zeros(shape, np.uint16))

    @classmethod
    def from_float32(cls, x) -> "HostBF16":
        """Round float32 values to bfloat16 (nearest even)."""
        return cls(f32_to_bf16_bits(np.asarray(x, np.float32)))

    @property
    def shape(self):
        return self.bits.shape

    @property
    def nbytes(self) -> int:
        return self.bits.nbytes

    @property
    def flags(self):
        return self.bits.flags

    @property
    def filename(self):
        """The file of a memory-mapped array, else None."""
        return getattr(self.bits, "filename", None)

    def __len__(self) -> int:
        return len(self.bits)

    def __getitem__(self, idx) -> "HostBF16":
        return HostBF16(self.bits[idx])

    def __setitem__(self, idx, value) -> None:
        """Write bfloat16 rows (another HostBF16: its bits) or float values
        (rounded to nearest even)."""
        if isinstance(value, HostBF16):
            self.bits[idx] = value.bits
        else:
            self.bits[idx] = f32_to_bf16_bits(np.asarray(value, np.float32))

    def __array__(self, dtype=None, copy=None):
        out = bf16_bits_to_f32(self.bits)
        return out if dtype is None else out.astype(dtype, copy=False)

    def to_torch(self) -> torch.Tensor:
        """A CPU ``torch.bfloat16`` tensor over the same bits (a copy for a
        read-only memory map)."""
        bits = self.bits if self.bits.flags["WRITEABLE"] else np.array(
            self.bits)
        return torch.from_numpy(
            np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def host_dtype(arr) -> str:
    """The dtype name of a host array: "bfloat16" for a HostBF16."""
    dtype = getattr(arr, "dtype", None)
    if dtype is None:
        dtype = np.asarray(arr[:1]).dtype
    return str(dtype)


def is_memory_mapped(arr) -> bool:
    """True for a np.memmap, a view of one, or a HostBF16 over either."""
    arr = getattr(arr, "bits", arr)
    return isinstance(arr, np.memmap) or isinstance(
        getattr(arr, "base", None), np.memmap)


def host_tensor(arr) -> torch.Tensor:
    """A CPU tensor over a host array's memory: float32, float16, int8 or
    int32 arrays as themselves, a HostBF16 as torch.bfloat16."""
    if isinstance(arr, HostBF16):
        return arr.to_torch()
    return torch.from_numpy(np.ascontiguousarray(arr))


# ---------------------------------------------------------- materialization
def _mem_total_bytes():
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def ensure_in_ram(arr, max_frac: float = None):
    """Copy a memory-mapped corpus into RAM with one sequential read (a
    random-access gather over a disk memory map is IO-bound). Anything
    else is returned as it is.

    Refuses, returning the memory map unchanged, when the copy alone would
    pass ``max_frac`` of the host's RAM (default: the environment's
    ``TPULMI_MATERIALIZE_MAX_FRAC``, else 0.45); `layout_host_store` then
    takes its source-sequential path, which needs no copy."""
    if not is_memory_mapped(arr):
        return arr
    if max_frac is None:
        max_frac = float(os.environ.get("TPULMI_MATERIALIZE_MAX_FRAC",
                                        "0.45"))
    total = _mem_total_bytes()
    if total is not None and arr.nbytes > max_frac * total:
        log.info("corpus stays memory-mapped: %.1f GB copy > %.0f%% of "
                 "%.1f GB host RAM", arr.nbytes / 1e9, max_frac * 100,
                 total / 1e9)
        return arr
    log.info("materializing memory-mapped corpus in RAM (%s)", arr.shape)
    if isinstance(arr, HostBF16):
        return HostBF16(np.array(arr.bits))
    return np.array(arr)


# ------------------------------------------------------------------- layout
@dataclass
class HostStoreArrays:
    """The BucketStore contents as host arrays, ready for one upload."""

    data_sorted: object              # (n_total + pad_rows, d): np.ndarray
    #                                  (float32 / int8; d/2 packed bytes for
    #                                  int4) or HostBF16
    ids_sorted: np.ndarray           # (n_total + pad_rows,) int32
    offsets: np.ndarray              # (n_categories + 1,) int32
    counts: np.ndarray               # (n_categories,) int32
    scales: Optional[np.ndarray]     # (n_total + pad_rows,) f32 or None
    n: int
    pad_rows: int
    row_align: int
    quant_bits: int = 8              # 8 (int8) or 4 (packed int4)


def _quantize_int8_host(rows: np.ndarray):
    """The numpy paths' int8 codes: (codes, scales) with
    codes = rint(rows / amax * 127)."""
    s = np.maximum(np.abs(rows).max(axis=1), 1e-12)
    codes = np.clip(np.rint(rows / s[:, None] * 127.0), -127, 127)
    return codes.astype(np.int8), s


def _write_rows(store_host, scales_host, idx, rows: np.ndarray,
                packed4: bool) -> None:
    """Write normalized float32 `rows` to store positions `idx`: cast on
    assignment (a HostBF16 rounds to nearest even), or as codes and scales
    when the store is quantized."""
    if scales_host is None:
        store_host[idx] = rows
        return
    quantize = quantize_rows_int4_host if packed4 else _quantize_int8_host
    codes, s = quantize(rows)
    store_host[idx] = codes
    scales_host[idx] = s


def _normalize_rows(rows: np.ndarray) -> np.ndarray:
    # not in place: rows read from a read-only memory map are a view of it
    return rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True),
                             1e-12)


def layout_host_store(
    pred: np.ndarray,
    data_search_host,
    n_categories: int,
    *,
    row_align: int = 1,
    store_dtype: str = "bfloat16",
    normalized: bool = False,
    pad_rows: int = 4096,
    chunk: int = 1_000_000,
    progress_cb=None,
    on_alloc=None,
) -> HostStoreArrays:
    """Lay `data_search_host` out in bucket-sorted aligned order on the
    host. `pred` is the (n,) bucket of every row. `store_dtype` is
    "bfloat16", "float32", "int8" or "int4" (the quantized ones add
    per-row scales; int4 packs two codes a byte into (rows, d/2) int8, the
    layout of `tpulmi_torch.ops.quantize.pack_int4`).

    ``progress_cb(final_rows)`` is called after each source chunk with a
    watermark: store rows ``[0, final_rows)`` are final and will not be
    written again (store positions rise with the stable label sort), which
    lets an uploader copy them while the tail is laid out.
    ``on_alloc(store_host, total_rows)`` is called once, right after the
    store buffer is allocated."""
    align = max(row_align, 1)
    quantized = store_dtype in ("int8", "int4")
    packed4 = store_dtype == "int4"
    if quantized:
        dtype = np.dtype(np.int8)
    elif store_dtype == "bfloat16":
        dtype = None
    else:
        dtype = np.dtype(store_dtype)

    n = int(pred.shape[0])
    d = int(np.asarray(data_search_host[:1]).shape[1])
    t0 = time.perf_counter()
    data_search_host = ensure_in_ram(data_search_host)
    counts = np.bincount(pred, minlength=n_categories).astype(np.int32)
    aligned = -(-counts // align) * align
    offsets = np.concatenate([[0], np.cumsum(aligned)]).astype(np.int32)
    pad_rows = -(-pad_rows // align) * align
    n_total = int(-(-(n + n_categories * align) // align) * align)

    order = np.argsort(pred, kind="stable").astype(np.int32)
    d_stored = d // 2 if packed4 else d
    if packed4 and d % 2:
        raise ValueError(f"int4 store needs even d, got {d}")
    rows_total = n_total + pad_rows
    store_host = (HostBF16.zeros((rows_total, d_stored)) if dtype is None
                  else np.zeros((rows_total, d_stored), dtype=dtype))
    ids_host = np.full((rows_total,), -1, dtype=np.int32)
    scales_host = (np.zeros((rows_total,), dtype=np.float32) if quantized
                   else None)
    raw_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    sorted_labels = pred[order]
    rank = np.arange(n, dtype=np.int64) - raw_offsets[sorted_labels]
    pos = offsets[sorted_labels].astype(np.int64) + rank
    if on_alloc is not None:
        on_alloc(store_host, rows_total)

    def arrays():
        log.info("host layout: %d rows -> %d aligned (+%d pad) in %.1fs",
                 n, n_total, pad_rows, time.perf_counter() - t0)
        if progress_cb is not None:
            # alignment gaps and the tail pad are final too
            progress_cb(rows_total)
        return HostStoreArrays(
            data_sorted=store_host, ids_sorted=ids_host, offsets=offsets,
            counts=counts, scales=scales_host, n=n, pad_rows=pad_rows,
            row_align=align, quant_bits=4 if packed4 else 8)

    if is_memory_mapped(data_search_host):
        # Source-sequential scatter: read the memory map in sequential
        # chunks and scatter into the store. dst[i] is the store position of
        # source row i. The watermark after chunk c is the least position
        # any later chunk writes (a suffix minimum of the chunks' minima);
        # source rows spread over all buckets, so the watermarks mostly
        # release at the end: the upload loses its overlap, not its order.
        dst = np.empty(n, np.int64)
        dst[order] = pos
        starts = list(range(0, n, chunk))
        cmins = np.array([dst[lo:min(lo + chunk, n)].min() for lo in starts],
                         np.int64)
        suffix = np.empty(len(starts) + 1, np.int64)
        suffix[-1] = n_total
        for i in range(len(starts) - 1, -1, -1):
            suffix[i] = min(suffix[i + 1], cmins[i])
        log.info("host layout: source-sequential scatter over %d chunks "
                 "(the corpus stays on disk)", len(starts))
        for ci, lo in enumerate(starts):
            hi = min(lo + chunk, n)
            rows = np.asarray(data_search_host[lo:hi], dtype=np.float32)
            if not normalized:
                rows = _normalize_rows(rows)
            d_chunk = dst[lo:hi]
            _write_rows(store_host, scales_host, d_chunk, rows, packed4)
            ids_host[d_chunk] = np.arange(lo, hi, dtype=np.int32)
            if progress_cb is not None:
                progress_cb(int(suffix[ci + 1]))
        return arrays()

    from tpulmi_torch.native import native_layout

    src_dtype = host_dtype(data_search_host)
    native_ok = (
        not packed4
        and not isinstance(data_search_host, (list, tuple))
        # the C++ kernel takes float32/float16/bfloat16 sources and
        # bfloat16/float32/int8 stores; anything else takes the numpy path
        and src_dtype in ("float32", "float16", "bfloat16")
        and str(store_host.dtype) in ("float32", "bfloat16", "int8")
        and native_layout.available())
    direct = (not quantized and normalized
              and src_dtype == str(store_host.dtype))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        if native_ok:
            native_layout.scatter_rows(
                data_search_host, order[lo:hi], pos[lo:hi], store_host,
                scales_host, normalized=normalized)
        elif direct:
            store_host[pos[lo:hi]] = data_search_host[order[lo:hi]]
        else:
            rows = np.asarray(data_search_host[order[lo:hi]],
                              dtype=np.float32)
            if not normalized:
                rows = _normalize_rows(rows)
            _write_rows(store_host, scales_host, pos[lo:hi], rows, packed4)
        ids_host[pos[lo:hi]] = order[lo:hi]
        if progress_cb is not None:
            progress_cb(int(pos[hi - 1]) + 1)
    return arrays()


# ------------------------------------------------------------------- upload
class _SlabCopier:
    """Copies host rows into a device buffer slab by slab.

    On a CUDA device each slab goes through one of two pinned buffers,
    allocated once, and is copied on a copy stream of its own; before a
    pinned buffer is refilled, the event of its last copy is waited for.
    `finish` makes the current stream wait for the copy stream, so work
    queued after it sees the whole buffer. On the CPU the rows are copied
    plainly."""

    def __init__(self, buf: torch.Tensor, slab_rows: int):
        self.buf = buf
        self.slab_rows = max(int(slab_rows), 1)
        self.cuda = buf.device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(buf.device)
            # the buffer may reuse memory the current stream still reads
            self.stream.wait_stream(torch.cuda.current_stream(buf.device))
            shape = (min(self.slab_rows, buf.shape[0]), *buf.shape[1:])
            self.pinned = [torch.empty(shape, dtype=buf.dtype,
                                       pin_memory=True) for _ in range(2)]
            self.events = [None, None]
            self.turn = 0

    def put(self, host_rows, lo: int) -> None:
        """Copy host rows (any length) into ``buf[lo:lo + len]``."""
        src = host_tensor(host_rows)
        for s in range(0, src.shape[0], self.slab_rows):
            part = src[s:s + self.slab_rows]
            dst = self.buf[lo + s:lo + s + part.shape[0]]
            if not self.cuda:
                dst.copy_(part)
                continue
            i = self.turn % 2
            self.turn += 1
            if self.events[i] is not None:
                self.events[i].synchronize()
            stage = self.pinned[i][:part.shape[0]]
            stage.copy_(part)
            with torch.cuda.stream(self.stream):
                dst.copy_(stage, non_blocking=True)
                self.events[i] = torch.cuda.Event()
                self.events[i].record(self.stream)

    def finish(self) -> torch.Tensor:
        if self.cuda:
            self.stream.synchronize()
            torch.cuda.current_stream(self.buf.device).wait_stream(
                self.stream)
        return self.buf


def _device_buffer(store_host, rows: int, device) -> torch.Tensor:
    dtype = (torch.bfloat16 if isinstance(store_host, HostBF16)
             else host_tensor(store_host[:1]).dtype)
    return torch.empty((rows, *store_host.shape[1:]), dtype=dtype,
                       device=device)


def _slab_write(buf: torch.Tensor, host_rows, slab_rows: int) -> torch.Tensor:
    """Copy `host_rows` into ``buf[:len(host_rows)]`` in slabs of at most
    `slab_rows` rows (see `_SlabCopier`) and return `buf`, ready for the
    current stream."""
    copier = _SlabCopier(buf, slab_rows)
    copier.put(host_rows, 0)
    return copier.finish()


def _slab_upload_serial(store_host, slab_rows: int, device) -> torch.Tensor:
    """Blocking slab-by-slab upload of a host array into a new device
    buffer."""
    buf = _device_buffer(store_host, store_host.shape[0], device)
    return _slab_write(buf, store_host, slab_rows)


def layout_and_upload(
    pred: np.ndarray,
    data_search_host,
    n_categories: int,
    *,
    device,
    row_align: int = 1,
    store_dtype: str = "bfloat16",
    normalized: bool = False,
    pad_rows: int = 4096,
    chunk: int = 1_000_000,
    overlap: bool = True,
    slab_rows: int = 262_144,
):
    """`layout_host_store` and the copy of ``data_sorted`` to `device`.
    Returns ``(arrays, data_sorted_dev)``: the host arrays (whose small
    ids, offsets, counts and scales the caller copies) and the store on
    `device` (torch.bfloat16 for a bfloat16 store).

    ``overlap=True`` copies finished slabs of the store from an uploader
    thread that follows the layout's watermarks, while the layout writes
    the tail; ``overlap=False`` lays out the whole store first, then
    copies it in slabs. Both fill the same buffer with the same bytes. An
    uploader's error is raised here."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # the uploader thread selects the card by its index
        device = torch.device("cuda", torch.cuda.current_device())
    slab_rows = max(int(slab_rows), 1)
    if not overlap:
        arrays = layout_host_store(
            pred, data_search_host, n_categories, row_align=row_align,
            store_dtype=store_dtype, normalized=normalized,
            pad_rows=pad_rows, chunk=chunk)
        return arrays, _slab_upload_serial(arrays.data_sorted, slab_rows,
                                           device)

    marks: "queue.Queue" = queue.Queue()
    state = {"err": None, "buf": None}

    def uploader():
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            copier = store_host = None
            uploaded = 0
            while True:
                item = marks.get()
                if item is None:          # the layout failed
                    return
                kind, payload = item
                if kind == "alloc":
                    store_host, total = payload
                    copier = _SlabCopier(
                        _device_buffer(store_host, total, device), slab_rows)
                    continue
                done = payload >= store_host.shape[0]
                target = (store_host.shape[0] if done
                          else (payload // slab_rows) * slab_rows)
                if target > uploaded:
                    copier.put(store_host[uploaded:target], uploaded)
                    uploaded = target
                if done:
                    state["buf"] = copier.finish()
                    return
        except BaseException as e:  # noqa: BLE001 - raised by the caller
            state["err"] = e

    th = threading.Thread(target=uploader, name="store-upload", daemon=True)
    th.start()
    try:
        arrays = layout_host_store(
            pred, data_search_host, n_categories, row_align=row_align,
            store_dtype=store_dtype, normalized=normalized,
            pad_rows=pad_rows, chunk=chunk,
            on_alloc=lambda store, total: marks.put(("alloc", (store, total))),
            progress_cb=lambda rows: marks.put(("rows", rows)))
    except BaseException:
        marks.put(None)
        th.join()
        raise
    th.join()
    if state["err"] is not None:
        raise state["err"]
    # the uploader synchronized its copy stream before it returned, so the
    # whole buffer is on the card for any stream
    log.info("overlapped store upload completed in-stream")
    return arrays, state["buf"]
