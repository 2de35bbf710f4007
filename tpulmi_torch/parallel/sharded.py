"""Several devices: the bucket-sharded store and search, and data-parallel
training.

**Bucket-sharded search** (the JAX package's expert-parallel analog; the
MLP is the router, buckets are the experts): the store is cut into
contiguous bucket ranges, one per mesh entry, each a `BucketStore` of its
own on its entry's device, padded to the same ``rows_pad = rows +
pad_rows``. Queries and probes are replicated. Each shard remaps the global
probe ids to its local range (``where(0 <= p - start < cat_pad, p - start,
cat_pad)``: a probe of another shard, and a dumped one, lands in the
local dump bucket ``cat_pad``), runs the single-device probe (the kernels
of `ops/probe_topk.py`, their plain versions, or the xla scan) on its own
store, and gives a (Q, k) partial; the partials are gathered in mesh order
onto one device (``dist.all_gather`` across processes) and merged by a
stable top-k over the shard-major concatenation, so a tie goes to the
lower shard, then the lower rank: the JAX program's order.

**Data-parallel training**: the parameters are replicated, the batch is
split along the mesh, and the per-shard mean gradients are averaged (the
JAX package's pmean; ``dist.all_reduce`` across processes) before one Adam
step, so every replica takes the same parameters.
"""

import copy
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpulmi_torch.buckets import BucketStore
from tpulmi_torch.hoststore import _device_buffer, _slab_write
from tpulmi_torch.models.train import make_optimizer
from tpulmi_torch.ops.distance import _topk_stable, l2_normalize
from tpulmi_torch.ops.probe_topk import probe_search as kernel_probe_search
from tpulmi_torch.parallel.mesh import (Mesh, all_reduce, check_mesh,
                                        gather_entries)
from tpulmi_torch.search import (_probe_search_impl, route_probes,
                                 routing_logits, size_class)


@dataclass
class ShardedBucketStore:
    """A store cut into contiguous bucket ranges: shard s holds global
    buckets ``[bucket_start[s], bucket_start[s] + cat_pad)`` (a ragged last
    shard pads with empty buckets) as a `BucketStore` of ``rows_pad`` rows
    on its mesh entry's device; None where another process owns it. The
    shards are copies, not views of the flat store."""

    shards: List[Optional[BucketStore]]
    bucket_start: np.ndarray   # (S,) int32 first global bucket of a shard
    n_shards: int
    cat_pad: int
    rows: int                  # rows of the largest shard
    pad_rows: int
    max_bucket: int            # rows of the largest bucket of any shard
    row_align: int = 1
    is_quantized: bool = False
    # code width of a quantized store (BucketStore.quant_bits)
    quant_bits: int = 8

    @property
    def rows_pad(self) -> int:
        return self.rows + self.pad_rows

    def local(self):
        """(shard index, store) of this process's shards, in mesh order."""
        return [(s, st) for s, st in enumerate(self.shards) if st is not None]

    def nbytes(self) -> int:
        """Bytes of this process's shards: rows, ids, scales, offsets and
        counts."""
        return sum(t.numel() * t.element_size()
                   for _, st in self.local()
                   for t in (st.data_sorted, st.ids_sorted, st.offsets,
                             st.counts, st.scales) if t is not None)


def _bounds(offsets: np.ndarray, n_cat: int, n_shards: int):
    """(cat_pad, [(lo, hi, row_lo, row_hi)] per shard, rows)."""
    cat_pad = -(-n_cat // n_shards)
    bounds = []
    for s in range(n_shards):
        lo, hi = min(s * cat_pad, n_cat), min((s + 1) * cat_pad, n_cat)
        bounds.append((lo, hi, int(offsets[lo]), int(offsets[hi])))
    return cat_pad, bounds, max(max(b[3] - b[2] for b in bounds), 1)


def _local_csr(offsets: np.ndarray, counts: np.ndarray, lo: int, hi: int,
               cat_pad: int, device):
    """A shard's (offsets, counts): the flat store's offsets rebased to the
    shard's first row, which keeps the alignment gaps of a row_align > 1
    store (a cumsum of the counts would lose them)."""
    off = np.zeros(cat_pad + 1, np.int32)
    cnt = np.zeros(cat_pad, np.int32)
    cnt[:hi - lo] = counts[lo:hi]
    off[:hi - lo + 1] = offsets[lo:hi + 1] - offsets[lo]
    off[hi - lo + 1:] = off[hi - lo]
    return (torch.as_tensor(off, device=device),
            torch.as_tensor(cnt, device=device))


def _cut(targets, offsets, counts, ids, scales, put_rows, *, pad_rows: int,
         row_align: int, quant_bits: int) -> ShardedBucketStore:
    """The shards of a flat layout (`offsets`, `counts`, `ids`, `scales`:
    tensors or host arrays) on `targets` (a device per shard, None where
    another process owns it); ``put_rows(device, row_lo, row_hi,
    rows_pad)`` gives a shard's zero-padded rows on its device."""
    cat_pad, bounds, rows = _bounds(offsets, int(counts.shape[0]),
                                    len(targets))
    rows_pad = rows + pad_rows
    shards = []
    for dev, (lo, hi, row_lo, row_hi) in zip(targets, bounds):
        if dev is None:
            shards.append(None)
            continue
        n = row_hi - row_lo
        ids_s = torch.full((rows_pad,), -1, dtype=torch.int32, device=dev)
        ids_s[:n] = torch.as_tensor(ids[row_lo:row_hi], device=dev)
        scales_s = None
        if scales is not None:
            scales_s = torch.zeros((rows_pad,), dtype=torch.float32,
                                   device=dev)
            scales_s[:n] = torch.as_tensor(scales[row_lo:row_hi], device=dev)
        off, cnt = _local_csr(offsets, counts, lo, hi, cat_pad, dev)
        shards.append(BucketStore(
            data_sorted=put_rows(dev, row_lo, row_hi, rows_pad),
            ids_sorted=ids_s, offsets=off, counts=cnt, n=rows,
            pad_rows=pad_rows, row_align=row_align, scales=scales_s,
            quant_bits=quant_bits))
    return ShardedBucketStore(
        shards=shards,
        bucket_start=np.array([b[0] for b in bounds], np.int32),
        n_shards=len(targets), cat_pad=cat_pad, rows=rows,
        pad_rows=pad_rows, max_bucket=int(counts.max(initial=0)),
        row_align=row_align, is_quantized=scales is not None,
        quant_bits=quant_bits)


def _targets(mesh: Optional[Mesh], n_shards: Optional[int], device):
    """The device of each shard, None where another process owns it."""
    if mesh is None:
        return [device] * n_shards
    check_mesh(mesh)
    local = set(mesh.local_entries())
    return [d if i in local else None for i, d in enumerate(mesh.devices.flat)]


def shard_store(store: BucketStore, n_shards: Optional[int] = None,
                mesh: Optional[Mesh] = None) -> ShardedBucketStore:
    """Cut a built store into `n_shards` contiguous bucket ranges, each
    copied into a zero-padded store of ``rows_pad`` rows: on its mesh
    entry's device with `mesh` (only this process's entries), else on the
    store's device. Bucket skew across shards costs padding rows, not
    work."""
    def put_rows(dev, row_lo, row_hi, rows_pad):
        data = torch.zeros((rows_pad, *store.data_sorted.shape[1:]),
                           dtype=store.data_sorted.dtype, device=dev)
        data[:row_hi - row_lo] = store.data_sorted[row_lo:row_hi]
        return data

    return _cut(_targets(mesh, n_shards, store.device),
                store.offsets.cpu().numpy(), store.counts.cpu().numpy(),
                store.ids_sorted, store.scales, put_rows,
                pad_rows=store.pad_rows, row_align=store.row_align,
                quant_bits=store.quant_bits)


def shard_store_from_host(arrays, mesh: Mesh,
                          slab_rows: int = 262_144) -> ShardedBucketStore:
    """A sharded store straight from the host layout
    (`tpulmi_torch.hoststore.HostStoreArrays`): each of this process's
    shards is copied slab by slab (`hoststore`'s pinned slab upload) from a
    zero-copy row range of the host arrays to its own device. The flat
    store is never resident on one device: the path for a store larger
    than one card. Equal to `shard_store` of the same layout."""
    def put_rows(dev, row_lo, row_hi, rows_pad):
        data = _device_buffer(arrays.data_sorted, rows_pad, dev).zero_()
        return _slab_write(data, arrays.data_sorted[row_lo:row_hi],
                           slab_rows)

    return _cut(_targets(mesh, None, None), np.asarray(arrays.offsets),
                np.asarray(arrays.counts), arrays.ids_sorted, arrays.scales,
                put_rows, pad_rows=int(arrays.pad_rows),
                row_align=int(arrays.row_align),
                quant_bits=arrays.quant_bits)


def local_probes(probes: torch.Tensor, start: int,
                 cat_pad: int) -> torch.Tensor:
    """Global probe ids -> a shard's local ids; every id outside the
    shard's range (another shard's, and a dumped -1) becomes the local dump
    bucket `cat_pad`, which the probe drops."""
    local = probes - int(start)
    return torch.where((local >= 0) & (local < cat_pad), local,
                       torch.full_like(local, cat_pad))


def search_shards(probes: torch.Tensor, queries: torch.Tensor,
                  sstore: ShardedBucketStore, mesh: Mesh, *, k: int,
                  backend: str, compute_dtype=torch.bfloat16,
                  int8_queries: bool = False, pair: bool = False,
                  qpb_pad: int = 128, data_chunk: int = 2048,
                  max_chunks: int = 1, query_chunk: int = 512):
    """Probe every shard of this process and merge all shards' partials:
    (dists (Q, k), 0-based ids (Q, k), max slots of one bucket as a 0-d
    tensor), on the queries' device. `probes` (Q, P) are global ids,
    `queries` normalized. ``backend`` "cuda" / "torch" runs
    `kernel_probe_search` (the kernels, or their plain versions) with
    `compute_dtype`, `int8_queries` and `pair`; "xla" the scan of
    `search.py` with the padding classes `qpb_pad`, `data_chunk`,
    `max_chunks`. The probes and queries are copied once to each distinct
    device."""
    home = queries.device
    on = {}
    parts_d, parts_i, slots = [], [], []
    for s, st in sstore.local():
        dev = st.device
        if dev not in on:
            on[dev] = (probes.to(dev), queries.to(dev))
        p, q = on[dev]
        p = local_probes(p, sstore.bucket_start[s], sstore.cat_pad)
        if backend == "xla":
            d, i, mx = _probe_search_impl(
                p, q, st, k=k, qpb_pad=qpb_pad, data_chunk=data_chunk,
                max_chunks=max_chunks, query_chunk=query_chunk,
                compute_dtype=compute_dtype)
            mx = torch.tensor(mx, device=dev)
        else:
            d, i, mx = kernel_probe_search(
                p, q, st, k=k, compute_dtype=compute_dtype, backend=backend,
                int8_queries=int8_queries, pair=pair)[:3]
        parts_d.append(d)
        parts_i.append(i)
        slots.append(mx.to(home))
    all_d = gather_entries(parts_d, mesh, home)       # (S, Q, k)
    all_i = gather_entries(parts_i, mesh, home)
    s, q, _ = all_d.shape
    d, i = _topk_stable(all_d.permute(1, 0, 2).reshape(q, s * k),
                        all_i.permute(1, 0, 2).reshape(q, s * k), k)
    return d, i, all_reduce(torch.stack(slots).max(), "max")


def sharded_probe_search(probe_buckets, queries_search,
                         sstore: ShardedBucketStore, mesh: Mesh, k: int = 10,
                         data_chunk: int = 2048, qpb_pad: Optional[int] = None,
                         backend: str = "xla"):
    """Bucket-sharded probe search over `mesh`: (dists, ids) like
    `search.py`'s scan (0-based ids). Each shard searches its bucket range;
    the partial top-k lists are gathered and merged, ties broken by shard,
    then by rank (the k-set equals the single-device search's; the order
    of equal distances may differ). `queries_search` are normalized; the
    default ``backend="xla"`` is the JAX function's scan, and "cuda" /
    "torch" run the probe kernels or their plain versions in float32.

    Every process passes the same host inputs (numpy arrays or CPU
    tensors); they are placed on this process's first mesh device."""
    check_mesh(mesh)
    home = mesh.devices.flat[mesh.local_entries()[0]]
    probes = torch.as_tensor(probe_buckets, dtype=torch.int32, device=home)
    queries = torch.as_tensor(queries_search, dtype=torch.float32,
                              device=home)
    # static padding classes from the slots of this batch (one host read)
    flat = probes.reshape(-1).to(torch.int64)
    max_slots = int(torch.bincount(flat, minlength=1).max())
    max_bucket = max(sstore.max_bucket, 1)
    data_chunk = min(data_chunk, size_class(max_bucket), sstore.rows_pad)
    qpb_pad = qpb_pad or size_class(max(max_slots, 1))
    d, i, _ = search_shards(
        probes, queries, sstore, mesh, k=k, backend=backend,
        compute_dtype=None if backend == "xla" else torch.float32,
        qpb_pad=qpb_pad, data_chunk=data_chunk,
        max_chunks=max(-(-max_bucket // data_chunk), 1),
        query_chunk=min(512, qpb_pad))
    return d, i


def make_sharded_search_program(model, mesh: Mesh, *, k: int,
                                n_buckets: int, compute_dtype=torch.bfloat16,
                                backend: str = "cuda", probe_mass=None,
                                int8_queries: bool = False,
                                pair: bool = False, qpb_pad: int = 128,
                                data_chunk: int = 2048, max_chunks: int = 1,
                                query_chunk: int = 512):
    """The several-device counterpart of `search.make_search_program`: one
    function (queries_nav, queries_search, sstore) -> (dists, ids,
    max_slots) that routes once on the router's device, normalizes the
    queries and runs `search_shards`. ``probe_mass`` truncates a query's
    probes at the routed-mass crossing with dump id -1, which lies below
    every shard's range, a ragged last shard's too, so the remap drops it
    on every shard. The worklist and the rerank pool are not taken: the
    JAX package's sharded program has neither."""

    @torch.no_grad()
    def program(queries_nav, queries_search, sstore):
        logits, mass_logits = routing_logits(
            model, queries_nav, need_mass=probe_mass is not None)
        probes = route_probes(logits, n_buckets, probe_mass=probe_mass,
                              dump_id=-1, mass_logits=mass_logits)
        qs = l2_normalize(queries_search.float())
        return search_shards(
            probes, qs, sstore, mesh, k=k, backend=backend,
            compute_dtype=compute_dtype, int8_queries=int8_queries,
            pair=pair, qpb_pad=qpb_pad, data_chunk=data_chunk,
            max_chunks=max_chunks, query_chunk=query_chunk)

    return program


class DPTrainStep:
    """Data-parallel Adam over `mesh`: the model is replicated once per
    distinct device of this process, every entry's share of a batch goes
    through its device's replica, and the entries' mean-loss gradients are
    averaged over the whole mesh (summed over this process's devices in
    order, then ``dist.all_reduce``) before one step of one optimizer; the
    replicas then copy its parameters, so every replica on every process
    holds the same bits. ``model`` (on the first device) carries the
    result."""

    def __init__(self, model, lr: float, mesh: Mesh):
        self.mesh = check_mesh(mesh)
        self.entries = mesh.local_entries()
        self.devices = mesh.local_devices()
        self.model = model.to(self.devices[0])
        self.opt = make_optimizer(self.model, lr)
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d)
                                        for d in self.devices[1:]]
        # this process's mesh entries on each of its devices
        self.groups = [[s for s in self.entries if mesh.devices.flat[s] == d]
                       for d in self.devices]

    def replica(self, device) -> torch.nn.Module:
        return self.replicas[self.devices.index(device)]

    def step_groups(self, xs: Sequence[torch.Tensor],
                    ys: Sequence[torch.Tensor]) -> torch.Tensor:
        """One step. ``xs[g]`` (n_g, b, d) and ``ys[g]`` (n_g, b) hold the
        batches of the n_g local entries on ``devices[g]``. Returns the
        loss, the mean over every mesh entry of its batch's mean
        cross-entropy."""
        home = self.devices[0]
        total = None
        for rep, x, y in zip(self.replicas, xs, ys):
            ce = F.cross_entropy(rep(x.reshape(-1, x.shape[-1])),
                                 y.reshape(-1).long(), reduction="none")
            part = ce.reshape(y.shape).mean(1).sum()
            grads = torch.autograd.grad(part, list(rep.parameters()))
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [part.detach().reshape(1)]).to(home)
            total = flat if total is None else total + flat
        total = all_reduce(total) / self.mesh.size
        at = 0
        for p in self.model.parameters():
            p.grad = total[at:at + p.numel()].view_as(p)
            at += p.numel()
        self.opt.step()
        with torch.no_grad():
            for rep in self.replicas[1:]:
                for a, b in zip(rep.parameters(), self.model.parameters()):
                    a.copy_(b)
        return total[-1]

    def __call__(self, xb, yb) -> torch.Tensor:
        """One step on a global batch (every process passes the same),
        split into ``mesh.size`` equal parts along the mesh."""
        xb = torch.as_tensor(xb, dtype=torch.float32)
        yb = torch.as_tensor(yb)
        n = int(xb.shape[0])
        if n % self.mesh.size:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.mesh.size} mesh entries")
        xb = xb.reshape(self.mesh.size, n // self.mesh.size, -1)
        yb = yb.reshape(self.mesh.size, -1)
        xs, ys = [], []
        for d, group in zip(self.devices, self.groups):
            xs.append(xb[group].to(d))
            ys.append(yb[group].to(d))
        return self.step_groups(xs, ys)


def make_dp_train_step(model, lr: float, mesh: Mesh) -> DPTrainStep:
    """A data-parallel train step over `mesh` (see `DPTrainStep`):
    ``loss = step(xb, yb)`` updates ``step.model`` in place."""
    return DPTrainStep(model, lr, mesh)
