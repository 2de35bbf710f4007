"""Batched probe search: routing -> query normalization -> probe.

Every (query, probe rank) pair is a slot. The router's top-P buckets give
each query its slots; the probe scores every slot against its bucket's rows
and merges each query's slots rank-major, so equal distances resolve to the
earlier probe rank, like the reference's stable merge.

Two probes:

- ``backend="cuda"`` / ``"torch"``: the probe kernel of `ops/probe_topk.py`
  (CUDA C++; its plain version on the CPU);
- ``backend="xla"``: the JAX package's XLA scan, `_probe_search_core`, in
  plain torch ops: slots grouped by bucket, each bucket's rows read in
  ``data_chunk``-row chunks against ``query_chunk`` slots at a time with a
  running top-k. It alone carries the threshold prune (``prune_after``):
  the probe ranks before ``t0`` are scanned first, each query's kth-best
  distance becomes its threshold, and a later (query chunk, bucket) scan is
  skipped when the spherical-cap bound of `buckets.compute_bucket_bounds`
  proves that none of its slots can reach it. Pruned results equal the
  unpruned scan's to the bit. The name is the JAX package's, so that
  configs convert one to one. `probe_search` is this scan behind the JAX
  package's public `probe_search` contract (padding classes chosen from
  the routing, 0-based ids).
"""

import torch

from tpulmi_torch.ops.distance import (SENTINEL_DIST, _topk_stable,
                                       l2_normalize)
from tpulmi_torch.ops.probe_topk import probe_search as kernel_probe_search
from tpulmi_torch.ops.quantize import unpack_int4
from tpulmi_torch.utils.profiling import span


def size_class(x: int, minimum: int = 128) -> int:
    """Round up to the next power of two (>= minimum)."""
    c = minimum
    while c < x:
        c *= 2
    return c


def _top_desc(x: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the n largest per row, ties to the lower index (the order
    `lax.top_k` gives; `torch.topk` does not promise one)."""
    return torch.argsort(x, dim=1, descending=True, stable=True)[:, :n]


def _probe_search_core(probe_buckets: torch.Tensor,
                       queries_search: torch.Tensor, store, thresholds, *,
                       k: int, qpb_pad: int, data_chunk: int, max_chunks: int,
                       query_chunk: int = 512, compute_dtype=None,
                       prune_eps: float = 0.0):
    """The XLA backend's probe scan. `probe_buckets` (Q, P) holds each
    query's probed bucket per rank (out-of-range ids, such as the dump
    bucket ``n_categories``, are dropped); `queries_search` (Q, d) is
    normalized. Slots are grouped by bucket (stable); per bucket, its slots
    are taken ``qc = min(query_chunk, qpb_pad)`` at a time (at most
    ``qpb_pad`` slots a bucket: the caller re-runs with a larger pad when
    the returned ``max_slots`` passes it), and its rows ``data_chunk`` at a
    time (at most ``max_chunks`` chunks), every product of the fixed shape
    (qc, d) x (d, data_chunk), in ``compute_dtype`` with float32 sums, into
    a running top-k. The per-slot lists are merged per query, rank-major
    and stable.

    With `thresholds` (Q,) float32 and a store with bounds, a (query chunk,
    bucket) scan runs only when some slot's bound, less ``prune_eps``, is
    at most its query's threshold. The bound is computed as the JAX package
    computes it, in float32: ``cq = clip(q . c_b)``, ``cos delta = 1`` when
    ``cq >= cos r_b``, else ``cq cos r_b + sqrt(1 - cq^2) sqrt(1 -
    cos^2 r_b)``, and ``bound = 1 - m_b max(cos delta, 0)``.

    Returns (dists (Q, k) float32 ascending, ids (Q, k) int32 0-based with
    -1 for empty places, max_slots, scanned_rows, nominal_rows): the rows
    streamed (chunk-granular, per query chunk) and those an unpruned scan
    would have streamed. The counts are Python ints."""
    prune = thresholds is not None
    if prune and not store.has_bounds:
        raise ValueError("threshold pruning needs compute_bucket_bounds")
    q, p = probe_buckets.shape
    n_slots = q * p
    n_cat = store.n_categories
    mc = data_chunk
    qc = min(query_chunk, qpb_pad)
    n_qchunks = qpb_pad // qc
    dev = queries_search.device
    quantized = store.is_quantized
    queries = queries_search
    if compute_dtype is not None:
        queries = queries.to(compute_dtype)
    data = store.data_sorted
    scaled = (store.scales / store.q_levels).float() if quantized else None
    rows_total = int(data.shape[0])

    slots = probe_buckets.reshape(n_slots).to(torch.int64)
    order = torch.argsort(slots, stable=True)
    live = (slots >= 0) & (slots < n_cat)
    slot_counts = torch.bincount(slots[live], minlength=n_cat)
    # the loops below are driven from the host: one read of the counts
    qcnt_h = slot_counts.tolist()
    qstart_h = [0]
    for c in qcnt_h[:-1]:
        qstart_h.append(qstart_h[-1] + c)
    dstart_h = store.offsets.tolist()
    dcnt_h = store.counts.tolist()
    order_pad = torch.cat([order, torch.full((qpb_pad,), n_slots,
                                             dtype=torch.int64, device=dev)])
    ar_q = torch.arange(qc, device=dev)
    ar_m = torch.arange(mc, device=dev)
    if prune:
        bounds_c = store.bucket_centroids.float()
        bounds_cr = store.bucket_cos_r.float()
        bounds_mn = store.bucket_max_norm.float()
        thresholds = thresholds.float()

    slot_d = torch.full((n_slots + 1, k), SENTINEL_DIST, dtype=torch.float32,
                        device=dev)
    slot_i = torch.full((n_slots + 1, k), -1, dtype=torch.int32, device=dev)
    scanned = nominal = 0
    for c in range(n_cat):
        qcnt, qstart = qcnt_h[c], qstart_h[c]
        if qcnt == 0:
            continue
        dstart, dcnt = int(dstart_h[c]), int(dcnt_h[c])
        n_chunks = min(-(-dcnt // mc), max_chunks)
        rows_if_scanned = -(-dcnt // mc) * mc
        for qj in range(min(-(-qcnt // qc), n_qchunks)):
            s0 = qstart + qj * qc
            slot_idx = order_pad[s0:s0 + qc]
            valid_q = (qj * qc + ar_q) < qcnt
            slot_idx = torch.where(valid_q, slot_idx,
                                   torch.full_like(slot_idx, n_slots))
            q_idx = torch.clamp(slot_idx // p, max=q - 1)
            qvecs = queries[q_idx]
            nominal += rows_if_scanned
            if prune:
                cq = torch.clamp(qvecs.float() @ bounds_c[c], -1.0, 1.0)
                cr = bounds_cr[c]
                cos_delta = torch.where(
                    cq >= cr, torch.ones_like(cq),
                    cq * cr + torch.sqrt(torch.clamp(1.0 - cq * cq, min=0.0))
                    * torch.sqrt(torch.clamp(1.0 - cr * cr, min=0.0)))
                bound = 1.0 - bounds_mn[c] * torch.clamp(cos_delta, min=0.0)
                needed = valid_q & ((bound - prune_eps) <= thresholds[q_idx])
                if not bool(needed.any()):
                    continue
            scanned += rows_if_scanned
            best_d = torch.full((qc, k), SENTINEL_DIST, dtype=torch.float32,
                                device=dev)
            best_i = torch.full((qc, k), -1, dtype=torch.int32, device=dev)
            for j in range(n_chunks):
                # a clamped start keeps the block inside the store; the
                # two-sided mask drops rows of earlier chunks it re-reads
                start = min(dstart + j * mc, max(rows_total - mc, 0))
                block = data[start:start + mc]
                block_ids = store.ids_sorted[start:start + mc]
                if store.packed:
                    block = unpack_int4(block)
                block = block.to(qvecs.dtype)
                sims = qvecs.float() @ block.float().T
                if quantized:
                    sims = sims * scaled[start:start + mc][None, :]
                dists = 1.0 - sims
                row = start + ar_m
                in_chunk = (row >= dstart + j * mc) & (row < dstart + dcnt)
                dists = torch.where(in_chunk[None, :], dists,
                                    torch.full_like(dists, SENTINEL_DIST))
                best_d, best_i = _topk_stable(
                    torch.cat([best_d, dists], 1),
                    torch.cat([best_i, block_ids[None, :].expand(qc, -1)], 1),
                    k)
            slot_d[slot_idx] = best_d
            slot_i[slot_idx] = best_i
    # rank-major per query: earlier ranks first, so ties go to them
    final_d, final_i = _topk_stable(slot_d[:n_slots].reshape(q, p * k),
                                    slot_i[:n_slots].reshape(q, p * k), k)
    return final_d, final_i, int(max(qcnt_h)), scanned, nominal


def _probe_search_impl(probe_buckets, queries_search, store, *, k: int,
                       qpb_pad: int, data_chunk: int, max_chunks: int,
                       query_chunk: int = 512, compute_dtype=None):
    """The unpruned XLA-backend scan: (dists, ids, max_slots)."""
    d, i, mx, _, _ = _probe_search_core(
        probe_buckets, queries_search, store, None, k=k, qpb_pad=qpb_pad,
        data_chunk=data_chunk, max_chunks=max_chunks,
        query_chunk=query_chunk, compute_dtype=compute_dtype)
    return d, i, mx


def probe_search(probe_buckets, queries_search, store, k: int = 10,
                 data_chunk: int = 2048, qpb_pad: int = None,
                 query_chunk: int = 512, compute_dtype=None):
    """Search the probed buckets for each query's k nearest neighbors with
    the XLA backend's scan, on the store's device.

    `probe_buckets` (Q, P) holds each query's probed bucket per rank;
    `queries_search` (Q, d) is normalized. Returns (dists, ids): (Q, k)
    float32 cosine distances ascending and (Q, k) int32 **0-based** row
    ids, -1 where the probed buckets hold fewer than k rows.

    The padding classes are chosen from the busiest bucket's slots and the
    largest bucket, as the JAX package's `probe_search` chooses them."""
    dev = store.data_sorted.device
    probe_buckets = torch.as_tensor(probe_buckets, device=dev).to(
        torch.int32)
    queries_search = torch.as_tensor(queries_search, device=dev)
    slots = probe_buckets.reshape(-1).to(torch.int64)
    live = (slots >= 0) & (slots < store.n_categories)
    max_slots = int(torch.bincount(
        slots[live], minlength=store.n_categories).max())
    max_bucket = int(store.counts.max())

    # a chunk may not exceed the store; the clamped start and two-sided
    # mask of the scan handle tail buckets
    data_chunk = min(data_chunk, size_class(max(max_bucket, 1)),
                     int(store.data_sorted.shape[0]))
    if qpb_pad is None:
        qpb_pad = size_class(max(max_slots, 1))
    query_chunk = min(query_chunk, qpb_pad)
    qpb_pad = -(-qpb_pad // query_chunk) * query_chunk
    max_chunks = max(-(-max_bucket // data_chunk), 1)
    dists, ids, _ = _probe_search_impl(
        probe_buckets, queries_search, store, k=k, qpb_pad=qpb_pad,
        data_chunk=data_chunk, max_chunks=max_chunks,
        query_chunk=query_chunk, compute_dtype=compute_dtype)
    return dists, ids


def _probe_search_pruned(probe_buckets, queries_search, store, thresholds, *,
                         k: int, qpb_pad: int, data_chunk: int,
                         max_chunks: int, query_chunk: int = 512,
                         compute_dtype=None, prune_eps: float = 0.0):
    """The threshold-pruned XLA-backend scan: (dists, ids, max_slots,
    scanned_rows, nominal_rows)."""
    return _probe_search_core(
        probe_buckets, queries_search, store, thresholds, k=k,
        qpb_pad=qpb_pad, data_chunk=data_chunk, max_chunks=max_chunks,
        query_chunk=query_chunk, compute_dtype=compute_dtype,
        prune_eps=prune_eps)


def route_probes(logits: torch.Tensor, n_buckets: int, *, probe_mass=None,
                 dump_id=None, mass_logits=None) -> torch.Tensor:
    """Rank buckets by routed score; with ``probe_mass`` keep every rank up
    to and including the one where the cumulative routed probability first
    reaches it, and replace later ranks by ``dump_id``. ``mass_logits``
    supplies the probabilities when they differ from the ranking score.
    Returns (Q, n_buckets) int32 probe ids."""
    probes = _top_desc(logits, n_buckets)
    if probe_mass is not None:
        probs = torch.softmax(
            logits if mass_logits is None else mass_logits, dim=-1)
        p_top = torch.gather(probs, 1, probes)
        cum = torch.cumsum(p_top, dim=1)
        keep = (cum - p_top) < probe_mass
        probes = torch.where(keep, probes, torch.full_like(probes, dump_id))
    return probes.to(torch.int32)


def routing_logits(model, queries_nav: torch.Tensor, *, need_mass: bool):
    """Apply the routing model; with ``need_mass`` on a model carrying a
    fitted ``mass_temp`` != 1, also the temperature-flattened logits for the
    truncation mass. Returns (ranking_logits, mass_logits or None)."""
    logits = model(queries_nav)
    if need_mass:
        mt = float(getattr(model, "mass_temp", 1.0))
        if mt != 1.0:
            return logits, logits / mt
    return logits, None


def make_search_program(model, *, k: int, n_buckets: int,
                        compute_dtype=torch.bfloat16, backend: str = "cuda",
                        probe_mass=None, fetch_dtype=None,
                        int8_queries: bool = False, pool_k: int = 0,
                        pair: bool = False, wl_pad: int = 0,
                        item_rows: int = 1024, qpb_pad: int = 128,
                        data_chunk: int = 2048, max_chunks: int = 1,
                        query_chunk: int = 512, prune_after: int = 0,
                        prune_eps: float = 0.0):
    """The search as one function (queries_nav, queries_search, store) ->
    (dists, ids, max_slots) over `model`: top-P routing (softmax is monotone,
    so the logits rank), normalization of the search queries, and the
    probe with its merge. `k` is the number of candidates fetched (the
    plan's k plus the rerank depth when the result is reranked);
    `int8_queries` applies to a quantized store only. `pool_k`, `pair`,
    `wl_pad` and `item_rows` choose the probe kernel's configuration
    (`ops/probe_topk.py`); with ``wl_pad > 0`` the worklist's true item
    total is a fourth result.

    ``backend="xla"`` scans with `_probe_search_core` (`qpb_pad`,
    `data_chunk`, `max_chunks` and `query_chunk` as there). With
    ``prune_after=t0 > 0`` it runs the two-phase prune: ranks [0, t0)
    scanned, each query's kth-best distance taken as its threshold, ranks
    [t0, P) scanned against it, and the two merged rank-major; the result
    then carries the scanned and nominal rows as fourth and fifth values,
    as it does when ``probe_mass`` truncates on this backend."""
    truncating = probe_mass is not None
    t0 = min(prune_after, n_buckets - 1) if prune_after > 0 else 0
    xla = dict(k=k, qpb_pad=qpb_pad, data_chunk=data_chunk,
               max_chunks=max_chunks, query_chunk=query_chunk,
               compute_dtype=compute_dtype)

    def xla_probe(probes, qs, store):
        if t0 > 0:
            d1, i1, m1, rows1, nom1 = _probe_search_core(
                probes[:, :t0], qs, store, None, **xla)
            tau = d1[:, k - 1]      # the kth-best after the first t0 ranks
            d2, i2, m2, rows2, nom2 = _probe_search_core(
                probes[:, t0:], qs, store, tau, prune_eps=prune_eps, **xla)
            # rank-major: phase one's candidates first, so ties go to the
            # earlier probe rank as in the single-phase scan
            d, i = _topk_stable(torch.cat([d1, d2], 1),
                                    torch.cat([i1, i2], 1), k)
            return d, i, max(m1, m2), rows1 + rows2, nom1 + nom2
        out = _probe_search_core(probes, qs, store, None, **xla)
        return out if truncating else out[:3]

    @torch.no_grad()
    def search_program(queries_nav, queries_search, store):
        with span("program.route"):
            logits, mass_logits = routing_logits(model, queries_nav,
                                                 need_mass=truncating)
            probes = route_probes(logits, n_buckets, probe_mass=probe_mass,
                                  dump_id=store.n_categories,
                                  mass_logits=mass_logits)
            qs = l2_normalize(queries_search.float())
        if backend == "xla":
            # the counts as 0-d tensors, as the kernel path gives them
            with span("program.probe"):
                d, i, *counts = xla_probe(probes, qs, store)
            rest = [i, *(torch.tensor(c, device=d.device) for c in counts)]
        else:
            d, *rest = kernel_probe_search(
                probes, qs, store, k=k, compute_dtype=compute_dtype,
                backend=backend, int8_queries=int8_queries, pool_k=pool_k,
                pair=pair, wl_pad=wl_pad, item_rows=item_rows)
        if fetch_dtype is not None:
            d = d.to(fetch_dtype)
        return (d, *rest)

    return search_program
