"""Batched probe search: routing -> query normalization -> probe.

Every (query, probe rank) pair is a slot. The router's top-P buckets give
each query its slots; the probe (`ops/probe_topk.py`) scores every slot
against its bucket's rows and merges each query's slots rank-major, so equal
distances resolve to the earlier probe rank, like the reference's stable
merge.
"""

import torch

from tpulmi_torch.ops.distance import l2_normalize
from tpulmi_torch.ops.probe_topk import probe_search


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
                        item_rows: int = 1024):
    """The search as one function (queries_nav, queries_search, store) ->
    (dists, ids, max_slots) over `model`: top-P routing (softmax is monotone,
    so the logits rank), normalization of the search queries, and the
    probe with its merge. `k` is the number of candidates fetched (the
    plan's k plus the rerank depth when the result is reranked);
    `int8_queries` applies to a quantized store only. `pool_k`, `pair`,
    `wl_pad` and `item_rows` choose the probe kernel's configuration
    (`ops/probe_topk.py`); with ``wl_pad > 0`` the worklist's true item
    total is a fourth result."""
    truncating = probe_mass is not None

    @torch.no_grad()
    def search_program(queries_nav, queries_search, store):
        logits, mass_logits = routing_logits(model, queries_nav,
                                             need_mass=truncating)
        probes = route_probes(logits, n_buckets, probe_mass=probe_mass,
                              dump_id=store.n_categories,
                              mass_logits=mass_logits)
        qs = l2_normalize(queries_search.float())
        d, *rest = probe_search(
            probes, qs, store, k=k, compute_dtype=compute_dtype,
            backend=backend, int8_queries=int8_queries, pool_k=pool_k,
            pair=pair, wl_pad=wl_pad, item_rows=item_rows)
        if fetch_dtype is not None:
            d = d.to(fetch_dtype)
        return (d, *rest)

    return search_program
