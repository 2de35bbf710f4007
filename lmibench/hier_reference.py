"""The plain reference of the hierarchical index's search: the two-level
router's joint scores, their top-P buckets, the scan of the routed rows and
the rerank, in plain torch and float32 with TF32 off, on whatever
device its tensors are on.

Its inputs are tensors, never the program's objects, and it imports
nothing of the program:

- `Router`: the outer MLP and the G inner MLPs as weight lists (ReLU
  between layers, none after the last) and the outer weight w;
- `Buckets`: the store's rows by bucket (bucket b is rows ``starts[b]`` to
  ``starts[b] + counts[b]``), with their 0-based ids and, for an int8
  store, their codes' per-row scales;
- the host rows (the corpus the rerank reads), any float dtype, and
  whether the build was told they are unit length (``normalized``): then
  they are taken as they are, else each is made unit.

`router_of`, `buckets_of` and `host_rows` read a built index and a
benchmark host array into these (attribute reads only); `compare` holds
the program's answers against the reference's, as `hier_hold.py` and the
port's tests do.

It computes:

- the joint score of global bucket ``g * C + b``, ``w * log_softmax(outer)
  [g] + log_softmax(inner_g)[b]``, and the P best buckets of each query;
- on an int8 store, each routed row's score from its codes: the exact
  integer dot (float64, exact for any width here) times the scales, the
  query's own codes and scale with int8 queries; then the best
  ``k + rerank_extra`` of each query, their cosine distances against the
  host rows in float32, and the best ``k + 1`` of those;
- on a float store, the exact distance to each routed row as stored, and
  the best ``k + 1``.

Where it departs from the program:

- it scans each routed bucket whole in one product; the program tiles it
  (K3) and merges per-slot lists;
- it takes each query's scale into the candidate score; the program ranks
  a slot without it (a positive constant per query) and applies it to the
  finished list;
- it reranks against the host rows in float32; the program's float16
  rerank reads a float16 copy of them;
- ties: it orders equal distances by the lower candidate position; the
  program by probe rank, then row;
- it returns ``k + 1`` answers a query, so that a hold can tell a
  near-tie at the k-th place from a wrong answer.
"""

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from lmibench.reference import full_float32

Layers = List[Tuple[torch.Tensor, torch.Tensor]]

# joint scores closer than this may rank either way: float32 sums of the
# two MLPs in another order differ by some 1e-6
ROUTE_TIE = 1e-5


@dataclass
class Router:
    outer: Layers          # (out, in) weights and (out,) biases
    inner: Layers          # (G, out, in) weights and (G, out) biases
    outer_weight: float


@dataclass
class Buckets:
    rows: torch.Tensor     # (R, d): float rows, or int8 codes
    ids: torch.Tensor      # (R,) 0-based row ids
    starts: torch.Tensor   # (B,) first row of each bucket
    counts: torch.Tensor   # (B,) rows of each bucket
    scales: Optional[torch.Tensor] = None   # (R,) int8 codes' scales


@dataclass
class Answers:
    routed: torch.Tensor   # (Q, P) buckets, best first
    scores: torch.Tensor   # (Q, G*C) joint scores
    dists: torch.Tensor    # (Q, k + 1) float32 ascending
    ids: torch.Tensor      # (Q, k + 1) 0-based, -1 where fewer were found


def _unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-12)


def mlp(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """A ReLU MLP: (Q, in) -> (Q, out)."""
    h = x.float()
    for i, (w, b) in enumerate(layers):
        h = h @ w.float().T + b.float()
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def stacked_mlp(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """G ReLU MLPs on the same rows: (Q, in) -> (Q, G, out)."""
    h = x.float().unsqueeze(0)
    for i, (w, b) in enumerate(layers):
        h = torch.matmul(h, w.float().transpose(1, 2)) + b.float()[:, None]
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h.transpose(0, 1)


def joint_scores(router: Router, queries_nav: torch.Tensor) -> torch.Tensor:
    """(Q, G*C) joint scores, group-major."""
    with full_float32():
        outer = torch.log_softmax(mlp(router.outer, queries_nav), dim=-1)
        inner = torch.log_softmax(stacked_mlp(router.inner, queries_nav),
                                  dim=-1)
    joint = router.outer_weight * outer[:, :, None] + inner
    return joint.reshape(joint.shape[0], -1)


def top_buckets(scores: torch.Tensor, p: int) -> torch.Tensor:
    """The p best buckets of each row, best first (ties to the lower
    bucket)."""
    return torch.argsort(scores, dim=1, descending=True, stable=True)[:, :p]


def int8_codes(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 codes of `x` and their scales:
    x ~ codes * scale / 127."""
    x = x.float()
    scale = x.abs().amax(dim=1).clamp_min(1e-12)
    codes = torch.clamp(torch.round(x / scale[:, None] * 127.0), -127, 127)
    return codes, scale


def _scan(buckets: Buckets, routed: torch.Tensor, q_rows: torch.Tensor,
          q_scales: Optional[torch.Tensor], depth: int):
    """The `depth` best routed rows of each query: (Q, depth) distances and
    store rows (-1 where fewer), from each bucket's distances to the
    queries routed to it."""
    n_q, p = routed.shape
    dev = q_rows.device
    cand_d = torch.full((n_q, p, depth), float("inf"), device=dev)
    cand_r = torch.full((n_q, p, depth), -1, dtype=torch.int64, device=dev)
    quantized = buckets.scales is not None
    for b in torch.unique(routed).tolist():
        qi, rank = (routed == b).nonzero(as_tuple=True)
        lo, n = int(buckets.starts[b]), int(buckets.counts[b])
        if n == 0:
            continue
        rows = buckets.rows[lo:lo + n].to(dev)
        if quantized:
            dots = (q_rows[qi].double() @ rows.double().T).float()
            sims = dots * (buckets.scales[lo:lo + n].to(dev).float()
                           / 127.0)[None, :]
            if q_scales is not None:
                sims = sims * (q_scales[qi] / 127.0)[:, None]
        else:
            sims = q_rows[qi] @ rows.float().T
        dist = 1.0 - sims
        m = min(depth, n)
        d, r = torch.topk(dist, m, dim=1, largest=False, sorted=True)
        cand_d[qi, rank, :m] = d
        cand_r[qi, rank, :m] = r + lo
    cand_d, cand_r = cand_d.reshape(n_q, -1), cand_r.reshape(n_q, -1)
    order = torch.argsort(cand_d, dim=1, stable=True)[:, :depth]
    return torch.gather(cand_d, 1, order), torch.gather(cand_r, 1, order)


def _ids_of(buckets: Buckets, rows: torch.Tensor) -> torch.Tensor:
    """The 0-based ids of store rows (-1 stays -1)."""
    ids = buckets.ids.to(rows.device)[rows.clamp_min(0)].long()
    return torch.where(rows >= 0, ids, torch.full_like(rows, -1))


@torch.no_grad()
def pair_dists(host_rows: torch.Tensor, ids: torch.Tensor,
               queries_search: torch.Tensor,
               normalized: bool = False) -> torch.Tensor:
    """The cosine distance of each query to each of its rows `ids` (Q, n;
    -1: +inf) in float32, the host rows taken as unit length as they are
    when `normalized`, else each made unit (the exact cosine)."""
    dev = queries_search.device
    q = _unit(queries_search)
    x = host_rows[ids.clamp_min(0).reshape(-1).cpu()].to(dev).float()
    if not normalized:
        x = _unit(x)
    with full_float32():
        dist = 1.0 - torch.einsum("qcd,qd->qc",
                                  x.reshape(*ids.shape, -1), q)
    return torch.where(ids.to(dev) >= 0, dist,
                       torch.full_like(dist, float("inf")))


@torch.no_grad()
def search(router: Router, buckets: Buckets, queries_nav: torch.Tensor,
           queries_search: torch.Tensor, n_probes: int, k: int, *,
           int8_queries: bool = False, rerank_extra: int = 10,
           host_rows: Optional[torch.Tensor] = None,
           normalized: bool = False) -> Answers:
    """The hierarchical search of each query over its `n_probes` best
    buckets. An int8 store (``buckets.scales`` set) is scored from its
    codes (with the queries' own int8 codes when `int8_queries`), and its
    best ``k + rerank_extra`` are reranked against `host_rows` (`pair_dists`
    with `normalized`); a float store is scanned exactly. Returns the best
    ``k + 1``."""
    dev = queries_search.device
    scores = joint_scores(router, queries_nav.to(dev))
    routed = top_buckets(scores, n_probes)
    q = _unit(queries_search)
    with full_float32():
        if buckets.scales is None:
            dists, rows = _scan(buckets, routed, q, None, k + 1)
        else:
            q_rows, q_scales = int8_codes(q) if int8_queries else (q, None)
            _, rows = _scan(buckets, routed, q_rows, q_scales,
                            k + rerank_extra)
            reranked = pair_dists(host_rows, _ids_of(buckets, rows), q,
                                  normalized)
            order = torch.argsort(reranked, dim=1, stable=True)[:, :k + 1]
            dists, rows = (torch.gather(reranked, 1, order),
                           torch.gather(rows, 1, order))
    return Answers(routed, scores, dists, _ids_of(buckets, rows))


# ------------------------------------------------- from a built index, holds
def router_of(index) -> Router:
    """A built `HierarchicalIndex`'s router as the reference takes it."""
    model = index.built.classifier.model
    return Router(
        outer=[(layer.weight.detach(), layer.bias.detach())
               for layer in model.outer.layers],
        inner=[(w.detach(), b.detach())
               for w, b in zip(model.inner.weights, model.inner.biases)],
        outer_weight=float(model.outer_weight))


def buckets_of(index) -> Buckets:
    """A built index's store by bucket as the reference takes it."""
    store = index.built.store
    return Buckets(rows=store.data_sorted, ids=store.ids_sorted,
                   starts=store.offsets[:-1], counts=store.counts,
                   scales=store.scales if store.is_quantized else None)


def host_rows(array) -> torch.Tensor:
    """A benchmark host array (float32, or bfloat16 bits as uint16) as a
    tensor over the same memory."""
    if array.dtype == np.uint16:
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def compare(routed, dists, ids, ref: Answers, dist_tol: float) -> dict:
    """The program's routed buckets (Q, P), distances (Q, k) and 0-based
    ids (Q, k) against the reference's answers for the same queries:

    - routed buckets equal as sets, except where the reference's P-th and
      (P+1)-th joint scores lie within `ROUTE_TIE`;
    - ids equal as sets, except where the reference's k-th and (k+1)-th
      distances lie within `dist_tol`;
    - distances, place by place: their root mean square gap within
      `dist_tol` (the widest gap beside it).

    ``held`` is all three; ``untied`` lists the first queries whose ids
    differ untied."""
    routed = np.asarray(routed)
    n_q, p = routed.shape
    k = ids.shape[1]
    scores = np.sort(ref.scores.cpu().numpy(), axis=1)[:, ::-1]
    ref_routed = ref.routed.cpu().numpy()
    route_diff = np.array([set(a) != set(b)
                           for a, b in zip(routed, ref_routed)])
    route_tie = (scores[:, p - 1] - scores[:, p]) < ROUTE_TIE
    ref_d = ref.dists.cpu().numpy().astype(np.float64)
    ref_i = ref.ids.cpu().numpy()
    id_diff = np.array([set(a) != set(b)
                        for a, b in zip(ids, ref_i[:, :k])])
    id_tie = (ref_d[:, k] - ref_d[:, k - 1]) < dist_tol
    gap = np.abs(np.asarray(dists, np.float64) - ref_d[:, :k])
    rms = float(np.sqrt(np.mean(gap ** 2)))
    out = {
        "queries": int(n_q), "probes": int(p), "k": int(k),
        "routed_differ": int(route_diff.sum()),
        "routed_differ_untied": int((route_diff & ~route_tie).sum()),
        "ids_differ": int(id_diff.sum()),
        "ids_differ_untied": int((id_diff & ~id_tie).sum()),
        "dist_rms_gap": rms, "dist_widest_gap": float(gap.max()),
        "dist_tol": dist_tol,
    }
    out["held"] = (out["routed_differ_untied"] == 0
                   and out["ids_differ_untied"] == 0 and rms <= dist_tol)
    out["untied"] = np.nonzero(id_diff & ~id_tie)[0][:20].tolist()
    return out
