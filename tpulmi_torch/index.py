"""LearnedIndex facade: build and search.

- ``build(data_nav, data_search)``: k-means-partition the navigation
  vectors, train the MLP router on the partition, assign every row to its
  *predicted* bucket (the model's argmax, like the reference), and lay the
  search vectors out in the bucket-sorted store on the index's device.
- ``search(queries_nav, queries_search, n_buckets, k)``: route each query to
  its top-`n_buckets` buckets and run the exact probe over them.

The index runs on ``device`` ("cuda" by default). A CUDA device on a machine
without one is an error; the CPU is used only when asked for. External ids
are 1-based (SISAP convention); everything internal is 0-based.
"""

import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from tpulmi_torch.buckets import (BucketStore, bucket_stats,
                                  build_bucket_store)
from tpulmi_torch.models.train import BucketClassifier
from tpulmi_torch.ops.distance import l2_normalize
from tpulmi_torch.ops.kmeans import kmeans
from tpulmi_torch.search import make_search_program
from tpulmi_torch.utils.config import IndexConfig, SearchConfig
from tpulmi_torch.utils.logging import get_logger
from tpulmi_torch.utils.profiling import resolve_device, sync

log = get_logger("tpulmi_torch.index")

_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16}
# the TPU kernel's top-k strategies; all compute the same function, and the
# one CUDA kernel serves them all
_EXTRACT_MODES = ("scalar", "group", "group2")


@dataclass
class BuiltIndex:
    """Everything the query path needs, on the index's device."""

    centroids: Optional[torch.Tensor]
    classifier: BucketClassifier
    store: BucketStore
    pred_categories: torch.Tensor  # (N,) int32 model-argmax bucket per row
    config: IndexConfig
    max_bucket: int = 0


class LearnedIndex:
    def __init__(self, config: IndexConfig = IndexConfig(), device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.built: Optional[BuiltIndex] = None
        self._search_programs = {}   # static config -> search function
        self.last_max_slots = None   # slots routed to the busiest bucket

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _generator(self) -> torch.Generator:
        return torch.Generator().manual_seed(self.config.seed)

    # ------------------------------------------------------------------ build
    def build(self, data_nav, data_search=None,
              n_categories: Optional[int] = None, epochs: Optional[int] = None,
              lr: Optional[float] = None, model_type: Optional[str] = None
              ) -> Tuple[np.ndarray, float]:
        """Build the index. Returns (pred_categories, build_seconds).
        `data_search` defaults to `data_nav`."""
        cfg = self.config
        n_categories = n_categories or cfg.n_categories
        epochs = epochs or cfg.epochs
        lr = lr or cfg.lr
        model_type = model_type or cfg.model_type
        n = int(np.shape(data_nav)[0])
        if cfg.fused_build and n >= 2:
            if n < n_categories:   # the reference's small-data fallback
                n_categories = max(n // 5, 2)
            return self._build_fused(data_nav, data_search, n_categories,
                                     epochs, lr, model_type)

        start = time.perf_counter()
        data_nav = self._tensor(data_nav)
        centroids, labels = kmeans(
            data_nav, n_categories, iters=cfg.kmeans_iters, seed=cfg.seed,
            max_points_per_centroid=cfg.kmeans_max_points_per_centroid,
            generator=self._generator())
        n_categories = int(centroids.shape[0]) if centroids is not None else 1
        classifier = BucketClassifier(
            int(data_nav.shape[1]), n_categories, lr=lr,
            model_type=model_type, seed=cfg.seed, device=self.device)
        losses = classifier.train(
            data_nav, labels, epochs=epochs, batch_size=cfg.batch_size,
            reference_step_semantics=cfg.reference_step_semantics,
            max_train_steps=cfg.max_train_steps)
        pred = classifier.predict(data_nav)
        data_search = l2_normalize(self._tensor(
            data_nav if data_search is None else data_search))
        store = build_bucket_store(pred, data_search, n_categories,
                                   row_align=cfg.row_align)
        sync(self.device)
        build_time = time.perf_counter() - start
        mx, mn, mean = bucket_stats(store)
        log.info("modular build: N=%d buckets=%d size max/mean/min="
                 "%d/%.0f/%d; final loss %.4f; build %.3fs", store.n,
                 n_categories, mx, mean, mn, float(losses[-1]), build_time)
        self.built = BuiltIndex(centroids, classifier, store, pred, cfg, mx)
        return pred.cpu().numpy(), build_time

    def _build_fused(self, data_nav, data_search, n_categories, epochs, lr,
                     model_type) -> Tuple[np.ndarray, float]:
        """Build through the staged build of tpulmi_torch/build.py."""
        from tpulmi_torch.build import fused_build

        cfg = self.config
        start = time.perf_counter()
        data_nav = self._tensor(data_nav)
        data_search = (data_nav if data_search is None
                       else self._tensor(data_search))
        result = fused_build(
            data_nav, data_search, model_type=model_type, lr=lr,
            n_categories=n_categories, kmeans_iters=cfg.kmeans_iters,
            kmeans_train_points=(cfg.kmeans_max_points_per_centroid
                                 * n_categories),
            epochs=epochs, batch_size=cfg.batch_size,
            row_align=cfg.row_align,
            reference_step_semantics=cfg.reference_step_semantics,
            max_train_steps=cfg.max_train_steps, seed=cfg.seed)
        sync(self.device)
        build_time = time.perf_counter() - start
        classifier = BucketClassifier(
            int(data_nav.shape[1]), n_categories, lr=lr,
            model_type=model_type, seed=cfg.seed, device=self.device,
            model=result.model)
        store = BucketStore(
            data_sorted=result.data_sorted, ids_sorted=result.ids_sorted,
            offsets=result.offsets, counts=result.counts,
            n=int(data_nav.shape[0]), pad_rows=result.pad_rows, row_align=max(cfg.row_align, 1))
        mx, mn, mean = bucket_stats(store)
        log.info("fused build: N=%d buckets=%d size max/mean/min=%d/%.0f/%d;"
                 " final loss %.4f; build %.3fs", store.n, n_categories, mx,
                 mean, mn, float(result.losses[-1]), build_time)
        self.built = BuiltIndex(result.centroids, classifier, store,
                                result.pred_categories, cfg, mx)
        return result.pred_categories.cpu().numpy(), build_time

    # ----------------------------------------------------------------- search
    def search(self, queries_nav, queries_search=None, n_buckets: int = 4,
               k: int = 10, search_config: Optional[SearchConfig] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """k-NN search probing the top-`n_buckets` routed buckets per query.
        Returns (dists, anns) of shape (Q, k): float32 cosine distances
        ascending and 1-based ids (an empty place is id 1 at distance
        10000)."""
        if self.built is None:
            raise ValueError("Index is not built, call `build` first.")
        scfg = search_config or SearchConfig(k=k, n_buckets=n_buckets)
        queries_nav = self._tensor(queries_nav)
        queries_search = (queries_nav if queries_search is None
                          else self._tensor(queries_search))

        bq = scfg.batch_queries
        if bq and queries_nav.shape[0] > bq:
            parts = [self.search(queries_nav[lo:lo + bq],
                                 queries_search[lo:lo + bq],
                                 n_buckets=n_buckets, k=k, search_config=scfg)
                     for lo in range(0, queries_nav.shape[0], bq)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))

        n_buckets = min(n_buckets, self.built.store.n_categories)
        plan = self._plan_search(queries_nav, n_buckets, k, scfg)
        program = self._dispatch_program(plan, n_buckets, scfg)
        out = program(queries_nav, queries_search, self.built.store)
        dists, ids = self._absorb_result(plan, out)
        return self._finalize(dists, ids)

    def _plan_search(self, queries_nav, n_buckets: int, k: int,
                     scfg: SearchConfig) -> SimpleNamespace:
        """Resolve the static decisions of one probe search: backend and
        compute dtype. Options of kernel variants not ported yet are
        refused."""
        unported = [name for name in ("pallas_worklist", "pallas_pool",
                                      "pallas_pair", "int8_queries")
                    if getattr(scfg, name)]
        if scfg.prune_after > 0:
            unported.append("prune_after")
        if unported:
            raise NotImplementedError(
                f"SearchConfig options not ported to tpulmi_torch yet: "
                f"{unported}")
        if scfg.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {scfg.compute_dtype!r}")
        if scfg.pallas_extract not in _EXTRACT_MODES:
            raise ValueError(f"unknown pallas_extract {scfg.pallas_extract!r}")
        compute_dtype = _DTYPES[scfg.compute_dtype]
        backend = scfg.backend
        if backend == "auto":
            # a store on the card is always searched by the kernel, which
            # raises on what it does not take
            backend = ("cuda" if self.built.store.device.type == "cuda"
                       else "torch")
        elif backend not in ("cuda", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        return SimpleNamespace(q=int(queries_nav.shape[0]), backend=backend,
                               compute_dtype=compute_dtype, k=k)

    def _dispatch_program(self, plan, n_buckets: int, scfg: SearchConfig):
        """The search function for the plan's static configuration, made
        once and kept."""
        key = (plan.backend, n_buckets, plan.k, plan.compute_dtype,
               scfg.probe_mass, scfg.fetch_dtype)
        program = self._search_programs.get(key)
        if program is None:
            program = make_search_program(
                self.built.classifier.model, k=plan.k, n_buckets=n_buckets,
                compute_dtype=plan.compute_dtype, backend=plan.backend,
                probe_mass=scfg.probe_mass,
                fetch_dtype=_DTYPES[scfg.fetch_dtype]
                if scfg.fetch_dtype else None)
            self._search_programs[key] = program
        return program

    def _absorb_result(self, plan, out):
        """Unpack a search result. The slot layout is sized for the worst
        case (every slot in its own block tail), so unlike the JAX
        package's queries-per-bucket pad it cannot overflow and there is
        no re-run; the busiest bucket's slot count is kept for callers."""
        dists, ids, max_slots = out
        self.last_max_slots = int(max_slots)
        return dists, ids

    @staticmethod
    def _finalize(dists: torch.Tensor, ids: torch.Tensor):
        """Empty places (id -1) keep the sentinel distance and become id 0;
        then ids become 1-based."""
        ids = torch.where(ids < 0, torch.zeros_like(ids), ids)
        return (dists.float().cpu().numpy(),
                ids.cpu().numpy().astype(np.int64) + 1)

    def search_single(self, queries_nav, queries_search=None, k: int = 10,
                      search_config: Optional[SearchConfig] = None):
        """Probe only each query's most likely bucket."""
        return self.search(queries_nav, queries_search, n_buckets=1, k=k,
                           search_config=search_config)

    def cluster(self, data, n_clusters: int):
        """k-means on the index's device: (centroids, labels)."""
        cfg = self.config
        return kmeans(self._tensor(data), n_clusters, iters=cfg.kmeans_iters,
                      seed=cfg.seed,
                      max_points_per_centroid=cfg.kmeans_max_points_per_centroid,
                      generator=self._generator())
