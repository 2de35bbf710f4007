"""LearnedIndex facade: build, quantize, search, save and load.

- ``build(data_nav, data_search)``: k-means-partition the navigation
  vectors, train the MLP router on the partition, assign every row to its
  *predicted* bucket (the model's argmax, like the reference), and lay the
  search vectors out in the bucket-sorted store on the index's device.
- ``search(queries_nav, queries_search, n_buckets, k)``: route each query to
  its top-`n_buckets` buckets and run the exact probe over them.
- ``quantize(host_corpus, bits)``: turn the store into int8 or packed int4
  codes with per-row scales. With a host-resident full-precision corpus
  attached, `search` fetches a few more candidates than k and reranks them
  exactly on the host, which takes the quantization error out of the result.
- ``search_stream(batches, ...)``: the serving loop: `search`'s results per
  batch, in order, with the next batches' copies and kernels queued on the
  card while a batch's results are fetched and reranked.
- ``build_with_host_store(data_nav, data_search_host, ...)``: the build for
  corpora whose store is laid out on the host (`tpulmi_torch.hoststore`)
  and copied to the card in slabs; the navigation stages are `build`'s.
- ``compute_bounds()``: per-bucket bounds for the threshold prune of the
  ``backend="xla"`` scan (``SearchConfig.prune_after``).
- ``save`` / ``load``: ``state.npz`` (numpy, no pickle) and ``meta.json``;
  the rerank corpus is recorded by fingerprint and reattached or asked for.

The index runs on ``device`` ("cuda" by default). A CUDA device on a machine
without one is an error; the CPU is used only when asked for. External ids
are 1-based (SISAP convention); everything internal is 0-based.
"""

import gc
import hashlib
import json
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, replace
from pathlib import Path
from types import SimpleNamespace
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from tpulmi_torch.buckets import (BucketStore, bucket_stats,
                                  build_bucket_store)
from tpulmi_torch.hoststore import HostBF16, host_dtype
from tpulmi_torch.models.train import BucketClassifier
from tpulmi_torch.native import native_layout
from tpulmi_torch.ops.distance import SENTINEL_DIST, l2_normalize
from tpulmi_torch.ops import probe_topk as probe
from tpulmi_torch.ops.kmeans import kmeans
from tpulmi_torch.search import (make_search_program, route_probes,
                                 routing_logits, size_class)
from tpulmi_torch.serving import QueryStager
from tpulmi_torch.utils.config import IndexConfig, SearchConfig
from tpulmi_torch.utils.logging import get_logger
from tpulmi_torch.utils.profiling import resolve_device, sync

log = get_logger("tpulmi_torch.index")

_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16}
# the TPU kernel's top-k strategies; all compute the same function, and the
# one CUDA kernel serves them all
_EXTRACT_MODES = ("scalar", "group", "group2")
CHECKPOINT_VERSION = 2
# the store's pruning bounds, saved when present
_BOUNDS = ("bucket_centroids", "bucket_cos_r", "bucket_max_norm")


def _host_mem_available():
    """Host MemAvailable in bytes, or None where /proc/meminfo is absent."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


class _materialize_async:
    """`ensure_in_ram` on a thread of its own, so that the one-time copy of
    a memory-mapped corpus into RAM runs beside the navigation stages of a
    host-store build."""

    def __init__(self, arr):
        from tpulmi_torch.hoststore import ensure_in_ram

        self._out = {}

        def run():
            try:
                self._out["arr"] = ensure_in_ram(arr)
            except BaseException as e:  # noqa: BLE001 - raised in result()
                self._out["err"] = e

        self._th = threading.Thread(target=run, name="corpus-mat",
                                    daemon=True)
        self._th.start()

    def result(self):
        self._th.join()
        if "err" in self._out:
            raise self._out["err"]
        return self._out["arr"]


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
        # (Q, n_buckets) -> worklist length of the probe kernel; -1 = the
        # worklist is off for this shape (its scratch would be too large)
        self._wl_pads = {}
        # (Q, n_buckets) shapes that `search` has answered: `search_stream`
        # dispatches only these ahead
        self._warm_shapes = set()
        # (host corpus, normalized) for the exact rerank of a quantized store
        self._host_corpus = None
        self._rerank_meta = None     # a restored checkpoint's rerank contract
        self._rerank_shadow = None   # (corpus, its float16 copy)
        # (Q, n_buckets) -> slots per bucket the xla scan was sized for
        self._qpb_pads = {}
        # rows the xla scan streamed, and would have streamed unpruned, in
        # the last search that counts them (pruning, or probe_mass on xla);
        # None after any other search
        self.last_scan_rows = self.last_nominal_rows = None

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
        self._set_built(BuiltIndex(centroids, classifier, store, pred, cfg,
                                   mx))
        return pred.cpu().numpy(), build_time

    def _set_built(self, built: BuiltIndex) -> None:
        """Install a new build; the search programs made for an earlier one
        hold its router and are dropped."""
        self.built = built
        self._search_programs = {}

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
            n=int(data_nav.shape[0]), pad_rows=result.pad_rows,
            row_align=max(cfg.row_align, 1))
        mx, mn, mean = bucket_stats(store)
        log.info("fused build: N=%d buckets=%d size max/mean/min=%d/%.0f/%d;"
                 " final loss %.4f; build %.3fs", store.n, n_categories, mx,
                 mean, mn, float(result.losses[-1]), build_time)
        self._set_built(BuiltIndex(result.centroids, classifier, store,
                                   result.pred_categories, cfg, mx))
        return result.pred_categories.cpu().numpy(), build_time

    # ------------------------------------------------------ build (host store)
    def build_with_host_store(self, data_nav, data_search_host,
                              normalized: bool = False,
                              store_dtype: str = "bfloat16",
                              overlap_upload: bool = False, mesh=None
                              ) -> Tuple[np.ndarray, float]:
        """The large-scale build: the navigation stages (k-means, router,
        predict) run on the index's device, exactly as in `build`, but the
        search store is laid out on the host and copied to the card once:
        for corpora whose store and source copy do not both fit the card.

        `data_search_host` stays a host array: float32, float16, or
        bfloat16 as a `tpulmi_torch.hoststore.HostBF16`, possibly a memory
        map (copied into RAM beside the navigation stages where the host
        has room; else laid out source-sequentially). `store_dtype` is
        "bfloat16", "float32", "int8" or "int4"; with a quantized store,
        `search` reranks the candidates against `data_search_host`.
        ``overlap_upload=True`` copies finished slabs of the store while
        the layout writes its tail (`hoststore.layout_and_upload`).

        ``mesh`` (a store sharded over several cards) is not ported yet
        (ROADMAP.md A7) and raises. Returns (pred_categories, seconds);
        the seconds of each stage are kept in ``self.last_build_stages``."""
        if mesh is not None:
            raise NotImplementedError(
                "build_with_host_store(mesh=...) shards the store over "
                "several cards: not ported to tpulmi_torch yet "
                "(ROADMAP.md A7)")
        from tpulmi_torch.build import fused_build

        cfg = self.config
        start = time.perf_counter()
        n_categories = cfg.n_categories
        # the memory map -> RAM copy of the corpus runs beside the
        # navigation stages
        mat_thread = _materialize_async(data_search_host)
        data_nav = self._tensor(data_nav)
        n, d_nav = int(data_nav.shape[0]), int(data_nav.shape[1])
        if n < n_categories:   # the reference's small-data fallback
            n_categories = max(n // 5, 2)
        result = fused_build(
            data_nav, None, model_type=cfg.model_type, lr=cfg.lr,
            n_categories=n_categories, kmeans_iters=cfg.kmeans_iters,
            kmeans_train_points=(cfg.kmeans_max_points_per_centroid
                                 * n_categories),
            epochs=cfg.epochs, batch_size=cfg.batch_size,
            row_align=cfg.row_align,
            reference_step_semantics=cfg.reference_step_semantics,
            max_train_steps=cfg.max_train_steps, seed=cfg.seed,
            include_store=False)
        pred = result.pred_categories.cpu().numpy()
        t_nav = time.perf_counter() - start
        log.info("host-store build: nav stages %.1fs (final loss %.4f)",
                 t_nav, float(result.losses[-1]))
        # park the router and centroids on the host while the store lands:
        # a store near the card's size needs one free region
        model = result.model.to("cpu")
        centroids = result.centroids.cpu()
        del data_nav, result
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

        t_mat = time.perf_counter()
        data_search_host = mat_thread.result()
        t_mat = time.perf_counter() - t_mat
        store, arrays, data_search_host = self._host_store_to_built(
            pred, data_search_host, n_categories, store_dtype=store_dtype,
            normalized=normalized, overlap_upload=overlap_upload, mesh=mesh)
        t_layout = time.perf_counter() - start - t_nav
        log.info("host-store build: layout+upload %.1fs", t_layout)
        classifier = BucketClassifier(
            d_nav, n_categories, lr=cfg.lr, model_type=cfg.model_type,
            seed=cfg.seed, device=self.device, model=model.to(self.device))
        build_time = time.perf_counter() - start
        log.info("host-store build: total %.1fs", build_time)
        self.last_build_stages = {"nav": t_nav, "materialize_wait": t_mat,
                                  "layout_upload": t_layout,
                                  "total": build_time}
        self._set_built(BuiltIndex(
            centroids.to(self.device), classifier, store,
            torch.as_tensor(pred, device=self.device), cfg,
            int(arrays.counts.max()) if arrays.counts.size else 0))
        # keep the host corpus for the exact rerank of a quantized store. A
        # corpus that stayed on disk through the layout is copied into RAM
        # now if it fits a wider share (the store, navigation and staging
        # copies are gone): a rerank gather over a disk memory map is slow
        from tpulmi_torch.hoststore import ensure_in_ram

        data_search_host = ensure_in_ram(data_search_host, max_frac=float(
            os.environ.get("TPULMI_RERANK_MATERIALIZE_MAX_FRAC", "0.6")))
        self._host_corpus = (data_search_host, normalized)
        return pred, build_time

    def _host_store_to_built(self, pred, data_search_host, n_categories, *,
                             store_dtype, normalized, overlap_upload, mesh):
        """Lay the store out on the host and land it on the index's device
        (`hoststore.layout_and_upload`): one flat store. Returns (store,
        host arrays, data_search_host). ``mesh`` (a sharded store) is not
        ported (ROADMAP.md A7)."""
        if mesh is not None:
            raise NotImplementedError(
                "a host-laid-out store sharded over a mesh is not ported to "
                "tpulmi_torch yet (ROADMAP.md A7)")
        from tpulmi_torch.hoststore import ensure_in_ram, layout_and_upload

        cfg = self.config
        data_search_host = ensure_in_ram(data_search_host)
        arrays, data_sorted_dev = layout_and_upload(
            pred, data_search_host, n_categories, device=self.device,
            row_align=cfg.row_align, store_dtype=store_dtype,
            normalized=normalized, overlap=overlap_upload)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        store = BucketStore(
            data_sorted=data_sorted_dev, ids_sorted=dev(arrays.ids_sorted),
            offsets=dev(arrays.offsets), counts=dev(arrays.counts),
            n=arrays.n, pad_rows=arrays.pad_rows, row_align=arrays.row_align,
            scales=(dev(arrays.scales) if arrays.scales is not None
                    else None),
            quant_bits=arrays.quant_bits)
        sync(self.device)
        return store, arrays, data_search_host

    def compute_bounds(self, chunk: int = 65536) -> None:
        """Per-bucket pruning bounds (`buckets.compute_bucket_bounds`: unit
        centroid, cap radius, largest row norm) for the threshold prune of
        the ``backend="xla"`` scan (`SearchConfig.prune_after`). Two
        streaming passes over the store; call again after `quantize` or a
        new build."""
        if self.built is None:
            raise ValueError("Index is not built, call `build` first.")
        from tpulmi_torch.buckets import compute_bucket_bounds

        store = compute_bucket_bounds(self.built.store, chunk=chunk)
        sync(self.device)
        self.built = replace(self.built, store=store)
        self._search_programs = {}

    # --------------------------------------------------------------- quantize
    def quantize(self, host_corpus=None, normalized: bool = False,
                 bits: int = 8) -> None:
        """Convert the built store to int8 (``bits=8``) or packed int4
        (``bits=4``) codes + per-row scales in place (half / a quarter of a
        bfloat16 store's bytes). Optionally attach a host-resident
        full-precision corpus so that `search` reranks the final candidates
        exactly; int4 in effect requires it."""
        if self.built is None:
            raise ValueError("Index is not built, call `build` first.")
        from tpulmi_torch.ops.quantize import quantize_store

        self.built = replace(
            self.built, store=quantize_store(self.built.store, bits=bits))
        self._search_programs = {}
        if host_corpus is not None:
            self._host_corpus = (host_corpus, normalized)

    def _resolve_rerank_extra(self, scfg) -> int:
        """Rerank depth: `SearchConfig.rerank_extra=None` resolves to 30 for
        a packed int4 store (whose coarser codes otherwise drop true
        neighbours from the candidate cut), else 10."""
        if scfg.rerank_extra is not None:
            return scfg.rerank_extra
        store = self.built.store if self.built is not None else None
        return 30 if getattr(store, "quant_bits", 8) == 4 else 10

    def _rerank_host(self, dists, ids, queries_search, k: int,
                     host_queries=None, rerank_dtype: str = "float32"):
        """Exact top-k over the quantized candidates, on the host: gather
        the candidate rows from the host corpus, recompute full-precision
        cosine distances, reorder, truncate to k. `ids` (numpy) are 0-based,
        -1 = empty. `dists` is unused (and may be None): every kept
        candidate's distance is recomputed.

        ``host_queries``: host-side mirror of ``queries_search``; without
        it the queries are copied back from the card.

        ``rerank_dtype="float16"`` gathers from a cached float16 shadow of
        the corpus: half the gathered bytes for ~4e-4 relative distance
        error, an order below the int8 error the rerank erases.

        When the native library (`tpulmi_torch.native`) has loaded and the
        corpus (or its shadow) is a C-contiguous float32, float16 or
        bfloat16 array, its fused ``rerank_dot`` reads each candidate row
        once and dots it on the fly, as the JAX package does; otherwise the
        rows are gathered and multiplied with ``torch.bmm``."""
        corpus, normalized = self._host_corpus
        q, k_eff = ids.shape
        d = int(np.asarray(corpus[:1]).shape[1])
        # a candidate list may hold one row twice: mark repeats empty so the
        # exact reorder can never return a row twice (a no-op otherwise)
        sort_idx = np.argsort(ids, axis=1, kind="stable")
        sorted_ids = np.take_along_axis(ids, sort_idx, axis=1)
        dup_sorted = np.zeros(ids.shape, dtype=bool)
        dup_sorted[:, 1:] = ((sorted_ids[:, 1:] == sorted_ids[:, :-1])
                             & (sorted_ids[:, 1:] >= 0))
        if dup_sorted.any():
            dup = np.zeros(ids.shape, dtype=bool)
            np.put_along_axis(dup, sort_idx, dup_sorted, axis=1)
            ids = np.where(dup, -1, ids)
        if host_queries is not None:
            qs = np.array(host_queries, np.float32)  # writable copy
        else:
            qs = np.array(torch.as_tensor(queries_search).float().cpu(),
                          np.float32)
        qs /= np.maximum(np.linalg.norm(qs, axis=1, keepdims=True), 1e-12)
        flat = np.maximum(ids, 0).reshape(-1)
        if rerank_dtype == "float16":
            shadow = self._rerank_shadow
            if shadow is None or shadow[0] is not corpus:
                # The shadow is a full-size float16 copy of the corpus. Past
                # the available host RAM the allocation would not raise, the
                # kernel's OOM killer would end the process: refuse instead.
                need = 2 * d * len(corpus)
                avail = _host_mem_available()
                if avail is not None and need > avail - (8 << 30):
                    raise RuntimeError(
                        f"f16 rerank shadow needs {need / 2**30:.1f} GiB but "
                        f"only {avail / 2**30:.1f} GiB host RAM is available")
                shadow = (corpus, np.asarray(corpus, np.float16))
                self._rerank_shadow = shadow
            src = shadow[1]
        else:
            src = corpus if isinstance(corpus, (np.ndarray, HostBF16)) \
                else None
        if (src is not None
                and str(src.dtype) in ("float32", "float16", "bfloat16")
                and src.flags["C_CONTIGUOUS"] and native_layout.available()):
            sims = native_layout.rerank_dot(src, ids, qs,
                                            normalized=normalized)
            return self._rerank_order(1.0 - sims, ids, k)
        if rerank_dtype == "float16":
            # the gathered rows stay float16: torch's CPU half bmm sums in
            # float32, and an upcast of the block costs more than the
            # halved gather saves
            rows = shadow[1][flat].reshape(q, k_eff, d)
        else:
            rows = np.asarray(corpus[flat], np.float32).reshape(q, k_eff, d)
        if not normalized:
            rows = np.asarray(rows, np.float32)
            rows /= np.maximum(
                np.linalg.norm(rows, axis=2, keepdims=True), 1e-12)
        qcol = torch.from_numpy(qs.astype(rows.dtype)).unsqueeze(2)
        sims = torch.bmm(torch.from_numpy(rows), qcol).float().numpy()[:, :, 0]
        return self._rerank_order(1.0 - sims, ids, k)

    @staticmethod
    def _rerank_order(exact, ids, k: int):
        """The k smallest exact distances of each row, stable; empty places
        (id -1) keep the sentinel distance."""
        exact = np.where(ids < 0, SENTINEL_DIST, exact)
        order = np.argsort(exact, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(exact, order, axis=1).astype(np.float32),
                np.take_along_axis(ids, order, axis=1))

    # ----------------------------------------------------------------- search
    def search(self, queries_nav, queries_search=None, n_buckets: int = 4,
               k: int = 10, search_config: Optional[SearchConfig] = None,
               queries_search_host=None) -> Tuple[np.ndarray, np.ndarray]:
        """k-NN search probing the top-`n_buckets` routed buckets per query.
        Returns (dists, anns) of shape (Q, k): float32 cosine distances
        ascending and 1-based ids (an empty place is id 1 at distance
        10000).

        ``queries_search_host``: optional host-side (numpy) mirror of
        ``queries_search``, used by the quantized-store rerank so that it
        never copies the queries back from the card. When ``queries_search``
        arrives as a numpy array the mirror is captured by itself."""
        if self.built is None:
            raise ValueError("Index is not built, call `build` first.")
        scfg = search_config or SearchConfig(k=k, n_buckets=n_buckets)
        # the scan counters are this call's: a search that does not count
        # leaves them None, and the batched loop below sums its parts'
        self.last_scan_rows = self.last_nominal_rows = None
        if queries_search is None:
            queries_search = queries_nav
        if queries_search_host is None and isinstance(queries_search,
                                                      np.ndarray):
            queries_search_host = queries_search
        queries_nav = self._tensor(queries_nav)
        queries_search = self._tensor(queries_search)

        bq = scfg.batch_queries
        if bq and queries_nav.shape[0] > bq:
            parts, counted = [], []
            for lo in range(0, queries_nav.shape[0], bq):
                parts.append(self.search(
                    queries_nav[lo:lo + bq], queries_search[lo:lo + bq],
                    n_buckets=n_buckets, k=k, search_config=scfg,
                    queries_search_host=(queries_search_host[lo:lo + bq]
                                         if queries_search_host is not None
                                         else None)))
                if self.last_scan_rows is not None:
                    counted.append((self.last_scan_rows,
                                    self.last_nominal_rows))
            if counted:
                self.last_scan_rows = sum(c[0] for c in counted)
                self.last_nominal_rows = sum(c[1] for c in counted)
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))

        n_buckets = min(n_buckets, self.built.store.n_categories)
        plan = self._plan_search(queries_nav, n_buckets, k, scfg)
        while True:
            program = self._dispatch_program(plan, n_buckets, scfg)
            out = program(queries_nav, queries_search, self.built.store)
            status = self._absorb_result(plan, n_buckets,
                                         self._fetch_result(out, plan))
            if status != "retry":
                break
        dists, ids = status
        return self._finalize(dists, ids, plan, k, scfg, queries_search,
                              queries_search_host)

    def _plan_search(self, queries_nav, n_buckets: int, k: int,
                     scfg: SearchConfig) -> SimpleNamespace:
        """Resolve the static decisions of one probe search into a mutable
        plan shared by `search` (with its overflow re-run) and
        `search_stream` (which dispatches ahead of the fetch): backend,
        compute dtype, rerank depth, the probe kernel's configuration
        (rerank pool, tile height, worklist length), and the xla scan's
        padding classes and pruning."""
        if scfg.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {scfg.compute_dtype!r}")
        if scfg.pallas_extract not in _EXTRACT_MODES:
            raise ValueError(f"unknown pallas_extract {scfg.pallas_extract!r}")
        if scfg.pallas_pool and scfg.pallas_extract == "scalar":
            raise ValueError(
                "the rerank pool (pallas_pool) needs a harvesting "
                "pallas_extract ('group'/'group2'), as in the JAX package")
        compute_dtype = _DTYPES[scfg.compute_dtype]
        backend = scfg.backend
        if backend == "auto":
            # a store on the card is always searched by the kernel, which
            # raises on what it does not take
            backend = ("cuda" if self.built.store.device.type == "cuda"
                       else "torch")
        elif backend not in ("cuda", "torch", "xla"):
            raise ValueError(f"unknown backend {backend!r}")
        store = self.built.store
        quantized = bool(getattr(store, "is_quantized", False))
        # a quantized store with a host corpus attached: fetch extra
        # candidates and rerank them at full precision on the host
        rerank = (scfg.rerank and quantized
                  and self._host_corpus is not None)
        k_eff = k + self._resolve_rerank_extra(scfg) if rerank else k
        # rerank pool: the kernel keeps an exact top-k, the pool supplies
        # the rerank extras
        pool_k = k if (scfg.pallas_pool and rerank and k_eff > k) else 0
        int8_queries = scfg.int8_queries and quantized
        pair = scfg.pallas_pair and probe.resolve_tiling(
            True, k=pool_k or k_eff, pool=bool(pool_k), device=self.device,
            query_bytes=1 if int8_queries else compute_dtype.itemsize,
            code_bits=store.quant_bits if quantized else 0, d=store.dim)
        q = int(queries_nav.shape[0])
        plan = SimpleNamespace(
            q=q, backend=backend, compute_dtype=compute_dtype, k=k,
            rerank=rerank, k_eff=k_eff, pool_k=pool_k, pair=pair, wl_pad=0,
            item_rows=scfg.pallas_mc,
            int8_queries=int8_queries, pruning=False, want_stats=False)
        if backend == "xla":
            self._plan_xla(plan, store, n_buckets, scfg)
            return plan
        # the worklist: sized from this batch's routing at a shape's first
        # use (one more routing pass and a host read), then cached
        if scfg.pallas_worklist:
            wl_pad = self._wl_pads.get((q, n_buckets))
            if wl_pad is None:
                wl_pad = self._estimate_wl_pad(queries_nav, n_buckets, scfg,
                                               plan)
                self._wl_pads[(q, n_buckets)] = wl_pad or -1
            plan.wl_pad = max(wl_pad, 0)
        return plan

    def _plan_xla(self, plan, store, n_buckets: int,
                  scfg: SearchConfig) -> None:
        """The xla scan's part of a plan. Padding classes: data_chunk and
        max_chunks follow the store; qpb_pad the routing of this batch,
        from a 4x-mean guess (or the value a search of this shape
        validated), re-run larger when the scan reports more slots in one
        bucket. Threshold pruning: past the first probe ranks, with bounds
        computed (`compute_bounds`); the scan counts rows when it prunes or
        truncates (``probe_mass``)."""
        n_slots = plan.q * n_buckets
        max_bucket = max(self.built.max_bucket, 1)
        plan.data_chunk = min(scfg.data_chunk, size_class(max_bucket),
                              int(store.data_sorted.shape[0]))
        plan.max_chunks = max(-(-max_bucket // plan.data_chunk), 1)
        plan.qpb_pad = scfg.queries_per_bucket_pad or self._qpb_pads.get(
            (plan.q, n_buckets), size_class(min(
                n_slots, max(4 * n_slots // store.n_categories, 128))))
        plan.pruning = (scfg.prune_after > 0 and store.has_bounds
                        and n_buckets > scfg.prune_after)
        plan.want_stats = plan.pruning or scfg.probe_mass is not None
        if scfg.prune_eps is not None:
            plan.prune_eps = float(scfg.prune_eps)
        elif scfg.compute_dtype == "bfloat16":
            plan.prune_eps = 5e-3   # bf16 inputs round similarities ~2e-3
        else:
            plan.prune_eps = 1e-4

    def _wl_pad_for(self, total: int, plan, n_buckets: int) -> int:
        """The worklist length for `total` items: 15% headroom for the
        routing of later batches, in steps of 1024; 0, the one-CTA-per-block
        launch, when the items' scratch would pass
        `probe.WL_SCRATCH_BYTES_MAX`."""
        pad = max(-(-int(total * 1.15) // 1024) * 1024, 1024)
        n_blocks = -(-(plan.q * n_buckets) // probe.BLOCK_SLOTS) + (
            self.built.store.n_categories)
        need = probe.worklist_scratch_bytes(pad, plan.pool_k or plan.k_eff,
                                            n_blocks, bool(plan.pool_k))
        if need > probe.WL_SCRATCH_BYTES_MAX:
            log.info("the worklist would need %d items and %d bytes of "
                     "scratch (> %d); keeping one CTA per block for this "
                     "shape", pad, need, probe.WL_SCRATCH_BYTES_MAX)
            return 0
        return pad

    @torch.no_grad()
    def _estimate_wl_pad(self, queries_nav, n_buckets: int,
                         scfg: SearchConfig, plan) -> int:
        """Size the worklist from this batch's routing:
        W = sum over probed buckets of ceil(slots / 64) * max(ceil(rows /
        span), 1), the closed form of `probe.build_worklist`, with span =
        pallas_mc rows (twice that with the 128-row tile). One more routing
        pass and a host read, once per (Q, n_buckets) shape."""
        store = self.built.store
        n_cat = store.n_categories
        logits, mass = routing_logits(self.built.classifier.model,
                                      queries_nav,
                                      need_mass=scfg.probe_mass is not None)
        probes = route_probes(logits, n_buckets, probe_mass=scfg.probe_mass,
                              dump_id=n_cat, mass_logits=mass)
        pb = probes.reshape(-1).cpu().numpy()
        slots = np.bincount(pb[pb < n_cat], minlength=n_cat)
        span = plan.item_rows * (2 if plan.pair else 1)
        steps = np.maximum(-(-store.counts.cpu().numpy() // span), 1)
        total = int(np.sum(-(-slots // probe.BLOCK_SLOTS) * steps
                           * (slots > 0)))
        return self._wl_pad_for(total, plan, n_buckets)

    def _dispatch_program(self, plan, n_buckets: int, scfg: SearchConfig):
        """The search function for the plan's static configuration, made
        once and kept. On the xla scan, rounds the plan's qpb_pad up to
        whole query chunks in place."""
        key = (plan.backend, n_buckets, plan.k_eff, plan.compute_dtype,
               scfg.probe_mass, scfg.fetch_dtype, plan.int8_queries,
               plan.pool_k, plan.pair, plan.wl_pad, plan.item_rows)
        xla = {}
        if plan.backend == "xla":
            query_chunk = min(scfg.query_chunk, plan.qpb_pad)
            plan.qpb_pad = -(-plan.qpb_pad // query_chunk) * query_chunk
            xla = dict(qpb_pad=plan.qpb_pad, data_chunk=plan.data_chunk,
                       max_chunks=plan.max_chunks, query_chunk=query_chunk,
                       prune_after=scfg.prune_after if plan.pruning else 0,
                       prune_eps=plan.prune_eps)
            key += tuple(xla.values())
        program = self._search_programs.get(key)
        if program is None:
            program = make_search_program(
                self.built.classifier.model, k=plan.k_eff, n_buckets=n_buckets,
                compute_dtype=plan.compute_dtype, backend=plan.backend,
                probe_mass=scfg.probe_mass,
                fetch_dtype=_DTYPES[scfg.fetch_dtype]
                if scfg.fetch_dtype else None,
                int8_queries=plan.int8_queries, pool_k=plan.pool_k,
                pair=plan.pair, wl_pad=plan.wl_pad, item_rows=plan.item_rows,
                **xla)
            self._search_programs[key] = program
        return program

    def _fetch_result(self, out, plan):
        """A program's result on the host: (dists, ids, max_slots[, the
        worklist's item total | scanned rows, nominal rows]); waits for the
        card. When the plan reranks, the quantized distances stay on the
        card (dists is None): the rerank recomputes every kept candidate's
        distance."""
        dists, ids, *counts = out
        return (None if plan.rerank else dists.cpu().float().numpy(),
                ids.cpu().numpy(), *(int(c) for c in counts))

    def _absorb_result(self, plan, n_buckets: int, got):
        """Hold a fetched result against its plan. Returns (dists, ids),
        or "retry" after growing an overflowed pad for a re-run: the
        worklist (whose trailing items were dropped) or, on the xla scan,
        the slots per bucket (qpb_pad; slots past it were not scanned). The
        kernel's slot layout is sized for the worst case and cannot
        overflow; the busiest bucket's slot count is kept for callers, and
        the xla scan's row counters in ``last_scan_rows`` /
        ``last_nominal_rows``."""
        dists, ids, max_slots, *extra = got
        if plan.wl_pad and extra[0] > plan.wl_pad:
            plan.wl_pad = self._wl_pad_for(extra[0], plan, n_buckets)
            self._wl_pads[(plan.q, n_buckets)] = plan.wl_pad or -1
            return "retry"
        if plan.backend == "xla":
            if plan.want_stats:
                self.last_scan_rows, self.last_nominal_rows = extra
            if max_slots > plan.qpb_pad:
                plan.qpb_pad = size_class(max_slots)
                return "retry"
            self._qpb_pads[(plan.q, n_buckets)] = plan.qpb_pad
        self.last_max_slots = max_slots
        self._warm_shapes.add((plan.q, n_buckets))
        return dists, ids

    def _finalize(self, dists, ids, plan, k: int, scfg: SearchConfig,
                  queries_search, queries_search_host):
        """Host post-processing of a fetched result (numpy arrays), shared
        by `search` and `search_stream`: the exact rerank when the plan
        asks for it (`dists` is then None), then empty places (id -1) keep
        the sentinel distance and become id 0, and ids become 1-based."""
        if plan.rerank:
            dists, ids = self._rerank_host(
                None, ids, queries_search, k,
                host_queries=queries_search_host,
                rerank_dtype=scfg.rerank_dtype)
        ids = np.where(ids < 0, 0, ids)
        return (np.asarray(dists, np.float32), ids.astype(np.int64) + 1)

    def search_stream(self, batches: Iterable, *, n_buckets: int = 10,
                      k: int = 10,
                      search_config: Optional[SearchConfig] = None,
                      depth: int = 2, overlap_finalize: bool = True):
        """The serving loop: a generator that yields `search`'s exact
        (dists, 1-based anns) for every batch of `batches`, in order, with
        up to ``depth`` batches dispatched to the card ahead of the fetch.

        ``batches`` yields ``(queries_nav, queries_search)`` or
        ``(queries_nav, queries_search, queries_search_host)`` (the third
        as in `search`). `search` waits for each of its stages: the copy of
        the queries, the kernels, the copy back, the host rerank. Here, on
        a CUDA device, a batch's host arrays are staged in pinned buffers
        and copied on a stream of their own, its kernels are queued behind
        that copy, and its results go to pinned buffers with an event; the
        next batch is queued before the last one's event is waited for, so
        copies, kernels and host work overlap. On a CPU device the same
        generator runs each dispatch inline.

        The first batch of a (Q, n_buckets) shape, and any batch above
        ``batch_queries``, drains the pipeline and goes through `search`
        (which builds the kernels and sizes the worklist). A worklist that
        overflows in flight redoes that one batch through `search` on the
        caller's thread. ``overlap_finalize`` runs `_finalize`, and with it
        the exact rerank, on one worker thread, so batch i's rerank runs
        beside batch i+1's fetch; the single worker keeps the order."""
        if self.built is None:
            raise ValueError("Index is not built, call `build` first.")
        scfg = search_config or SearchConfig(k=k, n_buckets=n_buckets)
        nb = min(n_buckets, self.built.store.n_categories)
        store = self.built.store
        pending = deque()   # dispatched batches, at most `depth`
        results = deque()   # finalize futures in order, at most 2
        executor = ThreadPoolExecutor(max_workers=1) if overlap_finalize \
            else None
        stager = (QueryStager(self.device, depth + 1)
                  if self.device.type == "cuda" else None)

        def unpack(batch):
            qn, qs, qh = batch if len(batch) == 3 else (*batch, None)
            if qs is None:
                qs = qn
            if qh is None and isinstance(qs, np.ndarray):
                qh = qs
            return qn, qs, qh

        def done(value):
            f = Future()
            f.set_result(value)
            return f

        def sync_one():
            """Fetch and absorb the oldest batch in flight; hand its host
            post-processing to the worker. Returns a future."""
            qn, qs, qh, fetch, plan = pending.popleft()
            status = self._absorb_result(plan, nb, fetch())
            if status == "retry":
                # the plan and its cache have grown: redo this one batch
                # here (a re-dispatch must not race the dispatch loop)
                return done(self.search(qn, qs, n_buckets=nb, k=k,
                                        search_config=scfg,
                                        queries_search_host=qh))
            args = (*status, plan, k, scfg, qs, qh)
            if executor is not None:
                return executor.submit(self._finalize, *args)
            return done(self._finalize(*args))

        try:
            for batch in batches:
                qn, qs, qh = unpack(batch)
                q = int(np.shape(qn)[0])
                if ((scfg.batch_queries and q > scfg.batch_queries)
                        or (q, nb) not in self._warm_shapes
                        or (scfg.pallas_worklist
                            and (q, nb) not in self._wl_pads)):
                    # drain so that results stay in order, then answer
                    # this batch through `search`
                    while pending:
                        results.append(sync_one())
                    while results:
                        yield results.popleft().result()
                    yield self.search(qn, qs, n_buckets=nb, k=k,
                                      search_config=scfg,
                                      queries_search_host=qh)
                    continue
                if stager is not None:
                    qn_dev, qs_dev, slot = stager.upload(qn, qs)
                else:
                    qn_dev, qs_dev = self._tensor(qn), self._tensor(qs)
                plan = self._plan_search(qn_dev, nb, k, scfg)
                program = self._dispatch_program(plan, nb, scfg)
                out = program(qn_dev, qs_dev, store)
                if stager is not None:
                    fetch = stager.download(slot, out, skip_dists=plan.rerank)
                else:
                    fetch = (lambda out=out, plan=plan:
                             self._fetch_result(out, plan))
                pending.append((qn, qs, qh, fetch, plan))
                if len(pending) >= depth:
                    results.append(sync_one())
                # keep one finalize in flight: yielding the older future
                # lets the newest rerank run beside the next batch's fetch
                while len(results) > 1:
                    yield results.popleft().result()
            while pending:
                results.append(sync_one())
            while results:
                yield results.popleft().result()
        finally:
            if executor is not None:
                executor.shutdown(wait=False)

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

    # ------------------------------------------------------------ checkpoint
    @staticmethod
    def _corpus_fingerprint(corpus) -> dict:
        """Cheap identity of a host rerank corpus: shape + a hash of three
        sampled rows. Enough to catch attaching the wrong corpus without
        reading all of it."""
        n, d = int(corpus.shape[0]), int(corpus.shape[1])
        h = hashlib.sha1()
        for i in (0, n // 2, n - 1):
            h.update(np.ascontiguousarray(
                np.asarray(corpus[i], np.float32)).tobytes())
        return {"n": n, "d": d, "rows_sha1": h.hexdigest()}

    def attach_host_corpus(self, corpus, normalized: bool = False) -> None:
        """Attach (or re-attach) the host-resident full-precision corpus
        used for the exact rerank of quantized search results. Validated
        against the checkpoint's fingerprint when one was restored."""
        meta = self._rerank_meta
        if meta is not None:
            fp = self._corpus_fingerprint(corpus)
            if fp != meta.get("fingerprint", fp):
                raise ValueError(
                    "host corpus does not match the checkpointed rerank "
                    f"fingerprint: got {fp}, expected {meta['fingerprint']}")
            normalized = bool(meta.get("normalized", normalized))
        self._host_corpus = (corpus, normalized)

    def save(self, path: str, include_corpus: bool = False) -> None:
        """Checkpoint the built index (centroids, router, bucket store and
        its pruning bounds) as ``state.npz`` + ``meta.json`` under `path`;
        `load` restores it. numpy has no bfloat16: a bfloat16 tensor is
        saved as its uint16 bits and named in ``meta["bfloat16"]``.

        A quantized index carries a host rerank corpus; its contract
        (fingerprint, dtype, and the source path when the corpus is a
        memmap) is always recorded so that `load` can reattach it or warn.
        ``include_corpus=True`` also copies the corpus into the checkpoint
        (``corpus.npy``; a bfloat16 corpus as its bits) for a
        self-contained restore."""
        if self.built is None:
            raise ValueError("Nothing to save, call `build` first.")
        path = Path(path).absolute()
        path.mkdir(parents=True, exist_ok=True)
        built, store = self.built, self.built.store
        bf16_names = []

        def host(t, name=None):
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:
                bf16_names.append(name)
                return t.view(torch.int16).numpy().view(np.uint16)
            return t.numpy()

        state = {
            "pred_categories": host(built.pred_categories),
            "store.data_sorted": host(store.data_sorted,
                                      "store.data_sorted"),
            "store.ids_sorted": host(store.ids_sorted),
            "store.offsets": host(store.offsets),
            "store.counts": host(store.counts),
        }
        if built.centroids is not None:
            state["centroids"] = host(built.centroids)
        if store.scales is not None:
            state["store.scales"] = host(store.scales)
        if store.has_bounds:
            for name in _BOUNDS:
                state[f"store.{name}"] = host(getattr(store, name))
        for name, t in built.classifier.model.state_dict().items():
            state[f"params.{name}"] = host(t, f"params.{name}")
        meta = {
            "config": built.config.to_dict(),
            "input_dim": built.classifier.input_dim,
            "n_classes": built.classifier.n_classes,
            "model_type": built.classifier.model_type,
            "store_n": store.n,
            "store_pad_rows": store.pad_rows,
            "store_row_align": store.row_align,
            "store_quant_bits": store.quant_bits,
            "version": CHECKPOINT_VERSION,
        }
        if bf16_names:
            meta["bfloat16"] = bf16_names
        if self._host_corpus is not None:
            corpus, normalized = self._host_corpus
            src = getattr(corpus, "filename", None)
            meta["rerank"] = {
                "normalized": bool(normalized),
                "fingerprint": self._corpus_fingerprint(corpus),
                "corpus_path": str(src) if src else None,
                "corpus_dtype": host_dtype(corpus),
            }
        np.savez(path / "state.npz", **state)
        if include_corpus and self._host_corpus is not None:
            corpus = self._host_corpus[0]
            np.save(path / "corpus.npy",
                    np.asarray(corpus.bits) if isinstance(corpus, HostBF16)
                    else np.asarray(corpus))
        with open(path / "meta.json", "w") as f:
            json.dump(meta, f)

    @staticmethod
    def _restore_rerank(index: "LearnedIndex", meta: dict, path: Path) -> None:
        """Reattach the host rerank corpus of a quantized checkpoint, or
        warn loudly that restored searches will run on the codes only.
        Tries, in order: ``corpus.npy`` inside the checkpoint (written by
        ``save(include_corpus=True)``), then the recorded source path of a
        memmap corpus. Fingerprint-validated either way."""
        rer = meta.get("rerank")
        if not rer:
            return
        index._rerank_meta = rer
        candidates = [path / "corpus.npy"]
        if rer.get("corpus_path"):
            candidates.append(Path(rer["corpus_path"]))
        for cand in candidates:
            if not cand.exists():
                continue
            try:
                corpus = np.load(cand, mmap_mode="r")
                if rer.get("corpus_dtype") == "bfloat16":
                    corpus = HostBF16(corpus)
                index.attach_host_corpus(corpus)
                log.info("rerank corpus reattached from %s", cand)
                return
            except (ValueError, OSError) as e:
                log.warning("rerank corpus at %s rejected: %s", cand, e)
        log.warning(
            "QUANTIZED index restored WITHOUT its rerank corpus: searches "
            "will run on the quantized codes only. Call "
            "attach_host_corpus(corpus) to restore the exact rerank "
            "(expected corpus: %s).", rer.get("fingerprint"))

    @classmethod
    def load(cls, path: str, device="cuda") -> "LearnedIndex":
        """Restore a saved index onto `device`."""
        path = Path(path).absolute()
        with open(path / "meta.json") as f:
            meta = json.load(f)
        cfg = IndexConfig(**meta["config"])
        index = cls(cfg, device=device)
        dev = index.device
        with np.load(path / "state.npz", allow_pickle=False) as z:
            state = {name: z[name] for name in z.files}
        for name in meta.get("bfloat16", []):
            state[name] = HostBF16(state[name]).to_torch()

        def t(name, dtype=None):
            return torch.as_tensor(state[name], dtype=dtype, device=dev)

        classifier = BucketClassifier(
            meta["input_dim"], meta["n_classes"], lr=cfg.lr,
            model_type=meta["model_type"], seed=cfg.seed, device=dev)
        classifier.model.load_state_dict(
            {name[len("params."):]: t(name) for name in state
             if name.startswith("params.")})
        store = BucketStore(
            data_sorted=t("store.data_sorted"),
            ids_sorted=t("store.ids_sorted", torch.int32),
            offsets=t("store.offsets", torch.int32),
            counts=t("store.counts", torch.int32),
            n=int(meta["store_n"]), pad_rows=int(meta["store_pad_rows"]),
            row_align=int(meta.get("store_row_align", 1)),
            scales=(t("store.scales", torch.float32)
                    if "store.scales" in state else None),
            quant_bits=int(meta.get("store_quant_bits", 8)),
            **{name: t(f"store.{name}", torch.float32) for name in _BOUNDS
               if f"store.{name}" in state})
        index.built = BuiltIndex(
            centroids=t("centroids") if "centroids" in state else None,
            classifier=classifier, store=store,
            pred_categories=t("pred_categories", torch.int32), config=cfg,
            max_bucket=bucket_stats(store)[0])
        cls._restore_rerank(index, meta, path)
        return index
