"""Hyperparameter sweep: one process builds and searches every grid
point in turn on one card, and scores recall against the exact oracle.

The grid is the reference sweep's: learning rate x model type x epochs x
n_categories, each at every probe budget of ``buckets_perc``. A sweep given
a ``resume_path`` appends (and flushes) one CSV row per result and, when
rerun after a crash, skips every row already written; the CSV's header is
the JAX package's, so either package resumes the other's file.

For a grid that varies only the learning rate, the training stage alone
can run all of them at once (`tpulmi_torch.models.train_lr_sweep`).
"""

import csv
import itertools
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from tpulmi_torch.baseline import Baseline
from tpulmi_torch.index import LearnedIndex
from tpulmi_torch.utils.config import IndexConfig, n_buckets_from_percentage
from tpulmi_torch.utils.logging import get_logger

log = get_logger("tpulmi_torch.sweep")

CSV_HEADER = ["lr", "model_type", "epochs", "n_categories", "n_buckets",
              "build_s", "search_s", "recall"]


@dataclass
class SweepGrid:
    """The reference sweep's grid shape, one value per axis by default."""

    lrs: Sequence[float] = (0.009,)
    model_types: Sequence[str] = ("MLP-5",)
    epochs: Sequence[int] = (12,)
    n_categories: Sequence[int] = (122,)
    buckets_perc: Sequence[int] = (4,)

    def combos(self):
        return itertools.product(self.lrs, self.model_types, self.epochs,
                                 self.n_categories)


@dataclass
class SweepResult:
    lr: float
    model_type: str
    epochs: int
    n_categories: int
    n_buckets: int
    build_s: float
    search_s: float
    recall: float


def _csv_row(r: SweepResult) -> list:
    return [r.lr, r.model_type, r.epochs, r.n_categories, r.n_buckets,
            f"{r.build_s:.2f}", f"{r.search_s:.3f}", f"{r.recall:.4f}"]


def _load_done(resume_path: str):
    """The (lr, model, epochs, n_cat, n_buckets) keys of the rows a
    previous (possibly crashed) sweep wrote to its CSV."""
    done = set()
    if resume_path and os.path.exists(resume_path):
        with open(resume_path, newline="") as f:
            for row in csv.DictReader(f):
                done.add((float(row["lr"]), row["model_type"],
                          int(row["epochs"]), int(row["n_categories"]),
                          int(row["n_buckets"])))
    return done


def run_sweep(data_nav, queries_nav, data_search=None, queries_search=None,
              grid: SweepGrid = SweepGrid(), k: int = 10,
              gt_ids: Optional[np.ndarray] = None,
              resume_path: Optional[str] = None,
              device="cuda") -> List[SweepResult]:
    """Sweep the grid; returns one row per (combination, probe budget) run
    by this call.

    `gt_ids` (1-based, (Q, >= k)) are the exact neighbours recall is
    scored against; by default `Baseline` computes them once. With
    `resume_path` each row is appended to that CSV as it completes, and
    the rows already there are skipped."""
    if data_search is None:
        data_search = data_nav
    if queries_search is None:
        queries_search = queries_nav
    if gt_ids is None:
        log.info("computing exact ground truth (%d queries)",
                 len(queries_search))
        _, gt_ids, _ = Baseline(device=device).search(queries_search,
                                                      data_search, k=k)

    done = _load_done(resume_path)
    fh = writer = None
    if resume_path:
        new_file = not os.path.exists(resume_path)
        fh = open(resume_path, "a", newline="")
        writer = csv.writer(fh)
        if new_file:
            writer.writerow(CSV_HEADER)
            fh.flush()
        if done:
            log.info("resuming sweep: %d rows already complete", len(done))

    results = []
    try:
        for lr, model_type, epochs, n_cat in grid.combos():
            probe_budgets = [
                b for b in n_buckets_from_percentage(list(grid.buckets_perc),
                                                     n_cat)
                if (float(lr), model_type, int(epochs), int(n_cat), b)
                not in done]
            if not probe_budgets:
                continue
            li = LearnedIndex(IndexConfig(n_categories=n_cat, epochs=epochs,
                                          lr=lr, model_type=model_type),
                              device=device)
            t0 = time.perf_counter()
            li.build(data_nav, data_search)
            build_s = time.perf_counter() - t0
            for n_buckets in probe_budgets:
                t0 = time.perf_counter()
                _, ids = li.search(queries_nav, queries_search,
                                   n_buckets=n_buckets, k=k)
                search_s = time.perf_counter() - t0
                recall = float(np.mean([
                    len(set(ids[i, :k]) & set(gt_ids[i, :k])) / k
                    for i in range(ids.shape[0])]))
                row = SweepResult(lr, model_type, epochs, n_cat, n_buckets,
                                  build_s, search_s, recall)
                results.append(row)
                if writer is not None:
                    writer.writerow(_csv_row(row))
                    fh.flush()
                log.info("lr=%g model=%s ep=%d cat=%d probes=%d: build "
                         "%.1fs search %.2fs recall %.4f", lr, model_type,
                         epochs, n_cat, n_buckets, build_s, search_s, recall)
    finally:
        if fh is not None:
            fh.close()
    return results


def results_to_csv(results: List[SweepResult],
                   path: str = "sweep.csv") -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        for r in results:
            w.writerow(_csv_row(r))
    log.info("wrote %s (%d rows)", path, len(results))
