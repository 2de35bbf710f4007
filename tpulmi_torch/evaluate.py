"""Evaluation: recall and throughput from SISAP-format result files, read
back and scored against a ground-truth h5 (``knns`` with 1-based ids,
`write_ground_truth`), and a recall / QPS plot of the scored rows."""

import csv
import glob
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from tpulmi_torch.utils.logging import get_logger

log = get_logger("tpulmi_torch.evaluate")


@dataclass
class EvalRow:
    algo: str
    params: str
    data: str
    size: str
    buildtime: float
    querytime: float
    recall: float
    qps: float


def recall_at_k(result_knns: np.ndarray, gt_knns: np.ndarray,
                k: int = 10) -> float:
    """Mean fraction of the true top-k found (the SISAP recall). Both
    arrays are id matrices of shape (Q, >=k); repeated ids in a result row
    count once."""
    q = result_knns.shape[0]
    if gt_knns.shape[0] != q:
        raise ValueError(f"query count mismatch: results {q} vs ground "
                         f"truth {gt_knns.shape[0]}")
    gt_k = np.asarray(gt_knns[:, :k], np.int64)
    res_k = np.asarray(result_knns[:, :k], np.int64)
    # offset ids per row so membership never crosses rows; drop repeats
    hi = max(int(gt_k.max(initial=0)), int(res_k.max(initial=0))) + 2
    offset = np.arange(q, dtype=np.int64)[:, None] * hi
    res_off = np.sort(res_k + offset, axis=1)
    first = np.concatenate(
        [np.ones((q, 1), bool), res_off[:, 1:] != res_off[:, :-1]], axis=1)
    hits = int(np.isin(res_off[first], (gt_k + offset).ravel()).sum())
    return hits / (q * k)


def evaluate_file(result_path: str, gt_path: str, k: int = 10) -> EvalRow:
    """Score one result h5 against a ground-truth h5."""
    import h5py

    with h5py.File(result_path, "r") as f:
        knns = np.asarray(f["knns"])
        attrs = dict(f.attrs)
    with h5py.File(gt_path, "r") as f:
        gt = np.asarray(f["knns"])
    querytime = float(attrs.get("querytime", float("nan")))
    return EvalRow(
        algo=str(attrs.get("algo", "")), params=str(attrs.get("params", "")),
        data=str(attrs.get("data", "")), size=str(attrs.get("size", "")),
        buildtime=float(attrs.get("buildtime", float("nan"))),
        querytime=querytime, recall=recall_at_k(knns, gt, k),
        qps=knns.shape[0] / querytime if querytime > 0 else float("nan"))


def evaluate_results(result_glob: str, gt_path: str, k: int = 10,
                     csv_path: Optional[str] = "res.csv") -> List[EvalRow]:
    """Score every result file matching `result_glob`; optionally write the
    ``res.csv`` summary."""
    rows = []
    for path in sorted(glob.glob(result_glob, recursive=True)):
        try:
            row = evaluate_file(path, gt_path, k)
        except (OSError, KeyError, ValueError) as e:
            log.warning("skipping %s: %s", path, e)
            continue
        rows.append(row)
        log.info("%s: recall@%d=%.4f qps=%.0f", os.path.basename(path), k,
                 row.recall, row.qps)
    if csv_path and rows:
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["algo", "params", "data", "size", "buildtime",
                        "querytime", "recall", "qps"])
            for r in rows:
                w.writerow([r.algo, r.params, r.data, r.size,
                            f"{r.buildtime:.3f}", f"{r.querytime:.3f}",
                            f"{r.recall:.4f}", f"{r.qps:.1f}"])
        log.info("wrote %s (%d rows)", csv_path, len(rows))
    return rows


def write_ground_truth(path: str, dists: np.ndarray, knns: np.ndarray) -> None:
    """Write a ground-truth h5 (1-based ``knns``, ascending ``dists``) in
    the layout the SISAP challenge publishes."""
    import h5py
    from pathlib import Path

    os.makedirs(Path(path).parent, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("knns", knns.shape, dtype=knns.dtype)[:] = knns
        f.create_dataset("dists", dists.shape, dtype=dists.dtype)[:] = dists


def plot_results(rows: List[EvalRow], out_path: str = "result.png") -> None:
    """Recall / QPS scatter of evaluated rows, written as a PNG (needs
    matplotlib; drawn off-screen)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for r in rows:
        ax.scatter(r.recall, r.qps, s=36)
        ax.annotate(r.params[-24:], (r.recall, r.qps), fontsize=6, alpha=0.7)
    ax.set_xlabel("recall@10")
    ax.set_ylabel("queries/s")
    ax.set_yscale("log")
    ax.set_title("tpulmi_torch recall/throughput")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    log.info("wrote %s", out_path)
