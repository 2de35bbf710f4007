"""Experiment CLI: build an index, search it at each probe budget and
write SISAP result files.

    python -m tpulmi_torch.cli --synthetic 300000 --n-categories 122 \\
        --epochs 12 --lr 0.003 -bp 1 2 3 --size 300K --result-dir result

The flags, their defaults and their choices are the JAX package's
(``tpulmi/cli.py``); the defaults are the reference's published 10M
configuration. ``-bp`` is the percent of buckets probed (floored, as the
reference does). ``--synthetic N`` runs the whole pipeline on N rows of the
synthetic clustered dataset and logs recall@k against the exact oracle;
without it the SISAP files are read from
``<data-dir>/<dataset>/<size>/{dataset,query}.h5`` (this package fetches
nothing). Everything runs on the card; `run` and `main` take a ``device``
for the CPU.
"""

import argparse
import os
import time

import numpy as np

from tpulmi_torch.baseline import Baseline
from tpulmi_torch.data import load_dataset, store_results, synthetic_dataset
from tpulmi_torch.index import LearnedIndex
from tpulmi_torch.utils.config import IndexConfig, n_buckets_from_percentage
from tpulmi_torch.utils.logging import get_logger

log = get_logger("tpulmi_torch.cli")

SIZES = ["100K", "300K", "10M", "30M", "100M"]


def _str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def run(
    kind: str = "pca96v2",
    key: str = "pca96",
    size: str = "10M",
    k: int = 10,
    index_type: str = "learned-index",
    buckets_perc=(4,),
    n_categories: int = 122,
    epochs: int = 205,
    model_type: str = "MLP-5",
    lr: float = 0.009,
    preprocess: bool = True,
    save: bool = False,
    synthetic: int = 0,
    data_dir: str = "data",
    result_dir: str = "result",
    save_index: str = "",
    hierarchical_groups: int = 0,
    store_dtype: str = "float32",
    shard: int = 0,
    probe_mass: float = 0.0,
    calibrate: bool = False,
    prune: bool = False,
    rerank_dtype: str = "float32",
    pallas_worklist: bool = False,
    pallas_extract: str = "group",
    pallas_pair: bool = False,
    fetch_dtype: str = "",
    router_restarts: int = 1,
    device="cuda",
):
    """Build, then search at each probe budget, writing one SISAP result
    file per budget under ``result_dir/<kind>/<size>/``."""
    # -bp is a percent of the buckets; a hierarchical index routes over
    # groups * categories global buckets, so the budget scales with it
    total_buckets = n_categories * max(hierarchical_groups, 1)
    n_buckets_list = n_buckets_from_percentage(list(buckets_perc),
                                               total_buckets)
    if index_type == "learned-index" and not n_buckets_list:
        log.warning(
            "-bp %s of %d categories resolves to zero probed buckets "
            "(reference semantics floor the percentage); no search will run",
            list(buckets_perc), n_categories,
        )
    log.info(
        "run: kind=%s key=%s size=%s k=%d index=%s buckets=%s categories=%d "
        "epochs=%d lr=%g model=%s preprocess=%s device=%s",
        kind, key, size, k, index_type, n_buckets_list, n_categories,
        epochs, lr, model_type, preprocess, device,
    )

    # ---- data ----
    if synthetic:
        ds = synthetic_dataset(
            n=synthetic, n_queries=10_000 if synthetic >= 100_000
            else max(synthetic // 30, 10), n_clusters=n_categories)
        data_nav, queries_nav = ds["data_nav"], ds["queries_nav"]
        data_search, queries_search = ds["data_search"], ds["queries_search"]
        kind = f"synthetic-{synthetic}"
    else:
        data_nav, queries_nav = load_dataset(kind, key, size, data_dir,
                                             preprocess=preprocess)
        kind_search, key_search = "clip768v2", "emb"
        if kind != kind_search:
            data_search, queries_search = load_dataset(
                kind_search, key_search, size, data_dir, preprocess=False)
        else:
            data_search, queries_search = data_nav, queries_nav
    log.info("data: nav %s, search %s, queries %s",
             data_nav.shape, data_search.shape, queries_nav.shape)

    if index_type == "baseline":
        baseline = Baseline(device=device)
        build_t = baseline.build(data_search)
        dists, nns, search_t = baseline.search(queries_search, k=k)
        log.info("baseline search: %.3fs", search_t)
        _store(result_dir, kind, size, "li-baseline", "li-baseline",
               dists, nns, build_t, search_t)
        return

    if index_type != "learned-index":
        raise ValueError(f"Unknown index type: {index_type}")

    cfg = IndexConfig(n_categories=n_categories, epochs=epochs, lr=lr,
                      model_type=model_type)
    if hierarchical_groups:
        from tpulmi_torch.hierarchical import (HierarchicalConfig,
                                               HierarchicalIndex)

        li = HierarchicalIndex(HierarchicalConfig(
            n_groups=hierarchical_groups, inner=cfg,
            router_restarts=max(1, router_restarts)), device=device)
    else:
        if router_restarts > 1:
            log.warning(
                "--router-restarts %d is a hierarchical-navigation knob "
                "and is ignored by the flat index; pass "
                "--hierarchical-groups to use it", router_restarts)
        li = LearnedIndex(cfg, device=device)
    _, build_t = li.build(data_nav, data_search)
    log.info("build time: %.1fs", build_t)
    if store_dtype in ("int8", "int4"):
        # codes + per-row scales, with the host corpus attached so that
        # search reranks the final candidates at full precision
        bits = 4 if store_dtype == "int4" else 8
        li.quantize(host_corpus=np.asarray(data_search, np.float32),
                    bits=bits)
        log.info("store quantized to int%d (+exact host rerank)", bits)
    if calibrate and hierarchical_groups:
        budget = max(n_buckets_list) if n_buckets_list else 8
        cal = li.calibrate_outer_weight(data_nav, probe_budget=budget)
        log.info("router calibrated: outer_weight=%.2f (containment "
                 "%.4f, w=1 %.4f)", cal["best"], cal["best_containment"],
                 cal["baseline_w1"] or -1.0)
    if prune:
        li.compute_bounds()
        log.info("pruning bounds computed (spherical caps per bucket)")
    if shard:
        li.shard(n_shards=shard)
        log.info("store sharded across %d devices", shard)

    if save_index:
        li.save(save_index)
        log.info("index checkpoint saved to %s", save_index)
    if save:
        path = (f"./models/{kind}-{size}-ep={epochs}-lr={lr}-cat="
                f"{n_categories}-model={model_type}-prep={preprocess}")
        li.save(path)
        log.info("index checkpoint saved to %s", path)

    scfg = None
    if (probe_mass or prune or rerank_dtype != "float32" or pallas_worklist
            or pallas_extract != "group" or pallas_pair or fetch_dtype
            or store_dtype == "int4"):
        from tpulmi_torch.utils.config import SearchConfig

        # the threshold prune lives on the xla scan only: pin the backend
        # so that --prune prunes
        if prune:
            log.info("--prune pins backend=xla (the probe kernel has no "
                     "threshold-prune path)")
        scfg = SearchConfig(
            k=k,
            probe_mass=probe_mass or None,
            prune_after=1 if prune else 0,
            backend="xla" if prune else "auto",
            rerank_dtype=rerank_dtype,
            pallas_worklist=pallas_worklist,
            pallas_extract=pallas_extract,
            pallas_pair=pallas_pair,
            fetch_dtype=fetch_dtype or None,
            # int4's coarser codes need a deeper exact-rerank pool
            rerank_extra=30 if store_dtype == "int4" else 10,
        )
    for n_buckets in n_buckets_list:
        start = time.perf_counter()
        dists, nns = li.search(queries_nav, queries_search,
                               n_buckets=n_buckets, k=k, search_config=scfg)
        search_t = time.perf_counter() - start
        log.info("search with %d buckets: %.3fs (%.0f q/s)",
                 n_buckets, search_t, queries_nav.shape[0] / search_t)
        identifier = (
            f"learned-index-{kind}-{size}-ep={epochs}-lr={lr}-cat="
            f"{n_categories}-model={model_type}-buck={n_buckets}"
        )
        _store(result_dir, kind, size, identifier, "Learned-index",
               dists, nns, build_t, search_t)
        if synthetic:
            from tpulmi_torch.evaluate import recall_at_k

            _, gt, _ = Baseline(device=device).search(queries_search,
                                                      data_search, k=k)
            recall = recall_at_k(nns, gt, k=k)
            log.info("recall@%d vs exact oracle: %.4f", k, recall)


def _store(result_dir, kind, size, identifier, algo, dists, nns,
           build_t, search_t):
    dst = os.path.join(result_dir, kind, size, f"{identifier}.h5")
    store_results(dst, algo, kind, dists, nns, build_t, search_t,
                  identifier, size)
    log.info("results stored: %s", dst)


def build_parser() -> argparse.ArgumentParser:
    """The command line, flag for flag the JAX package's."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", default="pca96v2")
    parser.add_argument("--emb", default="pca96")
    parser.add_argument("--size", default="10M", choices=SIZES)
    parser.add_argument("--k", default=10, type=int)
    parser.add_argument("--n-categories", default=122, type=int,
                        help="Number of categories (= buckets) to create")
    parser.add_argument("--epochs", default=205, type=int)
    parser.add_argument("--model-type", default="MLP-5")
    parser.add_argument("--lr", default=0.009, type=float)
    parser.add_argument("-bp", "--buckets-perc", nargs="+", default=[4],
                        type=int,
                        help="Percent of categories to probe (reference "
                             "semantics)")
    parser.add_argument("--preprocess", default=True, type=_str2bool,
                        help="L2-normalize navigation data")
    parser.add_argument("--save", default=False, type=_str2bool)
    parser.add_argument("--index-type", default="learned-index",
                        choices=["learned-index", "baseline"])
    parser.add_argument("--synthetic", default=0, type=int,
                        help="Run on N synthetic rows instead of the SISAP "
                             "files")
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--result-dir", default="result")
    parser.add_argument("--save-index", default="",
                        help="Directory for a checkpoint of the built index")
    parser.add_argument("--hierarchical-groups", default=0, type=int,
                        help="Two-level index with this many outer groups "
                             "(0 = flat single-level)")
    parser.add_argument("--store-dtype", default="float32",
                        choices=["float32", "int8", "int4"],
                        help="int8/int4 quantizes the store with an exact "
                             "host rerank of the final candidates (int4 "
                             "packs two codes per byte and reranks a deeper "
                             "pool)")
    parser.add_argument("--shard", default=0, type=int,
                        help="Shard the bucket store across the first N "
                             "devices (multi-card search)")
    parser.add_argument("--probe-mass", default=0.0, type=float,
                        help="Adaptive per-query probe truncation: stop "
                             "probing at this routed-probability mass "
                             "(0 = off; e.g. 0.98)")
    parser.add_argument("--calibrate", default=False, type=_str2bool,
                        help="Calibrate the hierarchical outer-router "
                             "weight against neighbor containment "
                             "(hierarchical indexes only)")
    parser.add_argument("--prune", default=False, type=_str2bool,
                        help="Compute per-bucket bounds and enable the "
                             "exact threshold skip (xla scan)")
    parser.add_argument("--rerank-dtype", default="float32",
                        choices=["float32", "float16"],
                        help="Precision of the exact host rerank of a "
                             "quantized store")
    parser.add_argument("--pallas-worklist", default=False, type=_str2bool,
                        help="Run the probe kernel over a worklist of "
                             "(block, chunk) items (identical results)")
    parser.add_argument("--pallas-pair", default=False, type=_str2bool,
                        help="Probe kernel tiles of 128 store rows instead "
                             "of 64 (identical results)")
    parser.add_argument("--fetch-dtype", default="",
                        choices=["", "float16", "bfloat16"],
                        help="Narrow the returned distances to this dtype "
                             "on the device (ids unchanged)")
    parser.add_argument("--router-restarts", default=1, type=int,
                        help="Build the hierarchical navigation stack this "
                             "many times under distinct seeds and keep the "
                             "one with the best pseudo-query containment "
                             "(1 = off)")
    parser.add_argument("--pallas-extract", default="group",
                        choices=["group", "group2", "scalar"],
                        help="Top-k maintenance mode of the probe kernel "
                             "(identical results; kept for configs)")
    return parser


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    run(
        kind=args.dataset,
        key=args.emb,
        size=args.size,
        k=args.k,
        index_type=args.index_type,
        buckets_perc=args.buckets_perc,
        n_categories=args.n_categories,
        epochs=args.epochs,
        model_type=args.model_type,
        lr=args.lr,
        preprocess=args.preprocess,
        save=args.save,
        synthetic=args.synthetic,
        data_dir=args.data_dir,
        result_dir=args.result_dir,
        save_index=args.save_index,
        hierarchical_groups=args.hierarchical_groups,
        store_dtype=args.store_dtype,
        shard=args.shard,
        probe_mass=args.probe_mass,
        calibrate=args.calibrate,
        prune=args.prune,
        rerank_dtype=args.rerank_dtype,
        pallas_worklist=args.pallas_worklist,
        pallas_extract=args.pallas_extract,
        pallas_pair=args.pallas_pair,
        fetch_dtype=args.fetch_dtype,
        router_restarts=args.router_restarts,
        device=device,
    )


if __name__ == "__main__":
    main()
