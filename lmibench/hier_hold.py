"""Hold a hierarchical cell's answers against the plain reference
(`hier_reference.py`), at the cell's own sizes, on the card:

    python3 lmibench/hier_hold.py --workload laion20m-hier-int8.batch10k \
        --seed <n> [--queries 1000] [--control]

It builds the cell's index through `system.System` as `run.py` does,
warms up as `run.py` does, times one request of the cell's traffic (an
order of the whole query pool) and, for the first ``--queries`` queries of
that request, compares (`hier_reference.compare`, at the cell's
``dist_rms_gap_max``) the buckets the built router sends them to
(`System.route`, over the request's whole order, so at the request's
shape) and the program's ids and distances with the reference's, fed the
built router's weights, the built store's rows by bucket and the host
rows, taken as unit length where the build was told they are
(``build.normalized``), as the configuration's ``guarantees`` state.

Beside the hold it reads each returned row's exact cosine distance (the
host row made unit) and prints the gaps of the program's distances to it
(``exact_rms_gap``, ``exact_widest_gap``). It logs the queries whose ids
differ untied.

``--control`` runs the configuration's control in the program's place
(the reference stays the configuration's): it must fail the distances.
The last line of standard output is one JSON object with every number
and ``held``. ``--smoke`` shrinks the cell as `run.py --smoke` does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lmibench import cells, datagen, hier_reference  # noqa: E402
from lmibench.run import log, shrink  # noqa: E402
from lmibench.system import System, with_control  # noqa: E402
from lmibench.traffic import closed_ring, warmup_sizes  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--queries", type=int, default=1000)
    p.add_argument("--control", action="store_true")
    p.add_argument("--smoke", action="store_true")
    return p.parse_args(argv)


def main(argv=None, device=None) -> int:
    args = parse(argv)
    cell = cells.find(args.workload)
    device = torch.device(device or "cuda")
    config = shrink(cell.config) if args.smoke else cell.config
    reference_config = config
    if args.control:
        config = with_control(config)
    if "hierarchy" not in config:
        log(f"{args.workload} has no hierarchy to hold")
        return 2
    corpus = datagen.Corpus(datagen.Spec.of(config), args.seed, device)
    queries_nav, queries_search = corpus.queries()
    search_rows, nav_rows = datagen.host_arrays(
        corpus, config["data"]["search_dtype"], config["data"]["nav_dtype"])
    system = System(config, device)
    t = time.perf_counter()
    system.build(search_rows, nav_rows)
    log(f"built in {time.perf_counter() - t:.3f}s; stages "
        f"{system.build_stages()}")
    del nav_rows
    pool = len(queries_nav)
    ring = closed_ring(cell.traffic, pool, args.seed)
    warm = np.random.default_rng(0).permutation(pool)
    for size in warmup_sizes(cell.traffic, pool):
        idx = warm[np.arange(size) % pool]
        system.search(queries_nav[idx], queries_search[idx])
    system.search(queries_nav[ring[0]], queries_search[ring[0]])

    # one request of the window
    order = ring[1 % len(ring)]
    t = time.perf_counter()
    dists, ids = system.search(queries_nav[order], queries_search[order])
    took = time.perf_counter() - t
    n = min(args.queries, pool)
    routed = system.route(queries_nav[order])[:n]
    sel = order[:n]

    search = reference_config["search"]
    tol = float(reference_config["check"]["dist_rms_gap_max"])
    index = system.index
    rows = hier_reference.host_rows(search_rows)
    q = torch.as_tensor(queries_search[sel], device=device)
    t = time.perf_counter()
    ref = hier_reference.search(
        hier_reference.router_of(index), hier_reference.buckets_of(index),
        torch.as_tensor(queries_nav[sel], device=device), q,
        system.n_buckets, system.k,
        int8_queries=bool(search.get("int8_queries")),
        rerank_extra=int(search.get("rerank_extra") or 10), host_rows=rows,
        normalized=bool(reference_config["build"].get("normalized")))
    log(f"reference over {n} queries in {time.perf_counter() - t:.3f}s")
    got_ids = torch.as_tensor(ids[:n] - 1, device=device)
    out = hier_reference.compare(routed, dists[:n], ids[:n] - 1, ref, tol)
    # the exact cosine of each returned row
    exact = hier_reference.pair_dists(rows, got_ids, q).cpu().numpy()
    exact_gap = np.abs(np.asarray(dists[:n], np.float64) - exact)
    out.update(exact_rms_gap=float(np.sqrt(np.mean(exact_gap ** 2))),
               exact_widest_gap=float(exact_gap.max()))
    for i in out["untied"][:10]:
        norms = torch.linalg.vector_norm(
            rows[got_ids[i].clamp_min(0).cpu()].float(), dim=1)
        log(f"query {i}: ids {(ids[i] - 1).tolist()} dists "
            f"{dists[i].tolist()} exact {exact[i].tolist()} row norms "
            f"{norms.tolist()}; reference ids {ref.ids[i].tolist()} "
            f"dists {ref.dists[i].tolist()}")
    out.update(workload=args.workload, seed=args.seed,
               control=args.control, request_s=took,
               device=(torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"))
    system.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
