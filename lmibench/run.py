"""Run one cell of the benchmark once and print its result line.

    python3 lmibench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

(``python -m lmibench.run`` works the same.) The run makes its corpus and
query pool from the seed on the card, builds the index as the cell's
configuration says, warms up every request size its traffic sends, drives
`LearnedIndex.search` for ``--seconds``, keeping (judging nothing inside
the window) the answers of a sample of its requests drawn from the seed,
and then, with the program's state freed, holds those
answers against the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number compared beside its limit.

Not for the benchmark's command line: ``--control`` runs the control (the
configuration's ``control``: the program's own path one precision below
the configuration's) in the program's place; ``--smoke`` shrinks the rows
and the query pool to the configuration's ``smoke`` sizes (widths stay);
``--sweep r1,r2,...`` (open loops) runs each rate's window after one
set-up and prints its tail and backlog, the way a cell's rate is found.
"""

import argparse
import bisect
import gc
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

if __package__ in (None, ""):
    # run as a file: the checkout's root holds both packages
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _process_start() -> float:
    """The host clock (time.time) at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


T_PROCESS = _process_start()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lmibench import cells, datagen, host, reference, stats, tracing  # noqa
from lmibench.check import Answers, Kept, judge  # noqa: E402
from lmibench.system import System, with_control  # noqa: E402
from lmibench.datagen import mix_seed  # noqa: E402
from lmibench.traffic import (closed_ring, open_schedule, run_closed,  # noqa
                              run_open, warmup_sizes)
from lmibench.workmodel import Work, search_work  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpulmi")
BREAKDOWN_ENTRIES = 10
# closed loops: besides the first pass through the ring, each request's
# answer is kept for the check with this chance, drawn from the seed, up
# to KEPT_MOST more
JUDGED_SHARE = 1 / 32
KEPT_MOST = 256
_JUDGE_STREAM = 5


def log(msg: str) -> None:
    print(f"[lmibench] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--sweep", default="",
                   help="open loops: comma-separated rates to run one "
                        "after another after one set-up; prints each "
                        "rate's tail and backlog and no result")
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name, compared
    whole, is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def shrink(config: dict) -> dict:
    """The configuration at its ``smoke`` sizes, for a rehearsal."""
    out = dict(config)
    for key, value in config["smoke"].items():
        out[key] = ({**config[key], **value} if isinstance(value, dict)
                    else value)
    return out


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None, device=None, system_factory=System) -> int:
    """One run. `device` None: the card, which must be there; a test may
    pass ``"cpu"`` with ``--smoke`` and its own `system_factory`."""
    args = parse(argv)
    cell = cells.find(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            log("no CUDA device: this benchmark runs on the card only")
            return 3
        if torch.cuda.device_count() < cell.chips:
            log(f"the cell needs {cell.chips} cards; "
                f"{torch.cuda.device_count()} found")
            return 3
        device = "cuda"
    device = torch.device(device)
    on_card = device.type == "cuda"
    config = shrink(cell.config) if args.smoke else cell.config
    if args.control:
        config = with_control(config)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    # ---- set-up: corpus, build, warm-up --------------------------------
    t = time.perf_counter()
    log(f"process start to set-up {time.time() - T_PROCESS:.3f}s")
    log(f"host: {host.facts(device)}")
    corpus = datagen.Corpus(datagen.Spec.of(config), args.seed, device)
    queries_nav, queries_search = corpus.queries()
    pool, k = len(queries_nav), config["k"]
    search_rows, nav_rows = datagen.host_arrays(
        corpus, config["data"]["search_dtype"], config["data"]["nav_dtype"])
    if on_card:
        torch.cuda.synchronize(device)
    log(f"corpus made on the card and copied to RAM in "
        f"{time.perf_counter() - t:.3f}s")
    system = system_factory(config, device)
    t = time.perf_counter()
    system.build(search_rows, nav_rows)
    build_s = time.perf_counter() - t
    del search_rows, nav_rows     # the program keeps what it needs
    build_stages = system.build_stages()
    log(f"built in {build_s:.3f}s; stages {build_stages}")

    traffic = cell.traffic
    closed = traffic["kind"] == "closed"
    if closed:
        ring_idx = closed_ring(traffic, pool, args.seed)
        ring = [(queries_nav[i], queries_search[i]) for i in ring_idx]
    else:
        requests = open_schedule(traffic, cell.rate, args.seconds, pool,
                                 args.seed)
    t = time.perf_counter()
    warm = np.random.default_rng(0).permutation(pool)
    for size in warmup_sizes(traffic, pool):
        idx = warm[np.arange(size) % pool]
        system.search(queries_nav[idx], queries_search[idx])
    if closed:
        system.search(*ring[0])
    log(f"warm-up in {time.perf_counter() - t:.3f}s")
    if args.sweep:
        sweep(system, traffic, queries_nav, queries_search, args)
        return 0

    # ---- the measured window ---------------------------------------------
    if closed:
        judged = judged_requests(args.seed, len(ring))
        kept = Kept(len(ring) + KEPT_MOST, pool, k)

    def serve_slot(slot):
        return system.search(*ring[slot])

    def keep(i, idx, out):
        return kept.put(out) if i < len(judged) and judged[i] else None

    marks = {}

    def window():
        marks["setup_s"] = time.time() - T_PROCESS
        marks["lo_ns"] = time.time_ns()
        if closed:
            return run_closed(serve_slot, ring_idx, args.seconds, keep=keep)
        return run_open(
            lambda idx: system.search(queries_nav[idx], queries_search[idx]),
            requests, args.seconds, traffic["drain_s"])

    span_set = None
    events = []
    if args.trace:
        span_set = tracing.Spans(cells.spans())
        span_set.install()
    before = host.Usage()
    if args.trace and on_card:
        served, events = tracing.device_trace(window)
    else:
        served = window()
    log(f"host over the window: {host.Usage().since(before)}")
    setup_s, lo_ns = marks["setup_s"], marks["lo_ns"]
    hi_ns = lo_ns + int(served.window_s * 1e9)
    if span_set is not None:
        span_set.uninstall()
    memory_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)
    log(f"host pages by NUMA node {host.pages_by_node()}; "
        f"{host.probes(device, queries_search[:pool].nbytes)}")

    # ---- after the window: what needs the program, then free it ---------
    work = None
    if args.trace:
        layout = system.layout()
        probes = system.route(queries_nav)
        work, per_request = Work(), {}
        for r, end in zip(served.requests, served.end):
            if np.isnan(end):
                continue
            key = id(r.queries)       # the ring's requests repeat
            if key not in per_request:
                per_request[key] = search_work(probes[r.queries], layout)
            work += per_request[key]
    system.close()
    del system
    gc.collect()

    answers = Answers(pool, k, config["rows"])
    failed = judged_n = 0
    for r, out in zip(served.requests, served.results):
        if out is not None:
            answers.add(r.queries, *(kept.get(out) if closed else out))
            judged_n += 1
        elif not closed:
            failed += 1
    log(f"{judged_n} of {len(served.requests)} requests' answers kept "
        f"for the check")

    # ---- the plain reference -----------------------------------------------
    t = time.perf_counter()
    pair_q, pair_row = answers.pairs()
    truth, pair_dist = reference.exact_answers(corpus, queries_search, k,
                                               pair_q, pair_row)
    log(f"reference: exact top-{k} of {pool} queries and {len(pair_q)} "
        f"returned pairs in {time.perf_counter() - t:.3f}s")
    verdict = judge(answers, truth, pair_q, pair_row, pair_dist, failed,
                    config["check"])
    log(f"{verdict['answers']} distinct answers; widest distance gap "
        f"{verdict['widest_gap']!r}")

    ctx = SimpleNamespace(
        cell=cell, config=config, args=args, served=served,
        setup_s=setup_s, build_s=build_s, build_stages=build_stages,
        verdict=verdict,
        spans=span_set, events=events, window_ns=(lo_ns, hi_ns), work=work,
        peaks=cells.peaks(), kernel_patterns=cells.kernel_patterns)
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cells.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    attempted = len(served.requests)
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": verdict["correct"], "attempted": attempted,
              "failed": failed + answers.malformed, "metrics": metrics,
              "device": device_info}
    if args.trace and on_card:
        busy = stats.union_length([(s, e) for _, _, s, e in events],
                                  lo_ns, hi_ns) / 1e9
        device_info["busy_s"] = busy
        device_info["window_s"] = served.window_s
        result["breakdown"] = breakdown(events, span_set, lo_ns, hi_ns)
    result["check"] = verdict["numbers"]

    for line in describe(served, closed, attempted, failed):
        log(line)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"host peak resident {rss:.2f} GiB; card peak "
        f"{memory_peak / 2**30:.2f} GiB")
    if on_card:
        log(f"card: {power_line()}")
    for name, n in verdict["numbers"].items():
        limit = ("min", n["min"]) if "min" in n else ("max", n["max"])
        print(f"check {name} {n['value']!r} {limit[0]} {limit[1]!r}",
              file=sys.stderr)
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package was loaded in this process: "
            f"{', '.join(found)}; no result")
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def judged_requests(seed: int, ring: int, most: int = 2**20) -> np.ndarray:
    """Which requests of a closed loop keep their answer for the check:
    the first pass through the ring's orders, and a share of the rest
    drawn from the seed before the window."""
    rng = np.random.default_rng(mix_seed(seed, _JUDGE_STREAM))
    out = rng.random(most) < JUDGED_SHARE
    out[:ring] = True
    return out


def sweep(system, traffic, queries_nav, queries_search, args) -> None:
    """Each rate's window in turn after one set-up: the tail, how late the
    last requests started (a growing backlog) and how long the queue took
    to drain after the window."""
    for rate in (float(r) for r in args.sweep.split(",")):
        reqs = open_schedule(traffic, rate, args.seconds, len(queries_nav),
                             args.seed)
        served = run_open(
            lambda idx: system.search(queries_nav[idx], queries_search[idx]),
            reqs, args.seconds, traffic["drain_s"])
        due = np.array([r.due for r in reqs])
        lat = served.end - due
        wait = served.start - due
        tail = wait[len(wait) * 9 // 10:]
        log(f"sweep rate {rate:g}/s: {len(reqs)} requests, latency ms p50 "
            f"{np.nanmedian(lat) * 1e3:.3f} p95 "
            f"{stats.percentile(np.nan_to_num(lat, nan=np.inf), 95) * 1e3:.3f}"
            f"; queue wait ms first tenth "
            f"{np.nanmean(wait[:len(wait) // 10]) * 1e3:.3f} last tenth "
            f"{np.nanmean(tail) * 1e3:.3f}; drained "
            f"{(np.nanmax(served.end) - args.seconds) * 1e3:.1f} ms after "
            f"the window; busy {np.nansum(served.end - served.start) / args.seconds:.3f}")


def describe(served, closed: bool, attempted: int, failed: int):
    """The run's sample counts, on lines before the result."""
    n_q = sum(len(r.queries) for r in served.requests)
    yield (f"{attempted} requests ({n_q} queries) in a window of "
           f"{served.window_s:.3f}s; {failed} never answered")
    took = (served.end - served.start)[~np.isnan(served.end)] * 1e3
    if len(took):
        p10, p50, p90 = np.percentile(took, [10, 50, 90])
        yield (f"service ms a request: p10 {p10:.3f}, p50 {p50:.3f}, p90 "
               f"{p90:.3f}, max {took.max():.3f}; by fifths of the window "
               + ", ".join(f"{np.mean(part):.3f}" for part in
                           np.array_split(took, 5)))
    if not closed:
        lat = served.end - np.array([r.due for r in served.requests])
        done = lat[~np.isnan(lat)]
        if len(done):
            yield (f"latency ms over {len(done)} answered: p50 "
                   f"{np.median(done) * 1e3:.3f}, p95 "
                   f"{stats.percentile(done, 95) * 1e3:.3f}, max "
                   f"{done.max() * 1e3:.3f}")
        if served.lateness is not None and len(served.lateness):
            yield (f"generator lateness ms over {len(served.lateness)} "
                   f"requests met idle: p50 "
                   f"{np.median(served.lateness) * 1e3:.4f}, max "
                   f"{served.lateness.max() * 1e3:.4f}")


def breakdown(events, span_set, lo_ns, hi_ns) -> dict:
    """The device operations that took most time, and the idle stretches by
    the span the host was in (summed per span)."""
    by_name = {}
    for name, _, s, e in events:
        s, e = max(s, lo_ns), min(e, hi_ns)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    idle = {}
    starts = sorted(span_set.records, key=lambda r: r[1]) if span_set else []
    keys = [r[1] for r in starts]
    for g0, g1 in stats.gaps([(s, e) for _, _, s, e in events], lo_ns,
                             hi_ns):
        mid = (g0 + g1) // 2
        label = "outside spans"
        j = bisect.bisect_right(keys, mid) - 1
        for back in range(j, max(j - 16, -1), -1):
            if starts[back][2] > mid:
                label = starts[back][0]
                break
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e9
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}


if __name__ == "__main__":
    sys.exit(main())
