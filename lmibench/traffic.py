"""The one general traffic generator and its two loops, driven by a mix's
data file (`lmibench/traffic/<name>.json`).

- ``"kind": "closed"``: one client sends the next request as soon as the
  last one returns. Each request is the whole query pool in an order of its
  own (a ring of ``ring`` orders drawn from the seed), so that no request
  repeats the one before it.
- ``"kind": "open"``: requests are due on a fixed schedule, whatever the
  server does. The rate is the cell's (`traffic/rates/<workload>.json`).
  ``round(rate * seconds)`` requests are due in the window; their gaps and
  sizes are one fixed set for every seed (drawn from `PROFILE_SEED`), in
  an order the seed draws, and the gaps are scaled to fill the window
  exactly. One server thread answers them in order of due time. Latency
  runs from the due time to the answer on the host, so a stall delays
  every request behind it.

Each request is an array of indices into the query pool. A mix file holds
the keys of its kind (`KEYS`) and no others, so that a setting the loops do
not read is refused rather than ignored.
"""

import time
from dataclasses import dataclass, field
from typing import Callable, List

import numpy as np

from lmibench.datagen import PROFILE_SEED, mix_seed

_TRAFFIC_STREAM = 3
KEYS = {"closed": {"kind", "ring", "why"},
        "open": {"kind", "size", "drain_s", "why"}}
SIZE_KEYS = {"dist", "mean", "min", "max"}


@dataclass
class Request:
    due: float             # seconds after the window opens
    queries: np.ndarray    # indices into the pool


@dataclass
class Served:
    """What a loop saw: per request its start and end (seconds after the
    window opened; NaN: never answered) and its result."""
    requests: List[Request]
    start: np.ndarray
    end: np.ndarray
    results: list = field(default_factory=list)
    window_s: float = 0.0
    lateness: np.ndarray = None   # open loop: start - due, when idle


def check_mix(spec: dict, name: str = "") -> dict:
    """`spec` as it is, or ValueError where it holds a kind or a key the
    loops do not implement."""
    kind = spec.get("kind")
    if kind not in KEYS:
        raise ValueError(f"traffic {name}: unknown kind {kind!r}")
    extra = set(spec) ^ KEYS[kind]
    if kind == "open":
        size = spec.get("size", {})
        extra |= set(size) ^ SIZE_KEYS
        if size.get("dist") != "geometric":
            extra.add(f"dist={size.get('dist')!r}")
    if extra:
        raise ValueError(f"traffic {name}: keys missing or not read: "
                         f"{sorted(extra)}")
    return spec


def open_schedule(spec: dict, rate: float, seconds: float, pool: int,
                  seed: int) -> List[Request]:
    n = max(1, int(round(rate * seconds)))
    fixed = np.random.default_rng(PROFILE_SEED)
    gaps = fixed.exponential(1.0, n)
    size = check_mix(spec)["size"]
    sizes = np.clip(fixed.geometric(1.0 / size["mean"], n), size["min"],
                    size["max"])
    rng = np.random.default_rng(mix_seed(seed, _TRAFFIC_STREAM))
    gaps, sizes = gaps[rng.permutation(n)], sizes[rng.permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    due *= seconds / gaps.sum()
    return [Request(float(t), rng.integers(0, pool, int(s)))
            for t, s in zip(due, sizes)]


def closed_ring(spec: dict, pool: int, seed: int) -> List[np.ndarray]:
    rng = np.random.default_rng(mix_seed(seed, _TRAFFIC_STREAM))
    return [rng.permutation(pool) for _ in range(spec["ring"])]


def warmup_sizes(spec: dict, pool: int) -> List[int]:
    """The request sizes a mix sends, for the warm-up."""
    if spec["kind"] == "closed":
        return [pool]
    return list(range(spec["size"]["min"], spec["size"]["max"] + 1))


def run_closed(serve: Callable, ring: List[np.ndarray], seconds: float,
               clock=time.perf_counter, keep: Callable = None) -> Served:
    """Send ring orders one after another until `seconds` have passed:
    ``serve(slot)`` answers ``ring[slot]``. The window ends when the last
    request sent inside it has been answered. ``keep(i, request, result)``
    returns what to hold of each result."""
    reqs, start, end, kept = [], [], [], []
    t0 = clock()
    i = 0
    while clock() - t0 < seconds:
        idx = ring[i % len(ring)]
        s = clock() - t0
        out = serve(i % len(ring))
        e = clock() - t0
        reqs.append(Request(s, idx))
        start.append(s)
        end.append(e)
        kept.append(keep(i, idx, out) if keep else out)
        i += 1
    return Served(reqs, np.array(start), np.array(end), kept,
                  window_s=end[-1] if end else clock() - t0)


def run_open(serve: Callable, requests: List[Request], seconds: float,
             drain_s: float, clock=time.perf_counter,
             sleep=time.sleep) -> Served:
    """Answer `requests` in order of due time; a request still unstarted
    `drain_s` after the window closes is never answered (NaN)."""
    n = len(requests)
    start, end = np.full(n, np.nan), np.full(n, np.nan)
    lateness, results = [], [None] * n
    t0 = clock()
    for i, r in enumerate(requests):
        now = clock() - t0
        if now > seconds + drain_s:
            break
        if now < r.due:
            wait = r.due - now
            if wait > 0.002:
                sleep(wait - 0.001)
            while clock() - t0 < r.due:
                pass
            now = clock() - t0
            lateness.append(now - r.due)
        start[i] = now
        results[i] = serve(r.queries)
        end[i] = clock() - t0
    return Served(requests, start, end, results, window_s=float(seconds),
                  lateness=np.array(lateness))
