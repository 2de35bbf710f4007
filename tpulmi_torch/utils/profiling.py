"""Device and timing helpers.

- `resolve_device(device)`: the device to run on; a CUDA device must exist.
- `sync(device)`: waits for the card's queued work (a no-op on the CPU).
- `phase_timer`: context manager timing a phase with a sync at exit.
- `trace(log_dir)`: a `torch.profiler` region written as a Chrome trace.
- `probe_work_model`: the FLOPs and bytes of the probe phase.
- `timeit`: best-of-N wall time with warmup and syncs.
- `span(name)`, `count(name, n)`: the program's own spans and counters
  (below); `records()`, `counters()`, `reset()` read and clear them.

Spans record only while a torch profiler records (``trace`` above, or any
``torch.profiler.profile``): each opens ``record_function(
"tpulmi_torch.<name>")`` and keeps ``(name, request_id, parent,
thread_id, start_ns, end_ns)`` on the host wall clock (`time.time_ns`),
the clock to which a trace's device events convert. ``parent`` is the
name of the enclosing span on the same thread (None at a root);
``request_id`` is the id of the root span's request, carried to another
thread by `bind` (a worker thread's spans record for a traced request
even where the profiler does not see that thread). The newest
`RECORDS_MAX` records are kept; the counter ``span_records_dropped``
counts the rest. With no profiler, `span` returns one shared no-op
context and records nothing.

Counters count always, from values the host already holds (never a read
from the card). While tracing, each increment is also stamped with its
time, so that ``counters(lo_ns, hi_ns)`` gives a window's growth.
"""

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable

import torch

from tpulmi_torch.utils.logging import get_logger

log = get_logger("tpulmi_torch.profiling")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device on a machine without one
    raises (nothing moves to the CPU unless asked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return device


def sync(device=None) -> None:
    """Wait for all queued work on `device` (default: the current CUDA
    device, when there is one)."""
    device = torch.device(device) if device is not None else None
    if device is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    elif device.type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def phase_timer(phase: str, result_holder: dict = None, device=None):
    """Time a phase, synchronizing `device` before the clock stops."""
    start = time.perf_counter()
    yield
    sync(device)
    elapsed = time.perf_counter() - start
    log.info("%s: %.3fs", phase, elapsed)
    if result_holder is not None:
        result_holder[phase] = elapsed


@contextmanager
def trace(log_dir: str = "tpulmi_torch_trace", device=None):
    """Profile the region (host, and the card's kernels when `device` is a
    CUDA device or, by default, when a card is present) and write it as a
    Chrome trace (``chrome://tracing``, Perfetto) under `log_dir`; the
    path is logged. Usage: ``with trace("t"): index.search(...)``."""
    import os

    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        sync(device)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_"
                        f"{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def probe_work_model(slot_counts, bucket_counts, d: int, qc: int, mc: int,
                     elem_bytes: int):
    """FLOPs and device-memory bytes of a blocked probe scan: per bucket,
    ceil(slots/qc) query blocks each scan the bucket's mc-padded rows (so a
    bucket is counted once per query block that reads it)."""
    import numpy as np

    qblocks = np.ceil(np.asarray(slot_counts, np.float64) / qc)
    rows_pad = np.ceil(np.asarray(bucket_counts, np.float64) / mc) * mc
    flops = float(np.sum(qblocks * qc * rows_pad) * d * 2)
    bytes_hbm = float(np.sum(qblocks * rows_pad) * d * elem_bytes)
    return flops, bytes_hbm


def timeit(fn: Callable, *args, repeats: int = 3, warmup: int = 1,
           device=None, **kwargs):
    """Best-of-N wall time of `fn(*args)` with syncs; returns
    (best_seconds, last_result)."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        sync(device)
    best = float("inf")
    for _ in range(repeats):
        start = time.perf_counter()
        result = fn(*args, **kwargs)
        sync(device)
        best = min(best, time.perf_counter() - start)
    return best, result


# ------------------------------------------------------ spans and counters
RECORDS_MAX = 1 << 20
SPAN_PREFIX = "tpulmi_torch."
_records = deque(maxlen=RECORDS_MAX)  # (name, request, parent, thread, s, e)
_stamps = deque(maxlen=RECORDS_MAX)   # (counter, t_ns, n), while tracing
_counts = {}
_lock = threading.Lock()


class _Local(threading.local):
    """A thread's open spans (their names) and its request id."""
    request = None

    def __init__(self):
        self.stack = []


_local = _Local()
_request_ids = itertools.count(1)
_profiling = torch.autograd._profiler_enabled


def tracing() -> bool:
    """Whether spans record on this thread: a torch profiler records here,
    or the thread runs a job of a traced request (`bind`)."""
    return _profiling() or _local.request is not None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "parent", "request", "root", "fn", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.stack
        self.parent = stack[-1] if stack else None
        request = _local.request
        self.root = request is None
        if request is None:
            request = _local.request = next(_request_ids)
        self.request = request
        stack.append(self.name)
        self.start = time.time_ns()
        self.fn = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        self.fn.__exit__(*exc)
        end = time.time_ns()
        _local.stack.pop()
        if self.root:
            _local.request = None
        _keep((self.name, self.request, self.parent, threading.get_ident(),
               self.start, end))
        return False


def _keep(record) -> None:
    if len(_records) == RECORDS_MAX:
        count("span_records_dropped")
    _records.append(record)


def span(name: str):
    """A span of the program named `name` (recorded as
    ``tpulmi_torch.<name>``) while tracing; else the shared no-op."""
    return _Span(name) if tracing() else _NO_SPAN


class _Request:
    __slots__ = ("request", "saved")

    def __init__(self, request: int):
        self.request = request

    def __enter__(self):
        self.saved = _local.request
        _local.request = self.request
        return self.request

    def __exit__(self, *exc):
        _local.request = self.saved
        return False


def new_request():
    """A fresh request id while tracing, else None: for a request that no
    root span opens (a `search_stream` batch)."""
    return next(_request_ids) if tracing() else None


def request(request_id):
    """The block's spans belong to `request_id` (None: a no-op)."""
    return _NO_SPAN if request_id is None else _Request(request_id)


def bind(request_id, fn: Callable) -> Callable:
    """`fn` run under `request(request_id)`, for another thread; `fn`
    itself when `request_id` is None."""
    if request_id is None:
        return fn

    def bound(*args, **kwargs):
        with _Request(request_id):
            return fn(*args, **kwargs)
    return bound


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`; stamped with the time while
    tracing."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n
    if tracing():
        _stamps.append((name, time.time_ns(), n))


def records() -> list:
    """The kept span records, oldest first."""
    return list(_records)


def counters(lo_ns: int = None, hi_ns: int = None) -> dict:
    """Every counter's total; with a window [lo_ns, hi_ns), the growth
    from increments stamped inside it (made while tracing)."""
    if lo_ns is None and hi_ns is None:
        with _lock:
            return dict(_counts)
    lo = -1 if lo_ns is None else lo_ns
    hi = float("inf") if hi_ns is None else hi_ns
    out = {}
    for name, t, n in list(_stamps):
        if lo <= t < hi:
            out[name] = out.get(name, 0) + n
    return out


def reset(prefix: str = None) -> None:
    """Clear the records, the stamps and every counter; with `prefix`,
    only the counters whose names begin with it."""
    with _lock:
        if prefix is None:
            _records.clear()
            _stamps.clear()
            _counts.clear()
        for name in [n for n in _counts if n.startswith(prefix or "")]:
            del _counts[name]


def self_ns(recs) -> list:
    """Each record's self time: its length less the part of it that its
    children (the spans of its thread opened inside it) cover. Spans of
    one thread nest, so a sweep in order of start keeps the open ones."""
    out = [r[5] - r[4] for r in recs]
    order = sorted(range(len(recs)),
                   key=lambda i: (recs[i][3], recs[i][4], -recs[i][5]))
    stack = []
    for i in order:
        _, _, _, thread, start, end = recs[i]
        while stack and (recs[stack[-1]][3] != thread
                         or recs[stack[-1]][5] <= start):
            stack.pop()
        if stack and end <= recs[stack[-1]][5]:
            out[stack[-1]] -= end - start
        stack.append(i)
    return out
