"""Device and timing helpers.

- `resolve_device(device)`: the device to run on; a CUDA device must exist.
- `sync(device)`: waits for the card's queued work (a no-op on the CPU).
- `phase_timer`: context manager timing a phase with a sync at exit.
- `trace(log_dir)`: a `torch.profiler` region written as a Chrome trace.
- `probe_work_model`: the FLOPs and bytes of the probe phase.
- `timeit`: best-of-N wall time with warmup and syncs.
"""

import time
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
