"""Spans and the device trace, for ``--trace 1`` runs only.

A span is a data file (`lmibench/spans/<name>.json`: ``target``, a dotted
``module:Class.method``, and ``layer``). `Spans` wraps each target with a
host-clock span and a `torch.profiler.record_function` of the same name; a
target that no longer exists is reported and left out, and whatever
metric reads it reads nothing. `device_trace` runs a callable under
`torch.profiler` and returns every device activity (kernels, copies,
sets) as intervals on the host's wall clock, the clock the spans use.
"""

import functools
import importlib
import sys
import time

import torch


class Spans:
    def __init__(self, specs: dict):
        self.specs = specs                  # name -> {"target", "layer"}
        self.records = []                   # (name, start_ns, end_ns)
        self.missing = []
        self._saved = []

    def install(self) -> None:
        for name, spec in self.specs.items():
            mod_name, _, attr_path = spec["target"].partition(":")
            try:
                owner = importlib.import_module(mod_name)
                *parents, attr = attr_path.split(".")
                for part in parents:
                    owner = getattr(owner, part)
                original = getattr(owner, attr)
            except (ImportError, AttributeError):
                self.missing.append(name)
                continue
            setattr(owner, attr, self._wrap(name, original))
            self._saved.append((owner, attr, original))
        if self.missing:
            print(f"[lmibench] span targets not found, their metrics read "
                  f"nothing: {', '.join(self.missing)}", file=sys.stderr)

    def _wrap(self, name, original):
        records = self.records
        label = f"lmibench.{name}"

        @functools.wraps(original)
        def spanned(*args, **kwargs):
            start = time.time_ns()
            try:
                with torch.profiler.record_function(label):
                    return original(*args, **kwargs)
            finally:
                records.append((name, start, time.time_ns()))
        return spanned

    def uninstall(self) -> None:
        for owner, attr, original in reversed(self._saved):
            setattr(owner, attr, original)
        self._saved = []

    def total_s(self, name: str, lo_ns: int, hi_ns: int) -> float:
        """Seconds of `name`'s spans inside [lo, hi), outer calls only (a
        span inside another of the same name counts once)."""
        from lmibench.stats import union_length

        return union_length([(s, e) for n, s, e in self.records
                             if n == name], lo_ns, hi_ns) / 1e9


_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_trace(fn):
    """Run `fn()` under the profiler. Returns (its result, device intervals
    as (name, kind, start_ns, end_ns))."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        kind = _kind(e)
        if kind is None:
            continue
        start = e.start_ns()
        events.append((e.name(), kind, start, start + e.duration_ns()))
    return out, events


def _kind(event):
    """kernel, gpu_memcpy or gpu_memset; None for anything else that the
    profiler puts on the device's row (user annotations)."""
    activity = getattr(event, "activity_type", None)
    if activity is not None:
        kind = str(activity())
        return kind if kind in _DEVICE_KINDS else None
    name = event.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return None if event.is_user_annotation() else "kernel"
