"""What the host gave a run, logged beside its result so that runs that
land apart can be told apart: the CPUs and NUMA nodes the process may use,
the card's NUMA node, where the process's pages lie, the CPU time and the
steal time over the window, and three short probes taken after it (one
core's speed, a host copy and a pageable copy to the card). Nothing here
is timed inside the window, and nothing here decides a metric."""

import os
import resource
import time
from pathlib import Path

import numpy as np
import torch

NODES = Path("/sys/devices/system/node")


def _read(path, default="?") -> str:
    try:
        return Path(path).read_text().strip()
    except OSError:
        return default


def numa_cpus() -> dict:
    """NUMA node -> its CPU list, as the kernel gives it."""
    return {p.name[4:]: _read(p / "cpulist")
            for p in sorted(NODES.glob("node[0-9]*"))}


def card_node(device) -> str:
    """The NUMA node of the card's PCI device ("?" where unknown)."""
    try:
        props = torch.cuda.get_device_properties(device)
        bus = (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
               f"{props.pci_device_id:02x}.0")
    except Exception:           # a logged fact must never stop a run
        return "?"
    return _read(f"/sys/bus/pci/devices/{bus}/numa_node")


def pages_by_node() -> dict:
    """The process's resident pages per NUMA node (/proc/self/numa_maps)."""
    out = {}
    try:
        with open("/proc/self/numa_maps") as f:
            for line in f:
                for word in line.split()[2:]:
                    if word[0] == "N" and "=" in word:
                        node, n = word[1:].split("=")
                        out[node] = out.get(node, 0) + int(n)
    except (OSError, ValueError):
        pass
    return out


class Usage:
    """The system's CPU ticks and the process's own use at one moment."""

    def __init__(self):
        self.wall = time.perf_counter()
        self.ru = resource.getrusage(resource.RUSAGE_SELF)
        try:
            with open("/proc/stat") as f:
                self.cpu = [int(x) for x in f.readline().split()[1:]]
        except (OSError, ValueError):
            self.cpu = []

    def since(self, before: "Usage") -> str:
        wall = self.wall - before.wall
        ru, r0 = self.ru, before.ru
        cpu_s = (ru.ru_utime - r0.ru_utime) + (ru.ru_stime - r0.ru_stime)
        text = (f"process CPU {cpu_s / wall:.3f} cores over "
                f"{wall:.3f}s; switches voluntary "
                f"{ru.ru_nvcsw - r0.ru_nvcsw}, involuntary "
                f"{ru.ru_nivcsw - r0.ru_nivcsw}; minor faults "
                f"{ru.ru_minflt - r0.ru_minflt}")
        if len(self.cpu) >= 8 and len(before.cpu) == len(self.cpu):
            d = [a - b for a, b in zip(self.cpu, before.cpu)]
            total = sum(d[:8]) or 1
            text += (f"; host busy {1 - (d[3] + d[4]) / total:.3f}, steal "
                     f"{d[7] / total:.4f}")
        return text


def facts(device) -> str:
    thp = _read("/sys/kernel/mm/transparent_hugepage/enabled")
    allowed = sorted(os.sched_getaffinity(0))
    return (f"CPUs allowed {len(allowed)} ({allowed[0]}-{allowed[-1]}); "
            f"NUMA nodes {numa_cpus()}; card on node {card_node(device)}; "
            f"THP {thp}; load {_read('/proc/loadavg')}")


def probes(device, query_bytes: int) -> str:
    """Three short probes after the window: one core's speed at a fixed
    Python loop, a 512 MiB host copy into touched pages, and a pageable
    copy to the card of one request's query bytes."""
    t = time.perf_counter()
    sum(range(10**7))
    loop_ms = (time.perf_counter() - t) * 1e3
    a = np.ones(2**27, np.float32)
    b = np.empty_like(a)
    b.fill(0)
    t = time.perf_counter()
    np.copyto(b, a)
    host = a.nbytes / (time.perf_counter() - t) / 1e9
    text = f"loop of 1e7 {loop_ms:.1f} ms; host copy {host:.2f} GB/s"
    if device.type == "cuda":
        src = torch.ones(max(1, query_bytes // 4), dtype=torch.float32)
        dst = torch.empty_like(src, device=device)
        dst.copy_(src)
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        for _ in range(5):
            dst.copy_(src)
        torch.cuda.synchronize(device)
        h2d = 5 * src.numel() * 4 / (time.perf_counter() - t) / 1e9
        text += f"; pageable copy to the card {h2d:.2f} GB/s"
        del src, dst
    del a, b
    return text
