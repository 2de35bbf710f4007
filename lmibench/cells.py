"""Finding a cell's files by name.

`BENCHMARK.json` (at the checkout's root) names metrics, configurations,
mixes and cells; everything that belongs to one of them sits in a file of
its own under `lmibench/`, found by that name:

- configuration ``c``: ``configs/<c>.json`` (the path `BENCHMARK.json`
  gives);
- traffic mix ``t``: ``traffic/<t>.json``, and for an open loop the
  cell's rate in ``traffic/rates/<workload>.json``;
- metric ``m``: its reader ``metrics/<m>.py`` (a ``read(ctx)`` function);
- spans: every ``spans/*.json``; kernel families: every
  ``kernels/*.json``; peaks: ``peaks.json``.
"""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from lmibench.traffic import check_mix

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    rate: float            # requests a second (open loops), else None
    end_to_end: list       # metric entries this cell reports
    per_layer: list


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether `cell` reports `metric`: listed in its ``workloads``, or,
    without that key, in every cell that reports what it moves (an
    end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def find(workload: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         + ", ".join(w["name"] for w in bench["workloads"]))
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root / conf["file"])
    traffic = check_mix(load_json(HERE / "traffic"
                                  / f"{entry['traffic']}.json"),
                        entry["traffic"])
    rate = None
    if traffic["kind"] == "open":
        rate = float(load_json(HERE / "traffic" / "rates"
                               / f"{workload}.json")["rate_per_s"])
    e2e = [m for m in bench["end_to_end"] if reports(m, workload, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, workload, names)]
    return Cell(workload, entry["chips"], config, traffic, rate, e2e,
                per_layer)


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"lmibench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def spans() -> dict:
    return {p.stem: load_json(p) for p in sorted((HERE / "spans").glob(
        "*.json"))}


def kernel_patterns(family: str) -> list:
    out = []
    for p in sorted((HERE / "kernels").glob("*.json")):
        spec = load_json(p)
        if spec["family"] == family:
            out += spec["patterns"]
    return out


def peaks() -> dict:
    return load_json(HERE / "peaks.json")
