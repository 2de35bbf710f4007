"""The benchmark's own tests: ``pytest lmibench/tests``. Tests that need
the card carry the ``cuda`` marker and decide in a fixture, never while a
module is imported, whether to skip."""

import functools
import json

import pytest

from lmibench import cells

HIER_WORKLOAD = "hier-test.batch10k"


def hier_config() -> dict:
    """A configuration with a ``hierarchy`` section, for the tests only:
    laion10m-int8's (int8 host store, int8 queries, the float16 rerank,
    its control and limits) with its routers made the inner routers of 8
    groups of 61 buckets, 12 probes and rerank depth 10; at the smoke
    sizes 2 groups of 12 buckets and 4 probes."""
    config = cells.load_json(cells.HERE / "configs" / "laion10m-int8.json")
    config["name"] = "hier-test"
    config["index"]["n_categories"] = 61
    config["hierarchy"] = {
        "n_groups": 8, "outer_epochs": 6, "outer_lr": 0.003,
        "outer_model_type": "MLP-5", "seed": 2023, "calibrate_budget": 24,
        "router_restarts": 1}
    config["search"].update(n_buckets=12, rerank_extra=10)
    config["smoke"]["hierarchy"] = {"n_groups": 2, "outer_epochs": 2,
                                    "calibrate_budget": 4}
    config["smoke"]["search"] = {"n_buckets": 4}
    return config


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false here)")
    return torch.device("cuda")


@pytest.fixture
def hier_cell(tmp_path, monkeypatch):
    """The cell `HIER_WORKLOAD` of `hier_config` under the batch10k mix,
    found by `cells.find` through a `BENCHMARK.json` of its own (the real
    one's metrics, each listing the cell where it lists laion10m-int8's),
    so that `run.main` runs it. Returns the workload's name."""
    bench = cells.load_json(cells.ROOT / "BENCHMARK.json")
    (tmp_path / "hier-test.json").write_text(json.dumps(hier_config()))
    bench["configs"] = [{"name": "hier-test", "file": "hier-test.json"}]
    bench["workloads"] = [{"name": HIER_WORKLOAD, "config": "hier-test",
                           "traffic": "batch10k", "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "laion10m-int8.batch10k" in m.get("workloads", ()):
            m["workloads"] = [HIER_WORKLOAD]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(cells, "find",
                        functools.partial(cells.find, root=tmp_path))
    return HIER_WORKLOAD
