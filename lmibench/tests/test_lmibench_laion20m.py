"""The 20M two-level cell, `laion20m-hier-int8.batch10k`, on the CPU: its
configuration found by name with a hierarchy the program takes, a smoke
run correct, the hold against `hier_reference.py` met by the program and
failed by its control, and the readers of the hierarchy's stages and span
on planted values (nothing where the program has none)."""

import json
from types import SimpleNamespace

import pytest

from lmibench import cells, hier_hold, run
from lmibench.system import System
from tpulmi_torch.hierarchical import HierarchicalConfig, HierarchicalIndex
from tpulmi_torch.utils import profiling
from tpulmi_torch.utils.config import IndexConfig

CELL = "laion20m-hier-int8.batch10k"
SEED = 3000000031
WINDOW = (1_000, 11_000)          # 10 us
STAGES = {"build_outer_s": "outer", "build_inner_s": "inner",
          "build_calibrate_s": "calibrate"}
SPANNED = ("route_joint_pct.batch",)


def test_the_configuration_is_found_and_its_hierarchy_taken():
    cell = cells.find(CELL)
    config = cell.config
    assert cell.chips == 1 and cell.traffic["kind"] == "closed"
    assert (config["rows"], config["d_search"], config["d_nav"]) == (
        20_000_000, 768, 96)
    assert config["reduced"] == []
    hier = config["hierarchy"]
    assert hier["n_groups"] * config["index"]["n_categories"] == 488
    assert (config["search"]["n_buckets"], hier["calibrate_budget"]) == (
        32, 24)
    assert "n_buckets" in config["assumed"]
    HierarchicalConfig(inner=IndexConfig(**config["index"]), **hier)
    system = System(run.shrink(config), "cpu")
    assert type(system.index) is HierarchicalIndex
    assert system.index.hconfig.n_groups == 2
    names = {m["name"] for m in cell.per_layer}
    assert set(STAGES) | set(SPANNED) <= names
    assert {"qps", "recall_at_10", "setup_s"} == {
        m["name"] for m in cell.end_to_end}


def test_a_smoke_run_of_the_cell_is_correct(capsys):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "0.5", "--trace", "1", "--smoke"], device="cpu")
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] > 0
    for metric in STAGES:
        assert out["metrics"][metric]["value"] > 0


@pytest.mark.parametrize("control", [False, True])
def test_the_hold_is_met_and_its_control_fails(capsys, control):
    argv = ["--workload", CELL, "--seed", str(SEED), "--queries", "300",
            "--smoke"] + (["--control"] if control else [])
    assert hier_hold.main(argv, device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["queries"] == 300 and out["probes"] == 4
    assert out["routed_differ_untied"] == 0
    assert out["held"] is not control
    assert (out["dist_rms_gap"] > out["dist_tol"]) is control
    # beside the hold: the gaps to the exact cosine of the returned rows
    assert out["exact_widest_gap"] >= out["exact_rms_gap"] > 0


def rec(name, start, end):
    return (name, 1, "program.route", 1, start, end)


@pytest.fixture
def program(monkeypatch):
    """Stand-in records and window counters for the program's registry."""
    state = SimpleNamespace(records=[], grown={})

    def counters(lo_ns=None, hi_ns=None):
        assert (lo_ns, hi_ns) == WINDOW
        return dict(state.grown)

    monkeypatch.setattr(profiling, "records", lambda: list(state.records))
    monkeypatch.setattr(profiling, "counters", counters)
    return state


def ctx(stages=None):
    return SimpleNamespace(window_ns=WINDOW, events=[],
                           build_stages=stages or {})


@pytest.mark.parametrize("metric", list(STAGES))
def test_a_build_stage_reads_the_programs_seconds(metric):
    read = cells.reader(metric)
    stages = {"nav": 9.0, "outer": 3.0, "inner": 4.5, "calibrate": 0.75}
    assert read(ctx(stages)) == stages[STAGES[metric]]
    # a flat build, or the program before the stages: nothing to read
    assert read(ctx({"nav": 9.0})) is None


def test_the_joint_router_share(program):
    program.records = [rec("route.joint", 2_000, 3_000),
                       rec("route.joint", 6_000, 7_000),
                       rec("route.joint", 10_500, 12_000),
                       rec("program.route", 2_000, 4_000)]
    # 2.5 us of the 10 inside the spans (the last one mostly past the
    # window)
    assert cells.reader("route_joint_pct.batch")(ctx()) == pytest.approx(
        25.0)


@pytest.mark.parametrize("metric", SPANNED)
def test_no_joint_router_reads_nothing(program, metric):
    # a flat index's search: its spans, none of the router's
    program.records = [rec("program.route", 2_000, 3_000)]
    program.grown = {"slots": 100}
    assert cells.reader(metric)(ctx()) is None


@pytest.mark.parametrize("metric", SPANNED)
def test_a_program_without_the_registry_reads_nothing(monkeypatch, metric):
    monkeypatch.delattr(profiling, "records")
    assert cells.reader(metric)(ctx()) is None
