"""BENCHMARK.json and the files it names: the names, units and keys its
format allows, every cell's files found by name, a run without a card
failing, and no module of the benchmark importing JAX or the JAX
package."""

import ast
import json
import re
from pathlib import Path

import pytest

from lmibench import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in \
        text and "\t" not in text


def test_top_level_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lmibench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("lmibench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    cells_ = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells_)) == len(cells_)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and line(w["why"])
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in
                                                      BENCH["workloads"]}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = cells.find(workload)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.reader(m["name"]))
    for m in BENCH["per_layer"]:
        for listed in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in
                                  cells.find(listed).end_to_end}
    config = cell.config
    assert config["name"] == next(w["config"] for w in BENCH["workloads"]
                                  if w["name"] == workload)
    assert config["reduced"] == next(
        c["reduced"] for c in BENCH["configs"]
        if c["name"] == config["name"])
    assert cell.traffic["kind"] in ("closed", "open")
    if cell.traffic["kind"] == "open":
        assert cell.rate > 0
    assert cells.kernel_patterns("probe")
    assert set(cells.peaks()) >= {"bf16_flops_per_s", "int8_ops_per_s",
                                  "hbm_bytes_per_s"}


def test_every_file_is_named_from_name_characters():
    for path in (ROOT / "lmibench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _top_level_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


FORBIDDEN = {"jax", "jaxlib", "flax", "tpulmi"}


def test_no_module_imports_jax_or_the_jax_package():
    seen = set()
    for path in (ROOT / "lmibench").rglob("*.py"):
        names = set(_top_level_imports(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        seen |= names
    # the port's name begins with the JAX package's: compared whole, it is
    # not the JAX package
    assert "tpulmi_torch" in seen


def test_the_import_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import tpulmi_torch.index\nfrom tpulmi.index import x\n"
                 "import jaxlib\n")
    names = set(_top_level_imports(p))
    assert names & FORBIDDEN == {"tpulmi", "jaxlib"}


def test_a_run_without_a_card_fails_and_prints_no_result(monkeypatch,
                                                          capsys):
    import torch

    from lmibench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed",
                   "3000000019", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "no CUDA device" in out.err


def test_the_run_names_jax_if_it_was_loaded(monkeypatch):
    import sys
    import types

    from lmibench import run

    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "tpulmi_torch_extra",
                        types.ModuleType("y"))
    assert run.forbidden_modules() == ["jax"]
