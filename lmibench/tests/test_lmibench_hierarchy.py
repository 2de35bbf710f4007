"""A configuration with a ``hierarchy`` section builds `HierarchicalIndex`
and runs through the whole harness: its store has G*C buckets, the work
model's routing is the program's, its layout and build stages read, and a
smoke run is correct while its control is not. A configuration without the
section builds exactly the `LearnedIndex` it always did."""

import json

import numpy as np
import pytest

from lmibench import cells, datagen, run
from lmibench.system import System, with_control
from lmibench.tests.conftest import hier_config
from tpulmi_torch import search as program_search
from tpulmi_torch.hierarchical import HierarchicalConfig, HierarchicalIndex
from tpulmi_torch.index import LearnedIndex
from tpulmi_torch.utils.config import IndexConfig

SEED = 3000000013
BENCH = cells.load_json(cells.ROOT / "BENCHMARK.json")


@pytest.fixture(scope="module")
def built():
    """The test configuration at its smoke sizes, built once on the CPU,
    with its query pool. Returns (config, system, queries_nav,
    queries_search)."""
    config = run.shrink(hier_config())
    corpus = datagen.Corpus(datagen.Spec.of(config), SEED, "cpu")
    queries = corpus.queries()
    search_rows, nav_rows = datagen.host_arrays(
        corpus, config["data"]["search_dtype"], config["data"]["nav_dtype"])
    system = System(config, "cpu")
    system.build(search_rows, nav_rows)
    yield (config, system, *queries)
    system.close()


def test_smoke_overrides_and_control_switches_reach_the_hierarchy():
    full = hier_config()
    small = run.shrink(full)
    assert small["hierarchy"] == {**full["hierarchy"], "n_groups": 2,
                                  "outer_epochs": 2, "calibrate_budget": 4}
    assert small["search"]["n_buckets"] == 4
    assert small["search"]["rerank_extra"] == 10
    full["control"]["switch"]["hierarchy"] = {"router_restarts": 2}
    switched = with_control(full)
    assert switched["hierarchy"] == {**full["hierarchy"],
                                     "router_restarts": 2}
    assert switched["search"]["rerank"] is False


def test_the_system_builds_a_hierarchical_index_of_g_times_c_buckets(built):
    config, system, _, _ = built
    index = system.index
    assert type(index) is HierarchicalIndex
    assert index.hconfig == HierarchicalConfig(
        inner=IndexConfig(**config["index"]), **config["hierarchy"])
    assert index.hconfig.n_groups == 2
    n_buckets = 2 * config["index"]["n_categories"]
    assert index.built.store.n_categories == n_buckets == 24
    assert index.built.classifier.model.n_groups == 2


def test_route_is_the_programs_top_p_of_the_joint_logits(built,
                                                         monkeypatch):
    config, system, q_nav, q_search = built
    taken = []
    route_probes = program_search.route_probes

    def recording(logits, n_buckets, **kw):
        out = route_probes(logits, n_buckets, **kw)
        taken.append((logits.shape, out.cpu().numpy()))
        return out

    monkeypatch.setattr(program_search, "route_probes", recording)
    system.search(q_nav, q_search)
    assert len(taken) == 1
    (shape, program_probes), = taken
    n_buckets = 2 * config["index"]["n_categories"]
    assert tuple(shape) == (len(q_nav), n_buckets)
    probes = system.route(q_nav)
    assert probes.shape == (len(q_nav), config["search"]["n_buckets"])
    assert probes.min() >= 0 and probes.max() < n_buckets
    np.testing.assert_array_equal(probes, program_probes)


def test_layout_and_build_stages_count_every_bucket(built):
    config, system, _, _ = built
    layout = system.layout()
    assert len(layout.rows) == 2 * config["index"]["n_categories"]
    assert int(layout.rows.sum()) == config["rows"]
    assert layout.list_k == config["k"] + 10
    assert "nav" in system.build_stages()


@pytest.mark.parametrize("bad", [{"n_group": 2}, {"inner": {}}])
def test_an_unknown_hierarchy_key_raises(bad):
    config = run.shrink(hier_config())
    config["hierarchy"] = {**config["hierarchy"], **bad}
    with pytest.raises(TypeError):
        System(config, "cpu")


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
@pytest.mark.parametrize("smoke", [False, True])
def test_a_configuration_without_a_hierarchy_builds_a_learned_index(name,
                                                                    smoke):
    config = cells.load_json(
        cells.ROOT / next(c["file"] for c in BENCH["configs"]
                          if c["name"] == name))
    assert "hierarchy" not in config
    if smoke:
        config = run.shrink(config)
    system = System(config, "cpu")
    assert type(system.index) is LearnedIndex
    assert system.index.config == IndexConfig(**config["index"])


def smoke(capsys, workload, *extra, trace="0"):
    rc = run.main(["--workload", workload, "--seed", str(SEED),
                   "--seconds", "0.5", "--trace", trace, "--smoke", *extra],
                  device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_smoke_run_is_correct_and_its_control_is_not(capsys, hier_cell):
    sound = smoke(capsys, hier_cell, trace="1")
    assert sound["correct"] is True
    assert sound["failed"] == 0 and sound["attempted"] > 0
    assert sound["check"]["recall_at_10"]["value"] >= 0.9
    control = smoke(capsys, hier_cell, "--control")
    assert control["correct"] is False
    gap = control["check"]["dist_rms_gap"]
    assert gap["value"] > gap["max"]
