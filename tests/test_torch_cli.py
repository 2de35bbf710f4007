"""tpulmi_torch.cli against tpulmi.cli: the flag surface (both parsers give
the same arguments for the same command line), the plan each `run` makes
(configs, probe budgets, quantization, calibration, bounds, shards, saves
and every SearchConfig field, recorded by a stand-in index in each
package's CLI), the baseline path's ids, and the port's CLI end to end on
the CPU over synthetic data and over local SISAP-layout h5 files."""

import dataclasses
import glob
import logging
import os
import re

import h5py
import numpy as np
import pytest
import torch

import tpulmi.cli as jcli
import tpulmi.hierarchical as jhier
import tpulmi_torch.cli as tcli
import tpulmi_torch.hierarchical as thier
from tpulmi.data import store_results as jax_store_results
from tpulmi.utils.config import n_buckets_from_percentage as jax_bp
from tpulmi_torch.baseline import Baseline
from tpulmi_torch.data import load_h5, normalize
from tpulmi_torch.utils.config import n_buckets_from_percentage

torch.set_num_threads(1)


def test_str2bool():
    for v in ("True", "true", "1", "yes", "y", "False", "0", "no", "x"):
        assert tcli._str2bool(v) == jcli._str2bool(v)
    assert tcli._str2bool("True") and not tcli._str2bool("False")


def test_bp_percent_semantics():
    assert n_buckets_from_percentage([4], 122) == [4]
    assert n_buckets_from_percentage([6], 122) == [7]
    assert n_buckets_from_percentage([1], 24) == []
    assert n_buckets_from_percentage([25, 26], 24) == [6]
    for bp in ([1], [1, 2, 3], [4, 50, 4], [25, 26], [0, 100]):
        for n in (8, 24, 122, 488):
            assert n_buckets_from_percentage(bp, n) == jax_bp(bp, n)


ARGVS = [
    [],
    ["--synthetic", "3000", "--n-categories", "8", "--epochs", "2",
     "-bp", "25", "50", "--size", "100K", "--k", "5"],
    ["--dataset", "clip768v2", "--emb", "emb", "--size", "300K",
     "--preprocess", "False", "--save", "yes", "--index-type", "baseline",
     "--data-dir", "d", "--result-dir", "r", "--save-index", "ck"],
    ["--hierarchical-groups", "3", "--store-dtype", "int4", "--shard", "4",
     "--probe-mass", "0.98", "--calibrate", "1", "--prune", "true",
     "--rerank-dtype", "float16", "--pallas-worklist", "true",
     "--pallas-pair", "y", "--fetch-dtype", "bfloat16",
     "--router-restarts", "3", "--pallas-extract", "group2",
     "--model-type", "MLP-3", "--lr", "0.01"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parsers_agree(monkeypatch, argv):
    """`main` hands `run` the same arguments in both packages (the port's
    adds the device)."""
    got = {}
    monkeypatch.setattr(jcli, "run", lambda **kw: got.setdefault("jax", kw))
    monkeypatch.setattr(tcli, "run", lambda **kw: got.setdefault("port", kw))
    jcli.main(argv)
    tcli.main(argv, device="cpu")
    assert got["port"].pop("device") == "cpu"
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("argv", [["--size", "1M"],
                                  ["--store-dtype", "int2"],
                                  ["--index-type", "faiss"]])
def test_parsers_refuse_alike(argv):
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2


def _config(cfg):
    return type(cfg).__name__, dataclasses.asdict(cfg)


def recorder(plan: list):
    """A stand-in for LearnedIndex / HierarchicalIndex in either package
    that records every call the CLI makes on it into `plan`."""

    class Recorder:
        def __init__(self, config, device=None):
            plan.append(("init", _config(config)))

        def build(self, data_nav, data_search=None):
            plan.append(("build", np.shape(data_nav), np.shape(data_search)))
            return np.zeros(len(data_nav), np.int32), 0.25

        def quantize(self, host_corpus=None, normalized=False, bits=8):
            host = np.asarray(host_corpus)
            plan.append(("quantize", bits, host.shape, str(host.dtype),
                         normalized))

        def calibrate_outer_weight(self, data_nav, probe_budget=16):
            plan.append(("calibrate", np.shape(data_nav), probe_budget))
            return {"best": 0.25, "best_containment": 0.9,
                    "baseline_w1": None}

        def compute_bounds(self):
            plan.append(("compute_bounds",))

        def shard(self, mesh=None, n_shards=None):
            plan.append(("shard", mesh, n_shards))

        def save(self, path):
            plan.append(("save", path))

        def search(self, queries_nav, queries_search=None, n_buckets=4,
                   k=10, search_config=None):
            plan.append(("search", np.shape(queries_nav),
                         np.shape(queries_search), n_buckets, k,
                         None if search_config is None
                         else search_config.to_dict()))
            q = len(queries_nav)
            return (np.zeros((q, k), np.float32),
                    np.tile(np.arange(1, k + 1), (q, 1)))

    return Recorder


PLANS = {
    "flat": dict(buckets_perc=(25, 50)),
    "int4": dict(store_dtype="int4", buckets_perc=(25,)),
    "hier_int8_shard": dict(hierarchical_groups=3, store_dtype="int8",
                            shard=4, buckets_perc=(50,), k=5),
    "hier_prune_mass_calibrate": dict(
        hierarchical_groups=3, calibrate=True, prune=True, probe_mass=0.98,
        buckets_perc=(40,), k=5),
    "worklist_pair": dict(pallas_worklist=True, pallas_pair=True,
                          store_dtype="int8", buckets_perc=(25,)),
    "extract_fetch_f16_rerank": dict(
        pallas_extract="scalar", fetch_dtype="float16",
        rerank_dtype="float16", store_dtype="int8", buckets_perc=(25,)),
    "restarts_flat_zero_budget": dict(router_restarts=3, buckets_perc=(1,)),
    "restarts_hier_save": dict(hierarchical_groups=2, router_restarts=2,
                               buckets_perc=(30,), save=True,
                               save_index="ckpt"),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_run_makes_the_jax_plan(monkeypatch, tmp_path, caplog, case):
    """The same run in both packages, each with its index replaced by a
    recorder: the same calls with the same configs and SearchConfigs."""
    kw = dict(synthetic=3000, n_categories=8, epochs=2, lr=0.003,
              size="100K", **PLANS[case])
    plans = {}
    for name, cli, hier in (("jax", jcli, jhier), ("port", tcli, thier)):
        plan = plans[name] = []
        monkeypatch.setattr(cli, "LearnedIndex", recorder(plan))
        monkeypatch.setattr(hier, "HierarchicalIndex", recorder(plan))
        extra = {"device": "cpu"} if name == "port" else {}
        with caplog.at_level(logging.WARNING):
            cli.run(result_dir=str(tmp_path / name), **kw, **extra)
    assert plans["port"] == plans["jax"]
    assert plans["port"][0][0] == "init"
    if case == "restarts_flat_zero_budget":
        warned = [r.getMessage() for r in caplog.records]
        for pkg in ("tpulmi.cli", "tpulmi_torch.cli"):
            msgs = [r.getMessage() for r in caplog.records if r.name == pkg]
            assert any("zero probed buckets" in m for m in msgs), warned
            assert any("--router-restarts 3" in m for m in msgs), warned
    # the same result files, by name
    names = {n: sorted(os.path.relpath(p, tmp_path / n) for p in glob.glob(
        str(tmp_path / n / "**" / "*.h5"), recursive=True)) for n in plans}
    assert names["port"] == names["jax"]


def test_cli_synthetic_end_to_end(tmp_path, caplog):
    """`run` on the CPU over synthetic data: one result file in the JAX
    package's layout, and recall@10 above the real-data test's 0.8."""
    with caplog.at_level(logging.INFO, logger="tpulmi_torch.cli"):
        tcli.run(synthetic=8000, n_categories=12, epochs=4, lr=0.003,
                 buckets_perc=[20], size="100K",
                 result_dir=str(tmp_path / "result"), device="cpu")
    files = glob.glob(str(tmp_path / "result" / "**" / "*.h5"),
                      recursive=True)
    assert len(files) == 1
    assert files[0].endswith(os.path.join(
        "synthetic-8000", "100K", "learned-index-synthetic-8000-100K-ep=4-"
        "lr=0.003-cat=12-model=MLP-5-buck=2.h5"))
    # the layout the JAX package writes, for the same arrays
    with h5py.File(files[0], "r") as f:
        knns, dists = np.asarray(f["knns"]), np.asarray(f["dists"])
        attrs = dict(f.attrs)
    assert knns.shape == dists.shape == (266, 10) and knns.min() >= 1
    assert attrs["buildtime"] > 0 and attrs["querytime"] > 0
    ref = str(tmp_path / "ref.h5")
    jax_store_results(ref, attrs["algo"], attrs["data"], dists, knns,
                      attrs["buildtime"], attrs["querytime"],
                      attrs["params"], attrs["size"])
    with h5py.File(ref, "r") as f, h5py.File(files[0], "r") as g:
        assert set(f.keys()) == set(g.keys())
        assert dict(f.attrs) == dict(g.attrs)
        for key in f:
            assert f[key].dtype == g[key].dtype
            np.testing.assert_array_equal(f[key][:], g[key][:])
    recalls = [float(m.group(1)) for r in caplog.records
               if (m := re.search(r"recall@10 vs exact oracle: ([\d.]+)",
                                  r.getMessage()))]
    assert len(recalls) == 1 and recalls[0] > 0.8


def test_cli_baseline_ids_equal_jax(tmp_path):
    kw = dict(synthetic=3000, n_categories=8, index_type="baseline",
              buckets_perc=[25], size="100K")
    jcli.run(result_dir=str(tmp_path / "jax"), **kw)
    tcli.run(result_dir=str(tmp_path / "port"), device="cpu", **kw)
    got = {}
    for name in ("jax", "port"):
        (path,) = glob.glob(str(tmp_path / name / "**" / "li-baseline.h5"),
                            recursive=True)
        with h5py.File(path, "r") as f:
            got[name] = (np.asarray(f["knns"]), np.asarray(f["dists"]),
                         f.attrs["algo"])
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    np.testing.assert_allclose(got["port"][1], got["jax"][1], atol=1e-6)
    assert got["port"][2] == got["jax"][2] == "li-baseline"


N, Q, D_NAV, D_SEARCH = 3000, 64, 32, 96


@pytest.fixture(scope="module")
def laion_fixture(tmp_path_factory):
    """SISAP-layout h5 files, pca96v2 (navigation) and clip768v2 (search),
    made as tests/test_laion_path.py makes them."""
    rng = np.random.default_rng(5)
    data_dir = tmp_path_factory.mktemp("data")
    centers = rng.normal(size=(12, D_SEARCH)).astype(np.float32)
    assign = rng.integers(0, 12, size=N)
    q_assign = rng.integers(0, 12, size=Q)
    base = (centers[assign]
            + 0.35 * rng.normal(size=(N, D_SEARCH))).astype(np.float32)
    qbase = (centers[q_assign]
             + 0.35 * rng.normal(size=(Q, D_SEARCH))).astype(np.float32)
    proj = rng.normal(size=(D_SEARCH, D_NAV)).astype(np.float32)
    layouts = {("pca96v2", "pca96"): (base @ proj, qbase @ proj),
               ("clip768v2", "emb"): (base, qbase)}
    for (kind, key), (data, queries) in layouts.items():
        d = data_dir / kind / "100K"
        os.makedirs(d)
        with h5py.File(d / "dataset.h5", "w") as f:
            f.create_dataset(key, data=data)
        with h5py.File(d / "query.h5", "w") as f:
            f.create_dataset(key, data=queries)
    return str(data_dir)


def test_cli_real_data_branch(laion_fixture, tmp_path):
    """The SISAP branch over local files: the navigation and search views,
    one result file, recall@5 against the exact oracle above 0.8."""
    result_dir = str(tmp_path / "result")
    tcli.run(kind="pca96v2", key="pca96", size="100K", k=5,
             buckets_perc=(30,), n_categories=10, epochs=3, lr=0.003,
             model_type="MLP-5", preprocess=True, data_dir=laion_fixture,
             result_dir=result_dir, device="cpu")
    out_dir = os.path.join(result_dir, "pca96v2", "100K")
    (name,) = os.listdir(out_dir)
    with h5py.File(os.path.join(out_dir, name), "r") as f:
        knns = np.asarray(f["knns"])
        assert knns.shape == (Q, 5) and f["dists"].shape == (Q, 5)
        assert knns.min() >= 1 and knns.max() <= N
        assert f.attrs["algo"] == "Learned-index"
        assert f.attrs["size"] == "100K"
    view = os.path.join(laion_fixture, "clip768v2", "100K")
    data = normalize(load_h5(os.path.join(view, "dataset.h5"), "emb"))
    queries = normalize(load_h5(os.path.join(view, "query.h5"), "emb"))
    _, gt, _ = Baseline(device="cpu").search(queries, data, k=5)
    recall = np.mean([len(set(knns[i]) & set(gt[i])) / 5 for i in range(Q)])
    assert recall > 0.8


def test_cli_missing_file_names_it(tmp_path):
    with pytest.raises(FileNotFoundError, match=re.escape(os.path.join(
            str(tmp_path), "pca96v2", "100K", "dataset.h5"))):
        tcli.run(kind="pca96v2", key="pca96", size="100K",
                 data_dir=str(tmp_path), result_dir=str(tmp_path / "r"),
                 device="cpu")


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--synthetic", "300", "--index-type", "baseline",
                   "--size", "100K", "--n-categories", "4"])
