"""tpulmi_torch's configs, data layer, evaluation and work model against
the JAX package's."""

import numpy as np
import pytest
import torch

from tpulmi import data as jdata
from tpulmi import evaluate as jeval
from tpulmi.utils import config as jcfg
from tpulmi.utils import profiling as jprof
from tpulmi_torch import data as tdata
from tpulmi_torch import evaluate as teval
from tpulmi_torch.utils import config as tcfg
from tpulmi_torch.utils import profiling as tprof

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["IndexConfig", "SearchConfig"])
def test_configs_round_trip(name):
    t, j = getattr(tcfg, name)(), getattr(jcfg, name)()
    assert t.to_dict() == j.to_dict()
    assert getattr(tcfg, name)(**j.to_dict()) == t
    assert getattr(jcfg, name)(**t.to_dict()) == j


def test_search_config_with_kernel_options_round_trips():
    """The worklist, pair and pool options set: still 1:1 with the JAX
    package's SearchConfig, both ways."""
    opts = dict(k=7, n_buckets=3, pallas_worklist=True, pallas_pair=True,
                pallas_pool=True, pallas_mc=512, pallas_extract="group2",
                int8_queries=True, rerank_extra=30)
    t, j = tcfg.SearchConfig(**opts), jcfg.SearchConfig(**opts)
    assert t.to_dict() == j.to_dict()
    assert tcfg.SearchConfig(**j.to_dict()) == t
    assert jcfg.SearchConfig(**t.to_dict()) == j
    assert (t.pallas_worklist, t.pallas_pair, t.pallas_pool) == (True,) * 3


def test_n_buckets_from_percentage():
    for bp in ([1], [4], [6], [1, 2, 3, 4, 5, 6], [0, 50, 100]):
        for n_cat in (8, 122, 488):
            assert tcfg.n_buckets_from_percentage(bp, n_cat) == \
                jcfg.n_buckets_from_percentage(bp, n_cat)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(zipf=1.1, ood_queries=0.2, nav_decorrelation=0.5, cluster_std=1.5),
])
def test_synthetic_dataset_bit_identical(kw):
    args = dict(n=2000, n_queries=50, d_nav=16, d_search=64, n_clusters=9,
                seed=3, **kw)
    t, j = tdata.synthetic_dataset(**args), jdata.synthetic_dataset(**args)
    assert t.keys() == j.keys()
    for key in t:
        assert t[key].dtype == j[key].dtype
        np.testing.assert_array_equal(t[key], j[key])


def test_results_file_and_recall(tmp_path, rng):
    q, k = 40, 10
    gt = np.stack([rng.permutation(500)[:k] + 1 for _ in range(q)])
    res = gt.copy()
    res[:, 5:] = rng.integers(1, 500, size=(q, 5))
    res[0] = 1                                    # repeated ids count once
    assert teval.recall_at_k(res, gt, k) == jeval.recall_at_k(res, gt, k)
    dists = np.sort(rng.random((q, k)).astype(np.float32), axis=1)
    path = tmp_path / "res" / "r.h5"
    tdata.store_results(str(path), "lmi", "clip768", dists, res, 1.5, 0.25,
                        "p", "300K")
    jeval.write_ground_truth(str(tmp_path / "gt.h5"), dists, gt)
    rows = teval.evaluate_results(str(tmp_path / "res" / "*.h5"),
                                  str(tmp_path / "gt.h5"), k=k,
                                  csv_path=str(tmp_path / "res.csv"))
    want = jeval.evaluate_file(str(path), str(tmp_path / "gt.h5"), k)
    assert len(rows) == 1 and rows[0] == teval.EvalRow(**vars(want))
    assert (tmp_path / "res.csv").read_text().startswith("algo,params")


def test_load_dataset_reads_sisap_layout(tmp_path, rng):
    import h5py

    base = tmp_path / "clip768" / "100K"
    base.mkdir(parents=True)
    x = rng.normal(size=(20, 8)).astype(np.float32)
    for name in ("dataset", "query"):
        with h5py.File(base / f"{name}.h5", "w") as f:
            f["emb"] = x
    d, q = tdata.load_dataset("clip768", "emb", "100K", str(tmp_path),
                              preprocess=True)
    np.testing.assert_allclose(d, jdata.normalize(x), atol=1e-7)
    with pytest.raises(FileNotFoundError):
        tdata.load_dataset("clip768", "emb", "300K", str(tmp_path))


def test_probe_work_model_identical(rng):
    slots = rng.integers(0, 600, size=30)
    counts = rng.integers(0, 9000, size=30)
    assert tprof.probe_work_model(slots, counts, 768, 512, 1024, 2) == \
        jprof.probe_work_model(slots, counts, 768, 512, 1024, 2)


def test_timeit_on_cpu():
    best, out = tprof.timeit(lambda x: x * 2, torch.ones(3), repeats=2)
    assert best >= 0 and torch.equal(out, torch.full((3,), 2.0))
