"""The whole slice: a JAX-built index carried across by convert.py searches
like the JAX package; a port-built index reaches the JAX package's
recall."""

import jax
import numpy as np
import pytest
import torch

from tpulmi.index import LearnedIndex as JaxIndex
from tpulmi.utils.config import IndexConfig as JaxIndexConfig
from tpulmi.utils.config import SearchConfig as JaxSearchConfig
from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
from tpulmi_torch.convert import index_from_arrays
from tpulmi_torch.evaluate import recall_at_k
from tpulmi_torch.ops.distance import exact_knn

torch.set_num_threads(1)

CFG = dict(n_categories=24, epochs=8, lr=0.003, model_type="MLP-5")


@pytest.fixture(scope="module")
def jax_index(synthetic_small):
    li = JaxIndex(JaxIndexConfig(**CFG))
    li.build(synthetic_small["data_nav"], synthetic_small["data_search"])
    return li


@pytest.fixture(scope="module")
def ground_truth(synthetic_small):
    _, ids = exact_knn(torch.from_numpy(synthetic_small["queries_search"]),
                       torch.from_numpy(synthetic_small["data_search"]), 10)
    return ids.numpy()


def _carried(li):
    s = li.built.store
    return index_from_arrays(
        jax.device_get(li.built.classifier.params), np.asarray(s.data_sorted),
        np.asarray(s.ids_sorted), np.asarray(s.offsets),
        np.asarray(s.counts), s.n, s.pad_rows, s.row_align,
        config=IndexConfig(**CFG),
        centroids=np.asarray(li.built.centroids),
        pred_categories=np.asarray(li.built.pred_categories), device="cpu")


@pytest.mark.parametrize("n_buckets", [1, 2, 4])
def test_carried_index_searches_like_jax(synthetic_small, jax_index,
                                         n_buckets):
    ds = synthetic_small
    tidx = _carried(jax_index)
    jd, ji = jax_index.search(
        ds["queries_nav"], ds["queries_search"], n_buckets=n_buckets, k=10,
        search_config=JaxSearchConfig(n_buckets=n_buckets, compute_dtype=None))
    td, ti = tidx.search(
        ds["queries_nav"], ds["queries_search"], n_buckets=n_buckets, k=10,
        search_config=SearchConfig(n_buckets=n_buckets, compute_dtype=None))
    assert td.dtype == np.float32 and ti.dtype == np.int64
    assert ti.min() >= 1
    np.testing.assert_allclose(td, jd, atol=1e-5)
    # ids agree except where distances tie
    gap = np.full(jd.shape, np.inf)
    step = np.diff(jd, axis=1)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    apart = gap > 1e-5
    np.testing.assert_array_equal(ti[apart], np.asarray(ji)[apart])
    assert (ti == np.asarray(ji)).mean() >= 0.99


def test_carried_index_routes_like_jax(synthetic_small, jax_index):
    ds = synthetic_small
    tidx = _carried(jax_index)
    clf = jax_index.built.classifier
    want = np.asarray(clf.model.apply({"params": clf.params},
                                      ds["queries_nav"]))
    got = tidx.built.classifier.logits(
        torch.from_numpy(ds["queries_nav"])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


SEEDS = (2023, 1, 2, 3)
BUDGETS = (1, 2, 4)


@pytest.fixture(scope="module")
def seed_recalls(synthetic_small, ground_truth):
    """recall@10 per probe budget, averaged over SEEDS, of each package's
    own build. The two packages draw different random numbers, and one
    seed's partition alone moves recall@10 at 1 probe by up to 0.12 in
    either package (measured at this shape), so single builds cannot be
    held to 0.02 of each other; their seed averages can."""
    ds = synthetic_small
    out = {}
    for name in ("jax", "port"):
        rec = []
        for seed in SEEDS:
            if name == "jax":
                li = JaxIndex(JaxIndexConfig(**CFG, seed=seed))
            else:
                li = LearnedIndex(IndexConfig(**CFG, seed=seed), device="cpu")
            li.build(ds["data_nav"], ds["data_search"])
            rec.append([recall_at_k(np.asarray(li.search(
                ds["queries_nav"], ds["queries_search"], n_buckets=nb,
                k=10)[1]) - 1, ground_truth) for nb in BUDGETS])
        out[name] = np.mean(rec, axis=0)
    return out


@pytest.mark.parametrize("budget", range(len(BUDGETS)))
def test_port_build_recall_matches_jax(seed_recalls, budget):
    rj, rt = seed_recalls["jax"][budget], seed_recalls["port"][budget]
    assert abs(rt - rj) <= 0.02, (BUDGETS[budget], rt, rj)


@pytest.fixture(scope="module")
def port_index(synthetic_small):
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    pred, seconds = li.build(synthetic_small["data_nav"],
                             synthetic_small["data_search"])
    assert pred.shape == (20_000,) and seconds > 0
    return li


def test_batch_queries_split_and_single(synthetic_small, port_index):
    ds = synthetic_small
    d, i = port_index.search(ds["queries_nav"], ds["queries_search"],
                             n_buckets=2, k=10)
    d2, i2 = port_index.search(
        ds["queries_nav"], ds["queries_search"], n_buckets=2, k=10,
        search_config=SearchConfig(n_buckets=2, batch_queries=64))
    # other batch shapes round the bf16 products' sums differently
    np.testing.assert_allclose(d, d2, atol=1e-6)
    assert (i == i2).mean() >= 0.99
    d1, i1 = port_index.search_single(ds["queries_nav"],
                                      ds["queries_search"])
    d1b, i1b = port_index.search(ds["queries_nav"], ds["queries_search"],
                                 n_buckets=1)
    np.testing.assert_array_equal(i1, i1b)


def test_modular_build_and_cluster(synthetic_small):
    ds = synthetic_small
    li = LearnedIndex(IndexConfig(**CFG, fused_build=False), device="cpu")
    pred, _ = li.build(ds["data_nav"], ds["data_search"])
    assert pred.shape == (20_000,)
    _, ids = li.search(ds["queries_nav"], ds["queries_search"], n_buckets=4)
    _, gt = exact_knn(torch.from_numpy(ds["queries_search"]),
                      torch.from_numpy(ds["data_search"]), 10)
    assert recall_at_k(ids - 1, gt.numpy()) > 0.9
    c, labels = li.cluster(ds["data_nav"][:2000], 6)
    assert c.shape == (6, 32) and labels.shape == (2000,)


def test_empty_places_are_id_one_at_sentinel(rng):
    """A probed bucket smaller than k: the rest of the row is id 1 at
    distance 10000, as the JAX package's _finalize returns it."""
    x = rng.normal(size=(30, 8)).astype(np.float32)
    li = LearnedIndex(IndexConfig(n_categories=6, epochs=2, row_align=1),
                      device="cpu")
    li.build(x, x)
    d, ids = li.search(x[:3], x[:3], n_buckets=1, k=25)
    empty = d == 10000.0
    assert empty.any() and (ids[empty] == 1).all()


@pytest.mark.parametrize("compute_dtype,k", [("bfloat16", 10), (None, 10),
                                             ("float16", 200)])
def test_auto_backend_follows_the_store(compute_dtype, k):
    """"auto" runs the kernel for any store on the card (the kernel raises
    on what it does not take) and the plain version for one on the CPU."""
    from types import SimpleNamespace

    li = LearnedIndex(device="cpu")
    scfg = SearchConfig(compute_dtype=compute_dtype, k=k)
    q = torch.zeros((3, 8))
    for dev, backend in (("cuda", "cuda"), ("cpu", "torch")):
        li.built = SimpleNamespace(
            store=SimpleNamespace(device=torch.device(dev)))
        assert li._plan_search(q, 2, k, scfg).backend == backend
    with pytest.raises(ValueError, match="pallas_extract"):
        li._plan_search(q, 2, k, SearchConfig(pallas_extract="rows"))


def test_unported_options_are_refused(synthetic_small, port_index):
    ds = synthetic_small
    d, i = port_index.search(ds["queries_nav"][:4], ds["queries_search"][:4])
    # prune_after is ported: the xla scan prunes (tests/test_torch_prune.py);
    # the kernel's search, as the JAX package's, ignores it
    dp, ip = port_index.search(ds["queries_nav"][:4],
                               ds["queries_search"][:4],
                               search_config=SearchConfig(prune_after=1))
    np.testing.assert_array_equal(ip, i)
    np.testing.assert_array_equal(dp, d)
    # the worklist, the 128-row tile and the pool are ported: each is
    # accepted and changes no result (the pool applies to a reranked
    # search only)
    for opt in (dict(pallas_worklist=True, pallas_mc=128),
                dict(pallas_pair=True), dict(pallas_pool=True)):
        do, io = port_index.search(
            ds["queries_nav"][:4], ds["queries_search"][:4],
            search_config=SearchConfig(**opt))
        np.testing.assert_array_equal(io, i)
        np.testing.assert_allclose(do, d, atol=1e-6)
    # int8 queries are ported: ignored on a full-precision store
    d8, i8 = port_index.search(ds["queries_nav"][:4],
                               ds["queries_search"][:4],
                               search_config=SearchConfig(int8_queries=True))
    np.testing.assert_array_equal(i8, i)
