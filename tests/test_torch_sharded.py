"""The bucket-sharded store and search, data-parallel training and the
data-parallel build of tpulmi_torch against tpulmi.parallel, on the CPU:
JAX on its 8 virtual CPU devices, the port on a mesh of 8 CPU entries.
The cases of tests/test_sharded.py, and the port held to the JAX functions
on the same inputs.

Tolerances: float32 distances 1e-5 and ids equal except where a distance
ties within 1e-5 (the merges sum in another order); a data-parallel step's
params 1e-5 (3 steps); the distributed build fed the JAX program's draws:
centroids 1e-5, losses 1e-3, params 1e-2 (Adam turns float32 rounding into
lr-sized steps, see test_torch_build.py), pred equal but at near-ties
(the JAX router's top two logits within 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpulmi.buckets import build_bucket_store as jax_build_store
from tpulmi.index import LearnedIndex as JaxIndex
from tpulmi.models.mlp import make_model as jax_make_model
from tpulmi.ops.quantize import quantize_store as jax_quantize_store
from tpulmi.parallel.dist_build import get_dist_nav_program
from tpulmi.parallel.dist_build import shard_rows as jax_shard_rows
from tpulmi.parallel.mesh import make_mesh as jax_make_mesh
from tpulmi.parallel.sharded import make_dp_train_step as jax_dp_step
from tpulmi.parallel.sharded import shard_store as jax_shard_store
from tpulmi.parallel.sharded import sharded_probe_search as jax_sps
from tpulmi.utils.config import IndexConfig as JaxIndexConfig
from tpulmi.utils.config import SearchConfig as JaxSearchConfig
from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
from tpulmi_torch.build import StageInputs
from tpulmi_torch.convert import (index_from_arrays, mlp_from_flax,
                                  mlp_state_from_flax, store_from_arrays)
from tpulmi_torch.ops.distance import exact_knn
from tpulmi_torch.ops.probe_topk import probe_search
from tpulmi_torch.parallel import (make_dp_train_step, make_mesh,
                                   shard_store, sharded_probe_search)
from tpulmi_torch.parallel.dist_build import dist_nav, dist_plan, shard_rows

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-5


def cpu_mesh(n=8, axis="buckets"):
    return make_mesh(axis_names=(axis,), devices=[CPU] * n)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jax_make_mesh(8, ("buckets",))


def equal_but_ties(d, ids, want_d, want_ids, tol=TOL):
    """Distances within `tol` place by place; ids equal wherever the
    distance is more than `tol` from every other in its row (the k-th place
    may also tie with a row past the cut)."""
    d, want_d = np.asarray(d), np.asarray(want_d)
    np.testing.assert_allclose(d, want_d, atol=tol)
    step = np.diff(want_d, axis=1)
    gap = np.full(want_d.shape, np.inf)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    apart = gap > tol
    apart[:, -1] = False
    np.testing.assert_array_equal(np.asarray(ids)[apart],
                                  np.asarray(want_ids)[apart])


def _setup(rng, n=3000, d=16, c=22, q=48):
    data = rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    return data, queries, labels


def _stores(data, labels, c, row_align=1, quantized=False):
    """The JAX store and the port's store over the same arrays."""
    js = jax_build_store(labels, data, c, row_align=row_align)
    if quantized:
        js = jax_quantize_store(js, bits=8)
    ps = store_from_arrays(
        np.asarray(js.data_sorted), np.asarray(js.ids_sorted),
        np.asarray(js.offsets), np.asarray(js.counts), js.n, js.pad_rows,
        js.row_align, device="cpu",
        scales=np.asarray(js.scales) if quantized else None)
    return js, ps


@pytest.mark.parametrize("c, n_shards, row_align, quantized", [
    (22, 8, 1, False), (10, 4, 64, True), (5, 8, 1, False)],
    ids=["float32", "int8-aligned", "empty-shards"])
def test_shard_store_equals_jax(rng, c, n_shards, row_align, quantized):
    data, _, labels = _setup(rng, n=1500, c=c)
    js, ps = _stores(data, labels, c, row_align, quantized)
    want = jax_shard_store(js, n_shards)
    got = shard_store(ps, mesh=cpu_mesh(n_shards))
    assert (got.n_shards, got.cat_pad, got.rows, got.pad_rows,
            got.row_align, got.is_quantized) == (
        want.n_shards, want.cat_pad, want.rows, want.pad_rows,
        want.row_align, want.scales is not None)
    np.testing.assert_array_equal(got.bucket_start,
                                  np.asarray(want.bucket_start)[:, 0])
    names = ["data_sorted", "ids_sorted", "offsets", "counts"]
    if quantized:
        names.append("scales")
    for name in names:
        stacked = torch.stack([getattr(st, name) for st in got.shards])
        np.testing.assert_array_equal(stacked.numpy(),
                                      np.asarray(getattr(want, name)))
    assert all(st.n == want.rows for st in got.shards)


def test_shard_store_partition(rng):
    data, _, labels = _setup(rng, c=10)
    _, ps = _stores(data, labels, 10)
    sstore = shard_store(ps, 4)
    assert sstore.n_shards == 4 and sstore.cat_pad == 3
    ids = torch.cat([st.ids_sorted for st in sstore.shards]).numpy()
    np.testing.assert_array_equal(np.sort(ids[ids >= 0]),
                                  np.arange(data.shape[0]))
    counts = ps.counts.numpy()
    for s, st in enumerate(sstore.shards):
        lo, hi = 3 * s, min(3 * (s + 1), 10)
        np.testing.assert_array_equal(st.counts.numpy()[:hi - lo],
                                      counts[lo:hi])


def test_sharded_probe_search_equals_jax(rng, mesh8):
    """sharded_probe_search on 5 random probes: the JAX function's result
    on both backends, and the single-device probe's."""
    data, queries, labels = _setup(rng)
    js, ps = _stores(data, labels, 22)
    probes = np.stack([rng.permutation(22)[:5] for _ in range(48)]).astype(
        np.int32)
    want_d, want_i = jax_sps(probes, queries, jax_shard_store(js, 8), mesh8,
                             k=10)
    sstore = shard_store(ps, mesh=cpu_mesh())
    single = probe_search(torch.from_numpy(probes), torch.from_numpy(queries),
                          ps, k=10, compute_dtype=torch.float32,
                          backend="torch")
    for backend in ("xla", "torch"):
        d, i = sharded_probe_search(probes, queries, sstore, cpu_mesh(),
                                    k=10, backend=backend)
        equal_but_ties(d, i, want_d, want_i)
        equal_but_ties(d, i, single[0], single[1])


@pytest.mark.parametrize("backend", ["xla", "torch"])
def test_sharded_probe_all_equals_exact(rng, backend):
    data, queries, labels = _setup(rng)
    _, ps = _stores(data, labels, 22)
    probes = np.tile(np.arange(22, dtype=np.int32), (queries.shape[0], 1))
    d, i = sharded_probe_search(probes, queries,
                                shard_store(ps, mesh=cpu_mesh()), cpu_mesh(),
                                k=10, backend=backend)
    want_d, want_i = exact_knn(queries, data, k=10, normalized=True)
    equal_but_ties(d, i, want_d, want_i)
    chosen = 1.0 - np.einsum("qkd,qd->qk", data[i.numpy()], queries)
    np.testing.assert_allclose(chosen, want_d.numpy(), atol=TOL)


@pytest.mark.parametrize("backend", ["xla", "torch"])
def test_sharded_with_empty_shards(rng, backend):
    """Fewer buckets than shards: the trailing shards own only padding
    buckets and contribute nothing but sentinels."""
    data, queries, labels = _setup(rng, n=800, c=5, q=16)
    _, ps = _stores(data, labels, 5)
    probes = np.stack([rng.permutation(5)[:2] for _ in range(16)]).astype(
        np.int32)
    want = probe_search(torch.from_numpy(probes), torch.from_numpy(queries),
                        ps, k=10, compute_dtype=torch.float32,
                        backend="torch")
    sstore = shard_store(ps, mesh=cpu_mesh())
    assert sum(int(st.counts.sum()) == 0 for st in sstore.shards) == 3
    d, i = sharded_probe_search(probes, queries, sstore, cpu_mesh(), k=10,
                                backend=backend)
    equal_but_ties(d, i, want[0], want[1])
    assert int(i.max()) < 800


def test_dp_train_step_equals_jax(rng):
    """3 data-parallel steps, each from the JAX step's params on the same
    batch, give the JAX step's loss and params (each step is held alone:
    across steps Adam's normalized update turns float32 rounding into
    larger drift); 17 more steps halve the loss."""
    model = jax_make_model("MLP-5", n_classes=6)
    tx = optax.adam(1e-2)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16)))["params"]
    opt_state = tx.init(params)
    jstep = jax_dp_step(model, tx, jax_make_mesh(8, ("data",)))
    centers = 3.0 * rng.normal(size=(6, 16)).astype(np.float32)
    y = rng.integers(0, 6, size=1024).astype(np.int32)
    x = centers[y] + 0.3 * rng.normal(size=(1024, 16)).astype(np.float32)

    step = make_dp_train_step(mlp_from_flax(jax.device_get(params)), 1e-2,
                              cpu_mesh(axis="data"))
    losses = []
    for _ in range(3):
        with torch.no_grad():
            for name, value in mlp_state_from_flax(
                    jax.device_get(params)).items():
                step.model.get_parameter(name).copy_(value)
        params, opt_state, jloss = jstep(params, opt_state, x, y)
        losses.append(float(step(x, y)))
        assert abs(losses[-1] - float(jloss)) <= TOL
        want = mlp_state_from_flax(jax.device_get(params))
        for name, value in step.model.state_dict().items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                       atol=TOL)
    for _ in range(17):
        losses.append(float(step(x, y)))
    assert losses[-1] < losses[0] * 0.5


# ------------------------------------------------------------ the facade
SMALL = dict(n_categories=24, epochs=4, lr=0.003, batch_size=512,
             row_align=1)


@pytest.fixture(scope="module")
def small_index(synthetic_small):
    li = LearnedIndex(IndexConfig(**SMALL), device="cpu")
    li.build(synthetic_small["data_nav"], synthetic_small["data_search"])
    return li


def test_facade_shard_search_matches_single(small_index, synthetic_small):
    """LearnedIndex.shard: the sharded search gives the flat search's
    result, repeated calls reuse one program, unshard searches flat."""
    li = small_index
    qn = synthetic_small["queries_nav"][:64]
    qs = synthetic_small["queries_search"][:64]
    scfg = SearchConfig(k=10, backend="xla", compute_dtype=None)
    li.unshard()
    d0, i0 = li.search(qn, qs, n_buckets=5, k=10, search_config=scfg)
    li.shard(cpu_mesh())
    d1, i1 = li.search(qn, qs, n_buckets=5, k=10, search_config=scfg)
    equal_but_ties(d1, i1, d0, i0)
    d2, i2 = li.search(qn, qs, n_buckets=5, k=10, search_config=scfg)
    assert len(li._search_programs) == 1
    np.testing.assert_array_equal(i2, i1)
    li.unshard()
    d3, i3 = li.search(qn, qs, n_buckets=5, k=10, search_config=scfg)
    np.testing.assert_array_equal(i3, i0)


def test_facade_shard_probe_mass(small_index, synthetic_small):
    """probe_mass on the sharded xla scan: the dumped probes drop on every
    shard and the result is the flat search's; the sharded scan counts no
    rows (as the JAX package's)."""
    li = small_index
    qn = synthetic_small["queries_nav"][:64]
    qs = synthetic_small["queries_search"][:64]
    scfg = SearchConfig(k=10, backend="xla", compute_dtype=None,
                        probe_mass=0.5)
    li.unshard()
    d0, i0 = li.search(qn, qs, n_buckets=8, k=10, search_config=scfg)
    assert li.last_scan_rows is not None
    # it truncated: some query lost a probe that held one of its top 10
    assert not np.array_equal(i0, li.search(
        qn, qs, n_buckets=8, k=10, search_config=SearchConfig(
            k=10, backend="xla", compute_dtype=None))[1])
    li.shard(cpu_mesh())
    try:
        d1, i1 = li.search(qn, qs, n_buckets=8, k=10, search_config=scfg)
        assert li.last_scan_rows is None
    finally:
        li.unshard()
    equal_but_ties(d1, i1, d0, i0)


def test_facade_shard_quantized(synthetic_small):
    """An int8 store sharded: probing every bucket with the host rerank
    gives the exact oracle, and quantize re-cut the shards."""
    data = np.asarray(synthetic_small["data_search"], np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    li = LearnedIndex(IndexConfig(**SMALL), device="cpu")
    li.build(synthetic_small["data_nav"][:8000], data[:8000])
    li.shard(cpu_mesh())
    li.quantize(host_corpus=data[:8000], normalized=True)
    assert all(st.is_quantized for st in li._sharded[0].shards)
    qn = synthetic_small["queries_nav"][:64]
    qs = synthetic_small["queries_search"][:64]
    d, i = li.search(qn, qs, n_buckets=24, k=10,
                     search_config=SearchConfig(k=10, backend="xla"))
    want_d, want_i = exact_knn(qs, data[:8000], k=10)
    np.testing.assert_array_equal(i, want_i.numpy() + 1)
    np.testing.assert_allclose(d, want_d.numpy(), atol=TOL)


def test_build_distributed(synthetic_small):
    """The data-parallel build: its router learned the partition (recall
    above 0.9 at 6 of 24 probes) and its sharded search equals the search
    after unshard."""
    ds = synthetic_small
    li = LearnedIndex(IndexConfig(n_categories=24, epochs=6, lr=0.003,
                                  batch_size=1024, row_align=1), device="cpu")
    pred, _ = li.build_distributed(ds["data_nav"], ds["data_search"],
                                   mesh=cpu_mesh(axis="data"))
    assert pred.shape == (ds["data_nav"].shape[0],)
    assert li._sharded is not None and li._sharded[1].axis_names == (
        "buckets",)
    qn, qs = ds["queries_nav"][:128], ds["queries_search"][:128]
    scfg = SearchConfig(k=10, backend="xla")
    _, ids = li.search(qn, qs, n_buckets=6, k=10, search_config=scfg)
    gt = exact_knn(qs, ds["data_search"], k=10)[1].numpy() + 1
    recall = np.mean([len(set(ids[r]) & set(gt[r])) / 10
                      for r in range(len(ids))])
    assert recall > 0.9
    li.unshard()
    np.testing.assert_array_equal(
        li.search(qn, qs, n_buckets=6, k=10, search_config=scfg)[1], ids)


DIST = dict(n_categories=12, kmeans_iters=25, epochs=2, batch_size=512)
DIST_SEED = 5


def _jax_dist_draws(plan, model, d_nav):
    """The draws of the JAX navigation program under PRNGKey(DIST_SEED):
    its split, fold_in and permutation calls."""
    kkey, ikey, tkey = jax.random.split(jax.random.PRNGKey(DIST_SEED), 3)
    train_idx = [np.asarray(jax.random.permutation(
        jax.random.fold_in(kkey, me), plan.n_local)[:plan.m_local])
        for me in range(plan.n_shards)]
    rows = plan.steps_per_epoch * plan.local_batch
    perms = [np.stack([np.asarray(jax.random.permutation(ek, plan.n_local)[
        :rows]) for ek in jax.random.split(jax.random.fold_in(tkey, me),
                                           plan.epochs)])
             for me in range(plan.n_shards)]    # (S, epochs, rows)
    batches = [torch.from_numpy(np.stack([p[e] for p in perms]).reshape(
        plan.n_shards, plan.steps_per_epoch, plan.local_batch).astype(
            np.int64)) for e in range(plan.epochs)]
    params = model.init(ikey, jnp.zeros((1, d_nav), jnp.float32))["params"]
    return StageInputs(torch.from_numpy(np.stack(train_idx).astype(np.int64)),
                       batches, mlp_state_from_flax(jax.device_get(params)))


def test_dist_nav_equals_jax(synthetic_small):
    """The navigation stages over 8 entries, fed the JAX program's draws,
    against the JAX program over its 8 devices."""
    data = synthetic_small["data_nav"][:6000]
    jmesh = jax_make_mesh(8, ("data",))
    sharded, n_local = jax_shard_rows(data, jmesh)
    model = jax_make_model("MLP-5", DIST["n_categories"])
    kpts = 256 * DIST["n_categories"]
    want = jax.device_get(get_dist_nav_program(
        model, optax.adam(0.003), jmesh, n_local=n_local, d_nav=32,
        n_categories=DIST["n_categories"], kmeans_iters=DIST["kmeans_iters"],
        kmeans_train_points=kpts, epochs=DIST["epochs"],
        batch_size=DIST["batch_size"])(sharded,
                                       jax.random.PRNGKey(DIST_SEED)))
    mesh = cpu_mesh(axis="data")
    shards, n_local2 = shard_rows(data, mesh)
    plan = dist_plan(8, n_local2, kmeans_train_points=kpts,
                     epochs=DIST["epochs"], batch_size=DIST["batch_size"])
    got = dist_nav(shards, mesh, model_type="MLP-5", lr=0.003,
                   n_categories=DIST["n_categories"],
                   kmeans_iters=DIST["kmeans_iters"],
                   kmeans_train_points=kpts, epochs=DIST["epochs"],
                   batch_size=DIST["batch_size"], seed=DIST_SEED,
                   stage_inputs=_jax_dist_draws(plan, model, 32))
    assert n_local2 == n_local and plan.epochs == len(want.losses)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), atol=TOL)
    np.testing.assert_allclose(got.losses.detach().numpy(),
                               np.asarray(want.losses), atol=1e-3)
    wstate = mlp_state_from_flax(want.params)
    for name, value in got.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), wstate[name].numpy(),
                                   atol=1e-2)
    pred = got.pred.numpy()
    assert pred.dtype == np.int32 and pred.shape == (8 * n_local,)
    # pred equal but at near-ties: the JAX router's top two logits within
    # TOL on every row where the two differ (padded rows included)
    differ = np.flatnonzero(pred != np.asarray(want.pred))
    if differ.size:
        rows = np.asarray(sharded).reshape(-1, 32)[differ]
        top2 = np.sort(np.asarray(model.apply({"params": want.params},
                                              rows)), axis=1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] <= TOL), differ


# ---------------------------------------- a carried index, both backends
@pytest.fixture(scope="module")
def carried(mesh8):
    """A JAX index (d=128, 16 buckets, row_align 128) sharded over the 8
    JAX devices, and a maker of the port's copy of it, sharded over 8 CPU
    entries."""
    rng = np.random.default_rng(3)
    n, d_nav, d, c = 4096, 24, 128, 16
    data_nav = rng.normal(size=(n, d_nav)).astype(np.float32)
    data = rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    cfg = dict(n_categories=c, epochs=4, lr=0.003, batch_size=512,
               row_align=128)
    jli = JaxIndex(JaxIndexConfig(**cfg))
    jli.build(data_nav, data)
    s = jli.built.store
    arrays = (jax.device_get(jli.built.classifier.params),
              *(np.asarray(a) for a in (s.data_sorted, s.ids_sorted,
                                        s.offsets, s.counts)),
              s.n, s.pad_rows, s.row_align)

    def port_index():
        tli = index_from_arrays(*arrays, config=IndexConfig(**cfg),
                                device="cpu")
        tli.shard(cpu_mesh())
        return tli

    jli.shard(mesh8)
    return jli, port_index, data_nav, data


@pytest.mark.parametrize("pair", [False, True], ids=["dense", "pair"])
def test_carried_index_sharded_equals_jax(carried, pair):
    """The same index sharded both ways: the port's xla scan and its plain
    kernel backend (with and without the 128-row tile) give the JAX
    sharded search's result."""
    jli, port_index, data_nav, data = carried
    tli = port_index()
    qn, qs = data_nav[:48], data[:48]
    want_d, want_i = jli.search(qn, qs, n_buckets=4, k=10,
                                search_config=JaxSearchConfig(
                                    k=10, backend="xla", compute_dtype=None))
    for backend in ("xla", "torch"):
        d, i = tli.search(qn, qs, n_buckets=4, k=10, search_config=(
            SearchConfig(k=10, backend=backend, compute_dtype=None,
                         pallas_pair=pair)))
        equal_but_ties(d, i, want_d, want_i)


def test_carried_index_sharded_int8_rerank(carried):
    """int8 shards, int8 queries and the host rerank on the kernel
    backend: probing every bucket gives the exact oracle."""
    _, port_index, data_nav, data = carried
    tli = port_index()
    tli.quantize(host_corpus=data, normalized=True)
    qn, qs = data_nav[:32], data[:32]
    d, i = tli.search(qn, qs, n_buckets=16, k=10, search_config=(
        SearchConfig(k=10, backend="torch", compute_dtype=None,
                     int8_queries=True)))
    want_d, want_i = exact_knn(qs, data, k=10, normalized=True)
    np.testing.assert_array_equal(i, want_i.numpy() + 1)
    np.testing.assert_allclose(d, want_d.numpy(), atol=TOL)


def test_sharded_search_stream_dispatch_ahead(rng):
    """The sharded search_stream dispatches every batch ahead through the
    sharded program (no `search` call) and equals per-batch `search`."""
    data_nav = rng.normal(size=(3000, 24)).astype(np.float32)
    data = rng.normal(size=(3000, 64)).astype(np.float32)
    li = LearnedIndex(IndexConfig(n_categories=16, epochs=3, lr=0.003,
                                  batch_size=512, row_align=128),
                      device="cpu")
    li.build(data_nav, data)
    li.shard(cpu_mesh())
    scfg = SearchConfig(k=10, backend="xla", compute_dtype=None)
    batches = [(data_nav[lo:lo + 40], data[lo:lo + 40])
               for lo in range(0, 200, 40)]
    want = [li.search(qn, qs, n_buckets=4, k=10, search_config=scfg)
            for qn, qs in batches]
    assert ("sharded", 40, 4) in li._qpb_pads
    calls = {"n": 0}
    orig = li.search

    def counting_search(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    li.search = counting_search
    got = list(li.search_stream(batches, n_buckets=4, k=10,
                                search_config=scfg, depth=2))
    li.search = orig
    assert calls["n"] == 0
    for (wd, wi), (gd, gi) in zip(want, got):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, atol=1e-6)
