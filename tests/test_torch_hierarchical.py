"""The hierarchical index of tpulmi_torch against tpulmi.hierarchical on the
CPU: the joint router and its predict on carried-over params, the
pseudo-queries, the containment scorer and the calibration, a whole build
fed the JAX package's random draws stage by stage, search (with n_groups
and with probe_mass on a fitted temperature), router restarts, the int8
host-store build, checkpoints and the stream.

One JAX build serves the module (5000 rows of `synthetic_small`, 3 groups
of 6 buckets). Tolerances: router outputs 1e-5 (float32 sums in another
order); a joint argmax equal except where the top two joint logits lie
within 1e-5; containments to one pseudo-query in n; k-means centroids
1e-5 and the trained params 1e-2 (Adam turns float32 rounding into
lr-sized steps, see test_torch_build.py: the router is held by what it
predicts, the bucket of every row, which must be equal)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulmi.hierarchical import HierarchicalConfig as JaxHierConfig
from tpulmi.hierarchical import HierarchicalIndex as JaxHierIndex
from tpulmi.models.mlp import make_model as jax_make_model
from tpulmi.utils.config import IndexConfig as JaxIndexConfig
from tpulmi.utils.config import SearchConfig as JaxSearchConfig
from tpulmi_torch import (HierarchicalConfig, HierarchicalIndex, IndexConfig,
                          SearchConfig)
from tpulmi_torch.build import StageInputs
from tpulmi_torch.convert import (joint_router_from_flax, mlp_state_from_flax,
                                  store_from_arrays)
from tpulmi_torch.evaluate import recall_at_k
from tpulmi_torch.hierarchical import (CALIBRATION_GRID,
                                       JointRouterClassifier)
from tpulmi_torch.index import BuiltIndex
from tpulmi_torch.ops.distance import exact_knn

torch.set_num_threads(1)

N_ROWS, G, C = 5000, 3, 6
INNER = dict(n_categories=C, epochs=3, lr=0.003, model_type="MLP-5",
             row_align=1)
HIER = dict(n_groups=G, outer_epochs=3, outer_lr=0.003, calibrate_budget=0)
TOL = 1e-5


def _cfg(**over):
    return HierarchicalConfig(inner=IndexConfig(**INNER), **{**HIER, **over})


@pytest.fixture(scope="module")
def ds(synthetic_small):
    return {k: (v[:N_ROWS] if k.startswith("data") else v)
            for k, v in synthetic_small.items()}


@pytest.fixture(scope="module")
def jax_hier(ds):
    hi = JaxHierIndex(JaxHierConfig(inner=JaxIndexConfig(**INNER), **HIER))
    hi.build(ds["data_nav"], ds["data_search"])
    return hi


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_draws(key, plan, model_type, n_categories, d_nav):
    kkey, ikey, tkey = jax.random.split(key, 3)
    if plan.n_train < plan.train_rows:
        stride = plan.train_rows // plan.n_train
        train_idx = (jnp.arange(plan.n_train, dtype=jnp.int32) * stride
                     + jax.random.randint(kkey, (plan.n_train,), 0, stride,
                                          jnp.int32))
    else:
        train_idx = jnp.arange(plan.n_train, dtype=jnp.int32)
    params = jax_make_model(model_type, n_categories).init(
        ikey, jnp.zeros((1, d_nav), jnp.float32))["params"]
    batches = [jax.random.permutation(ek, plan.train_rows)[
                   : plan.steps_per_epoch * plan.eff_batch].reshape(
                       plan.steps_per_epoch, plan.eff_batch)
               for ek in jax.random.split(tkey, plan.epochs)]
    return train_idx, params, batches


def _jax_stage_inputs(seed, plan, model_type, n_categories, d_nav):
    """The draws tpulmi.build's program takes from PRNGKey(seed)."""
    train_idx, params, batches = jax.device_get(_jax_draws(
        jax.random.PRNGKey(seed), plan, model_type, n_categories, d_nav))
    return StageInputs(
        train_idx=torch.from_numpy(np.asarray(train_idx, np.int64)),
        batches=[torch.from_numpy(np.asarray(b, np.int64)) for b in batches],
        init_state=mlp_state_from_flax(params))


@pytest.fixture(scope="module")
def port_hier(ds):
    """The port's build, fed the JAX package's draws at every stage."""
    hi = HierarchicalIndex(_cfg(), device="cpu")
    hi.stage_inputs = _jax_stage_inputs
    hi.build(ds["data_nav"], ds["data_search"])
    return hi


def _carried(jh) -> HierarchicalIndex:
    """A port index holding the JAX index's router, store and pred."""
    b, s = jh.built, jh.built.store
    router = joint_router_from_flax(jax.device_get(b.classifier.params),
                                    "MLP-5", "MLP-5", G, C)
    router.outer_weight = b.classifier.model.outer_weight
    router.mass_temp = b.classifier.model.mass_temp
    hi = HierarchicalIndex(_cfg(), device="cpu")
    store = store_from_arrays(np.asarray(s.data_sorted),
                              np.asarray(s.ids_sorted), np.asarray(s.offsets),
                              np.asarray(s.counts), s.n, s.pad_rows,
                              s.row_align, device="cpu")
    hi._set_built(BuiltIndex(
        torch.from_numpy(np.asarray(b.centroids)),
        JointRouterClassifier(router, b.classifier.input_dim,
                              b.classifier.model_type), store,
        torch.from_numpy(np.asarray(b.pred_categories)), hi.config,
        int(np.asarray(s.counts).max())))
    return hi


@pytest.fixture(scope="module")
def carried(jax_hier):
    return _carried(jax_hier)


def _set_weights(jh, th, w, t=None):
    jh.built.classifier.model.outer_weight = float(w)
    th.set_outer_weight(w)
    if t is not None:
        jh.built.classifier.model.mass_temp = float(t)
        th.set_mass_temp(t)


def _equal_but_near_ties(got, want, logits, tol=TOL):
    """Argmaxes equal wherever the top two logits are more than tol
    apart; most rows equal."""
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > tol
    np.testing.assert_array_equal(got[clear], want[clear])
    assert clear.mean() >= 0.99


def _ids_equal_but_ties(td, ti, jd, ji, tol=TOL):
    np.testing.assert_allclose(td, jd, atol=tol)
    gap = np.full(jd.shape, np.inf)
    step = np.diff(jd, axis=1)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    apart = gap > tol
    np.testing.assert_array_equal(ti[apart], np.asarray(ji)[apart])
    assert (ti == np.asarray(ji)).mean() >= 0.99


def test_index_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HierarchicalIndex(_cfg())


@pytest.mark.parametrize("w", [1.0, 0.25])
def test_joint_router_matches_jax(jax_hier, carried, ds, w):
    jclf = jax_hier.built.classifier
    router = carried.built.classifier.model
    w0 = jclf.model.outer_weight
    try:
        _set_weights(jax_hier, carried, w)
        x = ds["queries_nav"]
        jlo, jli = jclf.model.components({"params": jclf.params},
                                         jnp.asarray(x))
        lo, li = router.components(torch.from_numpy(x))
        np.testing.assert_allclose(lo.detach().numpy(), np.asarray(jlo),
                                   atol=TOL)
        np.testing.assert_allclose(li.detach().numpy(), np.asarray(jli),
                                   atol=TOL)
        want = np.asarray(jclf.model.apply({"params": jclf.params},
                                           jnp.asarray(x)))
        got = router(torch.from_numpy(x)).detach().numpy()
        assert got.shape == (len(x), G * C)
        np.testing.assert_allclose(got, want, atol=TOL)
    finally:
        _set_weights(jax_hier, carried, w0)


def test_predict_matches_jax_and_follows_the_outer_weight(jax_hier, carried,
                                                          ds):
    """The joint predict equals the JAX package's but for near-ties, at
    the build's weight and at two extreme ones; at each it equals the
    argmax of the router's forward at that weight (the weight is read at
    the call), and at least one of them moves some rows."""
    jclf = jax_hier.built.classifier
    clf = carried.built.classifier
    X = ds["data_nav"][:2000]
    w0 = clf.model.outer_weight
    base = clf.predict(X, chunk=512).numpy()
    assert base.dtype == np.int32
    try:
        flipped = False
        for w in (w0, 0.0, 50.0):
            _set_weights(jax_hier, carried, w)
            got = clf.predict(X, chunk=512).numpy()
            logits = clf.model(torch.from_numpy(X)).detach().numpy()
            np.testing.assert_array_equal(got, np.argmax(logits, axis=1))
            _equal_but_near_ties(got, np.asarray(jclf.predict(X)), logits)
            flipped |= not np.array_equal(got, base)
        assert flipped
    finally:
        _set_weights(jax_hier, carried, w0)


def test_nn_pseudo_queries_match_jax(carried, ds):
    data_nav = np.asarray(ds["data_nav"], np.float32)
    jq, jn = JaxHierIndex._nn_pseudo_queries(
        data_nav, n_queries=600, n_corpus_sample=1500, seed=11)
    q, nn = carried._nn_pseudo_queries(data_nav, n_queries=600,
                                       n_corpus_sample=1500, seed=11)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(nn, jn)
    assert not np.any(q == nn)


def test_containment_score_matches_jax(jax_hier, carried, ds):
    data_nav = np.asarray(ds["data_nav"], np.float32)
    qidx, nn = carried._nn_pseudo_queries(data_nav, n_queries=256,
                                          n_corpus_sample=2000, seed=5)
    grid = (0.25, 0.55, 1.0)
    want, want_w = jax_hier._containment_score(
        jax_hier.built.classifier, data_nav, qidx, nn, 5, grid=grid)
    got, got_w = carried._containment_score(
        carried.built.classifier, data_nav, qidx, nn, 5, grid=grid)
    np.testing.assert_allclose(got_w, want_w, atol=1.0 / len(qidx))
    assert got == max(got_w)
    assert abs(got - want) <= 1.0 / len(qidx)


@pytest.fixture(scope="module")
def jax_calibration(jax_hier, ds):
    return jax_hier.calibrate_outer_weight(
        ds["data_nav"], probe_budget=6, n_queries=512, n_corpus_sample=4000,
        apply=False)


def test_calibration_matches_jax(jax_calibration, carried, ds):
    want = jax_calibration
    got = carried.calibrate_outer_weight(
        ds["data_nav"], probe_budget=6, n_queries=512, n_corpus_sample=4000,
        apply=False)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["containment"], want["containment"],
                               atol=1.0 / 512)
    for key in ("weights", "best", "probe_budget", "mass_temp"):
        assert got[key] == want[key], key
    assert abs(got["baseline_w1"] - want["baseline_w1"]) <= 1.0 / 512
    assert got["best_containment"] == max(got["containment"])
    w0 = carried.built.classifier.model.outer_weight
    carried.search(ds["queries_nav"][:16], ds["queries_search"][:16],
                   n_buckets=4, k=5)
    assert carried._search_programs
    try:
        carried.calibrate_outer_weight(
            ds["data_nav"], probe_budget=6, n_queries=512,
            n_corpus_sample=4000)
        model = carried.built.classifier.model
        assert (model.outer_weight, model.mass_temp) == (
            want["best"], want["mass_temp"])
        assert not carried._search_programs
    finally:
        carried.set_outer_weight(w0)
        carried.set_mass_temp(1.0)


def test_build_matches_jax(jax_hier, port_hier, ds):
    """Fed the JAX package's draws, the port builds the same navigation
    stack: every row in the same bucket, the same outer centroids, the
    stacked params within Adam's drift, and the same store."""
    jb, tb = jax_hier.built, port_hier.built
    np.testing.assert_array_equal(tb.pred_categories.numpy(),
                                  np.asarray(jb.pred_categories))
    np.testing.assert_allclose(tb.centroids.numpy(), np.asarray(jb.centroids),
                               atol=TOL)
    want = joint_router_from_flax(jax.device_get(jb.classifier.params),
                                  "MLP-5", "MLP-5", G, C).state_dict()
    got = tb.classifier.model.state_dict()
    assert list(got) == list(want)
    for name, value in want.items():
        assert got[name].shape == value.shape, name
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   atol=1e-2, err_msg=name)
    assert tb.classifier.n_classes == jb.classifier.n_classes == G * C
    assert tb.classifier.model_type == jb.classifier.model_type
    ts, js = tb.store, jb.store
    for name in ("ids_sorted", "offsets", "counts"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    np.testing.assert_allclose(ts.data_sorted.numpy(),
                               np.asarray(js.data_sorted), atol=1e-6)


@pytest.mark.parametrize("mode", ["kernel", "probe_mass"])
def test_search_matches_jax(jax_hier, carried, jax_calibration, ds, mode):
    """The carried index searches like the JAX one: through the probe
    kernel's plain version, and on the xla scan with probe_mass truncating
    on the fitted temperature (the rows it scanned equal too)."""
    qn, qs = ds["queries_nav"], ds["queries_search"]
    w0 = carried.built.classifier.model.outer_weight
    try:
        if mode == "kernel":
            # the budget and batch of the n_groups test, whose JAX search
            # then reuses this compiled program
            kw = dict(n_buckets=6, compute_dtype=None)
            scfg, jscfg = SearchConfig(**kw), JaxSearchConfig(**kw)
        else:
            _set_weights(jax_hier, carried, jax_calibration["best"],
                         jax_calibration["mass_temp"])
            kw = dict(n_buckets=8, backend="xla", compute_dtype="float32",
                      query_chunk=8, probe_mass=0.6)
            scfg, jscfg = SearchConfig(**kw), JaxSearchConfig(**kw)
        jd, ji = jax_hier.search(qn, qs, n_buckets=kw["n_buckets"], k=10,
                                 search_config=jscfg)
        td, ti = carried.search(qn, qs, n_buckets=kw["n_buckets"], k=10,
                                search_config=scfg)
        _ids_equal_but_ties(td, ti, jd, ji)
        if mode == "probe_mass":
            assert carried.last_scan_rows == jax_hier.last_scan_rows
            assert carried.last_nominal_rows == jax_hier.last_nominal_rows
            rows = carried.last_scan_rows
            carried.search(qn, qs, n_buckets=8, k=10, search_config=(
                dataclasses.replace(scfg, probe_mass=1.0)))
            assert rows < carried.last_scan_rows   # the mass truncated
    finally:
        _set_weights(jax_hier, carried, w0, 1.0)


def test_search_n_groups_multiplies_the_budget(jax_hier, carried, ds):
    qn, qs = ds["queries_nav"], ds["queries_search"]
    d1, i1 = carried.search(qn, qs, n_groups=2, n_buckets=3, k=10)
    d2, i2 = carried.search(qn, qs, n_buckets=6, k=10)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)
    jd, ji = jax_hier.search(qn, qs, n_groups=2, n_buckets=3, k=10,
                             search_config=JaxSearchConfig(
                                 n_buckets=6, compute_dtype=None))
    td, ti = carried.search(qn, qs, n_groups=2, n_buckets=3, k=10,
                            search_config=SearchConfig(n_buckets=6,
                                                       compute_dtype=None))
    _ids_equal_but_ties(td, ti, jd, ji)


def test_router_restarts(ds):
    """restarts=2 scores both candidates on shared pseudo-queries, keeps
    the better one, moves the loser's params and centroids to the CPU; a
    rebuild with restarts=1 clears the scores."""
    hi = HierarchicalIndex(_cfg(router_restarts=2, calibrate_budget=6),
                           device="cpu")
    made = []
    build_one = hi._build_nav_candidate

    def recording(nav, seed):
        out = build_one(nav, seed)
        made.append((seed, *out))
        return out

    hi._build_nav_candidate = recording
    nav, search = ds["data_nav"][:2500], ds["data_search"][:2500]
    hi.build(nav, search)
    scores = hi._router_restart_scores
    assert len(scores) == 2 and [m[0] for m in made] == [2023, 3023]
    assert all(0.0 <= s <= 1.0 for s in scores)
    win = int(np.argmax(scores))
    assert hi.built.classifier is made[win][1]
    loser = made[1 - win]
    assert all(p.device.type == "cpu"
               for p in loser[1].model.parameters())
    assert loser[1] is not hi.built.classifier
    hi.hconfig = dataclasses.replace(hi.hconfig, router_restarts=1)
    hi.build(nav, search)
    assert hi._router_restart_scores is None


@pytest.fixture(scope="module")
def host_int8(ds):
    """The int8 host-store build, fed the same draws as `port_hier`, and
    calibrated at the end."""
    hi = HierarchicalIndex(_cfg(calibrate_budget=6), device="cpu")
    hi.stage_inputs = _jax_stage_inputs
    pred, _ = hi.build_with_host_store(
        ds["data_nav"], np.asarray(ds["data_search"], np.float32),
        store_dtype="int8")
    return hi, pred


def test_host_store_int8(host_int8, port_hier, ds):
    """Its pred is `build`'s, its store int8 codes of the same layout, its
    router calibrated, and its recall over the JAX test's bar
    (test_hierarchical_host_store_int8: above 0.85 at 9 of 18 probes)."""
    hi, pred = host_int8
    np.testing.assert_array_equal(pred,
                                  port_hier.built.pred_categories.numpy())
    store = hi.built.store
    assert store.is_quantized and store.n_categories == G * C
    ref = port_hier.built.store
    for name in ("offsets", "counts"):
        np.testing.assert_array_equal(getattr(store, name).numpy(),
                                      getattr(ref, name).numpy())
    np.testing.assert_array_equal(store.ids_sorted[:N_ROWS].numpy(),
                                  ref.ids_sorted[:N_ROWS].numpy())
    assert hi.built.classifier.model.outer_weight in CALIBRATION_GRID
    _, gt = exact_knn(torch.from_numpy(ds["queries_search"]),
                      torch.from_numpy(ds["data_search"]), 10)
    _, ids = hi.search(ds["queries_nav"], ds["queries_search"], n_buckets=9,
                       k=10)
    assert recall_at_k(ids - 1, gt.numpy(), 10) > 0.85


@pytest.mark.parametrize("kind", ["float32", "int8_rerank"])
def test_save_load(port_hier, host_int8, ds, tmp_path, kind):
    hi = port_hier if kind == "float32" else host_int8[0]
    qn, qs = ds["queries_nav"][:40], ds["queries_search"][:40]
    w0, t0 = (hi.built.classifier.model.outer_weight,
              hi.built.classifier.model.mass_temp)
    try:
        hi.set_outer_weight(0.4)
        hi.set_mass_temp(4.0)
        want = hi.search(qn, qs, n_buckets=5, k=10)
        hi.save(str(tmp_path / "ckpt"), include_corpus=True)
        back = HierarchicalIndex.load(str(tmp_path / "ckpt"), device="cpu")
    finally:
        hi.set_outer_weight(w0)
        hi.set_mass_temp(t0)
    assert type(back) is HierarchicalIndex
    assert back.hconfig == hi.hconfig
    model = back.built.classifier.model
    assert (model.outer_weight, model.mass_temp) == (0.4, 4.0)
    assert back.built.store.is_quantized == (kind != "float32")
    assert (back._host_corpus is not None) == (kind != "float32")
    got = back.search(qn, qs, n_buckets=5, k=10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("kind", ["float32", "int8_rerank"])
def test_stream_equals_search(port_hier, host_int8, ds, kind):
    hi = port_hier if kind == "float32" else host_int8[0]
    batches = [(ds["queries_nav"][s:s + 50], ds["queries_search"][s:s + 50])
               for s in (0, 50, 100, 150)]
    got = list(hi.search_stream(batches, n_buckets=4, k=10, depth=2))
    assert len(got) == len(batches)
    for (qn, qs), (d, ids) in zip(batches, got):
        wd, wi = hi.search(qn, qs, n_buckets=4, k=10)
        np.testing.assert_array_equal(ids, wi)
        np.testing.assert_array_equal(d, wd)
