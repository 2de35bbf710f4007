"""The port's fused build against tpulmi.build.make_build_program, fed the
same random draws (the k-means sample, the initial MLP weights and each
epoch's batch order), so neither side depends on its own RNG."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpulmi.build import make_build_program
from tpulmi.models.mlp import make_model
from tpulmi_torch.buckets import layout_store
from tpulmi_torch.build import StageInputs, build_plan, fused_build
from tpulmi_torch.convert import mlp_state_from_flax
from tpulmi_torch.ops.distance import l2_normalize

torch.set_num_threads(1)

SEED, K, EPOCHS, LR = 11, 24, 3, 0.003


def _jax_stage_inputs(plan, model, d_nav):
    """The draws make_build_program takes from PRNGKey(SEED)."""
    kkey, ikey, tkey = jax.random.split(jax.random.PRNGKey(SEED), 3)
    if plan.n_train < plan.train_rows:
        stride = plan.train_rows // plan.n_train
        train_idx = (jnp.arange(plan.n_train, dtype=jnp.int32) * stride
                     + jax.random.randint(kkey, (plan.n_train,), 0, stride,
                                          jnp.int32))
    else:
        train_idx = jnp.arange(plan.n_train, dtype=jnp.int32)
    params = model.init(ikey, jnp.zeros((1, d_nav), jnp.float32))["params"]
    batches = [
        np.asarray(jax.random.permutation(ek, plan.train_rows)[
            : plan.steps_per_epoch * plan.eff_batch]).reshape(
                plan.steps_per_epoch, plan.eff_batch)
        for ek in jax.random.split(tkey, plan.epochs)]
    return StageInputs(
        train_idx=torch.from_numpy(np.asarray(train_idx, np.int64)),
        batches=[torch.from_numpy(b.astype(np.int64)) for b in batches],
        init_state=mlp_state_from_flax(jax.device_get(params)))


@pytest.fixture(scope="module")
def builds(synthetic_small):
    ds = synthetic_small
    n, d_nav = ds["data_nav"].shape
    kpts = 256 * K
    model = make_model("MLP-5", K)
    program = make_build_program(
        model, optax.adam(LR), n=n, d_nav=d_nav, n_categories=K,
        kmeans_train_points=kpts, epochs=EPOCHS, batch_size=1024,
        row_align=256, pad_rows=1000)
    jr = program(jnp.asarray(ds["data_nav"]), jnp.asarray(ds["data_search"]),
                 jax.random.PRNGKey(SEED))
    plan = build_plan(n, kmeans_train_points=kpts, epochs=EPOCHS,
                      batch_size=1024)
    tr = fused_build(
        torch.from_numpy(ds["data_nav"]), torch.from_numpy(ds["data_search"]),
        model_type="MLP-5", lr=LR, n_categories=K, kmeans_train_points=kpts,
        epochs=EPOCHS, batch_size=1024, row_align=256, pad_rows=1000,
        stage_inputs=_jax_stage_inputs(plan, model, d_nav))
    return jax.device_get(jr), tr


def test_kmeans_stage_matches(builds):
    jr, tr = builds
    np.testing.assert_allclose(tr.centroids.numpy(), np.asarray(jr.centroids),
                               atol=1e-5)


def test_training_stage_matches(builds):
    """Losses per epoch agree. The weights are held to 1e-5 over 20 steps in
    test_torch_mlp.py; over these 57 steps Adam's normalized update turns
    float32 rounding in near-zero gradients into lr-sized steps (the first
    step agrees to ~6e-7, measured step by step), so here the router is
    held by what it predicts (test_predict_stage_matches)."""
    jr, tr = builds
    np.testing.assert_allclose(tr.losses.detach().numpy(),
                               np.asarray(jr.losses), atol=1e-3)


def test_predict_stage_matches(builds):
    jr, tr = builds
    pred = tr.pred_categories.numpy()
    assert pred.dtype == np.int32
    assert (pred == np.asarray(jr.pred_categories)).mean() >= 0.999


def test_store_stage_matches(builds, synthetic_small):
    """Stage 4 of the port on the JAX build's predictions gives the JAX
    build's store; on its own predictions, a consistent store."""
    jr, tr = builds
    data = l2_normalize(torch.from_numpy(synthetic_small["data_search"]))
    data_sorted, ids_sorted, offsets, counts, pad_rows = layout_store(
        torch.from_numpy(np.array(jr.pred_categories)), data, K, 1000, 256)
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(jr.offsets))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jr.counts))
    np.testing.assert_array_equal(ids_sorted.numpy(),
                                  np.asarray(jr.ids_sorted))
    np.testing.assert_allclose(data_sorted.numpy(),
                               np.asarray(jr.data_sorted), atol=1e-6)
    assert tr.data_sorted.shape == jr.data_sorted.shape
    pred = tr.pred_categories.numpy()
    np.testing.assert_array_equal(tr.counts.numpy(),
                                  np.bincount(pred, minlength=K))
    ids = tr.ids_sorted.numpy()
    for b in range(K):
        lo, cnt = int(tr.offsets[b]), int(tr.counts[b])
        assert lo % 256 == 0
        np.testing.assert_array_equal(ids[lo:lo + cnt],
                                      np.where(pred == b)[0])


def test_seeded_build_is_deterministic(synthetic_small):
    ds = synthetic_small
    x = torch.from_numpy(ds["data_nav"][:3000])
    s = torch.from_numpy(ds["data_search"][:3000])
    kw = dict(model_type="MLP-6", lr=LR, n_categories=8, epochs=2,
              batch_size=256, kmeans_iters=5, seed=5)
    a, b = fused_build(x, s, **kw), fused_build(x, s, **kw)
    assert torch.equal(a.pred_categories, b.pred_categories)
    assert torch.equal(a.ids_sorted, b.ids_sorted)
    assert a.losses.shape == (2,)
