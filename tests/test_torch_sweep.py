"""tpulmi_torch.sweep, models.train_lr_sweep and the evaluation leftovers
against the JAX package: the sweep on tiny data and its crash-resume, the
sweep CSV read by either package, `train_lr_sweep` fed the JAX draws
(losses and parameters within 1e-5 over 14 steps), the stacked training's
behaviour at full length, `plot_results`, `write_ground_truth` and
`trace`."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulmi.sweep as jsweep
import tpulmi_torch.sweep as tsweep
from tpulmi.models.mlp import make_model as jax_make_model
from tpulmi.models.train import train_lr_sweep as jax_train_lr_sweep
from tpulmi.models.train import train_plan
from tpulmi_torch.convert import mlp_from_flax, mlp_state_from_flax
from tpulmi_torch.data import synthetic_dataset
from tpulmi_torch.evaluate import (EvalRow, evaluate_file, plot_results,
                                   write_ground_truth)
from tpulmi_torch.models import MLP, StackedMLP, train_lr_sweep
from tpulmi_torch.models.train import BucketClassifier
from tpulmi_torch.utils.profiling import trace

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    return synthetic_dataset(n=5000, n_queries=50, d_nav=16, d_search=64,
                             n_clusters=8, seed=3)


def _args(ds):
    return (ds["data_nav"], ds["queries_nav"], ds["data_search"],
            ds["queries_search"])


def test_run_sweep_tiny(small, tmp_path):
    grid = tsweep.SweepGrid(lrs=(0.003,), model_types=("MLP",), epochs=(4,),
                            n_categories=(8,), buckets_perc=(25, 50))
    results = tsweep.run_sweep(*_args(small), grid=grid, device="cpu")
    assert [r.n_buckets for r in results] == [2, 4]
    by_buckets = {r.n_buckets: r.recall for r in results}
    assert by_buckets[4] >= by_buckets[2] - 0.05 and by_buckets[4] > 0.8
    assert all(r.build_s > 0 and r.search_s > 0 for r in results)
    path = tmp_path / "sweep.csv"
    tsweep.results_to_csv(results, str(path))
    lines = path.read_text().strip().splitlines()
    assert len(lines) == 3 and lines[0].startswith("lr,")
    # the JAX package's writer gives the same file for the same rows
    jpath = tmp_path / "jax.csv"
    jsweep.results_to_csv([jsweep.SweepResult(**vars(r)) for r in results],
                          str(jpath))
    assert jpath.read_text() == path.read_text()


def test_sweep_crash_resume(small, tmp_path):
    """A sweep interrupted after its first combination resumes from its
    CSV: one new row, and the file then covers the grid."""
    path = str(tmp_path / "sweep.csv")
    kw = dict(k=5, resume_path=path, device="cpu")
    partial = tsweep.SweepGrid(lrs=(0.003,), epochs=(3,), n_categories=(8,),
                               buckets_perc=(30,))
    tsweep.run_sweep(*_args(small), grid=partial, **kw)
    assert len(tsweep._load_done(path)) == 1
    grid = tsweep.SweepGrid(lrs=(0.003, 0.01), epochs=(3,),
                            n_categories=(8,), buckets_perc=(30,))
    results = tsweep.run_sweep(*_args(small), grid=grid, **kw)
    assert len(results) == 1 and results[0].lr == 0.01
    assert len(tsweep._load_done(path)) == 2
    assert tsweep._load_done(path) == jsweep._load_done(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sweep_csv_read_by_either_package(tmp_path, writer):
    rows = [(0.003, "MLP-5", 12, 122, 2, 1.5, 0.25, 0.95),
            (0.009, "MLP", 4, 8, 4, 0.5, 0.125, 0.8)]
    path = str(tmp_path / "sweep.csv")
    mod = jsweep if writer == "jax" else tsweep
    mod.results_to_csv([mod.SweepResult(*r) for r in rows], path)
    want = {(r[0], r[1], r[2], r[3], r[4]) for r in rows}
    assert tsweep._load_done(path) == jsweep._load_done(path) == want
    with open(path, newline="") as f:
        assert next(csv.reader(f)) == tsweep.CSV_HEADER


def _lr_problem(n=2000, d=12, c=6, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(c, d)).astype(np.float32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    X = centers[labels] + 0.05 * rng.normal(size=(n, d)).astype(np.float32)
    return X, labels


def _jax_draws(model, n, d, n_lrs, epochs, batch, seed, cap):
    """The draws of `tpulmi.models.train.train_lr_sweep`: inits from
    split(PRNGKey(seed), L), each epoch's permutation from
    split(PRNGKey(seed + 1), epochs)."""
    ep, spe, _ = train_plan(n, epochs, batch, cap)
    ikeys = jax.random.split(jax.random.PRNGKey(seed), n_lrs)
    inits = [mlp_from_flax(jax.device_get(
        model.init(k, jnp.zeros((1, d)))["params"])) for k in ikeys]
    ekeys = jax.random.split(jax.random.PRNGKey(seed + 1), ep)
    batches = [torch.from_numpy(np.asarray(
        jax.random.permutation(k, n)[:spe * batch]).reshape(spe, batch)
        .astype(np.int64)) for k in ekeys]
    return inits, batches


def test_train_lr_sweep_matches_jax_on_its_draws():
    """Fed the JAX program's inits and batches, every learning rate's
    epoch losses and final parameters are within 1e-5 of JAX's (14 steps:
    max_train_steps=20 truncated to 2 epochs of 7)."""
    X, y = _lr_problem()
    c = int(y.max()) + 1
    model = jax_make_model("MLP-5", n_classes=c)
    lrs = (0.0003, 0.001, 0.003)
    kw = dict(epochs=6, batch_size=256, seed=7, max_train_steps=20)
    jparams, jlosses = jax_train_lr_sweep(model, X, y, lrs, **kw)
    inits, batches = _jax_draws(model, len(X), X.shape[1], len(lrs),
                                6, 256, 7, 20)
    stacked, losses = train_lr_sweep("MLP-5", X, y, lrs, device="cpu",
                                     init_models=inits, batches=batches,
                                     **kw)
    assert isinstance(stacked, StackedMLP) and losses.shape == (3, 2)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               atol=1e-5)
    jparams = jax.device_get(jparams)
    for i in range(len(lrs)):
        want = mlp_state_from_flax(jax.tree_util.tree_map(lambda l: l[i],
                                                          jparams))
        for j in range(len(stacked.weights)):
            np.testing.assert_allclose(
                stacked.weights[j][i].detach().numpy(),
                want[f"layers.{j}.weight"].numpy(), atol=1e-5)
            np.testing.assert_allclose(
                stacked.biases[j][i].detach().numpy(),
                want[f"layers.{j}.bias"].numpy(), atol=1e-5)


def test_train_lr_sweep_learns():
    """At full length (tests/test_mlp.py's case): every learning rate's
    loss falls, the trajectories differ, the stack's leading axis is the
    learning rates', and the faster one fits."""
    X, y = _lr_problem()
    stacked, losses = train_lr_sweep("MLP-5", X, y, (0.0003, 0.003),
                                     epochs=6, batch_size=256, seed=7,
                                     device="cpu")
    losses = losses.numpy()
    assert losses.shape == (2, 6)
    assert (losses[:, -1] < losses[:, 0]).all()
    assert abs(losses[0, -1] - losses[1, -1]) > 1e-4
    for p in stacked.parameters():
        assert p.shape[0] == 2
    with torch.no_grad():
        logits = stacked(torch.from_numpy(X))
    assert logits.shape == (2, len(X), int(y.max()) + 1)
    assert (logits[1].argmax(1).numpy() == y).mean() > 0.9
    # an MLP given as the model: its architecture, the same draws
    template = MLP(X.shape[1], (256, 128), int(y.max()) + 1)
    again, losses2 = train_lr_sweep(template, X, y, (0.0003, 0.003),
                                    epochs=6, batch_size=256, seed=7,
                                    device="cpu")
    np.testing.assert_array_equal(losses2.numpy(), losses)


def test_train_lr_sweep_equals_single_classifier():
    """One learning rate of the stack, fed a classifier's start and
    batches, follows `BucketClassifier.train` (torch.optim.Adam) within
    1e-5."""
    X, y = _lr_problem(seed=1)
    c = int(y.max()) + 1
    clf = BucketClassifier(X.shape[1], c, lr=0.001, model_type="MLP-5",
                           seed=5, device="cpu")
    init = MLP(X.shape[1], (256, 128), c)
    init.load_state_dict(clf.model.state_dict())
    gen = torch.Generator().manual_seed(9)
    batches = [torch.randperm(len(X), generator=gen)[:20 * 64].reshape(20, 64)]
    stacked, losses = train_lr_sweep(
        "MLP-5", X, y, (0.003, 0.001), device="cpu",
        init_models=[init, init], batches=batches)
    want = clf.train(X, y, batches=batches)
    np.testing.assert_allclose(float(losses[1, 0]), float(want[0]),
                               atol=1e-5)
    for j, layer in enumerate(clf.model.layers):
        np.testing.assert_allclose(stacked.weights[j][1].detach().numpy(),
                                   layer.weight.detach().numpy(), atol=1e-5)


def test_plot_results(tmp_path):
    pytest.importorskip("matplotlib")
    rows = [EvalRow("A", "p1", "d", "s", 1.0, 0.5, 0.91, 2000.0),
            EvalRow("A", "p2", "d", "s", 1.0, 0.2, 0.85, 5000.0)]
    out = tmp_path / "pareto.png"
    plot_results(rows, str(out))
    assert out.exists() and out.stat().st_size > 1000
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_write_ground_truth_round_trip(tmp_path):
    """A ground-truth file the port writes is the JAX writer's byte for
    byte in content, and `evaluate_file` scores a result against it."""
    from tpulmi.evaluate import write_ground_truth as jax_write
    from tpulmi_torch.data import store_results

    rng = np.random.default_rng(2)
    knns = rng.integers(1, 500, size=(30, 10)).astype(np.int64)
    dists = np.sort(rng.random((30, 10)).astype(np.float32), axis=1)
    gt = str(tmp_path / "gt" / "gt.h5")
    write_ground_truth(gt, dists, knns)
    jax_write(str(tmp_path / "jgt.h5"), dists, knns)
    import h5py

    with h5py.File(gt, "r") as f, h5py.File(tmp_path / "jgt.h5", "r") as g:
        assert set(f.keys()) == set(g.keys()) == {"knns", "dists"}
        for key in f:
            assert f[key].dtype == g[key].dtype
            np.testing.assert_array_equal(f[key][:], g[key][:])
    res = knns.copy()
    res[:, 5:] = 999                       # half of each row found
    path = str(tmp_path / "res.h5")
    store_results(path, "Learned-index", "d", dists, res, 1.0, 0.5, "p", "s")
    row = evaluate_file(path, gt, k=10)
    assert row.recall == 0.5 and row.qps == 60.0


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones((64, 64))
    with trace(str(tmp_path), device="cpu"):
        torch.mm(x, x)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)
