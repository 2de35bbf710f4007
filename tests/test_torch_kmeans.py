"""tpulmi_torch.ops.kmeans against tpulmi.ops.kmeans from the same initial
centroids."""

import importlib

import numpy as np
import pytest
import torch

from tpulmi_torch.ops import kmeans as tk

# tpulmi.ops re-exports the function `kmeans` under the module's name
jk = importlib.import_module("tpulmi.ops.kmeans")
torch.set_num_threads(1)


def _blobs(rng, n=2000, d=16, k=8):
    centers = rng.normal(size=(k, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, k, size=n)] + rng.normal(
        size=(n, d)).astype(np.float32)
    return x


@pytest.mark.parametrize("iters", [1, 10])
def test_lloyd_matches_jax(rng, iters):
    x = _blobs(rng)
    init = x[rng.choice(len(x), 8, replace=False)]
    want = np.asarray(jk._lloyd(x, init, 8, iters))
    got = tk._lloyd(torch.from_numpy(x), torch.from_numpy(init), 8,
                    iters).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_lloyd_keeps_empty_cluster(rng):
    x = _blobs(rng, n=300)
    init = np.concatenate([x[:3], np.full((1, 16), 1e3, np.float32)])
    want = np.asarray(jk._lloyd(x, init, 4, 3))
    got = tk._lloyd(torch.from_numpy(x), torch.from_numpy(init), 4,
                    3).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[3], init[3])


def test_assign_matches_jax(rng):
    x = _blobs(rng, n=3000)
    c = _blobs(rng, n=8)
    want = np.asarray(jk.kmeans_assign(x, c, chunk=1024))
    got = tk.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c),
                           chunk=1024)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 1])
def test_kmeans_fallback_single_cluster(n):
    x = np.ones((n, 4), np.float32)
    jc, jl = jk.kmeans(x, 5)
    tc, tl = tk.kmeans(torch.from_numpy(x), 5)
    assert jc is None and tc is None
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_kmeans_fallback_fewer_rows_than_clusters(rng):
    x = _blobs(rng, n=23)
    jc, jl = jk.kmeans(x, 50, iters=5)
    tc, tl = tk.kmeans(torch.from_numpy(x), 50, iters=5)
    assert tc.shape == jc.shape == (4, 16)    # max(23 // 5, 2)
    assert tl.shape == (23,) and int(tl.max()) < 4


def test_kmeans_recovers_blobs(rng):
    x = _blobs(rng, n=4000, k=6)
    c, labels = tk.kmeans(torch.from_numpy(x), 6, iters=25,
                          max_points_per_centroid=100)
    assert c.shape == (6, 16) and labels.shape == (4000,)
    # every point sits nearer its own centroid than any other
    d = ((x[:, None, :] - c.numpy()[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(d.argmin(1), labels.numpy())
