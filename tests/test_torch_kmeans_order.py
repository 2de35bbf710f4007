"""Lloyd's update in a fixed order (tpulmi_torch/ops/kmeans.py::_lloyd_step):
each cluster's rows are summed as a one-hot matrix times the rows, where an
`index_add_` adds them with atomics on CUDA in no fixed order. Held against
the `index_add_` form it replaces, against tpulmi.ops.kmeans._lloyd, and
against itself: two runs agree to the bit. The card's side (two builds in
one process, and a build under torch.use_deterministic_algorithms) is in
tests/test_torch_kernels_card.py."""

import importlib

import numpy as np
import pytest
import torch

from tpulmi_torch.ops import kmeans as tk

# tpulmi.ops re-exports the function `kmeans` under the module's name
jk = importlib.import_module("tpulmi.ops.kmeans")
torch.set_num_threads(1)

# (rows, width, clusters): a test's size, the build's width at a small
# sample, and more clusters than the blobs fill (some stay empty)
SHAPES = [(2000, 16, 8), (3000, 96, 24), (500, 8, 40)]


def _blobs(seed, n, d, k):
    gen = np.random.default_rng(seed)
    centers = gen.normal(size=(k, d)).astype(np.float32) * 3
    x = centers[gen.integers(0, k, size=n)] + gen.normal(
        size=(n, d)).astype(np.float32)
    init = x[gen.choice(n, k, replace=False)]
    return torch.from_numpy(x), torch.from_numpy(init)


def _index_add_step(x, c):
    """The update this module used before: sums and counts by index_add_."""
    k = c.shape[0]
    labels = torch.argmin(tk._sq_dists(x, c), dim=1)
    counts = torch.zeros(k).index_add_(0, labels, torch.ones(x.shape[0]))
    sums = torch.zeros((k, x.shape[1])).index_add_(0, labels, x)
    new_c = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, new_c, c)


@pytest.mark.parametrize("n, d, k", SHAPES)
def test_fixed_order_step_equals_index_add(n, d, k):
    """One step and ten: the two sums differ only in their order, 1e-5."""
    x, c = _blobs(n + d, n, d, k)
    a = b = c
    for it in range(10):
        a, b = tk._lloyd_step(x, a), _index_add_step(x, b)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   err_msg=f"iteration {it}")


@pytest.mark.parametrize("n, d, k", SHAPES)
def test_fixed_order_lloyd_matches_jax(n, d, k):
    """25 iterations against the JAX package's segment_sum Lloyd, from the
    same initial centroids, within test_torch_kmeans.py's 1e-5; a cluster
    left empty keeps its initial centroid on both sides."""
    x, c = _blobs(7 * n + k, n, d, k)
    want = np.asarray(jk._lloyd(x.numpy(), c.numpy(), k, 25))
    got = tk._lloyd(x, c, k, 25).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("n, d, k", SHAPES)
def test_two_runs_are_equal_to_the_bit(n, d, k):
    x, c = _blobs(3 * n + d, n, d, k)
    a, b = tk._lloyd(x, c, k, 25), tk._lloyd(x.clone(), c.clone(), k, 25)
    assert torch.equal(a, b)
    assert a.dtype == torch.float32


def test_empty_cluster_keeps_its_centroid():
    x, c = _blobs(1, 300, 16, 3)
    far = torch.full((1, 16), 1e3)
    c = torch.cat([c, far])
    out = tk._lloyd_step(x, c)
    assert torch.equal(out[3], far[0])
    np.testing.assert_allclose(out.numpy(), _index_add_step(x, c).numpy(),
                               atol=1e-5)
