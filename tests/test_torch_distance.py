"""tpulmi_torch.ops.distance against tpulmi.ops.distance on the same inputs."""

import numpy as np
import pytest
import torch

from tpulmi.ops import distance as jd
from tpulmi_torch.ops import distance as td

torch.set_num_threads(1)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("n", [500, 3000])
def test_exact_knn_matches_jax(rng, normalized, n):
    data = rng.normal(size=(n, 48)).astype(np.float32)
    queries = rng.normal(size=(37, 48)).astype(np.float32)
    if normalized:
        data = data / np.linalg.norm(data, axis=1, keepdims=True)
        queries = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    jdist, jids = jd.exact_knn(queries, data, k=10, chunk=1024,
                               normalized=normalized)
    tdist, tids = td.exact_knn(torch.from_numpy(queries),
                               torch.from_numpy(data), k=10, chunk=1024,
                               normalized=normalized)
    np.testing.assert_allclose(tdist.numpy(), np.asarray(jdist), atol=1e-5)
    for a, b in zip(tids.numpy(), np.asarray(jids)):
        assert set(a.tolist()) == set(b.tolist())
    # ascending, 0-based
    assert (np.diff(tdist.numpy(), axis=1) >= 0).all()
    assert tids.min() >= 0 and tids.max() < n


@pytest.mark.parametrize("normalized", [True, False])
def test_pairwise_cosine_matches_jax(rng, normalized):
    x = rng.normal(size=(20, 64)).astype(np.float32)
    y = rng.normal(size=(30, 64)).astype(np.float32)
    want = np.asarray(jd.pairwise_cosine(x, y, normalized=normalized))
    got = td.pairwise_cosine(torch.from_numpy(x), torch.from_numpy(y),
                             normalized=normalized).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_l2_normalize_and_sentinel(rng):
    x = rng.normal(size=(10, 16)).astype(np.float32)
    x[3] = 0.0
    np.testing.assert_allclose(td.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jd.l2_normalize(x)), atol=1e-6)
    assert td.SENTINEL_DIST == jd.SENTINEL_DIST == 10000.0
