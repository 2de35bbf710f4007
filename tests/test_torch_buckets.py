"""tpulmi_torch.buckets against tpulmi.buckets for the same labels."""

import numpy as np
import pytest
import torch

from tpulmi.buckets import build_bucket_store as jax_store
from tpulmi_torch.buckets import bucket_stats, build_bucket_store

torch.set_num_threads(1)


@pytest.mark.parametrize("row_align", [1, 256])
@pytest.mark.parametrize("n_cat", [5, 17])
def test_store_equals_jax(rng, row_align, n_cat):
    n, d = 1500, 24
    data = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, n_cat, size=n).astype(np.int32)
    labels[labels == 2] = 3        # an empty bucket
    js = jax_store(labels, data, n_cat, pad_rows=300, row_align=row_align)
    ts = build_bucket_store(torch.from_numpy(labels), torch.from_numpy(data),
                            n_cat, pad_rows=300, row_align=row_align)
    np.testing.assert_array_equal(ts.offsets.numpy(), np.asarray(js.offsets))
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    np.testing.assert_array_equal(ts.ids_sorted.numpy(),
                                  np.asarray(js.ids_sorted))
    np.testing.assert_array_equal(ts.data_sorted.numpy(),
                                  np.asarray(js.data_sorted))
    assert (ts.n, ts.pad_rows, ts.row_align) == (js.n, js.pad_rows,
                                                 js.row_align)
    assert ts.n_categories == n_cat and ts.dim == d
    counts = np.bincount(labels, minlength=n_cat)
    assert bucket_stats(ts) == (counts.max(), counts.min(), counts.mean())


def test_bf16_copy_is_made_once(rng):
    data = rng.normal(size=(100, 16)).astype(np.float32)
    labels = rng.integers(0, 4, size=100)
    ts = build_bucket_store(labels, torch.from_numpy(data), 4)
    a = ts.data_as(torch.bfloat16)
    assert a is ts.data_as(torch.bfloat16)
    assert ts.data_as(torch.float32) is ts.data_sorted
    np.testing.assert_array_equal(a.float().numpy(),
                                  ts.data_sorted.bfloat16().float().numpy())
