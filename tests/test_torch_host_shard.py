"""The host layout landed shard by shard (`shard_store_from_host`) and the
mesh builds of tpulmi_torch, on a mesh of CPU entries: the cases of
tests/test_host_shard.py and of
tests/test_hierarchical.py::test_hierarchical_sharded_by_group, with the
shards held to the JAX package's `shard_store` of the same layout."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_sharded import cpu_mesh, equal_but_ties
from tpulmi.buckets import BucketStore as JaxBucketStore
from tpulmi.parallel.sharded import shard_store as jax_shard_store
from tpulmi_torch import (HierarchicalConfig, HierarchicalIndex, IndexConfig,
                          LearnedIndex, SearchConfig)
from tpulmi_torch.buckets import BucketStore
from tpulmi_torch.hoststore import HostBF16, host_tensor, layout_host_store
from tpulmi_torch.ops.distance import exact_knn
from tpulmi_torch.parallel import shard_store, shard_store_from_host

torch.set_num_threads(1)

N_DEV = 4


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _jax_rows(a):
    """A host layout's rows as the JAX package holds them."""
    if isinstance(a, HostBF16):
        return np.asarray(a.bits).view(ml_dtypes.bfloat16)
    return np.asarray(a)


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16", "int8"])
def test_shard_from_host_matches_shard_store(rng, store_dtype):
    """shard_store_from_host (slabs of 256 rows: several and a ragged
    tail) gives shard_store's shards of the same layout, and the JAX
    package's shard_store's, to the bit; each shard holds rows_pad rows,
    never the whole store."""
    n, d, n_cat = 3000, 32, 10
    data = _unit(rng, n, d)
    pred = rng.integers(0, n_cat, size=n).astype(np.int32)
    arrays = layout_host_store(pred, data, n_cat, row_align=1,
                               store_dtype=store_dtype, normalized=True,
                               pad_rows=64)
    got = shard_store_from_host(arrays, cpu_mesh(N_DEV), slab_rows=256)
    scales = arrays.scales
    flat = BucketStore(
        data_sorted=host_tensor(arrays.data_sorted),
        ids_sorted=host_tensor(arrays.ids_sorted),
        offsets=host_tensor(arrays.offsets),
        counts=host_tensor(arrays.counts), n=arrays.n,
        pad_rows=arrays.pad_rows, row_align=arrays.row_align,
        scales=None if scales is None else host_tensor(scales),
        quant_bits=arrays.quant_bits)
    want = shard_store(flat, N_DEV)
    jwant = jax_shard_store(JaxBucketStore(
        data_sorted=jnp.asarray(_jax_rows(arrays.data_sorted)),
        ids_sorted=jnp.asarray(arrays.ids_sorted),
        offsets=jnp.asarray(arrays.offsets),
        counts=jnp.asarray(arrays.counts), n=arrays.n,
        pad_rows=arrays.pad_rows, row_align=arrays.row_align,
        scales=None if scales is None else jnp.asarray(scales)), N_DEV)
    assert (got.cat_pad, got.rows, got.quant_bits) == (
        want.cat_pad, want.rows, want.quant_bits) == (
        jwant.cat_pad, jwant.rows, jwant.quant_bits)
    np.testing.assert_array_equal(got.bucket_start, want.bucket_start)
    names = ["data_sorted", "ids_sorted", "offsets", "counts"]
    if scales is not None:
        names.append("scales")
    for name in names:
        a = torch.stack([getattr(st, name) for st in got.shards])
        b = torch.stack([getattr(st, name) for st in want.shards])
        assert torch.equal(a, b), name
        j = np.asarray(getattr(jwant, name))
        if a.dtype == torch.bfloat16:
            a, j = a.view(torch.int16), j.view(np.int16)
        np.testing.assert_array_equal(a.numpy(), j)
    assert len(got.shards) == N_DEV
    for st in got.shards:
        assert st.data_sorted.shape[0] == got.rows_pad < arrays.n


def _data(rng, n, q, d):
    return (_unit(rng, n, 16), _unit(rng, n, d), _unit(rng, q, 16),
            _unit(rng, q, d))


def test_host_store_mesh_build_matches_single_device(rng):
    """build_with_host_store(mesh=...) searches as the same build landed
    on one device; its flat store stays on the host."""
    nav, data, qn, qs = _data(rng, 4000, 32, 64)
    cfg = IndexConfig(n_categories=12, epochs=3, lr=0.003, batch_size=512,
                      row_align=1)
    scfg = SearchConfig(k=5, backend="xla", compute_dtype=None)
    li1 = LearnedIndex(cfg, device="cpu")
    li1.build_with_host_store(nav, data, normalized=True,
                              store_dtype="float32")
    d1, i1 = li1.search(qn, qs, n_buckets=4, k=5, search_config=scfg)
    li2 = LearnedIndex(cfg, device="cpu")
    li2.build_with_host_store(nav, data, normalized=True,
                              store_dtype="float32", mesh=cpu_mesh(N_DEV))
    assert li2._sharded is not None and li2._sharded[0].n_shards == N_DEV
    for backend in ("xla", "torch"):
        d2, i2 = li2.search(qn, qs, n_buckets=4, k=5, search_config=(
            SearchConfig(k=5, backend=backend, compute_dtype=None)))
        equal_but_ties(d2, i2, d1, i1)


def test_host_store_mesh_build_int8_rerank(rng):
    """An int8 mesh build: the shards' codes searched, then the host
    rerank: every returned distance is the exact one of its id."""
    nav, data, qn, qs = _data(rng, 3000, 24, 64)
    cfg = IndexConfig(n_categories=8, epochs=3, lr=0.003, batch_size=512,
                      row_align=1)
    li = LearnedIndex(cfg, device="cpu")
    li.build_with_host_store(nav, data, normalized=True, store_dtype="int8",
                             mesh=cpu_mesh(N_DEV))
    assert li._host_corpus is not None and li._sharded[0].is_quantized
    d, i = li.search(qn, qs, n_buckets=4, k=5,
                     search_config=SearchConfig(k=5, backend="xla"))
    exact = 1.0 - np.einsum("qkd,qd->qk", data[i - 1], qs)
    np.testing.assert_allclose(d, exact, atol=1e-5)


def test_hierarchical_mesh_build_group_per_shard(rng):
    """A hierarchical host build over 4 entries places one group (3 inner
    buckets) per shard; probing every global bucket, the sharded scan and
    merge give the exact oracle."""
    nav, data, qn, qs = _data(rng, 4000, 32, 48)
    cfg = HierarchicalConfig(
        n_groups=N_DEV, outer_epochs=3, calibrate_budget=0,
        inner=IndexConfig(n_categories=3, epochs=3, lr=0.003,
                          batch_size=512, row_align=1))
    hi = HierarchicalIndex(cfg, device="cpu")
    hi.build_with_host_store(nav, data, normalized=True,
                             store_dtype="float32", mesh=cpu_mesh(N_DEV))
    assert hi._sharded[0].cat_pad == 3
    d, i = hi.search(qn, qs, n_buckets=12, k=5, search_config=SearchConfig(
        k=5, backend="xla", compute_dtype="float32"))
    gt_d, gt = exact_knn(qs, data, k=5)
    equal_but_ties(d, i, gt_d, gt.numpy() + 1)


def test_hierarchical_sharded_by_group(rng):
    """A device-store hierarchical index sharded by group (4 groups of 8
    buckets: 8 buckets a shard) searches as its flat store; setting the
    outer weight drops the sharded programs."""
    nav, data, qn, qs = _data(rng, 4000, 48, 32)
    hi = HierarchicalIndex(HierarchicalConfig(
        n_groups=4, outer_epochs=3, calibrate_budget=0,
        inner=IndexConfig(n_categories=8, epochs=3, lr=0.003,
                          batch_size=512, row_align=1)), device="cpu")
    hi.build(nav, data)
    scfg = SearchConfig(k=10, compute_dtype=None)
    d0, i0 = hi.search(qn, qs, n_buckets=6, k=10, search_config=scfg)
    hi.shard(cpu_mesh(4))
    assert hi._sharded[0].cat_pad == 8
    d1, i1 = hi.search(qn, qs, n_buckets=6, k=10, search_config=scfg)
    equal_but_ties(d1, i1, d0, i0)
    assert hi._search_programs
    hi.set_outer_weight(0.5)
    assert not hi._search_programs
    d2, i2 = hi.search(qn, qs, n_groups=2, n_buckets=3, k=10,
                       search_config=scfg)
    hi.unshard()
    equal_but_ties(d2, i2, *hi.search(qn, qs, n_buckets=6, k=10,
                                      search_config=scfg))


def test_mesh_built_index_checkpoints_to_flat(rng, tmp_path):
    """A mesh-built index (its built.store the host layout) saves a flat
    checkpoint; the restored index searches flat with equal results, and
    unshard lands the host layout on the index's device."""
    nav, data, qn, qs = _data(rng, 3000, 24, 48)
    cfg = IndexConfig(n_categories=8, epochs=3, lr=0.003, batch_size=512,
                      row_align=1)
    scfg = SearchConfig(k=5, backend="xla", compute_dtype="float32")
    li = LearnedIndex(cfg, device="cpu")
    li.build_with_host_store(nav, data, normalized=True,
                             store_dtype="float32", mesh=cpu_mesh(N_DEV))
    d0, i0 = li.search(qn, qs, n_buckets=4, k=5, search_config=scfg)
    li.save(tmp_path / "ckpt")
    restored = LearnedIndex.load(tmp_path / "ckpt", device="cpu")
    assert restored._sharded is None
    equal_but_ties(*restored.search(qn, qs, n_buckets=4, k=5,
                                    search_config=scfg), d0, i0)
    li.unshard()
    equal_but_ties(*li.search(qn, qs, n_buckets=4, k=5, search_config=scfg),
                   d0, i0)
