"""The 16-group hierarchy over a packed int4 host store against
tpulmi.hierarchical on the CPU: bench_40m.py's router shape (16 outer
groups) at a small size, 16 groups x 4 buckets over 8000 rows of
`synthetic_small`.

One JAX build serves the module: `build_with_host_store(store_dtype=
"int4")`. Its router is carried into the port (`convert.
joint_router_from_flax`), and the port lays out its own int4 host store
from the JAX build's pred (`layout_host_store`, the numpy quantizer of a
CPU index): ids, offsets, counts, codes and scales equal to the bit.

Both indexes are then searched at 8 of 64 probes and the rerank depths of
bench_20m.py's ladder (30, 60, 100), with the exact host rerank:

- float queries: the JAX package's CPU backend scores a quantized store
  with float32 queries whatever `int8_queries` says, and so does the port
  with ``int8_queries=False``: ids equal, distances within 1e-5;
- int8 queries, which the port quantizes (as the JAX package's TPU kernel
  does): the candidate cut sees other scores, so a query's ten ids may
  differ where a true neighbour lies within the int8 query noise of the
  cut. At most 2% of the queries may differ, on each of those rows the
  two lists' exact distances agree rank by rank within 5e-3, and recall@10
  is within 0.01 of the JAX package's. Measured here: no row differs at
  any of the three depths (the candidate lists are deep enough that the
  rerank sees the same ten), recall@10 0.9845 for both packages.
"""

import jax
import numpy as np
import pytest
import torch

from tpulmi.hierarchical import HierarchicalConfig as JaxHierConfig
from tpulmi.hierarchical import HierarchicalIndex as JaxHierIndex
from tpulmi.utils.config import IndexConfig as JaxIndexConfig
from tpulmi.utils.config import SearchConfig as JaxSearchConfig
from tpulmi_torch import HierarchicalConfig, HierarchicalIndex, IndexConfig
from tpulmi_torch import SearchConfig
from tpulmi_torch.convert import joint_router_from_flax, store_from_arrays
from tpulmi_torch.evaluate import recall_at_k
from tpulmi_torch.hierarchical import JointRouterClassifier
from tpulmi_torch.hoststore import layout_host_store
from tpulmi_torch.index import BuiltIndex
from tpulmi_torch.ops.distance import exact_knn

torch.set_num_threads(1)

N_ROWS, G, C, PROBES = 8000, 16, 4, 8
INNER = dict(n_categories=C, epochs=3, lr=0.003, model_type="MLP-5",
             row_align=1)
HIER = dict(n_groups=G, outer_epochs=3, outer_lr=0.003, calibrate_budget=0)
DEPTHS = (30, 60, 100)
ROWS_DIFFER_MAX = 0.02      # of the queries, with int8 queries
DIST_NOISE = 5e-3           # int8 query codes: ~1/127 of a unit norm
RECALL_TOL = 0.01


@pytest.fixture(scope="module")
def ds(synthetic_small):
    return {k: (np.asarray(v[:N_ROWS], np.float32) if k.startswith("data")
                else v) for k, v in synthetic_small.items()}


@pytest.fixture(scope="module")
def jax_int4(ds):
    hi = JaxHierIndex(JaxHierConfig(inner=JaxIndexConfig(**INNER), **HIER))
    pred, _ = hi.build_with_host_store(ds["data_nav"], ds["data_search"],
                                       normalized=True, store_dtype="int4")
    return hi, np.asarray(pred)


@pytest.fixture(scope="module")
def port_int4(jax_int4, ds):
    """A port index with the JAX router and its own int4 host layout of
    the JAX build's pred; returns (index, its host arrays)."""
    jh, pred = jax_int4
    b = jh.built
    router = joint_router_from_flax(jax.device_get(b.classifier.params),
                                    "MLP-5", "MLP-5", G, C)
    router.outer_weight = b.classifier.model.outer_weight
    router.mass_temp = b.classifier.model.mass_temp
    arrays = layout_host_store(pred, ds["data_search"], G * C, row_align=1,
                               store_dtype="int4", normalized=True,
                               device="cpu")
    store = store_from_arrays(arrays.data_sorted, arrays.ids_sorted,
                              arrays.offsets, arrays.counts, arrays.n,
                              arrays.pad_rows, arrays.row_align,
                              device="cpu", scales=arrays.scales,
                              quant_bits=4)
    hi = HierarchicalIndex(HierarchicalConfig(inner=IndexConfig(**INNER),
                                              **HIER), device="cpu")
    hi._set_built(BuiltIndex(
        torch.from_numpy(np.array(b.centroids)),
        JointRouterClassifier(router, b.classifier.input_dim,
                              b.classifier.model_type), store,
        torch.from_numpy(pred), hi.config, int(arrays.counts.max())))
    hi.attach_host_corpus(ds["data_search"], normalized=True)
    return hi, arrays


@pytest.fixture(scope="module")
def oracle(ds):
    d, i = exact_knn(torch.from_numpy(ds["queries_search"]),
                     torch.from_numpy(ds["data_search"]), 10)
    return i.numpy()


def _search(jh, th, ds, depth, int8q):
    q = (ds["queries_nav"], ds["queries_search"])
    jd, ji = jh.search(*q, n_buckets=PROBES, k=10,
                       search_config=JaxSearchConfig(
                           n_buckets=PROBES, k=10, compute_dtype=None,
                           backend="xla", int8_queries=int8q,
                           rerank_extra=depth))
    td, ti = th.search(*q, n_buckets=PROBES, k=10,
                       search_config=SearchConfig(
                           n_buckets=PROBES, k=10, compute_dtype=None,
                           int8_queries=int8q, rerank_extra=depth))
    return np.asarray(jd), np.asarray(ji), td, ti


def test_layout_from_the_same_pred_equals_jax(jax_int4, port_int4):
    """16 x 4 buckets of packed int4 codes: the port's host layout of the
    JAX build's pred is the JAX build's store, to the bit."""
    jh, _ = jax_int4
    _, arrays = port_int4
    s = jh.built.store
    assert arrays.quant_bits == 4 and s.n_categories == G * C
    for name in ("data_sorted", "ids_sorted", "offsets", "counts",
                 "scales"):
        np.testing.assert_array_equal(getattr(arrays, name),
                                      np.asarray(getattr(s, name)), name)
    assert (arrays.n, arrays.pad_rows, arrays.row_align) == (
        s.n, s.pad_rows, s.row_align)


@pytest.mark.parametrize("depth", DEPTHS)
def test_float_queries_equal_jax(jax_int4, port_int4, ds, oracle, depth):
    jd, ji, td, ti = _search(jax_int4[0], port_int4[0], ds, depth, False)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, atol=1e-5)
    assert recall_at_k(ti - 1, oracle, 10) == recall_at_k(ji - 1, oracle, 10)


@pytest.mark.parametrize("depth", DEPTHS)
def test_int8_queries_equal_jax_but_near_ties(jax_int4, port_int4, ds,
                                              oracle, depth):
    jd, ji, td, ti = _search(jax_int4[0], port_int4[0], ds, depth, True)
    same = np.array([set(a) == set(b) for a, b in zip(ti, ji)])
    assert (~same).mean() <= ROWS_DIFFER_MAX, (~same).sum()
    # on the rows that differ, both lists are exact distances of rows near
    # the cut: rank by rank within the int8 query noise
    np.testing.assert_allclose(td[~same], jd[~same], atol=DIST_NOISE)
    np.testing.assert_allclose(td[same], jd[same], atol=1e-5)
    rec_t = recall_at_k(ti - 1, oracle, 10)
    rec_j = recall_at_k(ji - 1, oracle, 10)
    assert abs(rec_t - rec_j) <= RECALL_TOL and rec_t > 0.8, (rec_t, rec_j)
