"""The quantized-store probe of tpulmi_torch (the plain versions of the
int8 / packed-int4 kernel and of the int8 x int8 kernel) against the JAX
package's Pallas kernel in interpret mode, on a store quantized by the JAX
package and carried across by convert.store_from_arrays.

Shapes follow the JAX package's own tests of these kernel branches: the
interpret-mode kernel keeps its TPU constraints (mc % 1024 == 0 for the
scale tiles, d/2 % 128 == 0 for the packed width). The kernels themselves
are held against these plain versions on a card by
tests/test_torch_kernels_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulmi.buckets import build_bucket_store
from tpulmi.ops.pallas_topk import pallas_probe_search
from tpulmi.ops.quantize import quantize_store
from tpulmi_torch.convert import store_from_arrays
from tpulmi_torch.ops.probe_topk import (group_slots, launch_counts,
                                         probe_search, probe_topk_int8q,
                                         probe_topk_int8q_plain,
                                         probe_topk_quant,
                                         probe_topk_quant_plain)
from tpulmi_torch.ops.quantize import quantize_rows, unpack_int4

torch.set_num_threads(1)

MC, QC = 1024, 128
DIMS = {8: 128, 4: 256}


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _setup(rng, bits, n=9000, c=9, q=32, labels=None):
    d = DIMS[bits]
    data, queries = _unit(rng, n, d), _unit(rng, q, d)
    if labels is None:
        labels = rng.integers(0, c, size=n).astype(np.int32)
    js = quantize_store(
        build_bucket_store(labels, data, c, pad_rows=MC, row_align=MC),
        bits=bits)
    ts = store_from_arrays(
        np.asarray(js.data_sorted), np.asarray(js.ids_sorted),
        np.asarray(js.offsets), np.asarray(js.counts), js.n, js.pad_rows,
        js.row_align, device="cpu", scales=np.asarray(js.scales),
        quant_bits=bits)
    return data, queries, labels, js, ts


def _both(js, ts, probes, queries, int8q, k=10):
    max_bucket = int(np.asarray(js.counts).max())
    jd_, ji, jm = pallas_probe_search(
        jnp.asarray(probes), jnp.asarray(queries), js, k=k, qc=QC, mc=MC,
        max_chunks=max(-(-max_bucket // MC), 1), compute_dtype=jnp.float32,
        int8_queries=int8q, interpret=True)
    td, ti, tm = probe_search(
        torch.from_numpy(probes), torch.from_numpy(queries), ts, k=k,
        compute_dtype=torch.float32, int8_queries=int8q, backend="torch")
    assert int(tm) == int(jm)
    return (np.asarray(jd_), np.asarray(ji)), (td.numpy(), ti.numpy())


def _apart(d, tol):
    gap = np.full(d.shape, np.inf)
    step = np.diff(d, axis=1)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    return gap > tol


def _probes(rng, c, q, p):
    return np.stack([rng.permutation(c)[:p] for _ in range(q)]).astype(
        np.int32)


@pytest.mark.parametrize("n_probes", [1, 3])
@pytest.mark.parametrize("int8q", [False, True], ids=["f32q", "int8q"])
@pytest.mark.parametrize("bits", [8, 4])
def test_plain_matches_pallas(rng, bits, int8q, n_probes):
    """float32 queries: sums taken in another order, 1e-5. int8 queries:
    the integer dots are exact on both sides, but the kernel's raw scores
    are hundreds in magnitude before the query's scale brings them back,
    and one rounding there is 1e-4 / 127 afterwards: 1e-4 covers it."""
    _, queries, _, js, ts = _setup(rng, bits)
    probes = _probes(rng, ts.n_categories, queries.shape[0], n_probes)
    (jd_, ji), (td, ti) = _both(js, ts, probes, queries, int8q)
    tol = 1e-4 if int8q else 1e-5
    np.testing.assert_allclose(td, jd_, atol=tol)
    assert (ti == ji).mean() > 0.99
    apart = _apart(jd_, tol)
    np.testing.assert_array_equal(ti[apart], ji[apart])


@pytest.mark.parametrize("int8q", [False, True], ids=["f32q", "int8q"])
@pytest.mark.parametrize("bits", [8, 4])
def test_subk_sentinels_match_pallas(rng, bits, int8q):
    """Buckets smaller than k: the rest of the list is exactly
    (10000, -1), also after the int8 queries' rescale."""
    n, c, q = 40, 10, 8
    _, queries, labels, js, ts = _setup(rng, bits, n=n, c=c, q=q)
    probes = rng.integers(0, c, size=(q, 1)).astype(np.int32)
    (jd_, ji), (td, ti) = _both(js, ts, probes, queries, int8q)
    for i in range(q):
        cnt = int((labels == probes[i, 0]).sum())
        assert (ti[i, cnt:] == -1).all() and (td[i, cnt:] == 10000.0).all()
        assert (ti[i, :cnt] >= 0).all() and (td[i, :cnt] < 3.0).all()
    np.testing.assert_array_equal(ti == -1, ji == -1)
    np.testing.assert_allclose(td, jd_, atol=1e-4 if int8q else 1e-5)


@pytest.mark.parametrize("int8q", [False, True], ids=["f32q", "int8q"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dump_ids_match_pallas(rng, bits, int8q):
    _, queries, _, js, ts = _setup(rng, bits)
    c = ts.n_categories
    probes = _probes(rng, c, queries.shape[0], 4)
    drop = rng.random(probes.shape) < 0.5
    drop[:, 0] = False
    drop[0, :] = True
    probes = np.where(drop, c, probes).astype(np.int32)
    (jd_, ji), (td, ti) = _both(js, ts, probes, queries, int8q)
    np.testing.assert_allclose(td, jd_, atol=1e-4 if int8q else 1e-5)
    assert (ti == ji).mean() > 0.99
    assert (ti[0] == -1).all() and (td[0] == 10000.0).all()


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_scores_come_from_the_codes(rng, bits):
    """Every distance is 1 - q . dequantized row; the bf16-query variant
    rounds only the queries (the codes are exact in bfloat16)."""
    _, queries, _, js, ts = _setup(rng, bits, n=3000, c=5, q=16)
    probes = torch.from_numpy(_probes(rng, 5, 16, 2))
    lay = group_slots(probes, ts.offsets, ts.counts)
    codes = unpack_int4(ts.data_sorted) if bits == 4 else ts.data_sorted
    deq = codes.float() * (ts.scales / ts.q_levels)[:, None]
    live = lay.slot_of_row < probes.numel()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.from_numpy(queries).to(dtype)
        od, oi = probe_topk_quant_plain(q, lay.qidx, ts.data_sorted,
                                        ts.scales, lay.blocks, 10, bits)
        own = 1.0 - torch.einsum(
            "rd,rkd->rk", q[lay.qidx[live].long()].float(),
            deq[oi[live].long()])
        torch.testing.assert_close(od[live], own, atol=2e-6, rtol=0)
        assert (od[live][:, 1:] >= od[live][:, :-1]).all()


def test_int8q_ranks_without_the_query_scale(rng):
    """Scaling a query changes its codes' scale only: same ids, and the
    distances follow 1 - s * cos."""
    _, queries, _, js, ts = _setup(rng, 8, n=3000, c=5, q=16)
    probes = torch.from_numpy(_probes(rng, 5, 16, 2))
    lay = group_slots(probes, ts.offsets, ts.counts)
    q = torch.from_numpy(queries)
    outs = []
    for factor in (1.0, 4.0):
        qc, qs = quantize_rows(q * factor)
        outs.append(probe_topk_int8q_plain(qc, qs, lay.qidx, ts.data_sorted,
                                           ts.scales, lay.blocks, 10, 8))
    (d1, i1), (d4, i4) = outs
    assert torch.equal(i1, i4)
    live = i1 >= 0
    torch.testing.assert_close((1.0 - d4)[live], 4.0 * (1.0 - d1)[live],
                               atol=1e-5, rtol=0)
    assert (d4[~live] == 10000.0).all()


def test_wrappers_take_plain_versions_on_cpu(rng):
    _, queries, _, js, ts = _setup(rng, 4, n=3000, c=5, q=16)
    probes = torch.from_numpy(_probes(rng, 5, 16, 2))
    lay = group_slots(probes, ts.offsets, ts.counts)
    q = torch.from_numpy(queries).bfloat16()
    before = launch_counts()
    args = (lay.qidx, ts.data_sorted, ts.scales, lay.blocks, 10, 4)
    for x, y in zip(probe_topk_quant(q, *args),
                    probe_topk_quant_plain(q, *args)):
        assert torch.equal(x, y)
    qc, qs = quantize_rows(torch.from_numpy(queries))
    for x, y in zip(probe_topk_int8q(qc, qs, *args),
                    probe_topk_int8q_plain(qc, qs, *args)):
        assert torch.equal(x, y)
    assert launch_counts() == before      # nothing launched on the CPU
    assert set(before) == {"probe_topk", "probe_topk_quant_int8",
                           "probe_topk_quant_int4", "probe_topk_int8q_int8",
                           "probe_topk_int8q_int4", "probe_worklist",
                           "merge_items", "probe_pair", "probe_pool",
                           "probe_cluster"}
    with pytest.raises(ValueError, match="k <="):
        probe_topk_quant(q, lay.qidx, ts.data_sorted, ts.scales, lay.blocks,
                         129, 4)
    with pytest.raises(ValueError, match="bits"):
        probe_topk_quant(q, lay.qidx, ts.data_sorted, ts.scales, lay.blocks,
                         10, 2)
    with pytest.raises(ValueError, match="widths differ"):   # int8 width
        probe_topk_quant(q, lay.qidx, ts.data_sorted, ts.scales, lay.blocks,
                         10, 8)
    with pytest.raises(ValueError, match="int8 codes"):
        probe_topk_int8q(q, qs, *args)
    with pytest.raises(ValueError, match="scales"):
        probe_topk_quant(q, lay.qidx, ts.data_sorted, ts.scales[:-1],
                         lay.blocks, 10, 4)


def test_int8_queries_ignored_on_a_full_precision_store(rng):
    n, d, c = 2000, 64, 5
    data, queries = _unit(rng, n, d), _unit(rng, 16, d)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    js = build_bucket_store(labels, data, c)
    ts = store_from_arrays(np.asarray(js.data_sorted),
                           np.asarray(js.ids_sorted), np.asarray(js.offsets),
                           np.asarray(js.counts), js.n, js.pad_rows,
                           js.row_align, device="cpu")
    probes = torch.from_numpy(_probes(rng, c, 16, 2))
    a = probe_search(probes, torch.from_numpy(queries), ts, k=10,
                     compute_dtype=torch.float32, backend="torch")
    b = probe_search(probes, torch.from_numpy(queries), ts, k=10,
                     compute_dtype=torch.float32, backend="torch",
                     int8_queries=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
