"""The CUDA kernels of tpulmi_torch against their plain versions, on a
card. Every test here carries the `cuda` marker and skips without one.

This file imports nothing of the JAX package, so that it also runs where
only torch is installed:

    python -m pytest tests/test_torch_kernels_card.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from tpulmi_torch.buckets import build_bucket_store
from tpulmi_torch.ops.probe_topk import (group_slots, launch_counts,
                                         probe_topk, probe_topk_int8q,
                                         probe_topk_int8q_plain,
                                         probe_topk_plain, probe_topk_quant,
                                         probe_topk_quant_plain)
from tpulmi_torch.ops.quantize import quantize_rows, quantize_store

pytestmark = pytest.mark.cuda

N, C, Q, P = 20000, 13, 500, 3


def _apart(d, tol):
    gap = np.full(d.shape, np.inf)
    step = np.diff(d, axis=1)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    return gap > tol


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _setup(rng, d, dev):
    def unit(n):
        x = rng.normal(size=(n, d)).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))

    labels = rng.integers(0, C, size=N).astype(np.int32)
    labels[labels == 4] = 5                      # an empty bucket
    labels[:N - 3][labels[:N - 3] == 7] = 8      # a bucket of < k rows
    store = build_bucket_store(torch.from_numpy(labels).to(dev),
                               unit(N).to(dev), C, row_align=8)
    probes = torch.from_numpy(rng.integers(0, C + 1, (Q, P)).astype(
        np.int32)).to(dev)                       # id C: a dumped slot
    return store, unit(Q).to(dev), group_slots(probes, store.offsets,
                                               store.counts), probes.numel()


def _check(kern, plain, lay, n_slots, tol):
    torch.cuda.synchronize()
    live = lay.slot_of_row < n_slots
    (kd, ki), (pd, pi) = ((t[live].cpu() for t in pair)
                          for pair in (kern, plain))
    torch.testing.assert_close(kd, pd, atol=tol, rtol=0)
    assert torch.equal(ki < 0, pi < 0)
    assert (kd[ki < 0] == 10000.0).all()
    apart = torch.from_numpy(_apart(pd.numpy(), tol))
    apart[:, -1] = False       # the k-th place may tie with the next row
    assert torch.equal(ki[apart], pi[apart])


@pytest.mark.parametrize("d", [256, 40])
def test_full_precision_kernel(rng, card, d):
    store, q, lay, n_slots = _setup(rng, d, card)
    before = launch_counts()["probe_topk"]
    for dtype, k in ((torch.bfloat16, 1), (torch.bfloat16, 10),
                     (torch.bfloat16, 100), (torch.float16, 10),
                     (torch.float32, 10)):
        args = (q.to(dtype), lay.qidx, store.data_sorted.to(dtype),
                lay.blocks, k)
        _check(probe_topk(*args), probe_topk_plain(*args), lay, n_slots,
               1e-4)
    assert launch_counts()["probe_topk"] == before + 5


# d = 96: half the width is no multiple of a staged slice
@pytest.mark.parametrize("d", [256, 96])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_kernels(rng, card, bits, d):
    full, q, lay, n_slots = _setup(rng, d, card)
    store = quantize_store(full, bits=bits)
    assert store.data_sorted.is_cuda and store.scales.is_cuda
    before = launch_counts()
    tail = (lay.qidx, store.data_sorted, store.scales, lay.blocks)
    for dtype, k in ((torch.bfloat16, 10), (torch.bfloat16, 100),
                     (torch.float16, 40), (torch.float32, 10)):
        args = (q.to(dtype), *tail, k, bits)
        _check(probe_topk_quant(*args), probe_topk_quant_plain(*args), lay,
               n_slots, 1e-4)
    qc, qs = quantize_rows(q)
    for k in (10, 100):
        args = (qc, qs, *tail, k, bits)
        # exact integer sums on both sides
        _check(probe_topk_int8q(*args), probe_topk_int8q_plain(*args), lay,
               n_slots, 1e-5)
    after = launch_counts()
    assert after[f"probe_topk_quant_int{bits}"] == (
        before[f"probe_topk_quant_int{bits}"] + 4)
    assert after[f"probe_topk_int8q_int{bits}"] == (
        before[f"probe_topk_int8q_int{bits}"] + 2)


def test_kernels_refuse_what_they_do_not_take(rng, card):
    """On CUDA tensors a wrapper launches or raises; it never falls back."""
    full, q, lay, _ = _setup(rng, 40, card)       # 40 % 16 != 0
    store = quantize_store(full, bits=8)
    before = launch_counts()
    with pytest.raises(ValueError, match="d % 16"):
        probe_topk_quant(q.bfloat16(), lay.qidx, store.data_sorted,
                         store.scales, lay.blocks, 10, 8)
    with pytest.raises(ValueError, match="queries of"):
        probe_topk_quant(q.double(), lay.qidx, store.data_sorted,
                         store.scales, lay.blocks, 10, 8)
    with pytest.raises(ValueError, match="several devices"):
        probe_topk_quant(q.bfloat16().cpu(), lay.qidx, store.data_sorted,
                         store.scales, lay.blocks, 10, 8)
    assert launch_counts() == before
