"""The rerank kernel (csrc/rerank_card.cu) against its plain version and the
host rerank, on a card. Every test here carries the `cuda` marker and skips
without one; the CPU half is tests/test_torch_rerank_card.py.

This file imports nothing of the JAX package, so that it also runs where
only torch is installed:

    python -m pytest tests/test_torch_rerank_card_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
from tpulmi_torch.hoststore import HostBF16
from tpulmi_torch.index import _float16_copy
from tpulmi_torch.ops import rerank_card as rc
from tpulmi_torch.utils import profiling

pytestmark = pytest.mark.cuda

BIG_N, D, Q, K = 1_000_000, 768, 10_000, 10


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _unit_rows(n, d, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, device=dev, generator=g)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _host_bf16(x: torch.Tensor) -> HostBF16:
    return HostBF16(x.to(torch.bfloat16).cpu().view(torch.int16).numpy()
                    .view(np.uint16))


@pytest.fixture(scope="module")
def big(card):
    """A bfloat16 host corpus of 1M unit rows of 768, its float16 copy on
    the card, 10k float32 queries near its rows (scaled: the rerank
    divides them by their norms)."""
    rows = _unit_rows(BIG_N, D, card, 1)
    corpus = _host_bf16(rows)
    pick = torch.randint(0, BIG_N, (Q,), device=card,
                         generator=torch.Generator(device=card).manual_seed(2))
    queries = (rows[pick] + 0.05 * _unit_rows(Q, D, card, 3)) * 1.7
    del rows
    return corpus, rc.float16_copy(corpus, card), queries


def _candidates(rng, n, q, k_eff):
    """Candidate lists: the first third of each row a run of neighbouring
    rows (close distances), the rest at random, with repeats and empty
    places."""
    ids = rng.integers(0, n, size=(q, k_eff)).astype(np.int32)
    base = rng.integers(0, n - k_eff, size=(q, 1))
    ids[:, :k_eff // 3] = base + np.arange(k_eff // 3)
    ids[::7, 3] = ids[::7, 1]
    ids[::11, -2:] = -1
    ids[5] = -1
    return ids


def _apart(d, tol):
    """Places whose distance is farther than `tol` from both neighbours'."""
    gap = np.full(d.shape, np.inf)
    step = np.diff(d, axis=1)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    return gap > tol


def _hold(got_d, got_i, full_d, full_i, k):
    """The kernel's (q, k) result against a full order (q, k_eff): ids
    equal at every place whose distance lies farther than 1e-5 from its
    neighbours' in the full order, max abs gap <= 1e-5, RMS <= 1e-6."""
    apart = _apart(full_d, 1e-5)[:, :k]
    assert (got_i[apart] == full_i[:, :k][apart]).all()
    gap = np.abs(got_d.astype(np.float64) - full_d[:, :k])
    assert gap.max() <= 1e-5
    assert np.sqrt(np.mean(gap ** 2)) <= 1e-6
    return int((got_i != full_i[:, :k]).any(axis=1).sum())


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("k_eff", [14, 20])
def test_kernel_against_plain_and_host(big, card, k_eff, normalized):
    """At the cells' shapes (q 10k, k_eff 14 and 20, d 768) over 1M rows:
    the kernel against the plain version on the card and against
    `_rerank_host` (float16 copy, the fused host pass)."""
    corpus, copy, queries = big
    ids = _candidates(np.random.default_rng(k_eff), BIG_N, Q, k_eff)
    ids_dev = torch.from_numpy(ids).to(card)
    before = rc.rerank_card.launches
    got_d, got_i = rc.rerank_card(copy, ids_dev, queries, K,
                                  normalized=normalized)
    torch.cuda.synchronize()
    assert rc.rerank_card.launches == before + 1
    assert got_d.shape == (Q, K) and got_i.dtype == torch.int32
    got_d, got_i = got_d.cpu().numpy(), got_i.cpu().numpy()
    pl_d, pl_i = rc.rerank_card_plain(copy, ids_dev, queries, k_eff,
                                      normalized=normalized)
    _hold(got_d, got_i, pl_d.cpu().numpy().astype(np.float64),
          pl_i.cpu().numpy(), K)
    li = LearnedIndex.__new__(LearnedIndex)
    li._host_corpus, li._rerank_shadow = (corpus, normalized), None
    host_d, host_i = li._rerank_host(None, ids, None, k_eff,
                                     host_queries=queries.cpu().numpy(),
                                     rerank_dtype="float16")
    differ = _hold(got_d, got_i, host_d.astype(np.float64), host_i, K)
    print(f"k_eff {k_eff} normalized {normalized}: ids differ (tied) on "
          f"{differ} of {Q} queries")
    assert (got_i[5] == -1).all() and (got_d[5] == 10000.0).all()


@pytest.mark.parametrize("d", [8, 96, 1000, 2048])
@pytest.mark.parametrize("k_eff", [1, 33, 64])
def test_kernel_shapes_ties_and_nan(card, d, k_eff):
    """Every chunk count the kernel is built for, k_eff from 1 to 64, whole
    orders (k = k_eff), against the plain version: equal rows keep their
    candidates' order, a NaN row goes last (after the empty places), an id
    past the corpus reads its last row, repeats are empty; ids equal where
    the plain distances lie apart by more than 1e-5, distances within
    1e-5."""
    n, q = 5000, 300
    x = _unit_rows(n, d, card, d + k_eff).half()
    x[20] = x[30] = x[10]
    x[7] = float("nan")
    qs = _unit_rows(q, d, card, 5) * 3.0
    rng = np.random.default_rng(d * 100 + k_eff)
    ids = rng.integers(0, n + 50, size=(q, k_eff)).astype(np.int64)
    ids[ids == 7] = 8
    if k_eff >= 4:
        ids[::3, :4] = (30, 7, 10, 20)
        ids[1::5, -1] = ids[1::5, 0]
    ids_dev = torch.from_numpy(ids).to(card)
    for normalized in (True, False):
        got_d, got_i = (t.cpu().numpy() for t in rc.rerank_card(
            x, ids_dev, qs, k_eff, normalized=normalized))
        want_d, want_i = (t.cpu().numpy() for t in rc.rerank_card_plain(
            x, ids_dev, qs, k_eff, normalized=normalized))
        nan = np.isnan(want_d)
        assert (np.isnan(got_d) == nan).all() and (got_i[nan] == 7).all()
        gap = np.abs(got_d - want_d)[~nan]
        assert gap.max() <= 1e-5
        apart = _apart(np.where(nan, np.inf, want_d).astype(np.float64),
                       1e-5)
        assert (got_i[apart] == want_i[apart]).all()
        if k_eff >= 4:
            assert (got_i[::3, -1] == 7).all()
            for row in got_i[::3]:
                assert [i for i in row.tolist() if i in (10, 20, 30)] == [
                    30, 10, 20]


def test_card_copy_equals_float16_copy(big, card):
    """The copy on the card, made from the bfloat16 host corpus through
    pinned slices, equals `_float16_copy` on sampled rows (and the first
    and last) to the bit."""
    corpus, copy, _ = big
    rows = np.unique(np.concatenate([
        [0, BIG_N - 1], np.random.default_rng(4).integers(0, BIG_N, 20000)]))
    want = _float16_copy(corpus[rows])
    got = copy[torch.from_numpy(rows).to(card)].cpu().numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_kernel_refuses_on_the_card(card):
    x = torch.zeros(100, 64, dtype=torch.float16, device=card)
    ids = torch.zeros(4, 12, dtype=torch.int32, device=card)
    qs = torch.zeros(4, 64, device=card)
    with pytest.raises(ValueError):
        rc.rerank_card(x, ids[:, ::2], qs, 4)          # not contiguous
    with pytest.raises(ValueError):
        rc.rerank_card(x, ids, qs.cpu(), 4)            # two devices
    d, i = rc.rerank_card(x, ids, qs, 40)              # k past k_eff
    assert d.shape == (4, 12)


def test_search_and_stream_through_the_card(card, monkeypatch):
    """A quantized index on the card with a bfloat16 host corpus and the
    float16 rerank: the plan reranks on the card, `search` and
    `search_stream` return the same results, which hold against the host
    rerank's (the site forced to "host"); the kernel's launches and the
    ``rerank_card`` counter move, and the host rerank does not run."""
    n, d, q = 40000, 96, 512
    rows = _unit_rows(n, d, card, 9)
    nav = rows[:, :32].contiguous().cpu().numpy()
    corpus = _host_bf16(rows)
    qs = (rows[:q] + 0.1 * _unit_rows(q, d, card, 10)).cpu().numpy()
    li = LearnedIndex(IndexConfig(n_categories=24, epochs=4, lr=0.003,
                                  batch_size=1024, row_align=64),
                      device=card)
    li.build_with_host_store(nav, corpus, normalized=True,
                             store_dtype="int8")
    scfg = SearchConfig(k=K, n_buckets=4, int8_queries=True,
                        rerank_dtype="float16", rerank_extra=10)
    assert li._plan_search(torch.from_numpy(qs[:, :32]).to(card), 4, K,
                           scfg).rerank == "card"
    launches = rc.rerank_card.launches
    counted = profiling.counters().get("rerank_card", 0)
    real_host = LearnedIndex._rerank_host

    def no_host(*a, **kw):
        raise AssertionError("the host rerank ran on the card path")

    monkeypatch.setattr(LearnedIndex, "_rerank_host", no_host)
    got_d, got_i = li.search(qs[:, :32], qs, n_buckets=4, k=K,
                             search_config=scfg)
    one_d, one_i = li.search(qs[:128, :32], qs[:128], n_buckets=4, k=K,
                             search_config=scfg)
    batches = [(qs[:128, :32], qs[:128])] * 4
    streamed = list(li.search_stream(batches, n_buckets=4, k=K,
                                     search_config=scfg))
    assert rc.rerank_card.launches > launches
    assert profiling.counters()["rerank_card"] - counted == q + 5 * 128
    assert li._rerank_shadow is None and li._card_copy[0] is corpus
    for s_d, s_i in streamed:
        np.testing.assert_array_equal(s_i, one_i)
        np.testing.assert_array_equal(s_d, one_d)
    monkeypatch.setattr(LearnedIndex, "_rerank_host", real_host)
    monkeypatch.setattr(LearnedIndex, "_rerank_site",
                        lambda self, *a: "host")
    host_d, host_i = li.search(qs[:, :32], qs, n_buckets=4, k=K,
                               search_config=scfg)
    np.testing.assert_allclose(got_d, host_d, rtol=0, atol=1e-5)
    apart = _apart(host_d.astype(np.float64), 1e-5)
    assert (got_i[apart] == host_i[apart]).all()
