"""The exact float16 rerank on the card (`tpulmi_torch.ops.rerank_card`) on
the CPU: its plain version against `LearnedIndex._rerank_host` on the same
candidates, the copy of the corpus made slice by slice against
`_float16_copy`, the rule that puts a plan's rerank on the card or the
host, the wrapper's refusals, and the search paths through the card
rerank (its plain version standing in for the kernel). The kernel itself
is held on a card by tests/test_torch_rerank_card_cuda.py."""

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpulmi_torch.index as index_mod
from tpulmi_torch import IndexConfig, LearnedIndex, SearchConfig
from tpulmi_torch.hoststore import HostBF16
from tpulmi_torch.index import _float16_copy
from tpulmi_torch.ops import rerank_card as rc
from tpulmi_torch.utils import profiling

torch.set_num_threads(1)

CFG = dict(n_categories=16, epochs=4, lr=0.003, batch_size=512, row_align=1)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _with_corpus(corpus, normalized):
    li = LearnedIndex.__new__(LearnedIndex)
    li._host_corpus = (corpus, normalized)
    li._rerank_shadow = li._card_copy = None
    return li


def _corpus(kind, x):
    return {"float32": x, "float16": x.astype(np.float16),
            "bfloat16": HostBF16.from_float32(x)}[kind]


def _candidates(rng, n, q, k_eff):
    """Candidate lists with repeated ids, empty places and exact ties (rows
    10, 20 and 30 of the corpus are made equal)."""
    ids = rng.integers(0, n, size=(q, k_eff)).astype(np.int32)
    ids[:, 5] = ids[:, 2]                  # a repeated id in every row
    ids[3, 7:] = -1
    ids[4, :] = -1
    ids[5, 1] = ids[5, 0] = ids[5, 9]
    ids[6:12, :3] = (30, 10, 20)           # equal rows: ties by position
    ids[8, 3] = 10                         # a tie that is also a repeat
    return ids


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("kind", ["float32", "float16", "bfloat16"])
def test_plain_equals_host_rerank(rng, kind, normalized):
    """The same candidates through `_rerank_host` (float16 copy) and the
    plain version over the same copy as a tensor: ids equal, distances
    within 1e-6, every id once, empty rows at the sentinel."""
    n, d, q, k_eff, k = 3000, 64, 40, 20, 10
    x = _unit(rng, n, d) * (1.0 if normalized else 3.0)
    x[20] = x[30] = x[10]
    corpus = _corpus(kind, x)
    queries = _unit(rng, q, d) * 2.0       # divided by their norms
    ids = _candidates(rng, n, q, k_eff)
    want_d, want_i = _with_corpus(corpus, normalized)._rerank_host(
        None, ids.copy(), None, k, host_queries=queries,
        rerank_dtype="float16")
    got_d, got_i = rc.rerank_card_plain(
        torch.from_numpy(_float16_copy(corpus)), torch.from_numpy(ids),
        torch.from_numpy(queries), k, normalized=normalized)
    assert got_d.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=1e-6)
    assert (got_i[4] == -1).all() and (got_d[4] == 10000.0).all()
    for row in got_i.numpy():
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    # equal rows keep their candidates' order
    for row in want_i[6:12]:
        tied = [i for i in row.tolist() if i in (10, 20, 30)]
        assert tied == [i for i in (30, 10, 20) if i in tied]
    # int64 ids give the same, as int64
    d64, i64 = rc.rerank_card(torch.from_numpy(_float16_copy(corpus)),
                              torch.from_numpy(ids.astype(np.int64)),
                              torch.from_numpy(queries), k,
                              normalized=normalized)
    assert i64.dtype == torch.int64
    np.testing.assert_array_equal(i64.numpy(), want_i)
    np.testing.assert_array_equal(d64.numpy(), got_d.numpy())


@pytest.mark.parametrize("kind", ["float32", "float16", "bfloat16",
                                  "float64"])
def test_card_copy_equals_float16_copy(rng, kind):
    """`float16_copy` on the CPU, slice by slice (its plain version: the
    same slices, converted by the same casts), equals `_float16_copy` to
    the bit, past float16's range and in its subnormals."""
    x = _unit(rng, 1000, 48) * 3.0
    x[0, :3] = (70000.0, 1e-6, -3e-8)
    with np.errstate(over="ignore"):
        corpus = (x.astype(np.float64) / 3.0 if kind == "float64"
                  else _corpus(kind, x))
        want = _float16_copy(corpus)
        got = rc.float16_copy(corpus, "cpu", slice_bytes=48 * 4 * 64)
    assert got.dtype == torch.float16 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint16),
                                  want.view(np.uint16))


GiB = 1 << 30
# (store device, sharded, rerank dtype, k_eff, copy made, free bytes) ->
# where the rerank runs
SITES = {
    "card": (("cuda", False, "float16", 14, False, 40 * GiB), "card"),
    "cpu_store": (("cpu", False, "float16", 14, False, 40 * GiB), "host"),
    "sharded": (("cuda", True, "float16", 14, False, 40 * GiB), "host"),
    "float32_rerank": (("cuda", False, "float32", 14, False, 40 * GiB),
                       "host"),
    "k_eff_65": (("cuda", False, "float16", 65, False, 40 * GiB), "host"),
    "k_eff_64": (("cuda", False, "float16", 64, False, 40 * GiB), "card"),
    "no_room": (("cuda", False, "float16", 14, False, 4 * GiB + 100),
                "host"),
    "just_room": (("cuda", False, "float16", 14, False,
                   4 * GiB + 2 * 64 * 1000), "card"),
    "copy_made": (("cuda", False, "float16", 14, True, 0), "card"),
}


@pytest.mark.parametrize("case", list(SITES))
def test_rerank_site(rng, monkeypatch, case):
    """`_rerank_site` in each case of its rule, from what the code can
    observe: the store's device, sharding, the rerank's dtype, k_eff, and
    the card's free memory (`torch.cuda.mem_get_info`, patched) against
    the copy's 2 n d bytes and the headroom, unless the copy exists."""
    (dev, sharded, dtype, k_eff, made, free), want = SITES[case]
    corpus = _unit(rng, 1000, 64)
    li = _with_corpus(corpus, True)
    if made:
        li._card_copy = (corpus, None)
    asked = []

    def mem_get_info(device=None):
        asked.append(device)
        return free, 80 * GiB

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    store = SimpleNamespace(device=torch.device(dev))
    scfg = SearchConfig(rerank_dtype=dtype)
    assert li._rerank_site(store, sharded, k_eff, scfg) == want
    # the card's memory is asked only where every other rule holds
    assert len(asked) == (case in ("card", "k_eff_64", "no_room",
                                   "just_room"))
    assert index_mod.CARD_COPY_HEADROOM == 4 * GiB


@pytest.fixture(scope="module")
def quantized():
    rng = np.random.default_rng(5)
    data, queries = _unit(rng, 4000, 64), _unit(rng, 48, 64)
    li = LearnedIndex(IndexConfig(**CFG), device="cpu")
    li.build(data, data)
    li.quantize(host_corpus=HostBF16.from_float32(data), normalized=True)
    return li, data, queries


def test_plan_records_the_site(quantized):
    """On a CPU store the plan reranks on the host; without a rerank it
    reranks nowhere."""
    li, data, queries = quantized
    qn = torch.from_numpy(queries)
    for rerank, want in ((True, "host"), (False, None)):
        scfg = SearchConfig(k=10, n_buckets=4, rerank=rerank,
                            rerank_dtype="float16")
        plan = li._plan_search(qn, 4, 10, scfg)
        assert plan.rerank == want


def test_search_through_the_card_rerank(quantized, monkeypatch):
    """With the site forced to "card" (the plain version standing in for
    the kernel on the CPU), `search`, a batched `search` and
    `search_stream` give the host rerank's ids and distances to 1e-6; the
    copy is made once, from the host corpus, under ``rerank.card_copy``,
    the host shadow is not made, `_rerank_host` is not called, and the
    counter ``rerank_card`` counts the queries."""
    li, data, queries = quantized
    scfg = SearchConfig(k=10, n_buckets=4, rerank_dtype="float16")
    li._rerank_shadow = li._card_copy = None
    want_d, want_i = li.search(queries, queries, n_buckets=4, k=10,
                               search_config=scfg)
    assert li._rerank_shadow is not None and li._card_copy is None

    monkeypatch.setattr(LearnedIndex, "_rerank_site",
                        lambda self, *a: "card")

    def no_host(*a, **kw):
        raise AssertionError("the host rerank ran on the card path")

    monkeypatch.setattr(LearnedIndex, "_rerank_host", no_host)
    before = profiling.counters().get("rerank_card", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        got_d, got_i = li.search(queries, queries, n_buckets=4, k=10,
                                 search_config=scfg)
    names = [r[0] for r in profiling.records()]
    assert names.count("rerank.card_copy") == 1
    assert names.count("rerank.card") == 1
    assert "rerank" not in names
    assert li._rerank_shadow is None
    corpus = li._host_corpus[0]
    assert li._card_copy[0] is corpus
    np.testing.assert_array_equal(li._card_copy[1].numpy(),
                                  _float16_copy(corpus))
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-6)
    assert got_d.dtype == np.float32 and got_i.dtype == np.int64

    copy = li._card_copy[1]
    split = SearchConfig(k=10, n_buckets=4, rerank_dtype="float16",
                         batch_queries=20)
    b_d, b_i = li.search(queries, queries, n_buckets=4, k=10,
                         search_config=split)
    np.testing.assert_array_equal(b_i, want_i)
    np.testing.assert_allclose(b_d, want_d, rtol=0, atol=1e-6)
    batches = [(queries[:16], queries[:16])] * 3
    got = list(li.search_stream(batches, n_buckets=4, k=10,
                                search_config=scfg))
    for s_d, s_i in got:
        np.testing.assert_array_equal(s_i, want_i[:16])
        np.testing.assert_allclose(s_d, want_d[:16], rtol=0, atol=1e-6)
    assert li._card_copy[1] is copy        # made once
    assert profiling.counters()["rerank_card"] - before == 48 + 48 + 3 * 16


def test_a_rerun_counts_its_queries_once(quantized, monkeypatch):
    """A search that overflows its pad and runs again on the card path
    reranks on the card at each run, keeps the result of the last, and
    counts its queries in ``rerank_card`` once."""
    li, data, queries = quantized
    scfg = SearchConfig(k=10, n_buckets=4, rerank_dtype="float16",
                        backend="xla")
    want_d, want_i = li.search(queries, queries, n_buckets=4, k=10,
                               search_config=scfg)
    monkeypatch.setattr(LearnedIndex, "_rerank_site",
                        lambda self, *a: "card")
    li._qpb_pads.clear()
    before, kept = profiling.counters(), len(profiling.records())
    with profile(activities=[ProfilerActivity.CPU]):
        got_d, got_i = li.search(queries, queries, n_buckets=4, k=10,
                                 search_config=replace(
                                     scfg, queries_per_bucket_pad=8,
                                     query_chunk=8))
    after = profiling.counters()
    reruns = after["reruns"] - before.get("reruns", 0)
    assert reruns >= 1
    names = [r[0] for r in profiling.records()[kept:]]
    assert names.count("rerank.card") == 1 + reruns
    assert after["rerank_card"] - before.get("rerank_card", 0) == 48
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-6)


def _bad(case):
    c16 = torch.zeros(100, 64, dtype=torch.float16)
    ids = torch.zeros(4, 12, dtype=torch.int32)
    qs = torch.zeros(4, 64)
    k = 10
    if case == "corpus_float32":
        c16 = c16.float()
    elif case == "corpus_1d":
        c16 = c16.reshape(-1)
    elif case == "ids_float":
        ids = ids.float()
    elif case == "ids_1d":
        ids = ids.reshape(-1)
    elif case == "queries_float64":
        qs = qs.double()
    elif case == "queries_shape":
        qs = torch.zeros(5, 64)
    elif case == "d_not_8":
        c16, qs = c16[:, :60], qs[:, :60]
    elif case == "d_past_max":
        c16 = torch.zeros(2, rc.MAX_D + 8, dtype=torch.float16)
        qs = torch.zeros(4, rc.MAX_D + 8)
    elif case == "k_eff_65":
        ids = torch.zeros(4, 65, dtype=torch.int32)
    elif case == "k_0":
        k = 0
    elif case == "two_devices":
        ids = ids.to("meta")
    elif case == "meta_device":
        c16, ids, qs = (t.to("meta") for t in (c16, ids, qs))
    return c16, ids, qs, k


@pytest.mark.parametrize("case", [
    "corpus_float32", "corpus_1d", "ids_float", "ids_1d", "queries_float64",
    "queries_shape", "d_not_8", "d_past_max", "k_eff_65", "k_0",
    "two_devices", "meta_device"])
def test_wrapper_refuses(case):
    """`rerank_card` raises on a bad dtype, shape, device or k_eff, before
    any device or plain path; the kernel's launch count does not move."""
    before = rc.rerank_card.launches
    c16, ids, qs, k = _bad(case)
    with pytest.raises(ValueError):
        rc.rerank_card(c16, ids, qs, k)
    assert rc.rerank_card.launches == before


def test_takes():
    assert rc.takes(1, 8) and rc.takes(64, 768) and rc.takes(20, 2048)
    assert not any((rc.takes(0, 768), rc.takes(65, 768), rc.takes(14, 0),
                    rc.takes(14, 772), rc.takes(14, 2056)))
