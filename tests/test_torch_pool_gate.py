"""The rerank pool's gate in the probe kernel's wgmma loop
(csrc/probe_wgmma.cuh), modelled in torch and held against the pool's
plain definition.

The kernel keeps, per slot row, a bound U_r: the distance of the k_out-th
smallest key the CTA's pool row holds (+inf while fewer than k_out classes
are filled), recomputed after tiles 2, 4, 8, 16, ... of the CTA; a column
touches the pool only if its distance is at most U_r. The header argues
that rows [k, k_out) stay exact. The model below follows the kernel tile by
tile (its swizzled pool layout, the cadence, one CTA per block or per work
item with the items' pools folded by a minimum), and must give rows
[k, k_out) of `probe_topk_quant_plain(..., k_out=...)` to the bit on drawn
stores with ties, ragged buckets and buckets of fewer than k_out rows. The
plain version itself is held against the Pallas kernel in interpret mode
on one case.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpulmi.buckets import build_bucket_store
from tpulmi.ops.pallas_topk import pallas_probe_search
from tpulmi.ops.quantize import quantize_store
from tpulmi_torch.convert import store_from_arrays
from tpulmi_torch.ops.probe_topk import (_SIGN, BLOCK_SLOTS, POOL_CLASSES,
                                         Q_LEVELS, bucket_runs, group_slots,
                                         pool_extras, pool_keys, pool_pairs,
                                         probe_search, probe_topk_quant_plain)
from tpulmi_torch.ops.quantize import pack_int4, unpack_int4

torch.set_num_threads(1)

HEADER = (Path(__file__).resolve().parent.parent / "tpulmi_torch" / "csrc"
          / "probe_wgmma.cuh")


def pool_swz(r):
    """probe_wgmma.cuh::pool_swz: where class c of slot row r lies."""
    return (r & 1) | ((r & 2) << 2) | ((r & 12) >> 1)


def test_swizzle_is_the_headers_and_conflict_free():
    """The header's swizzle is the one modelled here and a permutation of
    every row. The 16 rows of a warp folding one class at once (every
    column passes the gate in a CTA's first tiles) meet 16 distinct pairs
    of 4-byte banks, where without it they meet one; and an access by the
    accumulator layout (lanes (g, tq): rows 16 w + g or + 8, columns 8 j +
    2 tq + (e & 1)) meets each pair exactly twice, where without it eight
    lanes meet one pair."""
    text = HEADER.read_text()
    assert re.search(r"pool_swz\(int r\) \{\s*return \(r & 1\) \| "
                     r"\(\(r & 2\) << 2\) \| \(\(r & 12\) >> 1\);", text)
    for r in range(BLOCK_SLOTS):
        assert sorted(c ^ pool_swz(r) for c in range(POOL_CLASSES)) == list(
            range(POOL_CLASSES))
    for w in range(4):
        for c in range(POOL_CLASSES):
            rows = range(16 * w, 16 * w + 16)
            pairs = [(r * POOL_CLASSES + (c ^ pool_swz(r))) % 16 for r in rows]
            assert sorted(pairs) == list(range(16))
            assert len({(r * POOL_CLASSES + c) % 16 for r in rows}) == 1
    for t0 in (0, 64, 128, 192):
        for w in range(4):
            for j in range(8):
                for e in range(4):
                    pairs, plain = [], []
                    for lane in range(32):
                        g, tq = lane >> 2, lane & 3
                        r = w * 16 + g + (8 if e & 2 else 0)
                        c = (t0 + 8 * j + 2 * tq + (e & 1)) % POOL_CLASSES
                        pairs.append((r * POOL_CLASSES + (c ^ pool_swz(r)))
                                     % 16)
                        plain.append((r * POOL_CLASSES + c) % 16)
                    assert np.bincount(pairs, minlength=16).tolist() == [2] * 16
                    assert max(np.bincount(plain)) == 8


# ------------------------------------------------------------- the model
def _unsigned_min(a, b):
    return torch.where((a ^ _SIGN) < (b ^ _SIGN), a, b)


def kth_best(keys, kk):
    """The distance of the kk-th smallest key of each row (any order), +inf
    while fewer than kk are filled, its word's low 16 bits set: what the
    warp's radix select to 16 bits gives (a bound at or above the
    k_out-th best)."""
    srt = torch.sort(keys ^ _SIGN, dim=1).values ^ _SIGN
    word = ((srt[:, kk - 1] >> 32) & 0xffffffff) | 0xffff
    bound = pool_pairs(word << 32)[0]
    # an empty key's word is all ones
    return torch.where(word == 0xffffffff, float("inf"), bound)


def gated_cta(dist, first_row, places, nb, k_out):
    """The pool of one CTA behind the gate. `dist` (rows, cols): the CTA's
    columns in store order, column j at store row first_row + j, whose
    class is j % 128 (a CTA starts on a multiple of 128); `places`: each
    row's place in its block (the swizzle's r). Returns the keys in class
    order and how many (row, column) pairs touched the pool."""
    n, cols = dist.shape
    keys = torch.full((n, POOL_CLASSES), -1, dtype=torch.int64)
    bound = torch.full((n,), float("inf"))
    where = (torch.arange(POOL_CLASSES)[None, :]
             ^ pool_swz(places)[:, None])           # class c -> its place
    touched = 0
    for t in range(-(-cols // nb)):
        lo, hi = t * nb, min(cols, (t + 1) * nb)
        v = dist[:, lo:hi]
        pos = where[:, torch.arange(lo, hi) % POOL_CLASSES]
        new = pool_keys(v, (first_row + torch.arange(lo, hi)).expand(n, -1))
        gate = v <= bound[:, None]
        old = keys.gather(1, pos)
        keys.scatter_(1, pos, torch.where(gate, _unsigned_min(new, old), old))
        touched += int(gate.sum())
        if t > 0 and (t + 1) & t == 0:     # after tiles 2, 4, 8, ...
            bound = kth_best(keys, k_out)
    return keys.gather(1, where), touched


def gated_probe(q, qidx, codes, scales, blocks, k, k_out, bits, nb, span):
    """The wgmma loop's pool as the model computes it: one CTA per block
    (span 0) or per work item of `span` store rows, the items' pools folded
    by a minimum; then the extras of the definition for the exact prefix.
    Returns (out_d, out_i, touched pairs, all pairs)."""
    exact = probe_topk_quant_plain(q, qidx, codes, scales, blocks, k, bits)
    keys = torch.full((qidx.shape[0], POOL_CLASSES), -1, dtype=torch.int64)
    touched = total = 0
    for start, cnt, rows in bucket_runs(blocks):
        # the plain version's own arithmetic
        x = (unpack_int4(codes[start:start + cnt]) if bits == 4
             else codes[start:start + cnt]).to(q.dtype).float()
        sc = scales[start:start + cnt] / Q_LEVELS[bits]
        dist = 1.0 - (q[qidx[rows].long()].float() @ x.T) * sc[None, :]
        step = span or cnt
        for lo in range(0, cnt, step):
            part, n = gated_cta(dist[:, lo:lo + step], start + lo,
                                rows % BLOCK_SLOTS, nb, k_out)
            keys[rows] = _unsigned_min(keys[rows], part)
            touched += n
            total += part.shape[0] * min(step, cnt - lo)
    return (*pool_extras(exact[0], exact[1], *pool_pairs(keys), k_out),
            touched, total)


def _store(rng, sizes, d, bits, levels, twins):
    """Codes of small magnitude (`levels`: many equal products), positive
    scales drawn from a few values, rows j and j + 1 equal at `twins` of
    each bucket; float32 queries of whole numbers, so every product is
    exact whatever the order of its sum."""
    n = max(sum(sizes), 1)
    codes = rng.integers(-levels, levels + 1, size=(n, d)).astype(np.int8)
    scales = rng.choice(np.float32([0.5, 0.75, 1.25, 2.0]), size=n)
    starts = np.cumsum([0] + list(sizes[:-1]))
    for s, c in zip(starts, sizes):
        for j in twins:
            if j + 1 < c:
                codes[s + j + 1] = codes[s + j]
                scales[s + j + 1] = scales[s + j]
    codes_t = torch.from_numpy(codes)
    if bits == 4:
        codes_t = pack_int4(torch.clamp(codes_t, -7, 7))
    offsets = torch.tensor(list(starts) + [sum(sizes)], dtype=torch.int32)
    counts = torch.tensor(sizes, dtype=torch.int32)
    return codes_t, torch.from_numpy(scales.astype(np.float32)), offsets, counts


def _check(rng, sizes, d, bits, k, k_out, nb, span, n_q, p, levels=2,
           twins=(5, 63, 127)):
    codes, scales, offsets, counts = _store(rng, sizes, d, bits, levels,
                                            twins)
    c = len(sizes)
    q = torch.from_numpy(rng.integers(-3, 4, size=(n_q, d)).astype(
        np.float32))
    probes = np.stack([rng.permutation(c + 1)[:min(p, c + 1)]
                       for _ in range(n_q)]).astype(np.int32)  # id c: dumped
    lay = group_slots(torch.from_numpy(probes), offsets, counts)
    args = (q, lay.qidx, codes, scales, lay.blocks)
    want = probe_topk_quant_plain(*args, k, bits, k_out=k_out)
    got_d, got_i, touched, total = gated_probe(*args, k, k_out, bits, nb,
                                               span)
    assert torch.equal(got_i, want[1])
    assert torch.equal(got_d, want[0])
    return touched, total


@pytest.mark.parametrize("span", [0, 128, 384])
@pytest.mark.parametrize("nb", [64, 128])
@pytest.mark.parametrize("bits", [8, 4])
def test_gate_keeps_the_extras_exact(bits, nb, span):
    """Skewed buckets (one of 2,000 rows, one of fewer than k_out, an
    empty one), dumped slots, k = 10, k_out = 20: the model's rows equal
    the definition's to the bit, and the gate keeps most columns of a
    whole bucket out, some of an item of 384 rows, and none of an item of
    128 rows, whose gate is first set after its last tile."""
    rng = np.random.default_rng(7 + bits + nb + span)
    touched, total = _check(rng, [2000, 300, 15, 0, 777, 129], 32, bits, 10,
                            20, nb, span, n_q=48, p=3, levels=6)
    if span == 128:
        assert touched == total
    else:
        assert 0 < touched < total / (2 if span == 0 else 1), (touched, total)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       sizes=st.lists(st.integers(0, 700), min_size=1, max_size=5),
       bits=st.sampled_from([8, 4]), k=st.integers(1, 12),
       extra=st.integers(1, 128), nb=st.sampled_from([64, 128]),
       span=st.sampled_from([0, 128, 256, 384]),
       levels=st.integers(1, 7), p=st.integers(1, 3))
def test_gate_on_drawn_stores(seed, sizes, bits, k, extra, nb, span, levels,
                              p):
    """Drawn stores: ties (few code levels, equal rows), ragged buckets,
    buckets under k_out rows, k_out up to 128, both tile heights, the
    worklist's spans."""
    _check(np.random.default_rng(seed), sizes, 32, bits, k,
           min(k + extra, POOL_CLASSES), nb, span, n_q=24, p=p, levels=levels)


def test_plain_pool_against_pallas_on_a_quantized_store(rng):
    """The definition the model is held to, on an int8 store, against the
    Pallas kernel in interpret mode: the exact prefix equal, and the whole
    row ascending with every live id carrying its distance and none twice
    (the TPU kernel's extras are best-effort, so only its contract is
    compared)."""
    n, d, c, nq = 6000, 128, 5, 32
    data = rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    js = quantize_store(build_bucket_store(labels, data, c, pad_rows=1024,
                                           row_align=1024), bits=8)
    ts = store_from_arrays(np.asarray(js.data_sorted),
                           np.asarray(js.ids_sorted), np.asarray(js.offsets),
                           np.asarray(js.counts), js.n, js.pad_rows,
                           js.row_align, device="cpu",
                           scales=np.asarray(js.scales), quant_bits=8)
    probes = np.stack([rng.permutation(c)[:2] for _ in range(nq)]).astype(
        np.int32)
    max_bucket = int(np.asarray(js.counts).max())
    jd_, ji, _ = pallas_probe_search(
        jnp.asarray(probes), jnp.asarray(queries), js, k=5, k_out=16,
        qc=128, mc=1024, max_chunks=-(-max_bucket // 1024),
        compute_dtype=jnp.float32, extract_mode="group", interpret=True)
    td, ti, _ = probe_search(torch.from_numpy(probes),
                             torch.from_numpy(queries), ts, k=16, pool_k=5,
                             compute_dtype=torch.float32, backend="torch")
    td, ti = td.numpy(), ti.numpy()
    np.testing.assert_allclose(td[:, :5], np.asarray(jd_)[:, :5], atol=1e-5)
    np.testing.assert_array_equal(ti[:, :5], np.asarray(ji)[:, :5])
    assert np.all(np.diff(td, axis=1) >= 0)
    live = ti >= 0
    assert live[:, :5].all() and live.mean() > 0.9
    for row in ti:
        assert len(set(row[row >= 0].tolist())) == int((row >= 0).sum())
    # every id's distance from the codes, as the plain version scores it
    codes = ts.data_sorted.float().numpy()
    sc = ts.scales.numpy() / 127.0
    row_of = {int(i): r for r, i in enumerate(ts.ids_sorted.tolist())
              if int(i) >= 0}
    for qi in range(nq):
        for place in np.nonzero(live[qi])[0]:
            r = row_of[int(ti[qi, place])]
            want = 1.0 - float(queries[qi] @ codes[r]) * sc[r]
            assert abs(want - td[qi, place]) < 1e-5
