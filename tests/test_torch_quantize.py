"""tpulmi_torch/ops/quantize.py against tpulmi/ops/quantize.py on the same
rows, made from a seed with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulmi.buckets import build_bucket_store as jax_build_store
from tpulmi.ops import quantize as jq
from tpulmi_torch.buckets import build_bucket_store
from tpulmi_torch.convert import store_from_arrays
from tpulmi_torch.ops import quantize as tq

torch.set_num_threads(1)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _rows(rng, n, d):
    """Unit rows, rows with outliers, scaled rows and all-zero padding."""
    x = _unit(rng, n, d)
    x[1::7] *= rng.uniform(0.1, 30.0, size=(len(x[1::7]), 1)).astype(
        np.float32)
    x[2::11, :3] *= 9.0
    x[5::13] = 0.0
    # rows whose elements sit on the rounding boundaries of the int8 codes
    # (x / s * 127 = m + 0.5): there another operation order, such as
    # x * (127 / s), rounds the other way
    for i in range(3, n, 17):
        s_i = np.float32(rng.uniform(0.05, 2.0))
        m = rng.integers(-126, 126, size=d).astype(np.float32)
        x[i] = s_i * (m + np.float32(0.5)) / np.float32(127.0)
        x[i, 0] = s_i
    return x


@pytest.mark.parametrize("d", [64, 768])
def test_quantize_rows_bit_equal(rng, d):
    x = _rows(rng, 400, d)
    want_q, want_s = jq.quantize_rows(x)
    got_q, got_s = tq.quantize_rows(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    back = tq.dequantize_rows(got_q, got_s).numpy()
    # XLA may divide the scale by 127 through a reciprocal: one ulp
    np.testing.assert_allclose(
        back, np.asarray(jq.dequantize_rows(want_q, want_s)), rtol=3e-7)


def test_pack_unpack_bit_equal(rng):
    codes = rng.integers(-8, 8, size=(50, 96)).astype(np.int8)
    want = np.asarray(jq.pack_int4(jnp.asarray(codes)))
    got = tq.pack_int4(torch.from_numpy(codes))
    assert got.dtype == torch.int8 and got.shape == (50, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    # byte j: dim j in the low nibble, dim j + d/2 in the high one
    assert (got.numpy()[:, 0].astype(np.uint8) & 0xF).tolist() == (
        codes[:, 0].astype(np.uint8) & 0xF).tolist()
    back = tq.unpack_int4(got)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq.unpack_int4(jnp.asarray(want))))
    with pytest.raises(ValueError, match="even d"):
        tq.pack_int4(torch.zeros((2, 7), dtype=torch.int8))


@pytest.mark.parametrize("d", [64, 768])
def test_quantize_rows_int4_matches_jax(rng, d):
    """A row whose two best clip points tie within rounding may pick the
    other one when the error sum is taken in another order (the JAX
    package says so of its own two quantizers); so scales must be equal on
    at least 99.9% of rows, and codes bit-equal on every such row."""
    x = _rows(rng, 2000, d)
    want_p, want_s = (np.asarray(a) for a in jq.quantize_rows_int4(x))
    got_p, got_s = (a.numpy() for a in tq.quantize_rows_int4(
        torch.from_numpy(x)))
    same = got_s == want_s
    assert same.mean() >= 0.999
    np.testing.assert_array_equal(got_p[same], want_p[same])
    codes = tq.unpack_int4(torch.from_numpy(got_p)).numpy()
    assert codes.min() >= -8 and codes.max() <= 7
    # zero rows: first grid point, scale clamped, code 0
    zero = ~x.any(axis=1)
    assert zero.any() and (got_s[zero] == np.float32(1e-12)).all()
    assert not codes[zero].any()


def test_quantize_rows_int4_host_bit_equal(rng):
    x = _rows(rng, 700, 128)
    want_p, want_s = jq.quantize_rows_int4_host(x)
    got_p, got_s = tq.quantize_rows_int4_host(x)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_s, want_s)
    assert tq.INT4_CLIP_GRID == jq.INT4_CLIP_GRID
    assert tq.INT4_CLIP == jq.INT4_CLIP


@pytest.mark.parametrize("d", [768, 2048])
def test_cosine_dists_int8(rng, d):
    data, queries = _unit(rng, 300, d), _unit(rng, 20, d)
    qd, sd = jq.quantize_rows(data)
    qq, sq = jq.quantize_rows(queries)
    want = np.asarray(jq.cosine_dists_int8(qq, sq, qd, sd))
    got = tq.cosine_dists_int8(*(torch.from_numpy(np.asarray(a))
                                 for a in (qq, sq, qd, sd)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # the integer dot itself is exact, past float32's exact range too
    exact = np.asarray(qq, np.int64) @ np.asarray(qd, np.int64).T
    dot = tq.int_dot(torch.from_numpy(np.asarray(qq)),
                     torch.from_numpy(np.asarray(qd)))
    np.testing.assert_array_equal(dot.numpy(), exact.astype(np.float32))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_store_matches_jax(rng, bits):
    n, d, c = 1000, 64, 8
    data = _unit(rng, n, d)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    js = jq.quantize_store(
        jax_build_store(labels, data, c, pad_rows=64, row_align=32),
        bits=bits)
    store = build_bucket_store(torch.from_numpy(labels),
                               torch.from_numpy(data), c, pad_rows=64,
                               row_align=32)
    assert not store.is_quantized and store.dim == d
    store.data_as(torch.bfloat16)
    qs = tq.quantize_store(store, bits=bits)
    assert qs.is_quantized and qs.quant_bits == bits
    assert qs.packed == (bits == 4)
    assert qs.q_levels == js.q_levels == (7.0 if bits == 4 else 127.0)
    assert qs.dim == d == js.dim
    assert qs.data_sorted.shape[1] == (d // 2 if bits == 4 else d)
    assert qs.data_sorted.dtype == torch.int8
    # the layout is kept, and nothing of the float store is carried along
    for name in ("ids_sorted", "offsets", "counts"):
        assert getattr(qs, name) is getattr(store, name)
    assert (qs.n, qs.pad_rows, qs.row_align) == (n, store.pad_rows, 32)
    assert not qs._casts
    same = qs.scales.numpy() == np.asarray(js.scales)
    assert same.mean() >= 0.999
    np.testing.assert_array_equal(qs.data_sorted.numpy()[same],
                                  np.asarray(js.data_sorted)[same])
    with pytest.raises(ValueError, match="codes"):
        qs.data_as(torch.bfloat16)
    # a JAX-quantized store crosses bit for bit
    carried = store_from_arrays(
        np.asarray(js.data_sorted), np.asarray(js.ids_sorted),
        np.asarray(js.offsets), np.asarray(js.counts), js.n, js.pad_rows,
        js.row_align, device="cpu", scales=np.asarray(js.scales),
        quant_bits=bits)
    assert carried.is_quantized and carried.packed == (bits == 4)
    assert carried.data_sorted.dtype == torch.int8
    np.testing.assert_array_equal(carried.data_sorted.numpy(),
                                  np.asarray(js.data_sorted))
    np.testing.assert_array_equal(carried.scales.numpy(),
                                  np.asarray(js.scales))


def test_quantize_store_bits_validation(rng):
    data = _unit(rng, 200, 32)
    labels = rng.integers(0, 4, size=200).astype(np.int32)
    store = build_bucket_store(torch.from_numpy(labels),
                               torch.from_numpy(data), 4)
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_store(store, bits=3)
    q4 = tq.quantize_store(store, bits=4)
    with pytest.raises(ValueError, match="already int4"):
        tq.quantize_store(q4, bits=8)
    assert tq.quantize_store(q4, bits=4) is q4
    q8 = tq.quantize_store(store, bits=8)
    with pytest.raises(ValueError, match="already int8"):
        tq.quantize_store(q8, bits=4)


def test_quantize_store_runs_on_the_card_by_default(monkeypatch):
    """A store on the card is quantized there; carrying one across
    defaults to the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store_from_arrays(np.zeros((4, 8), np.int8), np.arange(4), [0, 4],
                          [4], 4, 0, 1, scales=np.ones(4, np.float32))
