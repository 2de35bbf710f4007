"""The packed int4 host layout of tpulmi_torch.hoststore against
tpulmi.hoststore on the CPU: 6000 rows of d 64 in 7 buckets, both layout
paths (the gather over an array in RAM, and the source-sequential scatter
over a float32 and over a bfloat16 memory map), rows given normalized and
not.

Two quantizers make the codes:

- the CPU twin, ``quantize_rows_int4_host`` (what a layout on a CPU device
  runs): the JAX package's store to the bit;
- `hoststore.Int4OnDevice`, what a layout on a CUDA device runs
  (`quantize_rows_int4` block by block), here on CPU tensors: ids,
  offsets, counts, pads and watermarks to the bit; codes and scales equal
  but on the rows whose two best clip points lie within float32 rounding
  of each other, where torch sums the grid's errors in another order than
  numpy. At most 1% of the rows may differ (none did here); on each such
  row both packages' codes reconstruct the row equally well, their squared
  errors within 1e-5 of each other relatively (float32 rounding of a
  64-term sum).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from tpulmi_torch import hoststore
from tpulmi_torch.hoststore import HostBF16, Int4OnDevice, layout_host_store
from tpulmi_torch.ops.quantize import quantize_rows_int4_host

torch.set_num_threads(1)

N, D, N_CAT = 6000, 64, 7
NEAR_TIE_ROWS_MAX = 0.01     # of the rows, with the torch quantizer
ERR_RTOL = 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(13)
    pred = rng.integers(0, N_CAT, size=N).astype(np.int32)
    pred[:500] = 2                   # one bucket larger than the others
    x = (rng.normal(size=(N, D)) * rng.uniform(0.5, 2.0, (N, 1))).astype(
        np.float32)
    return pred, x


def _sources(x, src, tmp_path):
    """(JAX package's corpus, port's corpus): arrays in RAM for the gather,
    memory maps for the source-sequential scatter. The JAX package's
    float32 map is copy-on-write: its scatter normalizes in place."""
    if src == "ram":
        return x, x
    if src == "bf16-map":
        np.save(tmp_path / "c.npy", x.astype(ml_dtypes.bfloat16).view(
            np.uint16))
        bits = np.load(tmp_path / "c.npy", mmap_mode="r")
        return bits.view(ml_dtypes.bfloat16), HostBF16(bits)
    np.save(tmp_path / "c.npy", x)
    return (np.load(tmp_path / "c.npy", mmap_mode="c"),
            np.load(tmp_path / "c.npy", mmap_mode="r"))


def _rows_seen(x, src, normalized):
    """The float32 rows the quantizers see, in source order."""
    rows = (np.asarray(x.astype(ml_dtypes.bfloat16), np.float32)
            if src == "bf16-map" else x.copy())
    if not normalized:
        rows /= np.maximum(np.linalg.norm(rows, axis=1, keepdims=True),
                           1e-12)
    return rows


def _sq_err(codes, scale, row):
    b = codes.astype(np.int32)
    q = np.concatenate([((b & 0xF) ^ 8) - 8, b >> 4])
    return float(((q * (np.float64(scale) / 7.0) - row) ** 2).sum())


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("src", ["ram", "f32-map", "bf16-map"])
@pytest.mark.parametrize("quantizer", ["numpy", "torch"])
def test_int4_layout_equals_jax(data, tmp_path, monkeypatch, quantizer, src,
                                normalized):
    from tpulmi import hoststore as ref_hoststore

    pred, x = data
    if normalized:
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    if src != "ram":
        monkeypatch.setenv("TPULMI_MATERIALIZE_MAX_FRAC", "0")
    if quantizer == "torch":
        # the card's quantizer, on CPU tensors, in blocks of 1000 rows
        monkeypatch.setattr(hoststore, "_int4_quantizer",
                            lambda device: Int4OnDevice(device, block=1000))
    ref_src, port_src = _sources(x, src, tmp_path)
    kw = dict(row_align=64, store_dtype="int4", normalized=normalized,
              pad_rows=100, chunk=700)
    marks = {"ref": [], "port": []}
    want = ref_hoststore.layout_host_store(pred, ref_src, N_CAT,
                                           progress_cb=marks["ref"].append,
                                           **kw)
    got = layout_host_store(pred, port_src, N_CAT, device="cpu",
                            progress_cb=marks["port"].append, **kw)
    for name in ("ids_sorted", "offsets", "counts"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)
    assert (got.n, got.pad_rows, got.row_align, got.quant_bits) == (
        want.n, want.pad_rows, want.row_align, 4)
    assert marks["port"] == marks["ref"]
    codes, scales = got.data_sorted, got.scales
    want_codes, want_scales = np.asarray(want.data_sorted), want.scales
    assert codes.shape == (want_codes.shape[0], D // 2)
    differ = (codes != want_codes).any(axis=1) | (scales != want_scales)
    if quantizer == "numpy":
        assert not differ.any()
        return
    assert differ.sum() <= NEAR_TIE_ROWS_MAX * N, differ.sum()
    rows = _rows_seen(x, src, normalized)
    for r in np.flatnonzero(differ):
        row = rows[got.ids_sorted[r]]
        e_got = _sq_err(codes[r], scales[r], row)
        e_want = _sq_err(want_codes[r], want_scales[r], row)
        assert abs(e_got - e_want) <= ERR_RTOL * e_want, (r, e_got, e_want)


def test_torch_quantizer_on_its_own_equals_numpy_but_near_ties():
    """`Int4OnDevice` over float32 rows and over bfloat16 bits, against the
    numpy twin on the same values: the same near-tie rule."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5000, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    bf = HostBF16.from_float32(x)
    for rows, seen in ((x, x), (bf, np.asarray(bf))):
        codes, scales = Int4OnDevice("cpu", block=1234)(rows)
        want_codes, want_scales = quantize_rows_int4_host(seen)
        differ = ((codes != want_codes).any(axis=1)
                  | (scales != want_scales))
        assert differ.sum() <= NEAR_TIE_ROWS_MAX * len(x)
        for r in np.flatnonzero(differ):
            e_got = _sq_err(codes[r], scales[r], seen[r])
            e_want = _sq_err(want_codes[r], want_scales[r], seen[r])
            assert abs(e_got - e_want) <= ERR_RTOL * e_want


def test_layout_quantizes_int4_on_the_layouts_device():
    """A CUDA device makes the codes on the card (nothing is allocated
    until rows come), anything else takes the numpy twin."""
    assert isinstance(hoststore._int4_quantizer(torch.device("cuda")),
                      Int4OnDevice)
    assert isinstance(hoststore._int4_quantizer("cuda:0"), Int4OnDevice)
    for device in (None, "cpu", torch.device("cpu")):
        assert hoststore._int4_quantizer(device) is quantize_rows_int4_host
