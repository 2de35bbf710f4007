"""tpulmi_torch.hoststore and synthetic_dataset_big against the JAX
package's: `layout_host_store` equal to the bit to its twin path by path
(the native gather, the numpy gather, the source-sequential scatter over a
memory map), watermarks included; `ensure_in_ram`; the slab uploads; and
the big dataset's cache files equal byte for byte.

Each path is held to its own twin only: the native gather rounds int8 codes
as nearbyintf(x * (127 / amax)), the numpy paths as rint(x / amax * 127)."""

import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_native import ref_native, use_ref_native  # noqa: F401
from tpulmi_torch import hoststore
from tpulmi_torch.hoststore import (HostBF16, _slab_upload_serial,
                                    ensure_in_ram, layout_and_upload,
                                    layout_host_store)
from tpulmi_torch.native import native_layout

torch.set_num_threads(1)

N, D, N_CAT = 3000, 32, 7


def _data(seed=5, normalize=True):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, N_CAT, size=N).astype(np.int32)
    pred[:40] = 3                    # one bucket larger than the others
    x = rng.normal(size=(N, D)).astype(np.float32) * 2.0
    if normalize:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return pred, x


def _pair(x, src, tmp_path=None):
    """(JAX package's corpus, port's corpus) of float32 `x` as `src`; on
    disk as memory maps when `tmp_path` is given. The JAX package's float32
    map is copy-on-write: its source-sequential path normalizes the rows it
    reads in place, which a read-only map refuses (the port's does not)."""
    if src == "bfloat16":
        bits = x.astype(ml_dtypes.bfloat16).view(np.uint16)
        if tmp_path is not None:
            np.save(tmp_path / "corpus.npy", bits)
            bits = np.load(tmp_path / "corpus.npy", mmap_mode="r")
        return bits.view(ml_dtypes.bfloat16), HostBF16(bits)
    if tmp_path is not None:
        np.save(tmp_path / "corpus.npy", x)
        return (np.load(tmp_path / "corpus.npy", mmap_mode="c"),
                np.load(tmp_path / "corpus.npy", mmap_mode="r"))
    return x, x


def _bytes(arr):
    return np.asarray(getattr(arr, "bits", arr)).view(np.uint8)


def _same(got, want):
    np.testing.assert_array_equal(_bytes(got.data_sorted),
                                  _bytes(want.data_sorted))
    np.testing.assert_array_equal(got.ids_sorted, want.ids_sorted)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.counts, want.counts)
    if want.scales is None:
        assert got.scales is None
    else:
        np.testing.assert_array_equal(got.scales, want.scales)
    assert (got.n, got.pad_rows, got.row_align, got.quant_bits) == (
        want.n, want.pad_rows, want.row_align, want.quant_bits)


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("store", ["bfloat16", "float32", "int8", "int4"])
@pytest.mark.parametrize("path", ["native", "numpy", "sequential"])
def test_layout_equals_reference_path(use_ref_native, monkeypatch, tmp_path,
                                      path, store, src, normalized):
    from tpulmi import hoststore as ref_hoststore

    pred, x = _data(normalize=normalized)
    if path == "numpy":
        monkeypatch.setattr(type(use_ref_native), "available",
                            lambda self: False)
        monkeypatch.setattr(type(native_layout), "available",
                            lambda self: False)
    if path == "sequential":
        monkeypatch.setenv("TPULMI_MATERIALIZE_MAX_FRAC", "0")
    ref_src, port_src = _pair(x, src, tmp_path if path == "sequential"
                              else None)
    kw = dict(row_align=64, store_dtype=store, normalized=normalized,
              pad_rows=100, chunk=700)
    marks = {"ref": [], "port": []}
    allocs = []
    want = ref_hoststore.layout_host_store(
        pred, ref_src, N_CAT, progress_cb=marks["ref"].append, **kw)
    before = native_layout.calls["scatter_rows"]
    got = layout_host_store(
        pred, port_src, N_CAT, progress_cb=marks["port"].append,
        on_alloc=lambda s, rows: allocs.append((s, rows)), **kw)
    _same(got, want)
    assert marks["port"] == marks["ref"]
    assert marks["port"] == sorted(marks["port"])
    assert marks["port"][-1] == got.data_sorted.shape[0]
    assert len(allocs) == 1 and allocs[0][0] is got.data_sorted
    native_calls = native_layout.calls["scatter_rows"] - before
    assert (native_calls > 0) == (path == "native" and store != "int4")
    if store == "bfloat16":
        assert isinstance(got.data_sorted, HostBF16)


def test_ensure_in_ram(tmp_path, monkeypatch):
    from tpulmi import hoststore as ref_hoststore

    _, x = _data()
    ref_mm, port_mm = _pair(x, "bfloat16", tmp_path)
    got = ensure_in_ram(port_mm)
    assert isinstance(got, HostBF16) and not hoststore.is_memory_mapped(got)
    np.testing.assert_array_equal(got.bits, port_mm.bits)
    want = ref_hoststore.ensure_in_ram(ref_mm)
    np.testing.assert_array_equal(got.bits, want.view(np.uint16))
    np.save(tmp_path / "f32.npy", x)
    mm = np.load(tmp_path / "f32.npy", mmap_mode="r")
    assert hoststore.is_memory_mapped(mm) and hoststore.is_memory_mapped(
        mm[10:20])
    ram = ensure_in_ram(mm[10:20])
    assert not hoststore.is_memory_mapped(ram)
    np.testing.assert_array_equal(ram, x[10:20])
    # refused above max_frac: the memory map comes back as it is
    assert ensure_in_ram(mm, max_frac=0.0) is mm
    assert ensure_in_ram(port_mm, max_frac=0.0) is port_mm
    monkeypatch.setenv("TPULMI_MATERIALIZE_MAX_FRAC", "0")
    assert ensure_in_ram(mm) is mm
    assert ref_hoststore.ensure_in_ram(mm) is mm
    # anything that is not mapped is returned untouched
    assert ensure_in_ram(x) is x


def _rss_file_bytes():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssFile:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("no RssFile in /proc/self/status")


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_ensure_in_ram_releases_the_map_slice_by_slice(tmp_path, monkeypatch,
                                                      kind):
    """The copy goes slice by slice, each slice's pages dropped from this
    process once copied: the copy equals the map, and the map's pages do
    not stay resident beside it."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40_000, 256)).astype(np.float32)   # 41 MB
    np.save(tmp_path / "x.npy", x.view(np.uint16) if kind == "bfloat16"
            else x)
    mm = np.load(tmp_path / "x.npy", mmap_mode="r")
    src = HostBF16(mm) if kind == "bfloat16" else mm
    monkeypatch.setattr(hoststore, "COPY_SLICE_BYTES", 1 << 20)
    before = _rss_file_bytes()
    got = ensure_in_ram(src)
    assert _rss_file_bytes() - before < 8 << 20
    assert not hoststore.is_memory_mapped(got)
    np.testing.assert_array_equal(getattr(got, "bits", got),
                                  getattr(src, "bits", src))
    # released pages read back as they were, and other arrays are left alone
    np.testing.assert_array_equal(np.asarray(mm[-5:]), np.load(
        tmp_path / "x.npy")[-5:])
    hoststore.release_pages(x)
    cow = np.load(tmp_path / "x.npy", mmap_mode="c")
    cow[0, 0] = 7
    hoststore.release_pages(cow)
    assert cow[0, 0] == 7


def test_ram_size_takes_the_control_groups_limit(tmp_path, monkeypatch):
    limit = tmp_path / "memory.max"
    limit.write_text("12345678\n")
    monkeypatch.setattr(hoststore, "CGROUP_LIMITS",
                        (str(tmp_path / "absent"), str(limit)))
    assert hoststore._mem_total_bytes() == 12345678
    limit.write_text("max\n")                         # no limit: the RAM
    total = hoststore._mem_total_bytes()
    assert total is not None and total > 12345678
    monkeypatch.setattr(hoststore, "CGROUP_LIMITS", (str(limit),))
    assert hoststore._mem_total_bytes() == total


@pytest.mark.parametrize("store", ["bfloat16", "float32", "int8", "int4"])
def test_layout_and_upload_overlap_equals_blocking(store, caplog):
    import logging

    pred, x = _data(seed=6)
    kw = dict(device="cpu", row_align=64, store_dtype=store, normalized=True,
              pad_rows=128, chunk=500)
    a_b, dev_b = layout_and_upload(pred, x, N_CAT, overlap=False, **kw)
    with caplog.at_level(logging.INFO, logger="tpulmi_torch.hoststore"):
        # small slabs: many copies, and a ragged last one
        a_o, dev_o = layout_and_upload(pred, x, N_CAT, overlap=True,
                                       slab_rows=300, **kw)
    assert any("completed in-stream" in r.getMessage()
               for r in caplog.records)
    _same(a_o, a_b)
    assert dev_o.dtype == dev_b.dtype == {
        "bfloat16": torch.bfloat16, "float32": torch.float32,
        "int8": torch.int8, "int4": torch.int8}[store]
    assert torch.equal(dev_o, dev_b)
    assert torch.equal(dev_b, hoststore.host_tensor(a_b.data_sorted))


def test_uploader_error_is_raised(monkeypatch):
    pred, x = _data(seed=7)

    def broken(*a, **kw):
        raise RuntimeError("no room on the card")

    monkeypatch.setattr(hoststore, "_device_buffer", broken)
    with pytest.raises(RuntimeError, match="no room"):
        layout_and_upload(pred, x, N_CAT, device="cpu", overlap=True,
                          row_align=64, store_dtype="float32",
                          normalized=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_slab_upload_serial_roundtrip(dtype):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1000, 16)).astype(np.float32)
    host = {"float32": x, "bfloat16": HostBF16.from_float32(x),
            "int8": np.clip(np.rint(x * 40), -127, 127).astype(np.int8)}[
        dtype]
    buf = _slab_upload_serial(host, slab_rows=256, device="cpu")
    assert buf.shape == (1000, 16)
    assert torch.equal(buf, hoststore.host_tensor(host))


def test_host_bf16_array():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(50, 6)).astype(np.float32)
    x[0, 0] = np.float32(1.00390625)          # a tie: rounds to even
    b = HostBF16.from_float32(x)
    want = x.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(b.bits, want.view(np.uint16))
    assert str(b.dtype) == "bfloat16" and b.shape == (50, 6) and len(b) == 50
    np.testing.assert_array_equal(np.asarray(b), want.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(b[3:5], np.float16),
                                  want[3:5].astype(np.float16))
    assert torch.equal(b.to_torch(), torch.from_numpy(x).to(torch.bfloat16))
    c = HostBF16.zeros((50, 6))
    c[[4, 2]] = b[[1, 3]]
    np.testing.assert_array_equal(c.bits[[4, 2]], b.bits[[1, 3]])
    with pytest.raises(TypeError):
        HostBF16(np.zeros(3, np.int16))


def test_synthetic_big_cache_equals_reference(tmp_path):
    from tpulmi.data import synthetic_dataset_big as ref_big
    from tpulmi_torch.data import synthetic_dataset_big

    kw = dict(n=2500, n_queries=30, d_nav=8, d_search=24, n_clusters=5,
              seed=3, chunk=1000)
    want = ref_big(cache_dir=str(tmp_path / "ref"), **kw)
    got = synthetic_dataset_big(cache_dir=str(tmp_path / "port"), **kw)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 4 and all(n.endswith("_h_" + n.split("_h_")[1])
                                   for n in names)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "ref" / name).read_bytes(), name
    assert isinstance(got["data_search"], HostBF16)
    assert hoststore.is_memory_mapped(got["data_search"])
    assert isinstance(got["data_nav"], np.memmap)
    np.testing.assert_array_equal(got["data_search"].bits,
                                  want["data_search"].view(np.uint16))
    np.testing.assert_array_equal(got["queries_search"],
                                  want["queries_search"])
    # each package reads the other's cache
    again = synthetic_dataset_big(cache_dir=str(tmp_path / "ref"), **kw)
    np.testing.assert_array_equal(again["data_search"].bits,
                                  got["data_search"].bits)
    np.testing.assert_array_equal(again["queries_nav"], got["queries_nav"])
    # the device generator takes neither package's host cache for its own:
    # it writes its own tag beside them
    dev = synthetic_dataset_big(cache_dir=str(tmp_path / "ref"),
                                backend="device", device="cpu", **kw)
    mine = sorted(p.name for p in (tmp_path / "ref").iterdir()
                  if p.name not in names)
    assert len(mine) == 4 and all("_s3_tcpu_" in n for n in mine)
    assert dev["data_search"].shape == got["data_search"].shape
    assert not np.array_equal(dev["data_search"].bits,
                              got["data_search"].bits)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_source_sequential_layout_releases_each_chunks_pages(
        monkeypatch, tmp_path, src, store):
    """The source-sequential scatter drops the map's pages after every
    chunk it has read (`release_pages`, counted by a spy), and lays out the
    same store as a scatter that releases nothing, to the bit; the gather
    over an array in RAM releases nothing."""
    pred, x = _data()
    _, port_src = _pair(x, src, tmp_path)
    monkeypatch.setenv("TPULMI_MATERIALIZE_MAX_FRAC", "0")
    kw = dict(row_align=64, store_dtype=store, normalized=True,
              pad_rows=100, chunk=700)
    real, calls = hoststore.release_pages, []

    def spy(arr):
        calls.append(arr)
        real(arr)

    monkeypatch.setattr(hoststore, "release_pages", spy)
    got = layout_host_store(pred, port_src, N_CAT, **kw)
    assert len(calls) == -(-N // 700)
    assert all(a is port_src for a in calls)
    layout_host_store(pred, x, N_CAT, **kw)
    assert len(calls) == -(-N // 700)
    monkeypatch.setattr(hoststore, "release_pages", lambda arr: None)
    _same(got, layout_host_store(pred, port_src, N_CAT, **kw))
