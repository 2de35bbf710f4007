"""`tpulmi_torch.data.synthetic_dataset_big(backend="device")` against the
JAX package's device generator (``tpulmi/data.py``), on the CPU.

The two packages draw their noise from different generators (torch's and
jax.random), so the comparison feeds both the same noise: `jax.random.normal`
is replaced inside these tests only, the JAX path runs eagerly
(`jax.disable_jit`) so that each chunk asks for its own, and the port's
`chunk_noise` hands back the same arrays. Tolerances: the two packages take
the norms in other summing orders, so a search row may round to the other
bfloat16 neighbour where it lies within a float32 rounding of the midpoint
(one unit in the last place, rarely); the float32 navigation rows agree
within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulmi.data import synthetic_dataset_big as jax_big
from tpulmi_torch import data as tdata
from tpulmi_torch.data import QUERY_STREAM, synthetic_dataset_big
from tpulmi_torch.hoststore import HostBF16, is_memory_mapped

KW = dict(n=3000, n_queries=40, d_nav=8, d_search=24, n_clusters=5, seed=3,
          chunk=1000)
NAMES = ("data_nav", "data_search", "queries_nav", "queries_search")


def _port(tmp_path, sub="port", **over):
    return synthetic_dataset_big(cache_dir=str(tmp_path / sub),
                                 backend="device", device="cpu",
                                 **{**KW, **over})


def _jax_with_noise(tmp_path, monkeypatch, **over):
    """The JAX package's device path, eagerly, with numpy noise in place of
    jax.random's; returns (its result, the noise of each chunk in order,
    the queries' last)."""
    rng = np.random.default_rng(11)
    noises = []

    def normal(key, shape, dtype=jnp.float32):
        noises.append(rng.standard_normal(shape).astype(np.float32))
        return jnp.asarray(noises[-1])

    monkeypatch.setattr(jax.random, "normal", normal)
    with jax.disable_jit():
        out = jax_big(cache_dir=str(tmp_path / "jax"), backend="device",
                      **{**KW, **over})
    monkeypatch.undo()
    return out, noises


def _feed(monkeypatch, noises):
    """The port's noise replaced by `noises` (chunk i -> noises[i], the
    queries -> the last); returns the list of chunk indices asked for."""
    asked = []

    def noise(seed, index, shape, device):
        asked.append(index)
        arr = noises[-1] if index == QUERY_STREAM else noises[index]
        assert arr.shape == tuple(shape)
        return torch.from_numpy(arr).to(device)

    monkeypatch.setattr(tdata, "chunk_noise", noise)
    return asked


def test_device_path_equals_jax_for_the_same_noise(tmp_path, monkeypatch):
    want, noises = _jax_with_noise(tmp_path, monkeypatch)
    assert len(noises) == 4                     # 3 chunks and the queries
    asked = _feed(monkeypatch, noises)
    got = _port(tmp_path)
    assert asked == [0, 1, 2, QUERY_STREAM]
    a = got["data_search"].bits.astype(np.int32)
    b = np.asarray(want["data_search"]).view(np.uint16).astype(np.int32)
    assert np.abs(a - b).max() <= 1             # one-ulp rounding ties
    assert (a != b).mean() <= 1e-3
    np.testing.assert_allclose(got["data_nav"], want["data_nav"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["queries_nav"], want["queries_nav"],
                               rtol=0, atol=1e-6)
    # the search queries: rounded through bfloat16, normalized again; a row
    # holding a tie moves by up to one bfloat16 step of its values
    qa, qb = got["queries_search"], want["queries_search"]
    assert np.all(np.abs(qa - qb) <= 2.0 ** -8 * np.abs(qb) + 1e-6)
    assert np.mean(np.abs(qa - qb).max(axis=1) <= 1e-6) >= 0.95


def test_gen_chunk_is_a_plain_function_of_its_inputs():
    rng = np.random.default_rng(4)
    centers = rng.normal(size=(6, 32)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    proj = (rng.normal(size=(32, 8)) / np.sqrt(32)).astype(np.float32)
    assign = rng.integers(0, 6, size=500)
    noise = rng.standard_normal((500, 32)).astype(np.float32)
    scale = np.float32(0.9 / np.sqrt(32))
    x, nav = tdata.gen_chunk(torch.from_numpy(centers),
                             torch.from_numpy(proj), torch.from_numpy(assign),
                             torch.from_numpy(noise), float(scale))
    assert x.dtype == torch.bfloat16 and nav.dtype == torch.float32
    ref = centers[assign] + scale * noise
    ref /= np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-12)
    rnav = ref @ proj
    rnav /= np.linalg.norm(rnav, axis=1, keepdims=True)
    np.testing.assert_allclose(x.float().numpy(), ref, rtol=2.0 ** -8,
                               atol=0)
    np.testing.assert_allclose(nav.numpy(), rnav, rtol=0, atol=1e-6)
    # TF32 is off inside and the caller's setting is restored
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tdata._full_float32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_numpy_draws_equal_jax(tmp_path):
    """At a small cluster_std every row lies next to its center: each row
    of the JAX package's device path (its own jax.random noise) has for
    nearest of the port's centers the port's assignment, and so do the
    port's own rows."""
    kw = dict(cluster_std=0.01)
    want = jax_big(cache_dir=str(tmp_path / "jax"), backend="device",
                   **KW, **kw)
    got = _port(tmp_path, **kw)
    assign, q_assign, centers, proj, scale = tdata._big_draws(
        KW["n"], KW["n_queries"], KW["d_nav"], KW["d_search"],
        KW["n_clusters"], KW["seed"], 0.01, 1.5)
    assert scale == np.float32(0.01 / np.sqrt(KW["d_search"]))
    for rows, labels in ((np.asarray(want["data_search"], np.float32),
                          assign),
                         (np.asarray(got["data_search"]), assign),
                         (want["queries_search"], q_assign),
                         (got["queries_search"], q_assign)):
        np.testing.assert_array_equal(np.argmax(rows @ centers.T, axis=1),
                                      labels)
    # the navigation view is the same projection of the same centers
    np.testing.assert_allclose(got["data_nav"], want["data_nav"], rtol=0,
                               atol=0.05)


def test_norms_are_one(tmp_path):
    got = _port(tmp_path)
    # bfloat16 keeps 8 bits: each value within 2**-9 of its own size
    search = np.linalg.norm(np.asarray(got["data_search"]), axis=1)
    assert np.all(np.abs(search - 1.0) <= 4e-3)
    for name in ("data_nav", "queries_nav", "queries_search"):
        norms = np.linalg.norm(np.asarray(got[name], np.float64), axis=1)
        assert np.all(np.abs(norms - 1.0) <= 1e-5), name


def test_cache_tag_and_format(tmp_path, monkeypatch):
    want, noises = _jax_with_noise(tmp_path, monkeypatch)
    got = _port(tmp_path)
    tag = "big_n3000_q40_dn8_ds24_c5_s3_tcpu"
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        f"{tag}_{k}.npy" for k in NAMES)
    files = {k: np.load(tmp_path / "port" / f"{tag}_{k}.npy") for k in NAMES}
    assert files["data_search"].dtype == np.uint16
    assert files["data_search"].shape == (3000, 24)
    assert files["data_nav"].dtype == np.float32
    assert files["data_nav"].shape == (3000, 8)
    assert files["queries_nav"].shape == (40, 8)
    assert files["queries_search"].dtype == np.float32
    assert files["queries_search"].shape == (40, 24)
    assert isinstance(got["data_search"], HostBF16)
    assert is_memory_mapped(got["data_search"])
    assert isinstance(got["data_nav"], np.memmap)
    np.testing.assert_array_equal(got["data_search"].bits,
                                  files["data_search"])
    # read back without generating
    monkeypatch.setattr(tdata, "chunk_noise", None)
    again = _port(tmp_path)
    for k in NAMES:
        a, b = again[k], got[k]
        a, b = (x.bits if isinstance(x, HostBF16) else x for x in (a, b))
        np.testing.assert_array_equal(a, b, err_msg=k)
    # the JAX package's device cache (no suffix) is not taken for its own
    jax_names = sorted(os.listdir(tmp_path / "jax"))
    assert all(n.startswith("big_n3000_q40_dn8_ds24_c5_s3_") and "_t" not in
               n.split("_s3_")[1] for n in jax_names)
    monkeypatch.undo()
    mine = synthetic_dataset_big(cache_dir=str(tmp_path / "jax"),
                                 backend="device", device="cpu", **KW)
    assert len(os.listdir(tmp_path / "jax")) == 8
    np.testing.assert_array_equal(mine["data_search"].bits,
                                  got["data_search"].bits)
    assert not np.array_equal(mine["data_search"].bits,
                              np.asarray(want["data_search"]).view(np.uint16))


def test_killed_generation_resumes_to_the_bit(tmp_path, monkeypatch):
    whole = _port(tmp_path, sub="whole")
    real = tdata.chunk_noise

    def dies_at_chunk_1(seed, index, shape, device):
        if index == 1:
            raise KeyboardInterrupt("killed")
        return real(seed, index, shape, device)

    monkeypatch.setattr(tdata, "chunk_noise", dies_at_chunk_1)
    with pytest.raises(KeyboardInterrupt):
        _port(tmp_path, sub="killed")
    marker = next((tmp_path / "killed").glob("*.progress"))
    assert marker.read_text() == "1000"
    asked = []

    def counted(seed, index, shape, device):
        asked.append(index)
        return real(seed, index, shape, device)

    monkeypatch.setattr(tdata, "chunk_noise", counted)
    resumed = _port(tmp_path, sub="killed")
    assert asked == [1, 2, QUERY_STREAM]
    assert not marker.exists()
    for name in sorted(os.listdir(tmp_path / "whole")):
        assert (tmp_path / "killed" / name).read_bytes() == (
            tmp_path / "whole" / name).read_bytes(), name
    np.testing.assert_array_equal(resumed["data_search"].bits,
                                  whole["data_search"].bits)


def test_chunk_noise_depends_on_seed_and_index_alone():
    a = tdata.chunk_noise(3, 2, (50, 24), "cpu")
    torch.randn(100)                           # the global stream moves on
    assert torch.equal(a, tdata.chunk_noise(3, 2, (50, 24), "cpu"))
    assert not torch.equal(a, tdata.chunk_noise(3, 1, (50, 24), "cpu"))
    assert not torch.equal(a, tdata.chunk_noise(4, 2, (50, 24), "cpu"))
    assert a.dtype == torch.float32 and abs(float(a.std()) - 1.0) < 0.1


def test_cuda_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_dataset_big(cache_dir=str(tmp_path / "c"),
                              backend="device", **KW)
    assert not (tmp_path / "c").exists()           # nothing was written
    with pytest.raises(ValueError, match="backend"):
        synthetic_dataset_big(cache_dir=str(tmp_path / "c"), backend="tpu",
                              **KW)


def test_generator_flushes_and_releases_every_chunk(tmp_path, monkeypatch):
    """Each chunk written is flushed and its maps' pages dropped
    (`hoststore.release_pages` on both maps, counted by a spy) before the
    resume marker moves past it; the cache equals a generation that
    releases nothing, byte for byte, and a killed generation resumes to
    the bit with its pages released (test_killed_generation_resumes_to_
    the_bit)."""
    from tpulmi_torch import hoststore

    real, calls, marks = hoststore.release_pages, [], []

    def spy(arr):
        calls.append(os.path.basename(arr.filename))
        real(arr)

    def mark(marker, rows):
        marks.append((rows, len(calls)))
        real_mark(marker, rows)

    real_mark = tdata._mark
    monkeypatch.setattr(hoststore, "release_pages", spy)
    monkeypatch.setattr(tdata, "_mark", mark)
    _port(tmp_path, sub="released")
    chunks = -(-KW["n"] // KW["chunk"])
    assert len(calls) == 2 * chunks
    assert sorted(set(calls)) == sorted(
        p.name for p in (tmp_path / "released").glob("*_data_*.npy"))
    # the marker names a chunk's rows only after both maps were released
    assert marks == [(KW["chunk"] * (i + 1), 2 * (i + 1))
                     for i in range(chunks)]
    monkeypatch.setattr(hoststore, "release_pages", lambda arr: None)
    _port(tmp_path, sub="kept")
    for name in sorted(os.listdir(tmp_path / "kept")):
        assert (tmp_path / "released" / name).read_bytes() == (
            tmp_path / "kept" / name).read_bytes(), name
