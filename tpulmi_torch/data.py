"""Data layer: normalization, SISAP h5 loading, the SISAP result writer,
and the synthetic clustered datasets.

`synthetic_dataset` gives the same arrays as the JAX package's for the same
arguments and seed, and `synthetic_dataset_big(backend="host")` the same
files: the two packages read each other's caches.
`synthetic_dataset_big(backend="device")` makes its chunks on the card
(torch). Fetching the SISAP files is not part of this package:
`load_dataset` reads them from ``data_dir``.
"""

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from tpulmi_torch.utils.logging import get_logger
from tpulmi_torch.utils.profiling import resolve_device, sync

log = get_logger("tpulmi_torch.data")

def normalize(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """L2-normalize rows (float32)."""
    x = np.asarray(x, dtype=np.float32)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(norms, eps)


def load_h5(path: str, key: str) -> np.ndarray:
    """Load one dataset from an HDF5 file into host memory as float32."""
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f[key], dtype=np.float32)


def load_dataset(kind: str, key: str, size: str, data_dir: str = "data",
                 preprocess: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Load (dataset, queries) for a SISAP (kind, size) pair from
    ``data_dir/kind/size/{dataset,query}.h5``, optionally L2-normalized."""
    paths = [os.path.join(data_dir, kind, size, f"{v}.h5")
             for v in ("dataset", "query")]
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(f"{p} not found (SISAP {kind}/{size})")
    data, queries = (load_h5(p, key) for p in paths)
    if preprocess:
        data, queries = normalize(data), normalize(queries)
    return data, queries


def store_results(dst: str, algo: str, kind: str, dists: np.ndarray,
                  anns: np.ndarray, buildtime: float, querytime: float,
                  params: str, size: str) -> None:
    """Write a SISAP-format result file (the reference writer's layout).
    `anns` must already be 1-based."""
    import h5py

    os.makedirs(Path(dst).parent, exist_ok=True)
    with h5py.File(dst, "w") as f:
        f.attrs["algo"] = algo
        f.attrs["data"] = kind
        f.attrs["buildtime"] = buildtime
        f.attrs["querytime"] = querytime
        f.attrs["size"] = size
        f.attrs["params"] = params
        f.create_dataset("knns", anns.shape, dtype=anns.dtype)[:] = anns
        f.create_dataset("dists", dists.shape, dtype=dists.dtype)[:] = dists


def synthetic_dataset(
    n: int,
    n_queries: int,
    d_nav: int = 96,
    d_search: int = 768,
    n_clusters: int = 122,
    seed: int = 2023,
    cluster_std: float = 0.9,
    skew: float = 1.5,
    zipf: float = 0.0,
    ood_queries: float = 0.0,
    nav_decorrelation: float = 0.0,
) -> Dict[str, np.ndarray]:
    """Clustered synthetic data shaped like the LAION subsets: a low-dim
    navigation view and a high-dim search view of the same points, both
    L2-normalized, with a skewed cluster-size profile. The views are linked
    by a fixed random linear map.

    Hard-mode knobs: ``cluster_std`` (overlap), ``zipf > 0`` (Zipf cluster
    sizes), ``ood_queries`` (fraction of queries uniform on the sphere),
    ``nav_decorrelation`` (noise mixed in before the nav projection)."""
    rng = np.random.default_rng(seed)
    if zipf > 0:
        weights = 1.0 / np.arange(1, n_clusters + 1, dtype=np.float64) ** zipf
        weights = rng.permutation(weights)
    else:
        weights = rng.random(n_clusters) ** skew
    weights /= weights.sum()
    assignments = rng.choice(n_clusters, size=n, p=weights)

    centers_search = rng.normal(size=(n_clusters, d_search)).astype(np.float32)
    centers_search /= np.linalg.norm(centers_search, axis=1, keepdims=True)

    # cluster_std is the expected noise norm relative to the unit centers
    noise_scale = cluster_std / np.sqrt(d_search)
    data_search = centers_search[assignments] + noise_scale * rng.normal(
        size=(n, d_search)
    ).astype(np.float32)

    proj = rng.normal(size=(d_search, d_nav)).astype(np.float32) / np.sqrt(d_search)
    if nav_decorrelation > 0:
        mix = np.sqrt(1.0 - nav_decorrelation ** 2)
        nav_src = (mix * data_search
                   + nav_decorrelation * rng.normal(
                       size=(n, d_search)).astype(np.float32)
                   / np.sqrt(d_search))
    else:
        nav_src = data_search
    data_nav = nav_src @ proj

    q_assign = rng.choice(n_clusters, size=n_queries, p=weights)
    queries_search = centers_search[q_assign] + noise_scale * rng.normal(
        size=(n_queries, d_search)
    ).astype(np.float32)
    if ood_queries > 0:
        n_ood = int(round(ood_queries * n_queries))
        ood = rng.normal(size=(n_ood, d_search)).astype(np.float32)
        queries_search[:n_ood] = ood
    if nav_decorrelation > 0:
        mix = np.sqrt(1.0 - nav_decorrelation ** 2)
        q_nav_src = (mix * queries_search
                     + nav_decorrelation * rng.normal(
                         size=(n_queries, d_search)).astype(np.float32)
                     / np.sqrt(d_search))
    else:
        q_nav_src = queries_search
    queries_nav = q_nav_src @ proj

    return {
        "data_nav": normalize(data_nav),
        "data_search": normalize(data_search),
        "queries_nav": normalize(queries_nav),
        "queries_search": normalize(queries_search),
        "cluster_assignments": assignments,
    }


# the queries' random stream in both big generators: no chunk has this index
QUERY_STREAM = 1_000_003


def synthetic_dataset_big(
    n: int,
    n_queries: int,
    d_nav: int = 96,
    d_search: int = 768,
    n_clusters: int = 122,
    seed: int = 2023,
    cluster_std: float = 0.9,
    skew: float = 1.5,
    cache_dir: str = ".bench_cache",
    chunk: int = 1_000_000,
    backend: str = "host",
    device="cuda",
) -> Dict[str, object]:
    """Multi-million-row variant of `synthetic_dataset`, generated in
    chunks straight into an on-disk ``.npy`` cache: the search vectors as
    bfloat16 (stored as uint16 bits), the navigation view as float32.
    Returns memory maps: ``data_search`` as a
    `tpulmi_torch.hoststore.HostBF16` over the cache file, ``data_nav`` as a
    float32 memory map; the queries as float32 arrays (the search queries
    rounded through bfloat16 and normalized again). All views are
    L2-normalized. Both backends draw the cluster weights, assignments,
    centers and projection from ``np.random.default_rng(seed)`` in the JAX
    package's order, and give each chunk a random stream of its own, so a
    killed generation resumes at its first unwritten chunk (a sidecar
    marker records the rows done). Statistically they match
    `synthetic_dataset`; the per-chunk streams give other values.

    ``backend="host"``: numpy on the host. Its streams, file names, tag
    (``_h``) and format are the JAX package's ``backend="host"`` ones, so
    each package reads the other's cache.

    ``backend="device"``: the JAX package's generator on the accelerator,
    here on ``device`` (default "cuda"; without a card that raises, nothing
    moves to the CPU). The draws go to the device once; each chunk's noise
    comes from a `torch.Generator` on the device seeded from (seed, chunk
    index) alone, and `gen_chunk` makes the chunk as the JAX package does.
    One device type gives the same bits in every run; jax.random gives
    other ones, so the tag records this generator and the device type
    (``_tcuda``, ``_tcpu``), and a cache of the JAX package's device
    generator (no suffix) is not loaded here. Chunks come back through
    pinned buffers into the memory maps while the next one is made; the
    seconds of each stage are logged.
    """
    tag = f"big_n{n}_q{n_queries}_dn{d_nav}_ds{d_search}_c{n_clusters}_s{seed}"
    if backend == "host":
        tag += "_h"
    elif backend == "device":
        device = resolve_device(device)
        tag += f"_t{device.type}"
    else:
        raise ValueError(f"backend must be 'host' or 'device', got "
                         f"{backend!r}")
    os.makedirs(cache_dir, exist_ok=True)
    paths = {k: os.path.join(cache_dir, f"{tag}_{k}.npy")
             for k in ("data_nav", "data_search", "queries_nav",
                       "queries_search")}
    if all(os.path.exists(p) for p in paths.values()):
        log.info("loaded cached big dataset %s", tag)
        return _load_big(paths)
    t = time.perf_counter()
    draws = _big_draws(n, n_queries, d_nav, d_search, n_clusters, seed,
                       cluster_std, skew)
    draws_s = time.perf_counter() - t
    if backend == "host":
        _synthetic_big_host(draws, seed, chunk, paths)
    else:
        _synthetic_big_device(draws, seed, chunk, paths, device, draws_s)
    return _load_big(paths)


def _load_big(paths):
    from tpulmi_torch.hoststore import HostBF16

    return {
        "data_nav": np.load(paths["data_nav"], mmap_mode="r"),
        "data_search": HostBF16(np.load(paths["data_search"],
                                        mmap_mode="r")),
        "queries_nav": np.load(paths["queries_nav"]),
        "queries_search": np.load(paths["queries_search"]),
    }


def _big_draws(n, n_queries, d_nav, d_search, n_clusters, seed, cluster_std,
               skew):
    """The numpy-side draws of both big generators, in the JAX package's
    order: (assignments, query assignments, unit centers, projection,
    noise scale as float32)."""
    rng = np.random.default_rng(seed)
    weights = rng.random(n_clusters) ** skew
    weights /= weights.sum()
    assignments = rng.choice(n_clusters, size=n, p=weights).astype(np.int32)
    q_assign = rng.choice(n_clusters, size=n_queries, p=weights).astype(
        np.int32)
    centers = rng.normal(size=(n_clusters, d_search)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    proj = rng.normal(size=(d_search, d_nav)).astype(np.float32) / np.sqrt(
        d_search)
    return (assignments, q_assign, centers, proj,
            np.float32(cluster_std / np.sqrt(d_search)))


def _open_big_cache(paths, n, d_search, d_nav):
    """The two memory maps a generator writes, the rows a killed
    generation already wrote (its marker) and the marker's path."""
    marker = paths["data_search"] + ".progress"
    done_rows = 0
    if (os.path.exists(marker) and os.path.exists(paths["data_search"])
            and os.path.exists(paths["data_nav"])):
        try:
            with open(marker) as f:
                done_rows = min(int(f.read().strip() or 0), n)
        except (OSError, ValueError):
            done_rows = 0
    resume = done_rows > 0
    try:
        ds_mm = np.lib.format.open_memmap(
            paths["data_search"], mode="r+" if resume else "w+",
            dtype=np.uint16, shape=(n, d_search))
        dn_mm = np.lib.format.open_memmap(
            paths["data_nav"], mode="r+" if resume else "w+",
            dtype=np.float32, shape=(n, d_nav))
    except ValueError:  # a stale file of another shape or dtype
        done_rows = 0
        ds_mm = np.lib.format.open_memmap(
            paths["data_search"], mode="w+", dtype=np.uint16,
            shape=(n, d_search))
        dn_mm = np.lib.format.open_memmap(
            paths["data_nav"], mode="w+", dtype=np.float32, shape=(n, d_nav))
    return ds_mm, dn_mm, done_rows, marker


def _mark(marker, rows):
    with open(marker, "w") as f:
        f.write(str(rows))


def _save_queries(paths, q_bits, q_nav):
    """The queries' files: the search queries go through bfloat16 and are
    normalized again in float32."""
    from tpulmi_torch.hoststore import bf16_bits_to_f32

    qx = bf16_bits_to_f32(q_bits)
    qx /= np.maximum(np.linalg.norm(qx, axis=1, keepdims=True), 1e-12)
    np.save(paths["queries_nav"], q_nav)
    np.save(paths["queries_search"], qx)


def _synthetic_big_host(draws, seed, chunk, paths):
    """The chunked host generator of `synthetic_dataset_big`: writes the
    ``.npy`` cache through memory maps."""
    from tpulmi_torch.hoststore import f32_to_bf16_bits

    assignments, q_assign, centers, proj, noise_scale = draws
    n, d_search, d_nav = len(assignments), centers.shape[1], proj.shape[1]

    def gen_chunk(stream_key, assign_chunk):
        rs = np.random.default_rng([seed, 11, stream_key])
        x = centers[assign_chunk]
        x += noise_scale * rs.standard_normal(x.shape, dtype=np.float32)
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True),
                        np.float32(1e-12))
        nav = x @ proj
        nav /= np.maximum(np.linalg.norm(nav, axis=1, keepdims=True),
                          np.float32(1e-12))
        return x, nav

    ds_mm, dn_mm, done_rows, marker = _open_big_cache(paths, n, d_search,
                                                      d_nav)
    if done_rows:
        log.info("big datagen (host): resuming at %d/%d rows", done_rows, n)
    for i, lo in enumerate(range(0, n, chunk)):
        hi = min(lo + chunk, n)
        if hi <= done_rows:
            continue
        x, nav = gen_chunk(i, assignments[lo:hi])
        ds_mm[lo:hi] = f32_to_bf16_bits(x)
        dn_mm[lo:hi] = nav
        _mark(marker, hi)
        log.info("big datagen (host): %d/%d rows", hi, n)
    ds_mm.flush()
    dn_mm.flush()
    del ds_mm, dn_mm
    if os.path.exists(marker):
        os.remove(marker)
    qx, qnav = gen_chunk(QUERY_STREAM, q_assign)
    _save_queries(paths, f32_to_bf16_bits(qx), qnav)


@contextlib.contextmanager
def _full_float32():
    """float32 matrix products in full float32 (no TF32) inside, whatever
    the caller set; restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def gen_chunk(centers: torch.Tensor, proj: torch.Tensor,
              assign: torch.Tensor, noise: torch.Tensor, noise_scale: float):
    """One chunk of the device generator, as the JAX package writes it
    (``tpulmi/data.py``, ``backend="device"``): the rows' centers plus
    ``noise_scale * noise``, L2-normalized (norms floored at 1e-12),
    projected by `proj` in float32 and normalized again. Returns (the
    search rows rounded to bfloat16, the navigation rows in float32)."""
    x = centers[assign] + noise_scale * noise
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                        min=1e-12)
    with _full_float32():
        nav = x @ proj
    nav = nav / torch.clamp(torch.linalg.vector_norm(nav, dim=1,
                                                     keepdim=True),
                            min=1e-12)
    return x.to(torch.bfloat16), nav


def chunk_noise(seed: int, index: int, shape, device) -> torch.Tensor:
    """The standard normal float32 noise of chunk `index` (`QUERY_STREAM`:
    the queries), from a `torch.Generator` on `device` seeded from (seed,
    index) alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, 13, index])
                        .generate_state(1, np.uint64)[0]))
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def _synthetic_big_device(draws, seed, chunk, paths, device, draws_s):
    """The chunked device generator of `synthetic_dataset_big`: each chunk
    is made on `device`, copied into one of two pinned buffers and written
    into the memory maps by a writer thread while the next chunk is made
    (a buffer is reused once its write has finished); a flusher thread then
    puts each written chunk on disk, drops the maps' pages and only then
    moves the resume marker past it."""
    from tpulmi_torch import hoststore

    t_all = time.perf_counter()
    assignments, q_assign, centers, proj, noise_scale = draws
    n, d_search, d_nav = len(assignments), centers.shape[1], proj.shape[1]
    scale = float(noise_scale)
    centers_d = torch.as_tensor(centers, device=device)
    proj_d = torch.as_tensor(proj, dtype=torch.float32, device=device)
    assign_d = torch.as_tensor(assignments, device=device)
    ds_mm, dn_mm, done_rows, marker = _open_big_cache(paths, n, d_search,
                                                      d_nav)
    if done_rows:
        log.info("big datagen (%s): resuming at %d/%d rows", device.type,
                 done_rows, n)
    rows = min(chunk, n)
    pin = device.type == "cuda"
    bufs = [(torch.empty((rows, d_search), dtype=torch.int16, pin_memory=pin),
             torch.empty((rows, d_nav), dtype=torch.float32, pin_memory=pin))
            for _ in range(2)]
    secs = {"gen": 0.0, "copy": 0.0, "write": 0.0, "flush": 0.0}
    fds = [os.open(paths[k], os.O_RDWR) for k in ("data_search", "data_nav")]

    def flush(hi):
        # to disk, then out of the page cache: a corpus larger than the
        # host's memory must not stay resident as it is written; the
        # marker names only rows that are on disk
        t = time.perf_counter()
        for fd, mm in zip(fds, (ds_mm, dn_mm)):
            os.fsync(fd)
            hoststore.release_pages(mm)
        _mark(marker, hi)
        secs["flush"] += time.perf_counter() - t

    def write(buf, lo, hi):
        if len(flushes) >= 2:
            # at most two chunks' pages wait for the disk beside this one
            flushes[-2].result()
        t = time.perf_counter()
        ds_mm[lo:hi] = buf[0][:hi - lo].numpy().view(np.uint16)
        dn_mm[lo:hi] = buf[1][:hi - lo].numpy()
        secs["write"] += time.perf_counter() - t
        flushes.append(flusher.submit(flush, hi))

    pending, flushes = [None, None], []
    try:
        # the writer shuts down first, so every chunk it wrote is flushed
        with ThreadPoolExecutor(max_workers=1) as flusher, \
                ThreadPoolExecutor(max_workers=1) as writer:
            for i, lo in enumerate(range(0, n, chunk)):
                hi = min(lo + chunk, n)
                if hi <= done_rows:
                    continue
                t = time.perf_counter()
                x, nav = gen_chunk(
                    centers_d, proj_d, assign_d[lo:hi].long(),
                    chunk_noise(seed, i, (hi - lo, d_search), device), scale)
                sync(device)
                secs["gen"] += time.perf_counter() - t
                slot = i % 2
                if pending[slot] is not None:
                    pending[slot].result()
                t = time.perf_counter()
                bufs[slot][0][:hi - lo].copy_(x.view(torch.int16))
                bufs[slot][1][:hi - lo].copy_(nav)
                secs["copy"] += time.perf_counter() - t
                del x, nav
                pending[slot] = writer.submit(write, bufs[slot], lo, hi)
                log.info("big datagen (%s): %d/%d rows", device.type, hi, n)
            for job in pending:
                if job is not None:
                    job.result()
        for job in flushes:
            job.result()
    finally:
        for fd in fds:
            os.close(fd)
    t = time.perf_counter()
    ds_mm.flush()
    dn_mm.flush()
    del ds_mm, dn_mm
    flush_s = time.perf_counter() - t
    if os.path.exists(marker):
        os.remove(marker)
    qx, qnav = gen_chunk(
        centers_d, proj_d, torch.as_tensor(q_assign, device=device).long(),
        chunk_noise(seed, QUERY_STREAM, (len(q_assign), d_search), device),
        scale)
    _save_queries(paths, qx.view(torch.int16).cpu().numpy().view(np.uint16),
                  qnav.cpu().numpy())
    log.info("big datagen (%s): %d rows written from row %d: draws %.2fs, "
             "generation on the device %.2fs, copy back %.2fs, write into "
             "the memory maps %.2fs and flush to disk with the pages dropped "
             "%.2fs (each beside the next chunks), last flush %.2fs; %.2fs "
             "in all", device.type, n - done_rows, done_rows, draws_s,
             secs["gen"], secs["copy"], secs["write"], secs["flush"],
             flush_s, draws_s + time.perf_counter() - t_all)
