"""Host-side data layer (numpy and h5py only): normalization, SISAP h5
loading, the SISAP result writer, and the synthetic clustered datasets.

`synthetic_dataset` gives the same arrays as the JAX package's for the same
arguments and seed, and `synthetic_dataset_big(backend="host")` the same
files: the two packages read each other's caches. Fetching the SISAP files
is not part of this package: `load_dataset` reads them from ``data_dir``.
"""

import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from tpulmi_torch.utils.logging import get_logger

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
) -> Dict[str, object]:
    """Multi-million-row variant of `synthetic_dataset`, generated on the
    host in chunks straight into an on-disk ``.npy`` cache: the search
    vectors as bfloat16 (stored as uint16 bits), the navigation view as
    float32. Returns memory maps: ``data_search`` as a
    `tpulmi_torch.hoststore.HostBF16` over the cache file, ``data_nav`` as a
    float32 memory map; the queries as float32 arrays (the search queries
    rounded through bfloat16 and normalized again). All views are
    L2-normalized.

    The generator streams, file names, tag and format are the JAX package's
    ``backend="host"`` ones, so each package reads the other's cache, and a
    killed generation resumes at its first unwritten chunk. Statistically it
    matches `synthetic_dataset`, but per-chunk random streams give other
    values. ``backend="device"`` (the JAX package's generator on the
    accelerator, through ``jax.random``) is not ported: it loads an
    existing cache and raises NotImplementedError where it would generate.
    """
    from tpulmi_torch.hoststore import HostBF16

    os.makedirs(cache_dir, exist_ok=True)
    tag = f"big_n{n}_q{n_queries}_dn{d_nav}_ds{d_search}_c{n_clusters}_s{seed}"
    if backend == "host":
        tag += "_h"
    paths = {k: os.path.join(cache_dir, f"{tag}_{k}.npy")
             for k in ("data_nav", "data_search", "queries_nav",
                       "queries_search")}
    if all(os.path.exists(p) for p in paths.values()):
        log.info("loaded cached big dataset %s", tag)
        return {
            "data_nav": np.load(paths["data_nav"], mmap_mode="r"),
            "data_search": HostBF16(np.load(paths["data_search"],
                                            mmap_mode="r")),
            "queries_nav": np.load(paths["queries_nav"]),
            "queries_search": np.load(paths["queries_search"]),
        }
    if backend != "host":
        raise NotImplementedError(
            f"synthetic_dataset_big(backend={backend!r}) generates with "
            "jax.random and is not ported (ROADMAP.md); use backend='host'")
    return _synthetic_big_host(n, n_queries, d_nav, d_search, n_clusters, seed,
                               cluster_std, skew, chunk, paths)


def _synthetic_big_host(n, n_queries, d_nav, d_search, n_clusters, seed,
                        cluster_std, skew, chunk, paths):
    """The chunked host generator of `synthetic_dataset_big`: writes the
    ``.npy`` cache as memory maps and returns read-only maps of it."""
    from tpulmi_torch.hoststore import (HostBF16, bf16_bits_to_f32,
                                        f32_to_bf16_bits)

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
    noise_scale = np.float32(cluster_std / np.sqrt(d_search))

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

    # Per-chunk random streams do not depend on the order chunks finish in,
    # so a killed generation resumes at the first unwritten chunk (the
    # sidecar marker records the rows done).
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
    if done_rows:
        log.info("big datagen (host): resuming at %d/%d rows", done_rows, n)
    for i, lo in enumerate(range(0, n, chunk)):
        hi = min(lo + chunk, n)
        if hi <= done_rows:
            continue
        x, nav = gen_chunk(i, assignments[lo:hi])
        ds_mm[lo:hi] = f32_to_bf16_bits(x)
        dn_mm[lo:hi] = nav
        with open(marker, "w") as f:
            f.write(str(hi))
        log.info("big datagen (host): %d/%d rows", hi, n)
    ds_mm.flush()
    dn_mm.flush()
    del ds_mm, dn_mm
    if os.path.exists(marker):
        os.remove(marker)

    qx, qnav = gen_chunk(1_000_003, q_assign)  # no chunk has this index
    # the queries go through bfloat16 and are normalized again in float32
    qx = bf16_bits_to_f32(f32_to_bf16_bits(qx))
    qx /= np.maximum(np.linalg.norm(qx, axis=1, keepdims=True), 1e-12)
    np.save(paths["queries_nav"], qnav)
    np.save(paths["queries_search"], qx)
    return {
        "data_nav": np.load(paths["data_nav"], mmap_mode="r"),
        "data_search": HostBF16(np.load(paths["data_search"],
                                        mmap_mode="r")),
        "queries_nav": qnav,
        "queries_search": qx,
    }
