"""Host-side data layer (numpy and h5py only): normalization, SISAP h5
loading, the SISAP result writer, and the synthetic clustered dataset.

`synthetic_dataset` gives the same arrays as the JAX package's for the same
arguments and seed. Fetching the SISAP files is not part of this package:
`load_dataset` reads them from ``data_dir``.
"""

import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

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
