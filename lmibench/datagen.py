"""The benchmark's own clustered corpus, made from the seed on the device.

After the design of `tpulmi_torch/data.py` (unit centers, Gaussian noise of
norm ``cluster_std``, a skewed cluster-size profile, a fixed random linear
map from the 768-d search view to the 96-d navigation view), rewritten here
so that a change to the program's generator does not move the yardstick.

Every seed gets the same *set* of cluster sizes and of query counts per
cluster, assigned to clusters in another order: the work of a search does
not change with the seed, only which rows and queries do it. The rows come
out in chunks, each made by one `torch.Generator` on the device in a fixed
order of calls, so the same seed on the same device type gives the same
bits every time: the plain reference makes the rows again instead of
reading what the program was handed.
"""

from dataclasses import dataclass

import numpy as np
import torch

CHUNK_ROWS = 1 << 20
# the stream that fixes the cluster-size profile and the open loop's gaps:
# the same for every seed
PROFILE_SEED = 20230
_QUERY_STREAM = 1
_ROW_STREAM = 2


def mix_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for (seed, stream); any whole seed works."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), 0x1A4B, stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def split_counts(total: int, weights: np.ndarray) -> np.ndarray:
    """`total` split over `weights` by largest remainder: whole counts
    that sum to `total` exactly."""
    raw = weights / weights.sum() * total
    counts = np.floor(raw).astype(np.int64)
    short = total - int(counts.sum())
    order = np.argsort(-(raw - counts), kind="stable")
    counts[order[:short]] += 1
    return counts


def size_profile(n_clusters: int, skew: float) -> np.ndarray:
    """The cluster weights, sorted descending, from `PROFILE_SEED`."""
    rng = np.random.default_rng(PROFILE_SEED)
    w = rng.random(n_clusters) ** skew
    return np.sort(w)[::-1] / w.sum()


@dataclass
class Spec:
    rows: int
    n_queries: int
    d_search: int
    d_nav: int
    n_clusters: int
    cluster_std: float
    skew: float

    @classmethod
    def of(cls, config: dict) -> "Spec":
        data = config["data"]
        return cls(config["rows"], config["n_queries"], config["d_search"],
                   config["d_nav"], data["n_clusters"], data["cluster_std"],
                   data["skew"])


class Corpus:
    """The draws of one seed on `device`: centers, projection, the rows'
    and queries' cluster labels. `chunks()` makes the rows; `queries()`
    the query pool."""

    def __init__(self, spec: Spec, seed: int, device):
        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(mix_seed(seed, 0))
        w = size_profile(spec.n_clusters, spec.skew)
        # the seed decides which cluster gets which size
        owner = torch.randperm(spec.n_clusters, generator=gen,
                               device=self.device).cpu().numpy()
        row_counts = np.empty(spec.n_clusters, np.int64)
        row_counts[owner] = split_counts(spec.rows, w)
        q_counts = np.empty(spec.n_clusters, np.int64)
        q_counts[owner] = split_counts(spec.n_queries, w)
        self.labels = self._shuffled_labels(row_counts, gen)
        self.q_labels = self._shuffled_labels(q_counts, gen)
        centers = torch.randn((spec.n_clusters, spec.d_search), generator=gen,
                              device=self.device)
        self.centers = centers / torch.linalg.vector_norm(
            centers, dim=1, keepdim=True)
        self.proj = torch.randn((spec.d_search, spec.d_nav), generator=gen,
                                device=self.device) / spec.d_search ** 0.5
        self.noise_scale = spec.cluster_std / spec.d_search ** 0.5

    def _shuffled_labels(self, counts, gen) -> torch.Tensor:
        labels = torch.repeat_interleave(
            torch.arange(len(counts), device=self.device),
            torch.as_tensor(counts, device=self.device))
        perm = torch.randperm(len(labels), generator=gen, device=self.device)
        return labels[perm]

    def _rows(self, labels, gen):
        """Search rows (unit norm, then rounded to bfloat16) and navigation
        rows (float32, unit norm) of these labels."""
        x = self.centers[labels] + self.noise_scale * torch.randn(
            (len(labels), self.spec.d_search), generator=gen,
            device=self.device)
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(
            1e-12)
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            nav = x @ self.proj
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
        nav = nav / torch.linalg.vector_norm(nav, dim=1,
                                             keepdim=True).clamp_min(1e-12)
        return x.to(torch.bfloat16), nav

    def chunks(self):
        """Yields (lo, hi, search rows bfloat16, navigation rows float32)
        on the device, CHUNK_ROWS at a time, always in the same order."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(mix_seed(self.seed, _ROW_STREAM))
        for lo in range(0, self.spec.rows, CHUNK_ROWS):
            hi = min(lo + CHUNK_ROWS, self.spec.rows)
            x, nav = self._rows(self.labels[lo:hi], gen)
            yield lo, hi, x, nav

    def queries(self):
        """The query pool as float32 host arrays (navigation, search), both
        unit norm; the search view went through bfloat16 as the rows did
        and was normalized again."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(mix_seed(self.seed, _QUERY_STREAM))
        x, nav = self._rows(self.q_labels, gen)
        x = x.float()
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(
            1e-12)
        return (np.ascontiguousarray(nav.cpu().numpy()),
                np.ascontiguousarray(x.cpu().numpy()))


def host_arrays(corpus: Corpus, search_dtype: str, nav_dtype: str):
    """The whole corpus in host RAM, chunk by chunk from the device: search
    and navigation rows as numpy arrays, each either float32 or the uint16
    bits of bfloat16. Returns (search, nav)."""
    spec = corpus.spec

    def empty(d, dtype):
        return np.empty((spec.rows, d),
                        np.uint16 if dtype == "bfloat16" else np.float32)

    search, nav = empty(spec.d_search, search_dtype), empty(spec.d_nav,
                                                            nav_dtype)
    for lo, hi, x, v in corpus.chunks():
        for dst, src, dtype in ((search, x, search_dtype),
                                (nav, v, nav_dtype)):
            if dtype == "bfloat16":
                torch.from_numpy(dst[lo:hi].view(np.int16)).copy_(
                    src.to(torch.bfloat16).view(torch.int16))
            else:
                torch.from_numpy(dst[lo:hi]).copy_(src.float())
        del x, v
    return search, nav
