"""Configuration dataclasses for tpulmi_torch.

Field for field the same as ``tpulmi.utils.config`` (names and defaults), so
that a config converts 1:1 between the two packages through ``to_dict()``.
The defaults (12 epochs, lr 0.003, batch 1024, MLP-5, 122 buckets) train one
Adam step per batch; ``max_train_steps`` caps the total step budget, rounded
down to whole epochs, and ``reference_step_semantics=True`` reproduces the
reference's one-step-per-epoch loop.
"""

from dataclasses import asdict, dataclass
from typing import List, Optional


@dataclass(frozen=True)
class IndexConfig:
    """Build-time configuration of the learned index."""

    n_categories: int = 122
    epochs: int = 12
    lr: float = 0.003
    model_type: str = "MLP-5"
    batch_size: int = 1024
    seed: int = 2023

    # Hard cap on total optimizer steps, truncated to whole epochs.
    # None = no cap.
    max_train_steps: Optional[int] = 20_000

    # K-means: 25 Lloyd iterations on at most this many points per centroid
    # (faiss Clustering defaults).
    kmeans_iters: int = 25
    kmeans_max_points_per_centroid: int = 256

    compute_dtype: str = "float32"

    # Build through the fused staged build (tpulmi_torch/build.py); False
    # runs the modular k-means / train / predict / store path.
    fused_build: bool = True

    # Every bucket starts on a multiple of this many store rows (sentinel
    # rows, id -1, fill the gaps). The CUDA probe kernel addresses rows
    # directly and needs no alignment; the default keeps the store layout
    # (and its row count) identical to the JAX package's.
    row_align: int = 2048

    # True: one optimizer step per epoch, like the reference's training loop.
    reference_step_semantics: bool = False

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class SearchConfig:
    """Query-time configuration."""

    k: int = 10
    n_buckets: int = 4
    queries_per_bucket_pad: Optional[int] = None
    data_chunk: int = 2048
    query_chunk: int = 512
    batch_queries: Optional[int] = None  # split very large query sets
    # Input precision of the distance products; accumulation is always
    # float32. None = float32.
    compute_dtype: Optional[str] = "bfloat16"

    # Probe backend: "cuda" (the hand-written probe kernel,
    # csrc/probe_topk.cu), "torch" (its plain PyTorch version), or "auto"
    # ("cuda" for a store on the card, "torch" for one on the CPU).
    backend: str = "auto"
    # The pallas_* names are kept so that configs convert 1:1 with the JAX
    # package. pallas_extract is only checked: all three modes compute the
    # same function and run the same CUDA kernel (with pallas_pool,
    # "scalar" is refused as the JAX package refuses it). pallas_qc was a
    # TPU tile size and is unused: the CUDA kernel's block is 64 slots.
    # pallas_mc is the store rows of one work item of the worklist (a
    # multiple of 128; twice as many with pallas_pair) and means nothing
    # without pallas_worklist. int8_queries (quantized stores only, ignored
    # on a full-precision one) quantizes the queries per row and runs the
    # int8 x int8 kernel of csrc/probe_topk_quant.cu.
    # pallas_worklist: one work item per live (64-slot block, pallas_mc-row
    # chunk) pair, walked by a persistent grid, and a second kernel that
    # merges a block's partial lists, instead of one CTA per block; sized
    # per (batch size, probes) from the first batch's routing and re-run
    # larger on overflow.
    # pallas_pair: tiles of 128 store rows instead of 64; declined (logged)
    # when the card's shared memory per block does not hold it.
    # pallas_pool: only when the search reranks: the kernel keeps an exact
    # top-k and draws the rerank_extra further candidates from a per-class
    # pool instead of keeping a list of k + rerank_extra.
    pallas_qc: int = 512
    pallas_mc: int = 1024
    pallas_extract: str = "group"
    int8_queries: bool = False
    pallas_worklist: bool = False
    pallas_pool: bool = False
    pallas_pair: bool = False

    # Quantized stores (LearnedIndex.quantize) with a host corpus attached:
    # fetch k + rerank_extra candidates and rerank them exactly on the host.
    # rerank_extra=None resolves to 30 for a packed int4 store, else 10.
    # rerank_dtype="float16" gathers from a cached float16 copy of the
    # corpus.
    rerank: bool = True
    rerank_extra: Optional[int] = None
    rerank_dtype: str = "float32"

    # Threshold pruning of the backend="xla" scan: past the first
    # prune_after probe ranks, a bucket is skipped when its bound proves it
    # cannot reach the query's kth-best distance (needs
    # LearnedIndex.compute_bounds; prune_eps None = 5e-3 in bfloat16, else
    # 1e-4). Results equal the unpruned scan's. 0 = off.
    prune_after: int = 0
    prune_eps: Optional[float] = None

    # Cast the returned distances to this dtype (ids are unaffected).
    fetch_dtype: Optional[str] = None

    # Per-query adaptive probe truncation: stop probing once the cumulative
    # routed probability reaches this mass. None = off.
    probe_mass: Optional[float] = None

    def to_dict(self) -> dict:
        return asdict(self)


def n_buckets_from_percentage(bp: List[int], n_categories: int) -> List[int]:
    """Reference `-bp` semantics: percent of n_categories, floored, deduped,
    zero-dropped. bp=4, 122 cats -> 4 buckets; bp=6 -> 7 buckets."""
    buckets = [int((b / 100) * n_categories) for b in bp]
    return sorted(set(b for b in buckets if b > 0))
