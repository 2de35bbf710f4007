"""tpulmi_torch — the learned index for approximate nearest-neighbor search
in PyTorch, with its probe kernel written in CUDA C++ for Hopper (sm_90a).

The same three stages as the JAX package ``tpulmi``, module for module:

1. Partition: k-means clusters the navigation vectors into buckets
   (``tpulmi_torch.ops.kmeans``).
2. Learn: an MLP learns each vector's bucket (``tpulmi_torch.models``).
3. Search: the MLP ranks buckets per query, and the top-P buckets are
   scanned exactly — cosine distances and a running top-k fused in one
   CUDA kernel (``tpulmi_torch.ops.probe_topk``) — then merged per query.

`HierarchicalIndex` (``tpulmi_torch.hierarchical``) routes through a
two-level factorized router over the same store and search. `Baseline`
(``tpulmi_torch.baseline``) is the exact oracle; ``python -m
tpulmi_torch.cli`` the experiment CLI, ``tpulmi_torch.sweep`` the
hyperparameter sweep.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.
"""

from tpulmi_torch.baseline import Baseline
from tpulmi_torch.hierarchical import HierarchicalConfig, HierarchicalIndex
from tpulmi_torch.index import BuiltIndex, LearnedIndex
from tpulmi_torch.utils.config import IndexConfig, SearchConfig

__version__ = "0.1.0"

__all__ = ["LearnedIndex", "BuiltIndex", "HierarchicalIndex",
           "HierarchicalConfig", "IndexConfig", "SearchConfig", "Baseline",
           "__version__"]
