from tpulmi_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from tpulmi_torch.parallel.sharded import (
    ShardedBucketStore,
    make_dp_train_step,
    shard_store,
    shard_store_from_host,
    sharded_probe_search,
)

__all__ = [
    "Mesh",
    "init_distributed",
    "make_mesh",
    "ShardedBucketStore",
    "shard_store",
    "shard_store_from_host",
    "sharded_probe_search",
    "make_dp_train_step",
]
