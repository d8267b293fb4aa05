"""Store indexes that make probes sublinear without giving up exactness."""

from repro_torch.index.clustered import (
    ClusteredStore,
    ScanPlan,
    build_clustered_store,
    store_from_fragments,
)
from repro_torch.index.mutable import MutableClusteredStore
from repro_torch.index.sharded import (
    ShardedClusteredStore,
    build_sharded_clustered_store,
)

__all__ = [
    "ClusteredStore",
    "MutableClusteredStore",
    "ScanPlan",
    "ShardedClusteredStore",
    "build_clustered_store",
    "build_sharded_clustered_store",
    "store_from_fragments",
]
