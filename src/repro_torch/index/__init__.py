"""Store indexes that make probes sublinear without giving up exactness."""

from repro_torch.index.clustered import (
    ClusteredStore,
    ScanPlan,
    build_clustered_store,
    store_from_fragments,
)
from repro_torch.index.mutable import MutableClusteredStore

__all__ = [
    "ClusteredStore",
    "MutableClusteredStore",
    "ScanPlan",
    "build_clustered_store",
    "store_from_fragments",
]
