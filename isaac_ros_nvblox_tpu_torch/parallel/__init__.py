"""Multi-device spatial scale-out: the shard mesh (`spatial.SpatialMesh`),
the sharded mapper, multi-process set-up, the worker and the dry run."""
