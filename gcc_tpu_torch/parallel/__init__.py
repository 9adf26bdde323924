"""Parallelism of the port (gcc_tpu/parallel): data parallelism
(parallel/mesh.py) and row-sharded eval (parallel/spatial.py)."""

from gcc_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, init_distributed, make_mesh, replicate_state, shard_batch,
    spawn, state_checksum,
)
from gcc_tpu_torch.parallel.spatial import (  # noqa: F401
    SpatialMesh, auto_shards, gather_rows, make_mesh_2d, shard_rows,
    spatial_apply,
)
