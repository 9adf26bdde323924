"""Data parallelism of the port (gcc_tpu/parallel): parallel/mesh.py."""

from gcc_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, init_distributed, make_mesh, replicate_state, shard_batch,
    spawn, state_checksum,
)
