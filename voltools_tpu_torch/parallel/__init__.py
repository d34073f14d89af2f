from .sharded import (
    Mesh,
    ShardedVolume,
    halo_for_matrix,
    make_mesh,
    sharded_affine_batch,
)

__all__ = [
    "Mesh",
    "ShardedVolume",
    "halo_for_matrix",
    "make_mesh",
    "sharded_affine_batch",
]
