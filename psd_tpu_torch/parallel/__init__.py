from .mesh import MeshConfig, batch_rows, create_mesh, shard_batch

__all__ = ["MeshConfig", "batch_rows", "create_mesh", "shard_batch"]
