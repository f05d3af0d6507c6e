from .mesh import (Layout, create_mesh, eval_chunks, initialize_distributed, layout, mesh_shape,
                   shard_model, sharded, train_batch)

__all__ = ["Layout", "create_mesh", "eval_chunks", "initialize_distributed", "layout",
           "mesh_shape", "shard_model", "sharded", "train_batch"]
