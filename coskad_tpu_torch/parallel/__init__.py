from .mesh import (Layout, create_mesh, eval_chunks, initialize_distributed, layout,
                   sharded, train_batch)

__all__ = ["Layout", "create_mesh", "eval_chunks", "initialize_distributed", "layout",
           "sharded", "train_batch"]
