"""The multi-stream fleet (the stream axis as a batch dimension, on one
device or sharded over the ranks of a ``torch.distributed`` mesh), the
T- and W-sharded locates, the mesh and the launcher of ranks."""
