"""Parallelism of the PyTorch port. So far only the single-device
(``axis=None``) forms of the vocab-parallel losses
(``parallel/tensor_parallel.py``); the mesh, tensor, pipeline, context
and expert parallelism are later slices."""
