"""Parallelism of the PyTorch port. So far only the single-device
(``axis=None``) forms: the vocab-parallel losses
(``parallel/tensor_parallel.py``) and the MoE routing and token movement
(``parallel/expert_parallel.py``); the mesh, tensor, pipeline, context
and expert-parallel exchanges are later slices."""
