"""Parallelism of the PyTorch port: the 5-axis mesh (``mesh.py``), the
tensor- and sequence-parallel regions, layers and vocab-parallel losses
(``tensor_parallel.py``, ``sequence_parallel.py``), the zigzag layout
and the context-parallel backend choice (``zigzag.py``,
``cp_select.py``), the pipeline schedules (``pipeline_parallel.py``), the
MoE routing, token movement and the expert-parallel all-to-all exchange
(``expert_parallel.py``), the train step over the mesh (``spmd.py``)
and FSDP (``fsdp.py``)."""
