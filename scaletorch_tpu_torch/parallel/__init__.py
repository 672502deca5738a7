"""Parallelism of the PyTorch port: the 5-axis mesh (``mesh.py``), the
tensor- and sequence-parallel regions, layers and vocab-parallel losses
(``tensor_parallel.py``, ``sequence_parallel.py``), the zigzag layout
and the context-parallel backend choice (``zigzag.py``,
``cp_select.py``), the train step over the mesh (``spmd.py``), and the
MoE routing and token movement on one device
(``expert_parallel.py``; the EP exchange is ROADMAP Queue 1 item 6b)."""
