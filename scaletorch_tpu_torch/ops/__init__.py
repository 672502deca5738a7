"""Kernels of the PyTorch port, each beside its plain PyTorch version.

Kernel sources live in ``scaletorch_tpu_torch/csrc/`` and are built by
``ops/_build.py`` at first use; ``_build.launch_counts`` counts launches.
``ops/paged_attention.py`` holds the paged-decode kernel's wrapper, its
plain version, the page scatter/gather and the dispatcher; ``ops/flash.py``
the flash-attention kernels K1-K3; ``ops/grouped_mlp.py`` the grouped
expert-MLP kernels K5-K7. ``ops/quantized_collectives.py`` is the int8
gradient all-reduce, plain torch ops (no kernel, as in the reference).
"""

from scaletorch_tpu_torch.ops._build import (  # noqa: F401
    launch_counts,
    reset_launch_counts,
)
