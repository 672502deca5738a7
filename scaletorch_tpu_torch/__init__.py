"""scaletorch_tpu_torch: the PyTorch / CUDA port of scaletorch_tpu.

The JAX package ``scaletorch_tpu`` stays the reference; this package
grows beside it, slice by slice, and never imports it (or JAX). Its
parts:

  * ``models``    — the Llama-family decoder (Llama, Qwen3) in the
    reference parameter layout, with its KV-cached forward;
  * ``ops``       — the hand-written CUDA kernels (sources in ``csrc/``,
    built with nvcc for sm_90a at first use) beside their plain PyTorch
    versions;
  * ``inference`` — the KV caches, the engine steps and
    ``InferenceEngine``;
  * ``data``, ``trainer`` — the corpus loader, the train and eval steps,
    the optimizers and the ``Trainer`` (fp32 or bf16 masters, the four
    remat policies, eval, checkpoint and resume);
  * ``dist``, ``parallel`` — the launcher bootstrap, the device mesh, and
    tensor, sequence and context parallelism with the train step over
    the mesh (``torchrun ... -m scaletorch_tpu_torch.train``);
  * ``telemetry``, ``utils`` — latency histograms, logging, devices,
    checkpoints, Hugging Face safetensors both ways.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
