"""The examples' training mains on the GPU (counterparts of the repo's
``examples/``): ``mingpt.train_mingpt`` (the GPT / GPT-MoE char-LM),
``mnist.train_mnist`` (LeNet-5, ``--fsdp``), ``imagenet.dist_train``
(ResNet-18/34 with sync-BN), ``fsdp.train_fsdp`` (a Llama on
``parallel/fsdp``, checkpointed and resumed), ``moe.train_moe`` (expert
parallelism), ``pipeline.train_pp`` (the pipeline schedules),
``longctx.train_longctx`` (ring and Ulysses context parallelism) and
``device_mesh.mesh_demos`` (DTensor placements and the tp / sp layers).
Run each with ``python -m``, alone or under ``torch.distributed.run``
(every rank of the world takes part); each runs on the CUDA card unless
``--device cpu`` is passed."""
