"""The examples' training mains on the GPU (counterparts of the repo's
``examples/``): ``mingpt.train_mingpt`` (the GPT / GPT-MoE char-LM) and
``mnist.train_mnist`` (LeNet-5). Run each with ``python -m``; both run on
the CUDA card unless ``--device cpu`` is passed, on one device."""
