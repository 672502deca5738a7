"""The examples' training mains on the GPU (counterparts of the repo's
``examples/``): ``mingpt.train_mingpt`` (the GPT / GPT-MoE char-LM),
``mnist.train_mnist`` (LeNet-5) and ``imagenet.dist_train`` (ResNet-18/34,
data parallel with sync-BN). Run each with ``python -m``; each runs on the
CUDA card unless ``--device cpu`` is passed; minGPT and MNIST on one
device."""
