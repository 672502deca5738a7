"""The ImageNet-style ResNet example (``dist_train``)."""
