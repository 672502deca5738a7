"""Training of the PyTorch port: the single-device train step, AdamW,
the LR schedules and the ``Trainer``."""
