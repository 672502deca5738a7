"""Training of the PyTorch port: the single-device train and eval steps,
AdamW, the LR schedules, the metrics logger and the ``Trainer``."""
