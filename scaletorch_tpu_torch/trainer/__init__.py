"""Training of the PyTorch port: the single-device train and eval steps,
the optimizers (AdamW, Adam, SGD, LAMB, Adafactor), the LR schedules,
the metrics logger and the ``Trainer``."""
