"""Data loading of the PyTorch port: the synthetic token stream."""
