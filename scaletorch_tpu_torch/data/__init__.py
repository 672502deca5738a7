"""Data loading of the PyTorch port: the tokenization of a local corpus,
the micro-batch loader over it, and the synthetic token stream."""
