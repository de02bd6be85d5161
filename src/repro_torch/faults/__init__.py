"""Error types of the PyTorch port."""
