"""Serving engine of the PyTorch port (see ``repro_torch.serve.engine``)."""
