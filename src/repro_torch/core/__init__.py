"""NUMARCK core stages of the PyTorch port (see ``repro_torch``)."""
