"""Dense GQA language model of the PyTorch port (see ``repro_torch.models.model``)."""
