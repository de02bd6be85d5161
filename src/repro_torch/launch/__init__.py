"""Multi-process launch over torch.distributed."""
