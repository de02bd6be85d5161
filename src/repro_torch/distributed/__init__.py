"""Sharded and multi-process drivers on torch.distributed."""
