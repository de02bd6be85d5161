"""Fault tolerance layer of the PyTorch port: the structured integrity
errors (``faults.errors``), deterministic fault injection
(``faults.inject``) and the bounded, jittered retry backoff
(``faults.retry``), as in the reference's ``repro.faults``."""
from repro_torch.faults.errors import (CommitTimeoutError, CorruptBlockError,
                                       CorruptShardError, InjectedFault,
                                       IntegrityError)
from repro_torch.faults.retry import Backoff

__all__ = ["IntegrityError", "CorruptBlockError", "CorruptShardError",
           "CommitTimeoutError", "InjectedFault", "Backoff"]
