"""Pass-plugin registry: passes self-register at import time.

Mirrors the codec registry in ``core.entropy`` -- one dict keyed by rule
id, a ``register_pass`` decorator, and name-based lookup so the CLI's
``--select``/``--list-rules`` and the tests can address passes
individually.  Importing :mod:`repro_torch.analysis.passes` populates it.
"""
from __future__ import annotations

from typing import Dict, List, Type

from repro_torch.analysis.core import LintPass

_REGISTRY: Dict[str, Type[LintPass]] = {}


def register_pass(cls: Type[LintPass]) -> Type[LintPass]:
    if cls.rule in _REGISTRY and _REGISTRY[cls.rule] is not cls:
        raise ValueError(f"duplicate lint rule {cls.rule!r}")
    _REGISTRY[cls.rule] = cls
    return cls


def get_pass(rule: str) -> Type[LintPass]:
    _ensure_loaded()
    try:
        return _REGISTRY[rule]
    except KeyError:
        raise ValueError(
            f"unknown lint rule {rule!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def all_passes() -> List[Type[LintPass]]:
    _ensure_loaded()
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def _ensure_loaded():
    # Import-for-effect: the passes package registers every shipped pass.
    from repro_torch.analysis import passes  # noqa: F401


__all__ = ["register_pass", "get_pass", "all_passes"]
