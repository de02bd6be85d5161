"""The port's lint passes.

Importing this package registers every pass with
:mod:`repro_torch.analysis.registry` (import-for-effect, like the entropy
codec registry).  Third-party/project-local passes can register the same
way: subclass :class:`repro_torch.analysis.LintPass`, decorate with
``@register_pass``, and import the module before running.
"""
from repro_torch.analysis.passes import concurrency        # noqa: F401
from repro_torch.analysis.passes import dtype_hazards      # noqa: F401
from repro_torch.analysis.passes import format_closure     # noqa: F401
from repro_torch.analysis.passes import host_sync          # noqa: F401
from repro_torch.analysis.passes import jit_cache          # noqa: F401
from repro_torch.analysis.passes import retry_discipline   # noqa: F401
