"""repro-torch-lint: the port's project-specific static analysis (the
counterpart of the reference's ``repro.analysis``, in torch forms).

The port's correctness and speed rest on contracts that span modules:
device-resident paths must not sync with the host, a compiled or built
callable (``torch.compile``, a kernel library) must be made once, the
overlap and entropy machinery keeps a lock and labelling discipline,
the NCK container and rANS blob formats stay closed, and the port's
dtype conventions (int64 for uint32 math, ``core/types.step_dtype`` for
step dtypes, the kernels' IEEE nvcc flags) keep its bytes identical to
the reference's.  Each is an AST pass over ``src/repro_torch``:

  * :mod:`repro_torch.analysis.core` -- the shared source model (a copy
    of the reference's): parsed AST, qualified function scopes,
    ``# repro-lint: disable=<rule>`` inline suppressions.
  * :mod:`repro_torch.analysis.registry` -- the pass registry.
  * :mod:`repro_torch.analysis.baseline` -- the committed baseline
    ``repro-torch-lint.baseline.json`` (line-free fingerprints).
  * :mod:`repro_torch.analysis.passes` -- the six passes, under the
    reference's rule ids.
  * :mod:`repro_torch.analysis.cli` -- ``python -m
    repro_torch.analysis`` / ``repro-torch-lint``.
"""
from repro_torch.analysis.core import (LintPass, Project, SourceFile,
                                       Violation, device_resident,
                                       load_project)
from repro_torch.analysis.registry import all_passes, get_pass, register_pass

__all__ = ["LintPass", "Project", "SourceFile", "Violation",
           "device_resident", "load_project", "all_passes", "get_pass",
           "register_pass"]
