"""Host runtime environment preset for spawned worker processes.

The port's counterpart of the reference's ``launch/runtime_env.py``.  The
multi-process launcher spawns worker interpreters; each one pays the same
host-side costs:

  * glibc malloc fragments the large transient host buffers the finalize
    stage and the gloo staging copies churn through -- preload tcmalloc
    when the host has it;
  * tcmalloc then logs every "large alloc" over ~1 GB to stderr, which
    garbles benchmark output -- raise the report threshold;
  * torch's C++ logging (c10d among it) warns on every rank of a gloo
    fleet -- keep it to errors.

Everything here is a pure dict-in/dict-out helper: nothing touches
``os.environ`` of the calling process, and importing this module imports
neither torch nor torch.distributed.  The reference's XLA flag helpers
(``merge_xla_flags``, ``host_device_count``) have no torch counterpart:
a torch process sees its devices without a flag.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

# Common soname locations across distro families; first hit wins.  The
# plain .so names cover toolchain images that ship only the -dev links.
TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so",
)

# ~60 GB: effectively "never report" without disabling the accounting.
TCMALLOC_REPORT_THRESHOLD = "60000000000"

# torch's C++ log level (c10/util/Logging): INFO, WARNING, ERROR, FATAL.
LOG_LEVEL_KEY = "TORCH_CPP_LOG_LEVEL"
QUIET_LOG_LEVEL = "ERROR"


def find_tcmalloc(candidates=TCMALLOC_CANDIDATES) -> Optional[str]:
    """First present tcmalloc soname, or None (glibc malloc stays)."""
    for path in candidates:
        if os.path.exists(path):
            return path
    return None


def runtime_env(base: Optional[Dict[str, str]] = None, *,
                tcmalloc: bool = True,
                quiet_logs: bool = True) -> Dict[str, str]:
    """Build a child-process environment with the runtime preset applied.

    ``base`` defaults to a copy of ``os.environ``; the result is always a
    new dict.  A value the caller already set is kept (``LD_PRELOAD`` is
    appended to, once)."""
    env = dict(os.environ if base is None else base)
    if tcmalloc:
        lib = find_tcmalloc()
        if lib is not None:
            pre = env.get("LD_PRELOAD", "")
            if lib not in pre.split(":"):
                env["LD_PRELOAD"] = f"{pre}:{lib}".strip(":")
            env.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
                           TCMALLOC_REPORT_THRESHOLD)
    if quiet_logs:
        env.setdefault(LOG_LEVEL_KEY, QUIET_LOG_LEVEL)
    return env


__all__ = ["find_tcmalloc", "runtime_env", "TCMALLOC_CANDIDATES",
           "TCMALLOC_REPORT_THRESHOLD", "LOG_LEVEL_KEY", "QUIET_LOG_LEVEL"]
