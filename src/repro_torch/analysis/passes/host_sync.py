"""Pass: host-sync-in-device-path.

The device-resident stages exist so that between-step state never
round-trips through the host; one stray ``.cpu()`` inside them
serializes the stream and the overlapped pipeline behind it.  This pass
flags host synchronization inside functions *registered* as
device-resident:

  * sync methods, whatever the receiver: ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``;
  * sync calls: ``torch.cuda.synchronize()``, ``np.asarray`` /
    ``np.array`` (of a tensor: a device path has no other use for them);
  * scalar fetches: ``float()`` / ``int()`` / ``bool()`` of a subscript
    (``int(a["b_auto"])``, a dict of device results) or of a ``torch.*``
    call (``int(torch.argmin(x))``); ``int(params.b_bits)`` is not
    flagged.

Registered means: listed in :data:`DEVICE_RESIDENT_NAMES` (exact names or
``fnmatch`` patterns), or decorated with
``repro_torch.analysis.device_resident``.  The reference's ``_*_shard``
pattern (its ``shard_map`` bodies) has no counterpart; the port's
per-shard device stage is ``distributed/pipeline.analyze_device`` and
the range pass's device half ``core/ratios.valid_ends_device``.

Allowance: syncs gated on telemetry are by design (a span's duration
must be the stage's time, not its dispatch time), so anything under
``if telemetry.enabled():`` / ``if tele:`` is exempt.  Intentional
boundary syncs carry inline suppressions or live in the committed
baseline: the point of the pass is that new ones cannot land quietly.
"""
from __future__ import annotations

import ast
import fnmatch
from typing import List, Set, Tuple

from repro_torch.analysis.core import (LintPass, SourceFile, call_name,
                                       names_in)
from repro_torch.analysis.registry import register_pass

# Functions whose bodies are device paths: the reference's names that
# exist in the port, and the port's per-shard stage.
DEVICE_RESIDENT_NAMES: Tuple[str, ...] = (
    "encode_device",                     # core/compress.py
    "decompress_step_device",            # core/compress.py
    "decode_anchor_device",              # core/compress.py
    "chain_advance",                     # kernels/ops.py
    "decode_blocks_device",              # kernels/rans.py
    "decode_bytes_blocks_device",        # kernels/rans.py
    "compress_blocks_device",            # kernels/rans.py
    "compress_blocks_device_symbols",    # kernels/rans.py
    "analyze_device",                    # distributed/pipeline.py
    "valid_ends_device",                 # core/ratios.py
)

# Callee names that force a device->host sync.
_SYNC_CALLS: Set[str] = {
    "torch.cuda.synchronize", "np.asarray", "np.array", "numpy.asarray",
    "numpy.array",
}
# Method syncs: flagged whatever the receiver.
_SYNC_METHODS: Set[str] = {"item", "tolist", "cpu", "numpy"}
# Builtins that sync when fed a device value.
_SCALAR_BUILTINS: Set[str] = {"float", "int", "bool"}

_TELE_GATES = {"tele", "telemetry.enabled"}


def is_device_resident(name: str, decorators: List[str]) -> bool:
    if any(d.endswith("device_resident") for d in decorators):
        return True
    return any(fnmatch.fnmatchcase(name, pat)
               for pat in DEVICE_RESIDENT_NAMES)


def _telemetry_gated_lines(fn_node: ast.AST) -> Set[int]:
    """Lines inside ``if tele:`` / ``if telemetry.enabled():`` branches."""
    out: Set[int] = set()
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.If):
            continue
        if names_in(node.test) & _TELE_GATES:
            for stmt in node.body:
                lo = stmt.lineno
                hi = getattr(stmt, "end_lineno", lo) or lo
                out.update(range(lo, hi + 1))
    return out


def _device_value(node: ast.AST) -> bool:
    """A subscript (a dict of device results) or a ``torch.*`` call."""
    if isinstance(node, ast.Subscript):
        return True
    return isinstance(node, ast.Call) \
        and (call_name(node) or "").startswith("torch.")


@register_pass
class HostSyncPass(LintPass):
    rule = "host-sync-in-device-path"
    description = ("no host synchronization inside device-resident "
                   "functions (telemetry-gated syncs exempt)")

    def check_file(self, sf: SourceFile) -> None:
        for fi in sf.functions:
            if not is_device_resident(fi.name, fi.decorators):
                continue
            gated = _telemetry_gated_lines(fi.node)
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                if node.lineno in gated:
                    continue
                # Nested defs inside a device function are separate
                # scopes (closures run later, host-side); only flag
                # calls whose innermost scope is this function.
                if sf.scope_at(node.lineno).rsplit(".", 1)[-1] != fi.name:
                    continue
                name = call_name(node)
                if name in _SYNC_CALLS:
                    self.emit(sf, node.lineno,
                              f"host sync `{name}` in device-resident "
                              f"function `{fi.name}`")
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _SYNC_METHODS):
                    self.emit(sf, node.lineno,
                              f"host sync `.{node.func.attr}()` in "
                              f"device-resident function `{fi.name}`")
                elif (isinstance(node.func, ast.Name)
                        and node.func.id in _SCALAR_BUILTINS
                        and node.args and _device_value(node.args[0])):
                    self.emit(sf, node.lineno,
                              f"scalar fetch `{node.func.id}(...)` in "
                              f"device-resident function `{fi.name}` "
                              "forces a device sync")
