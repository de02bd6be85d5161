"""Pass: dtype-hazard.

The port's dtype hazards are its written conventions (ROADMAP,
"Conventions for the port package"); each breaks byte identity with the
reference or a load on a machine without ml_dtypes:

  1. **uint32 arithmetic.**  ``torch.uint32`` has no ``>>``, ``+``,
     ``<`` or ``//`` on the CPU build, and where it has them their
     promotion differs by device.  u32 words and rANS states are held in
     int64 masked with ``0xFFFFFFFF`` and converted at the byte boundary.
     Flags those four operators where an operand is a ``torch.uint32``
     value: a ``.to(torch.uint32)`` / ``.view(torch.uint32)`` /
     ``dtype=torch.uint32`` expression, or a name assigned from one in
     the same function.
  2. **``np.dtype(<x>.dtype)``** outside ``core/types.step_dtype``:
     bfloat16 (recorded as ``"bfloat16"`` over uint16 storage) has no
     numpy dtype without ml_dtypes, which the card's machine lacks.
  3. **``torch.set_default_dtype``**: a process-wide switch that moves
     every later factory call's dtype, and so bytes.
  4. **The kernels' nvcc flags** (``kernels/_build.py`` ``NVCC_FLAGS``):
     byte identity rests on ``-prec-div=true``, ``-prec-sqrt=true``,
     ``-ftz=false`` and ``-fmad=false``; losing one, or gaining
     ``--use_fast_math``, moves a bin edge by an ulp.

The reference's x64 rule (a float64 request reaching a jitted path with
x64 off is silently downcast) has no torch form: torch keeps float64 on
the card, and the Sedov series is float64 end to end.
"""
from __future__ import annotations

import ast
from typing import Set

from repro_torch.analysis.core import (LintPass, SourceFile, call_name,
                                       dotted_name)
from repro_torch.analysis.registry import register_pass

_U32 = {"torch.uint32"}
_U32_OPS = (ast.RShift, ast.Add, ast.FloorDiv)
_REQUIRED_NVCC = ("-prec-div=true", "-prec-sqrt=true", "-ftz=false",
                  "-fmad=false")
_FORBIDDEN_NVCC = ("--use_fast_math", "-use_fast_math")


def _mentions_u32(node: ast.AST) -> bool:
    return any(dotted_name(n) in _U32 for n in ast.walk(node)
               if isinstance(n, ast.Attribute))


def _u32_names(fn: ast.AST) -> Set[str]:
    """Names assigned from an expression that makes a uint32 tensor."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _mentions_u32(node.value):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


@register_pass
class DtypeHazardPass(LintPass):
    rule = "dtype-hazard"
    description = ("no uint32 tensor arithmetic, np.dtype(x.dtype) outside "
                   "step_dtype, set_default_dtype, or loosened nvcc flags")

    def check_file(self, sf: SourceFile) -> None:
        for fi in sf.functions:
            self._check_u32(sf, fi)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                self._check_call(sf, node)
        if sf.rel.endswith("kernels/_build.py"):
            self._check_nvcc(sf)

    def _check_u32(self, sf: SourceFile, fi) -> None:
        names = _u32_names(fi.node)

        def u32(operand: ast.AST) -> bool:
            if isinstance(operand, ast.Name):
                return operand.id in names
            return isinstance(operand, ast.Call) and _mentions_u32(operand)

        for node in ast.walk(fi.node):
            if sf.scope_at(getattr(node, "lineno", 0)).rsplit(
                    ".", 1)[-1] != fi.name:
                continue
            if isinstance(node, ast.BinOp) and isinstance(node.op, _U32_OPS):
                operands = (node.left, node.right)
                op = type(node.op).__name__
            elif isinstance(node, ast.Compare) \
                    and any(isinstance(o, ast.Lt) for o in node.ops):
                operands = (node.left, *node.comparators)
                op = "Lt"
            else:
                continue
            if any(u32(o) for o in operands):
                self.emit(sf, node.lineno,
                          f"`{op}` on a torch.uint32 tensor in "
                          f"`{fi.name}`: hold u32 values in int64 masked "
                          "with 0xFFFFFFFF")

    def _check_call(self, sf: SourceFile, node: ast.Call) -> None:
        name = call_name(node) or ""
        if name in ("np.dtype", "numpy.dtype") and node.args \
                and isinstance(node.args[0], ast.Attribute) \
                and node.args[0].attr == "dtype":
            if sf.scope_at(node.lineno).rsplit(".", 1)[-1] != "step_dtype":
                self.emit(sf, node.lineno,
                          "`np.dtype(<x>.dtype)` outside "
                          "core/types.step_dtype: bfloat16 has no numpy "
                          "dtype without ml_dtypes")
        elif name == "torch.set_default_dtype":
            self.emit(sf, node.lineno,
                      "`torch.set_default_dtype` moves every later "
                      "factory call's dtype")

    def _check_nvcc(self, sf: SourceFile) -> None:
        for node in sf.tree.body:
            if not (isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "NVCC_FLAGS"
                    for t in node.targets)):
                continue
            flags = {c.value for c in ast.walk(node.value)
                     if isinstance(c, ast.Constant)
                     and isinstance(c.value, str)}
            for f in _REQUIRED_NVCC:
                if f not in flags:
                    self.emit(sf, node.lineno,
                              f"NVCC_FLAGS lacks `{f}`: the kernels' byte "
                              "identity rests on it")
            for f in _FORBIDDEN_NVCC:
                if f in flags:
                    self.emit(sf, node.lineno,
                              f"NVCC_FLAGS has `{f}`: it breaks the "
                              "kernels' byte identity")
            return
        self.emit(sf, 1, "kernels/_build.py defines no NVCC_FLAGS",
                  scope="<module>")
