"""Pass: jit-cache-hygiene ("built or traced once").

The reference's rule keeps ``jax.jit`` callables out of per-call paths.
The port's counterparts are what compiles, traces, builds or loads: a
``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace`` callable,
a ``torch.utils.cpp_extension.load`` / ``load_inline`` build, a
``ctypes.CDLL`` load of a kernel library and a CUDA graph capture
(``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``).  Each made per
call repeats seconds of work (an nvcc build, a trace) on every step.
The sanctioned shapes:

  1. **module scope** -- a decorator on a top-level function or a
     module-level ``fn = torch.compile(...)``: made once per process;
  2. **keyed cache stores** -- inside a function, the result assigned
     into a subscript (``_libs[name] = ctypes.CDLL(path)``, as
     ``kernels/_build.py`` keeps its libraries), or to a name that is
     stored into a subscript in the same function.

Everything else inside a function body is flagged; a lambda argument is
called out explicitly, since it is always a per-call trace.
"""
from __future__ import annotations

import ast
from typing import Dict, Optional

from repro_torch.analysis.core import (LintPass, SourceFile, call_name,
                                       dotted_name)
from repro_torch.analysis.registry import register_pass

_BUILD_NAMES = {
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.jit.trace_module", "torch.utils.cpp_extension.load",
    "torch.utils.cpp_extension.load_inline", "cpp_extension.load",
    "cpp_extension.load_inline", "load_inline", "ctypes.CDLL", "CDLL",
    "ctypes.cdll.LoadLibrary", "torch.cuda.CUDAGraph", "torch.cuda.graph",
}


def _is_build_call(node: ast.Call) -> bool:
    name = call_name(node)
    if name in _BUILD_NAMES:
        return True
    # partial(torch.compile, ...) / functools.partial(torch.jit.script)
    if name in {"partial", "functools.partial"} and node.args:
        return dotted_name(node.args[0]) in _BUILD_NAMES
    return False


@register_pass
class JitCachePass(LintPass):
    rule = "jit-cache-hygiene"
    description = ("torch.compile / jit / cpp_extension / CDLL / CUDA "
                   "graph call sites must be module-level or stored into "
                   "a keyed cache")

    def check_file(self, sf: SourceFile) -> None:
        parent: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(sf.tree):
            for child in ast.iter_child_nodes(node):
                parent[child] = node
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not _is_build_call(node):
                continue
            enc_func = self._enclosing_function(parent, node)
            if enc_func is None:
                continue            # module scope: made once, fine
            if self._is_decorator_of(enc_func, node, parent):
                if self._enclosing_function(parent, enc_func) is None:
                    continue
                self.emit(sf, node.lineno,
                          f"`@{call_name(node) or 'compile'}` on the nested "
                          f"function `{enc_func.name}` compiles per call "
                          "of the enclosing function")
                continue
            stmt = self._enclosing_statement(parent, node)
            if stmt is not None and self._keyed_store(stmt, node, enc_func):
                continue
            lam = any(isinstance(a, ast.Lambda) for a in node.args)
            what = call_name(node) or "compile"
            fname = enc_func.name
            msg = (f"per-call `{what}(lambda ...)` inside `{fname}` "
                   "retraces on every invocation" if lam else
                   f"`{what}` inside `{fname}` is neither module-level "
                   "nor stored into a keyed cache "
                   "(`_libs[key] = ...` pattern)")
            self.emit(sf, node.lineno, msg)

    @staticmethod
    def _enclosing_function(parent, node) -> Optional[ast.AST]:
        cur = parent.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = parent.get(cur)
        return None

    @staticmethod
    def _is_decorator_of(func: ast.AST, node: ast.AST, parent) -> bool:
        decs = getattr(func, "decorator_list", [])
        cur = node
        while cur is not None and cur is not func:
            if any(cur is d for d in decs):
                return True
            cur = parent.get(cur)
        return False

    @staticmethod
    def _enclosing_statement(parent, node) -> Optional[ast.stmt]:
        cur = parent.get(node)
        while cur is not None:
            if isinstance(cur, ast.stmt):
                return cur
            cur = parent.get(cur)
        return None

    @staticmethod
    def _keyed_store(stmt: ast.stmt, call: ast.Call,
                     enc_func: ast.AST) -> bool:
        """``cache[key] = build(...)`` (the call feeds the value), or the
        two-step form: ``fn = build(...)`` whose name is stored into a
        subscript elsewhere in the function."""
        if not isinstance(stmt, ast.Assign):
            return False
        if not any(n is call for n in ast.walk(stmt.value)):
            return False
        if any(isinstance(t, ast.Subscript) for t in stmt.targets):
            return True
        tnames = {t.id for t in stmt.targets if isinstance(t, ast.Name)}
        if not tnames:
            return False
        for other in ast.walk(enc_func):
            if other is stmt or not isinstance(other, ast.Assign):
                continue
            if not any(isinstance(t, ast.Subscript) for t in other.targets):
                continue
            used = {n.id for n in ast.walk(other.value)
                    if isinstance(n, ast.Name)}
            if tnames & used:
                return True
        return False
