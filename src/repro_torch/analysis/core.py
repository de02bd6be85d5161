"""Shared AST walker and source model for the port's lint passes (a copy
of the reference's framework-free ``analysis/core.py``).

One :class:`SourceFile` per scanned file carries the parsed tree, the
source lines, a map of inline suppressions, and the function scope table
(qualified names, so passes report ``ShardedCompressor._device_encode``
instead of a bare line number).  :class:`Project` bundles the scanned
files with the repo root so cross-file passes (format closure needs the
container writer, the blob header definitions and the test fixtures at
once) can see the whole surface.

Suppressions: a trailing or immediately preceding comment of the form ::

    # repro-lint: disable=<rule>[,<rule>...]

suppresses those rules for the annotated line.  Placed on a ``def`` line
it suppresses the rules for the whole function body -- that is the escape
hatch for documented, intentional contract exceptions (use sparingly; the
committed baseline is for legacy findings, suppressions are for
load-bearing ones that should never resurface as "new").
"""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([\w\-,\s]+)")

# Marker attribute set by the @device_resident decorator; the host-sync
# and dtype passes treat decorated functions exactly like registry hits.
_DEVICE_ATTR = "__repro_device_resident__"


def device_resident(fn):
    """Mark a function as device-resident for repro-lint (no runtime
    effect).  The host-sync and dtype-hazard passes scan decorated
    functions in addition to the built-in name registry."""
    setattr(fn, _DEVICE_ATTR, True)
    return fn


@dataclass(frozen=True)
class Violation:
    """One finding.  ``scope`` is the qualified function name (or
    ``<module>``); the baseline fingerprint deliberately excludes the
    line number so unrelated edits above a finding don't churn it."""

    rule: str
    path: str                    # repo-relative, "/"-separated
    line: int
    scope: str
    message: str

    def fingerprint(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.scope, self.message)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.scope}: "
                f"{self.message}")


@dataclass
class FunctionInfo:
    """One function scope: qualified name, its AST node, decorator names
    (dotted strings) and the line range it covers."""

    qualname: str
    node: ast.AST                # FunctionDef | AsyncFunctionDef | Lambda
    decorators: List[str] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]

    @property
    def line_range(self) -> Tuple[int, int]:
        return (self.node.lineno, max(self.node.lineno,
                                      getattr(self.node, "end_lineno", 0)
                                      or self.node.lineno))


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None (the one name
    resolver every pass shares)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    """Dotted name of a call's callee (``np.asarray``, ``self._q.submit``)."""
    return dotted_name(call.func)


def names_in(node: ast.AST) -> Set[str]:
    """Every dotted name (and bare name) mentioned anywhere under node."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        d = dotted_name(sub)
        if d is not None:
            out.add(d)
    return out


class _ScopeCollector(ast.NodeVisitor):
    """Builds the qualified-name function table of one module."""

    def __init__(self):
        self.functions: List[FunctionInfo] = []
        self._stack: List[str] = []

    def _qual(self, name: str) -> str:
        return ".".join(self._stack + [name])

    def _visit_func(self, node):
        decs = [d for d in (dotted_name(dec.func)
                            if isinstance(dec, ast.Call) else dotted_name(dec)
                            for dec in node.decorator_list) if d]
        # partial(torch.compile, ...) decorators: record the inner
        # callable too.
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call):
                for a in dec.args:
                    d = dotted_name(a)
                    if d:
                        decs.append(d)
        info = FunctionInfo(self._qual(node.name), node, decs)
        self.functions.append(info)
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()


def _parse_suppressions(source: str) -> Dict[int, Set[str]]:
    """line -> set(rule) from ``# repro-lint: disable=...`` comments."""
    out: Dict[int, Set[str]] = {}
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                out.setdefault(tok.start[0], set()).update(rules)
    except tokenize.TokenError:
        pass
    return out


class SourceFile:
    """One parsed module plus its scope table and suppression map."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        col = _ScopeCollector()
        col.visit(self.tree)
        self.functions = col.functions
        self._suppress = _parse_suppressions(source)
        # def-line suppressions widen to the whole function body.
        self._func_suppress: List[Tuple[int, int, Set[str]]] = []
        for fi in self.functions:
            lo, hi = fi.line_range
            rules: Set[str] = set()
            dec_lo = min([d.lineno for d in fi.node.decorator_list] + [lo])
            # dec_lo - 1: a comment line directly above the def (or its
            # first decorator) suppresses the whole body, matching the
            # prev-line semantics statements already get.
            for ln in range(dec_lo - 1, getattr(fi.node, "body",
                                                [fi.node])[0].lineno + 1):
                rules |= self._suppress.get(ln, set())
            if rules:
                self._func_suppress.append((lo, hi, rules))

    def scope_at(self, line: int) -> str:
        """Qualified name of the *innermost* function covering `line`."""
        best: Optional[FunctionInfo] = None
        for fi in self.functions:
            lo, hi = fi.line_range
            if lo <= line <= hi:
                if best is None or lo >= best.line_range[0]:
                    best = fi
        return best.qualname if best else "<module>"

    def suppressed(self, line: int, rule: str) -> bool:
        for probe in (line, line - 1):
            if rule in self._suppress.get(probe, set()):
                return True
        for lo, hi, rules in self._func_suppress:
            if lo <= line <= hi and rule in rules:
                return True
        return False

    def function_named(self, name: str) -> List[FunctionInfo]:
        return [f for f in self.functions if f.name == name]


class Project:
    """The scanned file set plus the repo root (for cross-tree passes)."""

    def __init__(self, files: Sequence[SourceFile], root: str):
        self.files = list(files)
        self.root = root

    def by_rel(self, rel: str) -> Optional[SourceFile]:
        for f in self.files:
            if f.rel == rel or f.rel.endswith("/" + rel):
                return f
        return None

    def iter_tree_files(self, subdir: str,
                        suffix: str = ".py") -> Iterator[str]:
        """Paths under ``root/subdir`` (e.g. the test fixtures the format
        pass cross-checks); yields nothing when the dir is absent."""
        base = os.path.join(self.root, subdir)
        for dirpath, _, names in os.walk(base):
            for n in sorted(names):
                if n.endswith(suffix):
                    yield os.path.join(dirpath, n)


class LintPass:
    """Base class for repro-lint passes.

    Subclasses set ``rule`` (the id used by suppressions and the
    baseline) and implement either :meth:`check_file` (per-module passes)
    or :meth:`check_project` (cross-file passes); ``run`` calls both.
    Use :meth:`emit` so suppression filtering is applied uniformly.
    """

    rule: str = "abstract"
    description: str = ""

    def __init__(self):
        self._out: List[Violation] = []

    def emit(self, sf: Optional[SourceFile], line: int, message: str,
             rel: Optional[str] = None, scope: Optional[str] = None):
        if sf is not None and sf.suppressed(line, self.rule):
            return
        self._out.append(Violation(
            rule=self.rule,
            path=rel if rel is not None else (sf.rel if sf else "<project>"),
            line=line,
            scope=scope if scope is not None
            else (sf.scope_at(line) if sf else "<project>"),
            message=message))

    def check_file(self, sf: SourceFile) -> None:   # per-module hook
        pass

    def check_project(self, project: Project) -> None:  # cross-file hook
        pass

    def run(self, project: Project) -> List[Violation]:
        self._out = []
        for sf in project.files:
            self.check_file(sf)
        self.check_project(project)
        return list(self._out)


def load_project(paths: Sequence[str], root: str) -> Project:
    """Parse every ``.py`` under `paths` into a Project (skips files that
    fail to parse -- reported by the CLI as hard errors instead)."""
    files: List[SourceFile] = []
    seen: Set[str] = set()
    for p in paths:
        if os.path.isfile(p):
            cands = [p]
        else:
            cands = [os.path.join(dp, n)
                     for dp, _, names in os.walk(p)
                     for n in sorted(names) if n.endswith(".py")]
        for c in sorted(cands):
            c = os.path.abspath(c)
            if c in seen:
                continue
            seen.add(c)
            rel = os.path.relpath(c, root)
            with open(c, "r", encoding="utf-8") as fh:
                files.append(SourceFile(c, rel, fh.read()))
    return Project(files, root)


__all__ = ["Violation", "FunctionInfo", "SourceFile", "Project", "LintPass",
           "device_resident", "dotted_name", "call_name", "names_in",
           "load_project"]
