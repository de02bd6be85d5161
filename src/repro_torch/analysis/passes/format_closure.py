"""Pass: format-closure.

The on-disk format is a closed matrix: every NCK container magic has a
reader branch and old readers reject newer files cleanly; every rANS
blob version is written and parsed from one ``_V_*`` definition; and the
per-step / per-read telemetry records carry exactly the canonical key
sets.  A new magic, blob version, or telemetry key that lands in only
one of its places is a corrupt-file or broken-dashboard bug waiting for
the next reader.  The reference's sub-checks, pointed at the port's
writer (``src/repro_torch/core/container.py``), blob coder
(``src/repro_torch/kernels/rans.py``) and key canon
(``src/repro_torch/obs/report.py``); the magic-in-tests checks read the
port's tests (``tests/test_torch_*.py``, where
``tests/test_torch_container.py`` holds the NCK bytes):

  1. **Magic matrix**: the ``_MAGIC_V*`` constants, the ``_MAGICS``
     reader-accept dict and the writer's version->magic map cover
     exactly the same set, and every magic byte-string appears in a
     test.
  2. **Blob versions**: every ``_V_*`` constant appears in both a writer
     context (``*.pack(...)`` argument) and a reader comparison; header
     pack calls pass the named constant, never an integer literal.
  3. **Telemetry key canon**: dict literals stored into
     ``...["telemetry"]`` / ``...["telemetry_read"]`` use exactly the
     canonical keys (``STEP_TELEMETRY_KEYS`` / ``READ_TELEMETRY_KEYS``);
     driver-stage partial records may use the canonical subset plus
     ``device_entropy_s``.
  4. **Manifest magic**: ``_MANIFEST_MAGIC`` has a reader branch and a
     test fixture; the NCK4 checksum keys have writer, reader and test
     sites.
  5. **Atomic publish discipline**: every durable publish goes through
     ``core.container.atomic_commit`` (write tmp, flush, fsync, rename);
     any other ``os.replace``/``os.rename`` is flagged.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import LintPass, Project, SourceFile, call_name
from repro_torch.analysis.registry import register_pass

def _port_tests_text(project: Project) -> str:
    """The port's tests (``tests/test_torch_*.py``), concatenated."""
    out = []
    for path in project.iter_tree_files("tests"):
        if os.path.basename(path).startswith("test_torch_"):
            with open(path, "r", encoding="utf-8") as fh:
                out.append(fh.read())
    return "".join(out)


# Driver-stage partial record keys that finalize_step folds into the
# canonical record (see core/pipeline.py).
_DRIVER_EXTRA_KEYS = {"device_entropy_s"}


def _const_str_keys(d: ast.Dict) -> Optional[List[str]]:
    keys = []
    for k in d.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.append(k.value)
        else:
            return None
    return keys


def _tuple_of_strs(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                vals.append(e.value)
            else:
                return None
        return tuple(vals)
    return None


def _module_str_assigns(sf: SourceFile) -> Dict[str, bytes]:
    """Module-level ``NAME = b"..."`` / ``NAME = "..."`` assignments."""
    out: Dict[str, bytes] = {}
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, (bytes, str)):
            name = node.targets[0].id
            v = node.value.value
            out[name] = v if isinstance(v, bytes) else v.encode()
    return out


@register_pass
class FormatClosurePass(LintPass):
    rule = "format-closure"
    description = ("container magics, blob versions and telemetry key "
                   "sets stay closed across writer/reader/tests")

    def check_project(self, project: Project) -> None:
        canon = self._load_canon(project)
        for sf in project.files:
            self._check_telemetry_writes(sf, canon)
            self._check_atomic_publish(sf)
        csf = project.by_rel("src/repro_torch/core/container.py")
        if csf is not None:
            self._check_magics(csf, project)
            self._check_manifest_magic(csf, project)
            self._check_checksum_frame(csf, project)
        rsf = project.by_rel("src/repro_torch/kernels/rans.py")
        if rsf is not None:
            self._check_blob_versions(rsf)

    # ----------------------------------------------------- canon loading
    @staticmethod
    def _load_canon(project: Project) -> Dict[str, Tuple[str, ...]]:
        canon: Dict[str, Tuple[str, ...]] = {}
        rsf = project.by_rel("src/repro_torch/obs/report.py")
        if rsf is None:
            return canon
        for node in rsf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if name in ("STEP_TELEMETRY_KEYS", "READ_TELEMETRY_KEYS"):
                    vals = _tuple_of_strs(node.value)
                    if vals:
                        canon[name] = vals
        return canon

    # ----------------------------------------------- telemetry key canon
    def _check_telemetry_writes(self, sf: SourceFile,
                                canon: Dict[str, Tuple[str, ...]]) -> None:
        step_keys = set(canon.get("STEP_TELEMETRY_KEYS", ()))
        read_keys = set(canon.get("READ_TELEMETRY_KEYS", ()))
        if not step_keys or not read_keys:
            return
        # Dict literals assigned to local names, for one-hop resolution
        # (the `rec = {...}; meta["telemetry_read"] = rec` pattern).
        local_dicts: Dict[Tuple[str, str], ast.Dict] = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Dict):
                local_dicts[(sf.scope_at(node.lineno),
                             node.targets[0].id)] = node.value
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                which = self._telemetry_slot(tgt)
                if which is None:
                    continue
                slot, sub_key = which
                exact = slot == "telemetry_read" or sf.scope_at(
                    node.lineno).rsplit(".", 1)[-1].startswith("finalize")
                allowed = (read_keys if slot == "telemetry_read"
                           else step_keys)
                if sub_key is not None:
                    # x["telemetry_read"]["fetch_s"] = ... single-key store
                    if sub_key not in allowed:
                        self.emit(sf, node.lineno,
                                  f'key "{sub_key}" written to '
                                  f'meta["{slot}"] is not in the canonical '
                                  'key set')
                    continue
                d = node.value
                if isinstance(d, ast.Name):
                    d = local_dicts.get((sf.scope_at(node.lineno), d.id), d)
                if not isinstance(d, ast.Dict):
                    continue
                keys = _const_str_keys(d)
                if keys is None:
                    self.emit(sf, node.lineno,
                              f'meta["{slot}"] written with non-literal '
                              'keys; the canonical key set cannot be '
                              'checked')
                    continue
                extra = ([k for k in keys if k not in allowed]
                         if slot == "telemetry_read" or exact else
                         [k for k in keys
                          if k not in allowed | _DRIVER_EXTRA_KEYS])
                missing = ([k for k in sorted(allowed)
                            if k not in keys] if exact else [])
                for k in extra:
                    self.emit(sf, node.lineno,
                              f'key "{k}" written to meta["{slot}"] is '
                              'not in the canonical key set')
                if missing:
                    self.emit(sf, node.lineno,
                              f'meta["{slot}"] record is missing canonical '
                              f'keys: {", ".join(missing)}')

    @staticmethod
    def _telemetry_slot(tgt: ast.AST) -> Optional[Tuple[str, Optional[str]]]:
        """(slot, sub_key) when `tgt` stores into a telemetry record."""
        if not isinstance(tgt, ast.Subscript):
            return None
        key = tgt.slice
        if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
            return None
        if key.value in ("telemetry", "telemetry_read"):
            return key.value, None
        # one level deeper: x["telemetry_read"]["fetch_s"] = ...
        inner = tgt.value
        if isinstance(inner, ast.Subscript) \
                and isinstance(inner.slice, ast.Constant) \
                and inner.slice.value in ("telemetry", "telemetry_read"):
            return inner.slice.value, key.value
        return None

    # -------------------------------------------------- container magics
    def _check_magics(self, sf: SourceFile, project: Project) -> None:
        consts = {k: v for k, v in _module_str_assigns(sf).items()
                  if re.fullmatch(r"_MAGIC_V\d+", k)}
        magics_keys: Set[str] = set()
        writer_magics: Set[str] = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == "_MAGICS"
                            for t in node.targets) \
                    and isinstance(node.value, ast.Dict):
                for k in node.value.keys:
                    if isinstance(k, ast.Name):
                        magics_keys.add(k.id)
            # the writer's version -> magic literal map ({1: _MAGIC_V1,..})
            elif isinstance(node, ast.Dict) and node.keys and all(
                    isinstance(k, ast.Constant) and isinstance(k.value, int)
                    for k in node.keys):
                for v in node.values:
                    if isinstance(v, ast.Name) and v.id in consts:
                        writer_magics.add(v.id)
        for name in sorted(consts):
            if name not in magics_keys:
                self.emit(sf, 1, f"container magic `{name}` is not accepted "
                          "by the `_MAGICS` reader matrix", scope="<module>")
            if writer_magics and name not in writer_magics:
                self.emit(sf, 1, f"container magic `{name}` has no writer "
                          "branch (version -> magic map)",
                          scope="<module>")
        # every magic byte-string must appear in a test file
        tests_text = _port_tests_text(project)
        for name, magic in sorted(consts.items()):
            token = magic.decode("ascii", "replace")
            if tests_text and token not in tests_text:
                self.emit(sf, 1, f"container magic `{name}` ({token}) has "
                          "no test fixture exercising it",
                          scope="<module>")

    # -------------------------------------------------- manifest closure
    def _check_manifest_magic(self, sf: SourceFile,
                              project: Project) -> None:
        consts = _module_str_assigns(sf)
        magic = consts.get("_MANIFEST_MAGIC")
        if magic is None:
            return
        compared = False
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Compare):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name) \
                            and sub.id == "_MANIFEST_MAGIC":
                        compared = True
        if not compared:
            self.emit(sf, 1, "`_MANIFEST_MAGIC` has no reader branch "
                      "(never compared against file bytes)",
                      scope="<module>")
        token = magic.decode("ascii", "replace")
        tests_text = _port_tests_text(project)
        if tests_text and token not in tests_text:
            self.emit(sf, 1, f"manifest magic `_MANIFEST_MAGIC` ({token}) "
                      "has no test fixture exercising it",
                      scope="<module>")

    # -------------------------------------------- NCK4 checksum closure
    def _check_checksum_frame(self, sf: SourceFile,
                              project: Project) -> None:
        """The NCK4 checksum frame joins the writer/reader/test closure:
        when `_MAGIC_V4` exists, the `_CRC_KEY` / `_BLOCK_CRC_KEY`
        record keys must each have a writer site (subscript store or
        dict-literal key), a reader site (load / `.get` / membership
        test), and a test exercising the literal key string -- a digest
        that is stamped but never verified (or vice versa) is an open
        frame."""
        consts = _module_str_assigns(sf)
        if "_MAGIC_V4" not in consts:
            return
        keys = [k for k in ("_CRC_KEY", "_BLOCK_CRC_KEY") if k in consts]
        for want in ("_CRC_KEY", "_BLOCK_CRC_KEY"):
            if want not in consts:
                self.emit(sf, 1, f"NCK4 exists but checksum key constant "
                          f"`{want}` is not defined", scope="<module>")
        written: Set[str] = set()
        read: Set[str] = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.slice, ast.Name) \
                    and node.slice.id in keys:
                if isinstance(node.ctx, ast.Store):
                    written.add(node.slice.id)
                else:
                    read.add(node.slice.id)
            elif isinstance(node, ast.Dict):
                for k in node.keys:
                    if isinstance(k, ast.Name) and k.id in keys:
                        written.add(k.id)
            elif isinstance(node, ast.Call):
                cn = call_name(node) or ""
                if cn.endswith(".get"):
                    for a in node.args:
                        if isinstance(a, ast.Name) and a.id in keys:
                            read.add(a.id)
            elif isinstance(node, ast.Compare):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name) and sub.id in keys:
                        read.add(sub.id)
        for name in keys:
            if name not in written:
                self.emit(sf, 1, f"checksum key `{name}` is never stamped "
                          "by a writer (no store site)", scope="<module>")
            if name not in read:
                self.emit(sf, 1, f"checksum key `{name}` is never verified "
                          "by a reader (no load site)", scope="<module>")
        tests_text = _port_tests_text(project)
        for name in keys:
            token = consts[name].decode("ascii", "replace")
            if tests_text and f'"{token}"' not in tests_text:
                self.emit(sf, 1, f"checksum key `{name}` (\"{token}\") has "
                          "no test fixture exercising it",
                          scope="<module>")

    def _check_atomic_publish(self, sf: SourceFile) -> None:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            cn = call_name(node) or ""
            if cn not in ("os.replace", "os.rename"):
                continue
            scope = sf.scope_at(node.lineno)
            if scope.rsplit(".", 1)[-1] == "atomic_commit":
                continue
            self.emit(sf, node.lineno,
                      f"`{cn}` outside core.container.atomic_commit: "
                      "durable publishes must go through the "
                      "fsync-before-rename helper")

    # ---------------------------------------------------- blob versions
    def _check_blob_versions(self, sf: SourceFile) -> None:
        vnames = {node.targets[0].id
                  for node in sf.tree.body
                  if isinstance(node, ast.Assign)
                  and len(node.targets) == 1
                  and isinstance(node.targets[0], ast.Name)
                  and re.fullmatch(r"_V_\w+", node.targets[0].id)}
        packed: Set[str] = set()
        compared: Set[str] = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                cn = call_name(node) or ""
                if cn.endswith(".pack") or cn.endswith(".pack_into"):
                    for i, a in enumerate(node.args):
                        if isinstance(a, ast.Name) and a.id in vnames:
                            packed.add(a.id)
                        elif isinstance(a, ast.Constant) \
                                and isinstance(a.value, int) and i == 1 \
                                and cn.startswith(("_HDR", "_RAW_HDR")):
                            self.emit(sf, node.lineno,
                                      "blob header packed with literal "
                                      f"version {a.value}; use the `_V_*` "
                                      "constant")
            elif isinstance(node, ast.Compare):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name) and sub.id in vnames:
                        compared.add(sub.id)
        for name in sorted(vnames):
            if name not in packed:
                self.emit(sf, 1, f"blob version `{name}` is never written "
                          "(no pack site uses it)", scope="<module>")
            if name not in compared:
                self.emit(sf, 1, f"blob version `{name}` has no reader "
                          "branch (never compared)", scope="<module>")
