"""Checker 3 — atomic-write enforcement.

Every artifact that lands on the shared PVC goes through
``io/artifacts.py``'s tmp+``os.replace`` writer, because the READ
protocol (pickle shapes, filenames, token polling) is the interop
contract and a torn read is not. The port always writes atomically (it
does not read the reference's ``KMLS_REFERENCE_RACE_COMPAT``), so the
rule is: nothing outside the approved writer modules/functions opens a
file for writing or serializes straight to a path.

Flags, outside the allowlist:

- ``open(path, mode)`` with a write-capable mode (``w``/``a``/``x`` or
  ``+``), and ``os.fdopen`` likewise;
- ``pickle.dump``, ``json.dump``, ``np.save``/``np.savez*``,
  ``np.savetxt`` — direct serialization to a handle/path;
- ``os.replace``/``os.rename`` anywhere in the package outside
  ``cfg.durable_rename_function`` (``io/artifacts.py::durable_replace``)
  and ``cfg.rename_allowed_modules``: a rename belongs not merely in
  the writer module but in THE durable rename — publication-critical
  renames must fsync the source
  file and the parent directory, or a power cut after the rename can
  silently vanish the publication — so even inside the approved writer
  module, a bare ``os.replace`` that is not ``durable_replace`` itself
  is flagged.

Scope is the package only (``kmlserver_tpu_torch/``): chip_smoke.py
writes its own local state files and is not part of the PVC contract.
The kernel and native-library build caches (``ops/cuda_build.py``,
``utils/nativelib.py``) rename into ``build/``, not onto the PVC, and are
rename-allowed by configuration.
"""

from __future__ import annotations

import ast

from .callgraph import resolve_call
from .core import (
    SEVERITY_ERROR,
    AnalysisConfig,
    Finding,
    FunctionInfo,
    ProjectIndex,
)

_SERIALIZERS = (
    "pickle.dump",
    "json.dump",
    "np.save",
    "np.savez",
    "np.savez_compressed",
    "np.savetxt",
    "numpy.save",
    "numpy.savez",
    "numpy.savez_compressed",
    "numpy.savetxt",
)
_RENAMES = ("os.replace", "os.rename")


def _write_mode(call: ast.Call) -> str | None:
    """The write-capable mode literal of an ``open``/``os.fdopen`` call,
    or None for reads / non-literal modes (non-literal = unknowable;
    stay quiet rather than guess)."""
    mode_node: ast.AST | None = None
    if len(call.args) >= 2:
        mode_node = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if mode_node is None:
        return None
    if isinstance(mode_node, ast.Constant) and isinstance(
        mode_node.value, str
    ):
        mode = mode_node.value
        if any(c in mode for c in "wax+"):
            return mode
    return None


def _module_allowed(relpath: str, allowed: set[str]) -> bool:
    if relpath in allowed:
        return True
    return any(
        m.endswith("/") and relpath.startswith(m) for m in allowed
    )


def run(index: ProjectIndex, cfg: AnalysisConfig) -> list[Finding]:
    allowed_modules = set(cfg.atomic_allowed_modules)
    allowed_functions = set(cfg.atomic_allowed_functions)
    rename_allowed = set(cfg.rename_allowed_modules)
    findings: list[Finding] = []
    for relpath in sorted(index.modules):
        if not relpath.startswith(cfg.package_dir):
            continue
        # renames are checked EVERYWHERE in the package, including the
        # atomic-allowed writer modules (the durable-rename rule is
        # stricter than the direct-write rule); plain writes keep the
        # module allowlist.
        writes_allowed = _module_allowed(relpath, allowed_modules)
        renames_allowed = _module_allowed(relpath, rename_allowed)
        if writes_allowed and renames_allowed:
            continue
        mod = index.modules[relpath]
        # top-level function spans, so a write can be attributed to (and
        # allowlisted by) its enclosing function — including writes in
        # NESTED closures, which unlike the hotpath checker's
        # completion-closure exemption have no business being exempt
        # here: a torn PVC write from a closure tears exactly the same
        spans: list[tuple[int, int, FunctionInfo]] = []
        for (rel, _qual), info in index.functions.items():
            if rel != relpath:
                continue
            end = getattr(info.node, "end_lineno", None)
            start = getattr(info.node, "lineno", None)
            if start is not None and end is not None:
                spans.append((start, end, info))
        module_caller = FunctionInfo(relpath, "<module>", mod.tree, None)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            info = module_caller
            best_span = None
            for start, end, fn_info in spans:
                if start <= node.lineno <= end and (
                    best_span is None or start > best_span[0]
                ):
                    best_span = (start, end)
                    info = fn_info
            site = resolve_call(index, info, node)
            if site.dotted in _RENAMES:
                if (
                    renames_allowed
                    or info.ref == cfg.durable_rename_function
                ):
                    continue
                findings.append(
                    Finding(
                        checker="atomic-write",
                        severity=SEVERITY_ERROR,
                        file=info.relpath,
                        line=node.lineno,
                        key=f"{site.dotted}@{info.qualname}",
                        message=(
                            f"publication-critical rename `{site.dotted}`"
                            f" in `{info.qualname}` bypasses "
                            "io/artifacts.py::durable_replace; without "
                            "the fsync-file + fsync-parent-dir "
                            "discipline a power cut after the rename "
                            "can silently vanish the publication"
                        ),
                    )
                )
                continue
            if writes_allowed or info.ref in allowed_functions:
                continue
            construct: str | None = None
            mode: str | None = None
            if site.dotted in ("open", "os.fdopen"):
                mode = _write_mode(node)
                if mode is not None:
                    construct = f"{site.dotted}(mode={mode!r})"
            elif site.dotted in _SERIALIZERS:
                construct = site.dotted
            if construct is None:
                continue
            findings.append(
                Finding(
                    checker="atomic-write",
                    severity=SEVERITY_ERROR,
                    file=info.relpath,
                    line=node.lineno,
                    key=f"{construct}@{info.qualname}",
                    message=(
                        f"direct file write `{construct}` in "
                        f"`{info.qualname}` bypasses the atomic artifact "
                        "writer; route it through io/artifacts.py "
                        "(save_pickle / atomic_write_text / "
                        "_atomic_write_bytes) so a crash mid-write can "
                        "never leave torn bytes on the PVC"
                    ),
                )
            )
    return findings
