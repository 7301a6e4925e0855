"""Checker 7 — metric-series registry.

Every Prometheus series the project exports — the serving ``/metrics``
exposition (serving/metrics.py, plus the app's dynamically rendered
robustness keys) and the mining ``job_metrics.prom`` textfile
(observability/jobmetrics.py) — must be declared in
``serving.metrics.METRIC_REGISTRY`` as ``"<type>:<scope>"`` with a valid
type (counter/gauge/summary/histogram) and scope (serving/mining), must
carry a README row, and must match the scope of the module that renders
it. And the inverse: a registry entry nothing renders is an orphan — a
dashboard keeps querying a series the fleet stopped exporting.

Collection mirrors the knob checker's discipline: series names are
AST string literals (tokens matching ``kmls_[a-z0-9_]+`` embedded in
exposition-module strings — f-string constant fragments included, so
``f'kmls_cache_hits_total {cache.hits}'`` counts), docstrings are
skipped outright (prose must neither keep a series alive nor demand an
entry for an example), comments never reach the AST, and the
``METRIC_REGISTRY`` dict's own span is excluded so a key cannot count
as the exposition reference that keeps itself alive. Dynamically
rendered series (the robustness dict: plain keys prefixed ``kmls_`` at
render time) are collected from the configured source function's dict
keys and subscript stores.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterator

from .core import (
    SEVERITY_ERROR,
    SEVERITY_WARN,
    AnalysisConfig,
    Finding,
    ProjectIndex,
)

_SERIES_RE = re.compile(r"\bkmls_[a-z0-9][a-z0-9_]*[a-z0-9]\b")
# histogram children are rendered per-bucket from the base name; they are
# implementation suffixes of the declared series, never declared themselves
_CHILD_SUFFIXES = ("_bucket", "_sum", "_count")

VALID_TYPES = ("counter", "gauge", "summary", "histogram")
VALID_METRIC_SCOPES = ("serving", "mining")


def _docstring_node_ids(tree: ast.AST) -> set[int]:
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(
            node,
            (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
        ):
            body = getattr(node, "body", [])
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                out.add(id(body[0].value))
    return out


def _iter_series_literals(tree: ast.AST) -> Iterator[tuple[str, int]]:
    docstrings = _docstring_node_ids(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if id(node) in docstrings:
                continue
            for token in _SERIES_RE.findall(node.value):
                yield token, node.lineno


def _registry_span(
    index: ProjectIndex, cfg: AnalysisConfig
) -> tuple[int, int] | None:
    mod = index.modules.get(cfg.metrics_file)
    if mod is None:
        return None
    for node in mod.tree.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        if (
            isinstance(target, ast.Name)
            and target.id == cfg.metric_registry_name
        ):
            return (node.lineno, node.end_lineno or node.lineno)
    return None


def parse_metric_registry(
    index: ProjectIndex, cfg: AnalysisConfig
) -> tuple[dict[str, str], dict[str, int], int]:
    """``METRIC_REGISTRY = {...}`` parsed WITHOUT importing →
    (name -> "type:scope", name -> line, registry line)."""
    mod = index.modules.get(cfg.metrics_file)
    if mod is None:
        return {}, {}, 0
    for node in mod.tree.body:
        target = None
        value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value = node.target, node.value
        if (
            isinstance(target, ast.Name)
            and target.id == cfg.metric_registry_name
            and isinstance(value, ast.Dict)
        ):
            entries: dict[str, str] = {}
            lines: dict[str, int] = {}
            for k, v in zip(value.keys, value.values):
                if (
                    isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)
                ):
                    entries[k.value] = v.value
                    lines[k.value] = k.lineno
            return entries, lines, node.lineno
    return {}, {}, 0


def collect_exposed_series(
    index: ProjectIndex, cfg: AnalysisConfig
) -> dict[str, list[tuple[str, int, str]]]:
    """series -> [(file, line, scope), ...], first ref per exposition
    scope — a series rendered by BOTH the serving and mining surfaces
    keeps one ref from each, so the scope check can flag the surface
    that should not be rendering it."""
    span = _registry_span(index, cfg)
    refs: dict[str, list[tuple[str, int, str]]] = {}

    def add(name: str, relpath: str, line: int, scope: str) -> None:
        surfaces = refs.setdefault(name, [])
        if all(seen_scope != scope for _, _, seen_scope in surfaces):
            surfaces.append((relpath, line, scope))

    for relpath, scope in cfg.metric_exposition_files.items():
        mod = index.modules.get(relpath)
        if mod is None:
            continue
        for name, line in _iter_series_literals(mod.tree):
            if (
                relpath == cfg.metrics_file
                and span is not None
                and span[0] <= line <= span[1]
            ):
                continue
            if any(name.endswith(sfx) for sfx in _CHILD_SUFFIXES):
                continue
            add(name, relpath, line, scope)
    for ref, prefix, scope in cfg.metric_dynamic_sources:
        info = index.function(ref)
        if info is None:
            continue
        for node in ast.walk(info.node):
            keys: list[tuple[str, int]] = []
            if isinstance(node, ast.Dict):
                keys = [
                    (k.value, k.lineno)
                    for k in node.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value, str)
                ]
            elif isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Subscript
            ):
                sl = node.targets[0].slice
                if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                    keys = [(sl.value, node.lineno)]
            for key, line in keys:
                add(f"{prefix}{key}", info.relpath, line, scope)
    return refs


def _read_text(root: str, relpath: str) -> str:
    try:
        with open(os.path.join(root, relpath), "r", encoding="utf-8") as fh:
            return fh.read()
    except OSError:
        return ""


def run(index: ProjectIndex, cfg: AnalysisConfig) -> list[Finding]:
    entries, reg_lines, reg_line = parse_metric_registry(index, cfg)
    findings: list[Finding] = []
    if not entries:
        findings.append(
            Finding(
                checker="metrics",
                severity=SEVERITY_ERROR,
                file=cfg.metrics_file,
                line=1,
                key="registry-missing",
                message=(
                    f"no `{cfg.metric_registry_name}` dict found in "
                    f"{cfg.metrics_file}; every exported Prometheus "
                    "series must be declared there as "
                    f"\"<type>:<scope>\" ({'/'.join(VALID_TYPES)} : "
                    f"{'/'.join(VALID_METRIC_SCOPES)})"
                ),
            )
        )
        return findings

    refs = collect_exposed_series(index, cfg)
    readme_text = _read_text(index.root, cfg.readme)

    for name in sorted(refs):
        relpath, line, _scope = refs[name][0]
        if name not in entries:
            findings.append(
                Finding(
                    checker="metrics",
                    severity=SEVERITY_ERROR,
                    file=relpath,
                    line=line,
                    key=f"unregistered:{name}",
                    message=(
                        f"series `{name}` is exported here but not "
                        f"declared in metrics.{cfg.metric_registry_name}; "
                        "add it with a type+scope and a README row"
                    ),
                )
            )
            continue
        declared_scope = entries[name].partition(":")[2]
        if declared_scope not in VALID_METRIC_SCOPES:
            continue  # bad-entry finding below covers it
        # check every surface: a series both modules render is a
        # mismatch on whichever side the registry did not declare
        for relpath, line, scope in refs[name]:
            if declared_scope != scope:
                findings.append(
                    Finding(
                        checker="metrics",
                        severity=SEVERITY_ERROR,
                        file=relpath,
                        line=line,
                        key=f"scope-mismatch:{name}",
                        message=(
                            f"series `{name}` is exported by a "
                            f"{scope!r}-side module but registered with "
                            f"scope {declared_scope!r} — the two "
                            "exposition surfaces must not swap series"
                        ),
                    )
                )
    for name in sorted(entries):
        value = entries[name]
        kline = reg_lines.get(name, reg_line)
        mtype, sep, scope = value.partition(":")
        if not sep or mtype not in VALID_TYPES or scope not in VALID_METRIC_SCOPES:
            findings.append(
                Finding(
                    checker="metrics",
                    severity=SEVERITY_ERROR,
                    file=cfg.metrics_file,
                    line=kline,
                    key=f"bad-entry:{name}",
                    message=(
                        f"`{name}` has malformed registry value "
                        f"{value!r}; expected \"<type>:<scope>\" with "
                        f"type in {', '.join(VALID_TYPES)} and scope in "
                        f"{', '.join(VALID_METRIC_SCOPES)}"
                    ),
                )
            )
            continue
        if name not in refs:
            findings.append(
                Finding(
                    checker="metrics",
                    severity=SEVERITY_WARN,
                    file=cfg.metrics_file,
                    line=kline,
                    key=f"orphan:{name}",
                    message=(
                        f"`{name}` is declared in the registry but no "
                        "exposition module renders it — remove the entry "
                        "(and its README row) or wire the series up"
                    ),
                )
            )
        if readme_text and name not in readme_text:
            findings.append(
                Finding(
                    checker="metrics",
                    severity=SEVERITY_WARN,
                    file=cfg.metrics_file,
                    line=kline,
                    key=f"undocumented:{name}",
                    message=(
                        f"`{name}` is not mentioned anywhere in "
                        f"{cfg.readme}; every exported series needs a "
                        "row in the metrics table (README "
                        "\"Observability\")"
                    ),
                )
            )
    return findings
