"""Checker 8 — kernel cost-spec registry.

The cost-attribution layer (observability/costmodel.py) derives MFU and
roofline classifications from analytic FLOPs/bytes specs, one per
dispatched kernel. That only stays true if the spec registry and the dispatch sites
cannot drift: a kernel observed without a spec silently attributes zero
work (the runtime counts it as ``kmls_costmodel_unspecced_total``, but
nothing fails), and a spec nothing observes is a dead formula a reader
will trust anyway. This checker closes both directions statically:

- every ``observe_kernel("<name>", ...)`` call site anywhere in the
  analyzed tree must name a key of ``KERNEL_COST_SPECS``;
- every registry key must have at least one observe site (orphans are
  warnings — a mining-side spec consumed only via ``phase_cost`` keeps
  itself alive through the required-anchor list below);
- ``phase_cost("<name>", ...)`` call sites are held to the same
  membership rule (they KeyError at runtime — this catches it in CI);
- a non-literal kernel name is flagged: the registry contract is only
  checkable when the name is visible at the call site (forwarding
  helpers carry a pragma);
- the REQUIRED kernel names (the dispatched kernels: replicated/
  sharded/native serve, embed top-k, ALS sweep, support count, delta
  recount) must all be registered — the anchor that keeps a rename from
  silently hollowing the checker;
- every ``kmls_*`` series the cost model renders must be declared in
  ``serving.metrics.METRIC_REGISTRY`` (the metrics checker covers the
  file too; this keeps the invariant named even if the exposition-file
  list drifts).
"""

from __future__ import annotations

import ast

from .core import (
    SEVERITY_ERROR,
    SEVERITY_WARN,
    AnalysisConfig,
    Finding,
    ProjectIndex,
)
from .metricsreg import (
    _CHILD_SUFFIXES,
    _iter_series_literals,
    parse_metric_registry,
)

# call names whose FIRST positional argument is a cost-spec kernel name
_SPEC_CALLS = ("observe_kernel", "phase_cost")


def parse_cost_specs(
    index: ProjectIndex, cfg: AnalysisConfig
) -> tuple[dict[str, int], int]:
    """``KERNEL_COST_SPECS = {...}`` parsed WITHOUT importing →
    (kernel name -> line, registry line; empty when absent)."""
    mod = index.modules.get(cfg.costmodel_file)
    if mod is None:
        return {}, 0
    for node in mod.tree.body:
        target = None
        value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value = node.target, node.value
        if (
            isinstance(target, ast.Name)
            and target.id == cfg.costspec_registry_name
            and isinstance(value, ast.Dict)
        ):
            out = {
                k.value: k.lineno
                for k in value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            }
            return out, node.lineno
    return {}, 0


def collect_observe_sites(
    index: ProjectIndex,
) -> tuple[dict[str, list[tuple[str, int]]], list[tuple[str, int, str]]]:
    """Scan every module for cost-spec call sites →
    (kernel name -> [(file, line)], unresolvable sites as
    (file, line, call name)). A site is any call to one of
    ``observe_kernel`` / ``phase_cost`` / ``timed_observation`` — as a
    method or a bare imported name — whose kernel argument is the first
    positional: a string literal resolves, anything else is
    unresolvable (pragma-suppressed where forwarding is the point)."""
    sites: dict[str, list[tuple[str, int]]] = {}
    unresolved: list[tuple[str, int, str]] = []
    for relpath, mod in index.modules.items():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = None
            if isinstance(func, ast.Attribute):
                name = func.attr
            elif isinstance(func, ast.Name):
                name = func.id
            if name not in _SPEC_CALLS:
                continue
            if not node.args:
                # keyword-only spelling: treat as unresolvable — the
                # contract is a visible literal first argument
                unresolved.append((relpath, node.lineno, name))
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(
                first.value, str
            ):
                sites.setdefault(first.value, []).append(
                    (relpath, node.lineno)
                )
            else:
                unresolved.append((relpath, node.lineno, name))
    return sites, unresolved


def run(index: ProjectIndex, cfg: AnalysisConfig) -> list[Finding]:
    specs, reg_line = parse_cost_specs(index, cfg)
    findings: list[Finding] = []
    if not specs:
        findings.append(
            Finding(
                checker="costspec",
                severity=SEVERITY_ERROR,
                file=cfg.costmodel_file,
                line=1,
                key="registry-missing",
                message=(
                    f"no `{cfg.costspec_registry_name}` dict found in "
                    f"{cfg.costmodel_file}; every dispatched "
                    "kernel needs an analytic cost spec there"
                ),
            )
        )
        return findings

    sites, unresolved = collect_observe_sites(index)

    for name in sorted(sites):
        if name not in specs:
            relpath, line = sites[name][0]
            findings.append(
                Finding(
                    checker="costspec",
                    severity=SEVERITY_ERROR,
                    file=relpath,
                    line=line,
                    key=f"unregistered:{name}",
                    message=(
                        f"kernel `{name}` is observed/attributed here "
                        "but has no entry in "
                        f"costmodel.{cfg.costspec_registry_name} — its "
                        "dispatches would attribute ZERO flops/bytes "
                        "(kmls_costmodel_unspecced_total); register an "
                        "analytic spec"
                    ),
                )
            )
    for name in sorted(specs):
        if name not in sites:
            findings.append(
                Finding(
                    checker="costspec",
                    severity=SEVERITY_WARN,
                    file=cfg.costmodel_file,
                    line=specs[name],
                    key=f"orphan:{name}",
                    message=(
                        f"cost spec `{name}` has no observe_kernel/"
                        "phase_cost call site anywhere — remove the "
                        "spec or wire the dispatch up"
                    ),
                )
            )
    for relpath, line, call in unresolved:
        findings.append(
            Finding(
                checker="costspec",
                severity=SEVERITY_WARN,
                file=relpath,
                line=line,
                key=f"unresolvable:{relpath}:{call}",
                message=(
                    f"`{call}` called with a non-literal kernel name — "
                    "the spec-registry contract is only checkable when "
                    "the name is visible at the call site (forwarding "
                    "helpers carry a `# kmls-verify: allow[costspec]` "
                    "pragma)"
                ),
            )
        )
    for name in cfg.costspec_required:
        if name not in specs:
            findings.append(
                Finding(
                    checker="costspec",
                    severity=SEVERITY_ERROR,
                    file=cfg.costmodel_file,
                    line=reg_line,
                    key=f"required-missing:{name}",
                    message=(
                        f"required kernel `{name}` (a dispatched "
                        "kernel) has no cost spec in "
                        f"{cfg.costspec_registry_name} — a rename must "
                        "update the checker config, not hollow the "
                        "registry"
                    ),
                )
            )

    # every series the cost model renders must be in METRIC_REGISTRY —
    # the metrics checker enforces this too (costmodel.py is one of its
    # exposition files); repeating it HERE keeps checker 8 sound even if
    # that file list drifts
    entries, _lines, _reg = parse_metric_registry(index, cfg)
    mod = index.modules.get(cfg.costmodel_file)
    if entries and mod is not None:
        seen: set[str] = set()
        for series, line in _iter_series_literals(mod.tree):
            if series in seen or any(
                series.endswith(sfx) for sfx in _CHILD_SUFFIXES
            ):
                continue
            seen.add(series)
            if series not in entries:
                findings.append(
                    Finding(
                        checker="costspec",
                        severity=SEVERITY_ERROR,
                        file=cfg.costmodel_file,
                        line=line,
                        key=f"series-unregistered:{series}",
                        message=(
                            f"cost-model series `{series}` is not "
                            "declared in metrics.METRIC_REGISTRY"
                        ),
                    )
                )
    return findings
