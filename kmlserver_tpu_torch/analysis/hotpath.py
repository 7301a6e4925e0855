"""Checker 1 — hot-path purity.

The serving contract: the dispatch path (batcher admission/collection →
engine replica dispatch → the lookup it enqueues on the card) never
blocks the host on the card, never does file I/O, never sleeps. A host
sync on this path stalls the dispatching thread until the card has
finished everything queued before — the next batch cannot be staged
while the previous one computes, and every request of the batch waits
for it. Runtime evidence exists (the smoke's sync guard on the card) but
only fires AFTER a bad diff ships; this checker rejects the diff.

Mechanics: BFS the call graph from the configured dispatch entry points
(``AnalysisConfig.hotpath_entries``) and flag every forbidden construct
(``time.sleep``, ``open``, ``torch.cuda.synchronize``, ``.item()``,
``.tolist()``, ``.cpu()``, ``.synchronize()``, ``.result()``,
``torch.tensor(..., device=...)``, pickle/json file I/O, …) in any
reachable function body. Completion-side closures — the ``finish()``
callables, which wait on the card BY DESIGN — never join the graph
because nested defs are only traversed where they are visibly called
(see callgraph module docstring). What a dispatch reaches only through a
callable parameter (``RecommendEngine._enqueue``'s ``lookup``) is
anchored as an entry of its own.
"""

from __future__ import annotations

from .callgraph import CallGraph, match_forbidden
from .core import SEVERITY_ERROR, AnalysisConfig, Finding, ProjectIndex


def run(index: ProjectIndex, cfg: AnalysisConfig) -> list[Finding]:
    graph = CallGraph(index)
    paths = graph.reachable(cfg.hotpath_entries)
    findings: list[Finding] = []
    for ref, path in paths.items():
        info = index.function(ref)
        if info is None:
            continue
        for site in graph.sites(ref):
            construct = match_forbidden(
                site,
                cfg.hotpath_forbidden_calls,
                cfg.hotpath_forbidden_methods,
                cfg.hotpath_forbidden_kw_calls,
            )
            if construct is None:
                continue
            via = " -> ".join(p.split("::", 1)[1] for p in path)
            findings.append(
                Finding(
                    checker="hotpath",
                    severity=SEVERITY_ERROR,
                    file=info.relpath,
                    line=site.line,
                    key=f"{construct}@{info.qualname}",
                    message=(
                        f"host-sync/blocking construct `{construct}` in "
                        f"`{info.qualname}`, reachable from the serving "
                        f"dispatch path ({via}); host syncs, file I/O "
                        "and sleeps are forbidden here — move it "
                        "off the dispatch path (publication/completion "
                        "side) or justify with a pragma/baseline entry"
                    ),
                )
            )
    return findings
