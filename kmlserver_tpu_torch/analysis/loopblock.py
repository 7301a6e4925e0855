"""Checker 9 — no blocking constructs in event-loop context.

The defect class this checker rejects: ``faults.fire()``'s blocking
``time.sleep`` running ON the asyncio event loop inside
``aioserver._Conn._dispatch`` turns a per-request chaos stall into a
whole-replica outage (effective concurrency 1). The asyncio front end's contract is that the loop NEVER
blocks: stalls are scheduled via ``loop.call_later``, device waits live
on the engine pool, and file/socket I/O stays on worker threads.

Mechanics: :func:`callgraph.classify_contexts` builds the event-loop
context map — asyncio Protocol callbacks, ``async def``s,
``call_soon``/``call_later``/``call_at`` targets (a global pre-pass,
because ``call_soon_threadsafe`` schedules ONTO the loop from any
thread), done-callbacks registered in loop context, plus the configured
entries the conservative graph can't see through (the inline
``app.handle`` dispatch). Every function in the map is scanned for the
configured blocking constructs; ``await``-ed calls are exempt (they
yield, not block), and an executor hop naturally ends the walk because
a callable handed to ``submit``/``run_in_executor`` produces no call
edge. Findings carry the entry → call path and why the entry is
loop-context, so the fix target is obvious.
"""

from __future__ import annotations

from .callgraph import CallGraph, classify_contexts, match_forbidden
from .core import SEVERITY_ERROR, AnalysisConfig, Finding, ProjectIndex


def run(index: ProjectIndex, cfg: AnalysisConfig) -> list[Finding]:
    graph = CallGraph(index)
    ctx = classify_contexts(index, cfg, graph)
    findings: list[Finding] = []
    for ref in sorted(ctx.loop):
        path = ctx.loop[ref]
        info = index.function(ref)
        if info is None:
            continue
        for site in graph.sites(ref):
            if site.awaited:
                continue
            construct = match_forbidden(
                site,
                cfg.loopblock_forbidden_calls,
                cfg.loopblock_forbidden_methods,
            )
            if construct is None:
                continue
            entry = path[0]
            reason = ctx.loop_roots.get(entry, "loop entry")
            via = " -> ".join(p.split("::", 1)[1] for p in path)
            findings.append(
                Finding(
                    checker="loopblock",
                    severity=SEVERITY_ERROR,
                    file=info.relpath,
                    line=site.line,
                    key=f"{construct}@{info.qualname}",
                    message=(
                        f"blocking construct `{construct}` in "
                        f"`{info.qualname}` runs in event-loop context "
                        f"(entry path: {via}; entry is {reason}); a "
                        "block here freezes every connection on the "
                        "replica — schedule it with loop.call_later, "
                        "hop through the engine pool/run_in_executor, "
                        "or justify with a pragma/baseline entry"
                    ),
                )
            )
    return findings
