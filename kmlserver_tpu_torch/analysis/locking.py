"""Checker 2 — lock-acquisition order and blocking-under-lock.

The serving tier holds 16+ ``threading.Lock``/``Condition`` instances
(batcher, engine, cache, metrics, faults, nativelib, watchdog, HTTP
server). Two invariants keep them deadlock- and tail-free, both
documented in code comments today and enforced only by load tests:

- **acyclic acquisition order** — e.g. the cache's singleflight calls
  the batcher's admission UNDER the cache lock (documented as safe
  because the batcher never calls back into the cache); the inverse
  edge appearing anywhere would be an AB/BA deadlock at QPS.
- **no blocking under a hot-path lock** — a ``time.sleep``, file open,
  ``Future.result`` or device sync while holding a lock on the request
  path serializes every concurrent request behind one slow operation
  (the GIL makes this WORSE than a plain stall: waiters burn sched
  wakeups). The reload lock is deliberately exempt — the reload path is
  cold and does file I/O under it by design.

Mechanics:

- **lock discovery**: ``self.<attr> = threading.Lock()/RLock()/
  Condition(...)`` in any method, and module-level ``<name> =
  threading.Lock()``. A ``Condition(self.<lock>)`` ALIASES the wrapped
  lock — acquiring the condition is acquiring that lock.
- **acquisition**: ``with <lock-expr>:`` over a discovered lock
  (``self.x``, module-global ``x``, or ``<anything>.x`` when the attr
  name is unique among discovered locks).
- **order edges**: lock A → lock B when B is acquired inside A's
  ``with`` body, directly or through resolved project calls (fixpoint
  over the call graph). Cycles are reported once per cycle set.
- **blocking**: a configured blocking construct inside a HOT lock's
  body, directly or through resolved calls (``Condition.wait`` is
  allowed: it releases the lock).
"""

from __future__ import annotations

import ast
import dataclasses

from .callgraph import CallGraph, match_forbidden, resolve_call
from .core import (
    SEVERITY_ERROR,
    AnalysisConfig,
    Finding,
    FunctionInfo,
    ProjectIndex,
)

_LOCK_CTORS = ("Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore")


@dataclasses.dataclass(frozen=True)
class LockId:
    owner: str  # class name, or "<relpath>" for module-level locks
    attr: str

    def render(self) -> str:
        return f"{self.owner}.{self.attr}"


@dataclasses.dataclass
class _FuncLockFacts:
    # locks this function acquires in its own body (outermost only —
    # nested ones are reported as order edges, not as direct acquires)
    acquires: set[LockId] = dataclasses.field(default_factory=set)
    # (held lock, acquired lock, line) order edges from this body
    edges: set[tuple[LockId, LockId, int]] = dataclasses.field(
        default_factory=set
    )
    # (held lock, construct, line) blocking sites from this body
    blocking: set[tuple[LockId, str, int]] = dataclasses.field(
        default_factory=set
    )
    # (held lock, callee ref, line): calls made while holding a lock
    held_calls: set[tuple[LockId, str, int]] = dataclasses.field(
        default_factory=set
    )


def _is_threading_lock_ctor(node: ast.AST) -> str | None:
    """→ ctor name when ``node`` is ``threading.X(...)``/bare ``X(...)``
    with X a lock constructor."""
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    name = None
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        if func.value.id == "threading":
            name = func.attr
    elif isinstance(func, ast.Name):
        name = func.id
    return name if name in _LOCK_CTORS else None


def discover_locks(
    index: ProjectIndex,
) -> tuple[set[LockId], dict[LockId, LockId]]:
    """→ (locks, aliases). ``aliases`` maps a Condition built over
    another discovered lock onto that lock."""
    locks: set[LockId] = set()
    pending_alias: dict[LockId, tuple[str, str]] = {}
    for (relpath, _qual), info in index.functions.items():
        if info.class_name is None:
            continue
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            ctor = _is_threading_lock_ctor(node.value)
            if ctor is None:
                continue
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                lock = LockId(info.class_name, target.attr)
                locks.add(lock)
                if ctor == "Condition" and node.value.args:
                    arg = node.value.args[0]
                    if (
                        isinstance(arg, ast.Attribute)
                        and isinstance(arg.value, ast.Name)
                        and arg.value.id == "self"
                    ):
                        pending_alias[lock] = (info.class_name, arg.attr)
    for relpath, mod in index.modules.items():
        for node in mod.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and _is_threading_lock_ctor(node.value)
            ):
                locks.add(LockId(relpath, node.targets[0].id))
    aliases = {
        cond: LockId(owner, attr)
        for cond, (owner, attr) in pending_alias.items()
        if LockId(owner, attr) in locks
    }
    return locks, aliases


class _LockWalker:
    """Per-function walk tracking the ``with``-lock stack."""

    def __init__(
        self,
        index: ProjectIndex,
        info: FunctionInfo,
        locks: set[LockId],
        aliases: dict[LockId, LockId],
        cfg: AnalysisConfig,
    ):
        self.index = index
        self.info = info
        self.locks = locks
        self.aliases = aliases
        self.cfg = cfg
        self.facts = _FuncLockFacts()
        # attr name -> lock, for unique-attr resolution on unknown
        # receivers (`self.server.active_lock`)
        by_attr: dict[str, list[LockId]] = {}
        for lock in locks:
            by_attr.setdefault(lock.attr, []).append(lock)
        self.unique_attr = {
            attr: ls[0] for attr, ls in by_attr.items() if len(ls) == 1
        }

    def _lock_of(self, node: ast.AST) -> LockId | None:
        lock: LockId | None = None
        if isinstance(node, ast.Attribute):
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and self.info.class_name
            ):
                cand = LockId(self.info.class_name, node.attr)
                if cand in self.locks:
                    lock = cand
            if lock is None:
                lock = self.unique_attr.get(node.attr)
        elif isinstance(node, ast.Name):
            cand = LockId(self.info.relpath, node.id)
            if cand in self.locks:
                lock = cand
        if lock is not None:
            lock = self.aliases.get(lock, lock)
        return lock

    def walk(self) -> _FuncLockFacts:
        self._visit_body(list(ast.iter_child_nodes(self.info.node)), [])
        return self.facts

    def _visit_body(self, nodes: list[ast.AST], held: list[LockId]) -> None:
        for node in nodes:
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(node, ast.With):
                acquired: list[LockId] = []
                for item in node.items:
                    lock = self._lock_of(item.context_expr)
                    if lock is not None and lock not in held:
                        acquired.append(lock)
                for lock in acquired:
                    if not held:
                        self.facts.acquires.add(lock)
                    for holder in held:
                        self.facts.edges.add((holder, lock, node.lineno))
                self._visit_body(list(node.body), held + acquired)
                # with-items' own expressions still need call scanning
                for item in node.items:
                    self._scan_expr(item.context_expr, held)
                continue
            if isinstance(node, ast.Call):
                self._scan_call(node, held)
            self._visit_body(list(ast.iter_child_nodes(node)), held)

    def _scan_expr(self, node: ast.AST, held: list[LockId]) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._scan_call(sub, held)

    def _scan_call(self, node: ast.Call, held: list[LockId]) -> None:
        if not held:
            return
        site = resolve_call(self.index, self.info, node)
        # Condition.wait releases the lock while blocked — not a block
        if site.method == "wait":
            return
        construct = match_forbidden(
            site, self.cfg.locks_blocking_calls, self.cfg.locks_blocking_methods
        )
        for holder in held:
            if construct is not None:
                self.facts.blocking.add((holder, construct, node.lineno))
            if site.target is not None:
                self.facts.held_calls.add((holder, site.target, node.lineno))


def run(index: ProjectIndex, cfg: AnalysisConfig) -> list[Finding]:
    locks, aliases = discover_locks(index)
    graph = CallGraph(index)
    facts: dict[str, _FuncLockFacts] = {}
    for (relpath, qual), info in index.functions.items():
        facts[info.ref] = _LockWalker(index, info, locks, aliases, cfg).walk()

    # interprocedural fixpoint: what may each function acquire / block
    # on, transitively through resolved project calls?
    trans_acquires: dict[str, set[LockId]] = {
        ref: set(f.acquires) for ref, f in facts.items()
    }
    trans_blocking: dict[str, set[str]] = {
        ref: {c for _h, c, _l in f.blocking} for ref, f in facts.items()
    }
    # also: blocking constructs in a function body OUTSIDE any lock still
    # block a caller that holds one
    for ref in facts:
        info = index.function(ref)
        if info is None:
            continue
        for site in graph.sites(ref):
            if site.method == "wait":
                continue
            construct = match_forbidden(
                site, cfg.locks_blocking_calls, cfg.locks_blocking_methods
            )
            if construct is not None:
                trans_blocking[ref].add(construct)
    changed = True
    while changed:
        changed = False
        for ref in facts:
            for site in graph.sites(ref):
                tgt = site.target
                if tgt is None or tgt not in facts:
                    continue
                if not trans_acquires[tgt] <= trans_acquires[ref]:
                    trans_acquires[ref] |= trans_acquires[tgt]
                    changed = True
                if not trans_blocking[tgt] <= trans_blocking[ref]:
                    trans_blocking[ref] |= trans_blocking[tgt]
                    changed = True

    hot = _parse_hot_locks(cfg)
    findings: list[Finding] = []
    edges: set[tuple[LockId, LockId]] = set()
    edge_sites: dict[tuple[LockId, LockId], tuple[str, int]] = {}

    for ref, f in facts.items():
        info = index.function(ref)
        if info is None:
            continue
        # direct nested-with edges
        for holder, acquired, line in f.edges:
            edges.add((holder, acquired))
            edge_sites.setdefault((holder, acquired), (info.relpath, line))
        # interprocedural edges + blocking through calls
        for holder, callee, line in f.held_calls:
            for acquired in trans_acquires.get(callee, ()):
                if acquired != holder:
                    edges.add((holder, acquired))
                    edge_sites.setdefault(
                        (holder, acquired), (info.relpath, line)
                    )
            if holder in hot:
                callee_info = index.function(callee)
                for construct in sorted(trans_blocking.get(callee, ())):
                    findings.append(
                        Finding(
                            checker="locks",
                            severity=SEVERITY_ERROR,
                            file=info.relpath,
                            line=line,
                            key=(
                                f"block:{holder.render()}:{construct}"
                                f"@{info.qualname}"
                            ),
                            message=(
                                f"`{info.qualname}` calls "
                                f"`{callee_info.qualname if callee_info else callee}`"
                                f" while holding hot-path lock "
                                f"{holder.render()}, and that call may "
                                f"block on `{construct}`; blocking under "
                                "a hot lock serializes every concurrent "
                                "request behind one slow operation"
                            ),
                        )
                    )
        # direct blocking under a hot lock
        for holder, construct, line in f.blocking:
            if holder in hot:
                findings.append(
                    Finding(
                        checker="locks",
                        severity=SEVERITY_ERROR,
                        file=info.relpath,
                        line=line,
                        key=f"block:{holder.render()}:{construct}@{info.qualname}",
                        message=(
                            f"blocking construct `{construct}` while "
                            f"holding hot-path lock {holder.render()} in "
                            f"`{info.qualname}`; move the blocking work "
                            "outside the critical section"
                        ),
                    )
                )

    findings.extend(_cycle_findings(edges, edge_sites))
    # de-dup by fingerprint+line (fixpoint can re-derive the same fact)
    seen: set[tuple[str, int]] = set()
    unique: list[Finding] = []
    for f in findings:
        ident = (f.fingerprint, f.line)
        if ident not in seen:
            seen.add(ident)
            unique.append(f)
    return unique


def _parse_hot_locks(cfg: AnalysisConfig) -> set[LockId]:
    hot: set[LockId] = set()
    for spec in cfg.hot_locks:
        if "::" in spec:
            relpath, _, name = spec.partition("::")
            hot.add(LockId(relpath, name))
        else:
            owner, _, attr = spec.rpartition(".")
            hot.add(LockId(owner, attr))
    return hot


def _cycle_findings(
    edges: set[tuple[LockId, LockId]],
    edge_sites: dict[tuple[LockId, LockId], tuple[str, int]],
) -> list[Finding]:
    """DFS cycle detection over the acquisition-order graph; one finding
    per cycle, keyed by the sorted lock set so the fingerprint is stable
    whichever edge the walk enters through."""
    graph: dict[LockId, set[LockId]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    findings: list[Finding] = []
    reported: set[tuple[str, ...]] = set()
    for start in sorted(graph, key=lambda lock: lock.render()):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(
                graph.get(node, ()), key=lambda lock: lock.render()
            ):
                if nxt == start and len(path) > 1:
                    cycle = tuple(sorted(x.render() for x in path))
                    if cycle in reported:
                        continue
                    reported.add(cycle)
                    relpath, line = edge_sites.get(
                        (node, start), ("<unknown>", 0)
                    )
                    chain = " -> ".join(x.render() for x in path + [start])
                    findings.append(
                        Finding(
                            checker="locks",
                            severity=SEVERITY_ERROR,
                            file=relpath,
                            line=line,
                            key=f"cycle:{'|'.join(cycle)}",
                            message=(
                                f"lock-acquisition-order cycle: {chain} — "
                                "two threads taking these locks in "
                                "opposite orders deadlock; pick one "
                                "global order"
                            ),
                        )
                    )
                elif nxt not in path and len(path) < 8:
                    stack.append((nxt, path + [nxt]))
    return findings
