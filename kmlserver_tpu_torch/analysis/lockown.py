"""Checker 10 — lock-ownership race inference.

The serving tier is full of classes whose methods run in DIFFERENT
execution contexts: the threaded batcher's collection loop vs the
asyncio loop, the iohealth monitor's PVC-thread writers vs the engine's
readers, the forecaster's per-request ``observe`` vs its actuator
reads. Each such class guards its mutable state with a lock — but
nothing today notices when one method quietly skips it. That is a data
race the GIL mostly hides until a torn read lands under load.

Mechanics — deliberately conservative, in the house style:

- Only classes that OWN at least one discovered lock
  (:func:`locking.discover_locks`) are examined: owning a lock is the
  author's own declaration that the class is shared across contexts.
  Deliberately lock-free classes (the loop-confined AsyncMicroBatcher,
  plain value objects) are structurally out of scope.
- A class's mutable fields are the ``self.<attr>`` names assigned in
  ``__init__`` (minus the locks themselves).
- Every ``self.<attr>`` read/write in every method is collected with
  the set of class-owned locks held at that point (``with``-stack walk,
  Condition aliases resolved, nested closures excluded — they run in
  whatever context invokes them).
- A field's OWNING lock is inferred by majority vote over its guarded
  accesses, but only when the evidence is convincing: at least
  ``cfg.lockown_min_guarded`` guarded accesses AND at least as many
  guarded as unguarded. Below that bar the field has no inferred owner
  and is never flagged — thin evidence must not manufacture races.
- Findings are UNGUARDED WRITES (outside ``__init__``) to a field with
  an inferred owner. Unguarded reads are not flagged: many are benign
  snapshot reads, and a write-path gate catches the mutations that
  actually tear.
- Methods named ``*_locked`` (``cfg.lockown_held_suffix``) are the
  repo's documented handoff convention — only ever called with the
  owning lock held — and are excluded from both the vote and the sweep.

Messages name the execution contexts the class's methods run in (from
:func:`callgraph.classify_contexts`) so the reader sees WHY the
unguarded write is cross-context reachable.
"""

from __future__ import annotations

import ast
import dataclasses

from .callgraph import classify_contexts
from .core import (
    SEVERITY_ERROR,
    AnalysisConfig,
    Finding,
    FunctionInfo,
    ProjectIndex,
)
from .locking import LockId, discover_locks


@dataclasses.dataclass(frozen=True)
class _Access:
    attr: str
    write: bool
    held: tuple[LockId, ...]  # class-owned locks held at the access
    method: str  # qualname of the accessing method
    line: int


class _FieldAccessWalker:
    """Per-method walk collecting ``self.<attr>`` accesses with the
    ``with``-lock stack, mirroring ``locking._LockWalker``'s
    resolution rules."""

    def __init__(
        self,
        index: ProjectIndex,
        info: FunctionInfo,
        locks: set[LockId],
        aliases: dict[LockId, LockId],
    ):
        self.index = index
        self.info = info
        self.locks = locks
        self.aliases = aliases
        self.accesses: list[_Access] = []
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

    def walk(self) -> list[_Access]:
        self._visit(list(ast.iter_child_nodes(self.info.node)), [])
        return self.accesses

    def _visit(self, nodes: list[ast.AST], held: list[LockId]) -> None:
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
                self._visit(list(node.body), held + acquired)
                continue
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                class_name = self.info.class_name or ""
                owned = tuple(
                    lock for lock in held if lock.owner == class_name
                )
                self.accesses.append(
                    _Access(
                        attr=node.attr,
                        write=isinstance(node.ctx, (ast.Store, ast.Del)),
                        held=owned,
                        method=self.info.qualname,
                        line=node.lineno,
                    )
                )
            self._visit(list(ast.iter_child_nodes(node)), held)


def _init_fields(index: ProjectIndex, class_name: str) -> set[str]:
    init = index.class_method(class_name, "__init__")
    if init is None:
        return set()
    fields: set[str] = set()
    for node in ast.walk(init.node):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for target in targets:
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                fields.add(target.attr)
    return fields


def run(index: ProjectIndex, cfg: AnalysisConfig) -> list[Finding]:
    locks, aliases = discover_locks(index)
    ctx = classify_contexts(index, cfg)
    lock_owners = {lock.owner for lock in locks} | {
        alias.owner for alias in aliases
    }
    findings: list[Finding] = []
    for class_name in sorted(lock_owners):
        relpath = index.classes.get(class_name)
        if relpath is None:
            continue  # module-level locks have a relpath "owner"
        lock_attrs = {
            lock.attr for lock in locks if lock.owner == class_name
        } | {
            cond.attr
            for cond, real in aliases.items()
            if cond.owner == class_name or real.owner == class_name
        }
        fields = _init_fields(index, class_name) - lock_attrs
        if not fields:
            continue
        methods = [
            info
            for (rel, _qual), info in sorted(index.functions.items())
            if rel == relpath
            and info.class_name == class_name
            and not info.qualname.endswith(".__init__")
            # `*_locked` methods run with the owning lock already held
            # (the repo's handoff convention) — out of scope both ways
            and not info.qualname.endswith(cfg.lockown_held_suffix)
        ]
        accesses: list[_Access] = []
        for info in methods:
            accesses.extend(
                _FieldAccessWalker(index, info, locks, aliases).walk()
            )
        class_contexts = sorted(
            {c for info in methods for c in ctx.contexts(info.ref)}
        ) or ["unclassified"]
        for field in sorted(fields):
            touches = [a for a in accesses if a.attr == field]
            guarded = [a for a in touches if a.held]
            unguarded = [a for a in touches if not a.held]
            if (
                len(guarded) < cfg.lockown_min_guarded
                or len(guarded) < len(unguarded)
            ):
                continue
            votes: dict[LockId, int] = {}
            for access in guarded:
                for lock in access.held:
                    votes[lock] = votes.get(lock, 0) + 1
            owner = max(
                sorted(votes, key=lambda lock: lock.render()),
                key=lambda lock: votes[lock],
            )
            for access in unguarded:
                if not access.write:
                    continue
                findings.append(
                    Finding(
                        checker="lockown",
                        severity=SEVERITY_ERROR,
                        file=relpath,
                        line=access.line,
                        key=f"unguarded:{field}@{access.method}",
                        message=(
                            f"unguarded write to `{class_name}.{field}` "
                            f"in `{access.method}`: {len(guarded)} other "
                            f"access(es) guard this field with "
                            f"{owner.render()}, and the class's methods "
                            f"run in {'/'.join(class_contexts)} "
                            "context(s) — take the owning lock, or "
                            "document the ownership handoff with a "
                            "pragma"
                        ),
                    )
                )
    return findings
