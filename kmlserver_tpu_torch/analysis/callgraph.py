"""Best-effort project call graph.

Resolution is deliberately CONSERVATIVE — an edge exists only when the
callee is identifiable without type inference:

- ``name(...)``            → function in the same module, or a
                             ``from X import name`` project import, or a
                             project class (edge to ``Class.__init__``);
- ``self.m(...)``          → method ``m`` of the enclosing class;
- ``self.attr.m(...)``     → method ``m`` of ``attr``'s class, when
                             ``__init__`` annotated/constructed it
                             (:attr:`ProjectIndex.attr_types`);
- ``mod.f(...)``           → function ``f`` in the project module bound
                             to local name ``mod``;
- ``Class.m(...)``         → that class's method.

Anything else (calls through locals, parameters, callbacks, returned
closures) produces NO edge: a missed edge can hide a violation, but a
fabricated edge would fabricate a violation, and a CI gate must not cry
wolf. The nested-closure rule in :func:`core.iter_nodes_shallow` is part
of the same stance — a closure's body joins the graph only where the
closure itself is visibly invoked.

For forbidden-construct matching, every call site also gets a DOTTED
NAME (``"time.sleep"``, ``"torch.cuda.synchronize"``, ``"open"``)
resolved through the module's import aliases, the bare method name for
receiver-independent rules (``.item()``, ``.result()``), and the names of
its keyword arguments for rules that hold only with a keyword
(``torch.tensor(x, device=d)``, a pageable host-to-device copy).

Execution-context classification lives here too: every
function is classified as event-loop (reachable from asyncio Protocol
callbacks, ``async def``s, ``loop.call_soon/call_later/call_at``
targets, ``add_done_callback`` callbacks registered in loop context, or
configured entries), worker-thread (reachable from ``Thread(target=…)``
/ ``executor.submit(fn)`` / ``run_in_executor`` / ``to_thread``
targets), or neither. The same conservative stance applies: a function
REFERENCE handed to a scheduler resolves only when it is visibly a
project function — which also means executor hops naturally END the
loop walk, because the handed-off callable produces no call edge.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable

from .core import (
    AnalysisConfig,
    FunctionInfo,
    ProjectIndex,
    iter_nodes_shallow,
)


@dataclasses.dataclass(frozen=True)
class CallSite:
    """One call expression inside a function body (nested scopes
    excluded)."""

    line: int
    dotted: str | None  # "time.sleep", "open", … None when unresolvable
    method: str | None  # bare attr name for ".item()"-style rules
    target: str | None  # project function ref "relpath::qualname"
    awaited: bool = False  # directly under an ``await`` — yields, not blocks
    keywords: tuple[str, ...] = ()  # keyword-argument names (``**`` dropped)


def _dotted_name(node: ast.AST) -> str | None:
    """Flatten Name/Attribute chains → "a.b.c" (None on anything else)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_call(
    index: ProjectIndex,
    caller: FunctionInfo,
    call: ast.Call,
    awaited: bool = False,
) -> CallSite:
    func = call.func
    line = call.lineno
    mod = index.modules[caller.relpath]
    dotted = _dotted_name(func)
    method = func.attr if isinstance(func, ast.Attribute) else None
    target: FunctionInfo | None = None

    if isinstance(func, ast.Name):
        name = func.id
        target = index.functions.get((caller.relpath, name))
        if target is None and name in mod.name_imports:
            src_rel, src_name = mod.name_imports[name]
            target = index.functions.get((src_rel, src_name))
            if target is None:
                # imported project CLASS: constructor edge
                if index.classes.get(src_name) is not None:
                    target = index.class_method(src_name, "__init__")
        if target is None and index.classes.get(name) == caller.relpath:
            target = index.class_method(name, "__init__")

    elif isinstance(func, ast.Attribute):
        value = func.value
        # self.m(...)
        if isinstance(value, ast.Name) and value.id == "self":
            if caller.class_name:
                target = index.class_method(caller.class_name, func.attr)
        # self.attr.m(...)
        elif (
            isinstance(value, ast.Attribute)
            and isinstance(value.value, ast.Name)
            and value.value.id == "self"
            and caller.class_name
        ):
            attr_cls = index.attr_types.get(
                (caller.class_name, value.attr)
            )
            if attr_cls:
                target = index.class_method(attr_cls, func.attr)
        # mod.OBJ.m(...) — module singleton through a module alias
        elif (
            isinstance(value, ast.Attribute)
            and isinstance(value.value, ast.Name)
            and value.value.id in mod.module_imports
        ):
            obj_cls = index.module_attr_types.get(
                (mod.module_imports[value.value.id], value.attr)
            )
            if obj_cls:
                target = index.class_method(obj_cls, func.attr)
        # mod.f(...) / Class.m(...) / OBJ.m(...)
        elif isinstance(value, ast.Name):
            name = value.id
            if name in mod.module_imports:
                target = index.functions.get(
                    (mod.module_imports[name], func.attr)
                )
            elif index.classes.get(name) is not None:
                target = index.class_method(name, func.attr)
            elif name in mod.external_imports:
                # canonicalize through the alias so "import numpy as np"
                # and "import numpy" both match "numpy.*" rules; the
                # local alias spelling is kept too via `dotted`
                root = mod.external_imports[name].split(".")[0]
                dotted = f"{root}.{func.attr}"
            else:
                # module singleton: same-module NAME, or
                # "from X import NAME" where X assigned NAME = Class()
                obj_cls = index.module_attr_types.get(
                    (caller.relpath, name)
                )
                if obj_cls is None and name in mod.name_imports:
                    obj_cls = index.module_attr_types.get(
                        mod.name_imports[name]
                    )
                if obj_cls:
                    target = index.class_method(obj_cls, func.attr)

    return CallSite(
        line=line,
        dotted=dotted,
        method=method,
        target=target.ref if target is not None else None,
        awaited=awaited,
        keywords=tuple(kw.arg for kw in call.keywords if kw.arg is not None),
    )


def function_calls(
    index: ProjectIndex, info: FunctionInfo
) -> list[CallSite]:
    """Every call site in ``info``'s own scope (closures excluded)."""
    nodes = list(iter_nodes_shallow(info.node))
    # every call under an ``await`` expression counts as awaited — the
    # direct coroutine call, and coroutine factories handed to awaited
    # combinators (``await asyncio.wait_for(event.wait(), …)``: that
    # ``.wait()`` builds a coroutine, it does not block)
    awaited_ids: set[int] = set()
    for node in nodes:
        if isinstance(node, ast.Await):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    awaited_ids.add(id(sub))
    out: list[CallSite] = []
    for node in nodes:
        if isinstance(node, ast.Call):
            out.append(
                resolve_call(
                    index, info, node, awaited=id(node) in awaited_ids
                )
            )
    return out


class CallGraph:
    """Edges + memoized per-function call sites over a ProjectIndex."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self._sites: dict[str, list[CallSite]] = {}

    def sites(self, ref: str) -> list[CallSite]:
        if ref not in self._sites:
            info = self.index.function(ref)
            self._sites[ref] = (
                function_calls(self.index, info) if info else []
            )
        return self._sites[ref]

    def reachable(
        self,
        entries: Iterable[str],
        cuts: Iterable[str] = (),
    ) -> dict[str, list[str]]:
        """BFS from ``entries`` → ``{ref: call path from an entry}``.
        The path (entry → … → ref) makes findings explainable. ``cuts``
        are refs the walk never enters — statically reachable functions
        that a dispatch layer guarantees never RUN in this context."""
        cut_set = set(cuts)
        paths: dict[str, list[str]] = {}
        queue: list[str] = []
        for entry in entries:
            if (
                self.index.function(entry)
                and entry not in paths
                and entry not in cut_set
            ):
                paths[entry] = [entry]
                queue.append(entry)
        while queue:
            ref = queue.pop(0)
            for site in self.sites(ref):
                tgt = site.target
                if tgt is not None and tgt not in paths and tgt not in cut_set:
                    paths[tgt] = paths[ref] + [tgt]
                    queue.append(tgt)
        return paths


def match_forbidden(
    site: CallSite,
    forbidden_calls: Iterable[str],
    forbidden_methods: Iterable[str],
    forbidden_kw_calls: Iterable[tuple[str, str]] = (),
) -> str | None:
    """→ the matched construct name, or None. ``forbidden_kw_calls`` are
    (dotted name, keyword) pairs that match only when the call passes
    that keyword (``torch.tensor(x, device=d)`` → ``"torch.tensor(device=)"``)."""
    if site.dotted is not None and site.dotted in forbidden_calls:
        return site.dotted
    if site.method is not None and site.method in forbidden_methods:
        return f".{site.method}()"
    if site.dotted is not None:
        for dotted, keyword in forbidden_kw_calls:
            if site.dotted == dotted and keyword in site.keywords:
                return f"{dotted}({keyword}=)"
    return None


# ---------------------------------------------------------------------------
# execution-context classification
# ---------------------------------------------------------------------------

# asyncio transport base classes whose callbacks the loop invokes
_PROTOCOL_BASES = frozenset(
    {
        "asyncio.Protocol",
        "asyncio.BufferedProtocol",
        "asyncio.DatagramProtocol",
        "asyncio.SubprocessProtocol",
    }
)

# loop scheduling methods -> positional index of the callback argument
_SCHEDULE_CALLBACK_ARG = {
    "call_soon": 0,
    "call_soon_threadsafe": 0,
    "call_later": 1,
    "call_at": 1,
}

# thread-launch calls -> positional index of the callable argument
# (`Thread(target=…)` passes it by keyword and is handled separately)
_THREAD_CALLABLE_ARG = {
    "submit": 0,  # Executor.submit — only counts when arg 0 RESOLVES
    "run_in_executor": 1,
    "to_thread": 0,
}


@dataclasses.dataclass
class ExecContext:
    """Which functions run where. ``loop``/``thread`` map each
    reachable ref to its call path from a context root; ``loop_roots``
    maps each loop root to WHY it is one (for findings)."""

    loop: dict[str, list[str]]
    thread: dict[str, list[str]]
    loop_roots: dict[str, str]

    def contexts(self, ref: str) -> set[str]:
        out: set[str] = set()
        if ref in self.loop:
            out.add("event-loop")
        if ref in self.thread:
            out.add("worker-thread")
        return out


def resolve_func_ref(
    index: ProjectIndex, caller: FunctionInfo, node: ast.AST
) -> str | None:
    """Resolve a bare function REFERENCE (a callback handed to a
    scheduler) to a project ref, under the same conservative rules as
    :func:`resolve_call`. Locals, parameters, and closures → None."""
    mod = index.modules[caller.relpath]
    if isinstance(node, ast.Name):
        info = index.functions.get((caller.relpath, node.id))
        if info is None and node.id in mod.name_imports:
            info = index.functions.get(mod.name_imports[node.id])
        return info.ref if info else None
    if isinstance(node, ast.Attribute):
        value = node.value
        if isinstance(value, ast.Name):
            if value.id == "self" and caller.class_name:
                info = index.class_method(caller.class_name, node.attr)
                return info.ref if info else None
            if value.id in mod.module_imports:
                info = index.functions.get(
                    (mod.module_imports[value.id], node.attr)
                )
                return info.ref if info else None
            if index.classes.get(value.id) is not None:
                info = index.class_method(value.id, node.attr)
                return info.ref if info else None
        elif (
            isinstance(value, ast.Attribute)
            and isinstance(value.value, ast.Name)
            and value.value.id == "self"
            and caller.class_name
        ):
            attr_cls = index.attr_types.get(
                (caller.class_name, value.attr)
            )
            if attr_cls:
                info = index.class_method(attr_cls, node.attr)
                return info.ref if info else None
    return None


def _callback_targets(
    index: ProjectIndex, caller: FunctionInfo, node: ast.AST
) -> list[str]:
    """Refs a callback argument may invoke: the ref itself, or — for a
    lambda — every resolvable call in its body (the lambda runs in the
    scheduler's context, so its calls do too)."""
    ref = resolve_func_ref(index, caller, node)
    if ref is not None:
        return [ref]
    if isinstance(node, ast.Lambda):
        out: list[str] = []
        for sub in ast.walk(node.body):
            if isinstance(sub, ast.Call):
                site = resolve_call(index, caller, sub)
                if site.target is not None:
                    out.append(site.target)
        return out
    return []


def _is_protocol_class(index: ProjectIndex, class_name: str) -> bool:
    relpath = index.classes.get(class_name)
    if relpath is None:
        return False
    mod = index.modules[relpath]
    for base in index.class_bases.get(class_name, ()):
        if base in _PROTOCOL_BASES:
            return True
        # "from asyncio import Protocol" / aliased imports
        if "." not in base and mod.external_imports.get(base) in _PROTOCOL_BASES:
            return True
    return False


def _scheduled_loop_roots(index: ProjectIndex) -> dict[str, str]:
    """Global pre-pass: targets of ``loop.call_soon``/``call_later``/
    ``call_at``/``call_soon_threadsafe`` anywhere in the tree (full
    walk, closures and lambdas included — ``call_soon_threadsafe``
    schedules ONTO the loop from any context, so the scheduling site's
    own context is irrelevant)."""
    roots: dict[str, str] = {}
    for info in index.functions.values():
        for node in ast.walk(info.node):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
            ):
                continue
            argidx = _SCHEDULE_CALLBACK_ARG.get(node.func.attr)
            if argidx is None or len(node.args) <= argidx:
                continue
            for ref in _callback_targets(index, info, node.args[argidx]):
                roots.setdefault(
                    ref,
                    f"scheduled onto the loop by "
                    f"`{info.qualname}` via {node.func.attr}",
                )
    return roots


def _thread_roots(index: ProjectIndex) -> dict[str, str]:
    """Targets handed to threads/executors anywhere in the tree:
    ``Thread(target=f)``, ``pool.submit(f)``, ``loop.run_in_executor
    (None, f)``, ``asyncio.to_thread(f)``. Only resolvable project
    function refs count — `batcher.submit(request)` hands off DATA, not
    a callable, and produces no root."""
    roots: dict[str, str] = {}
    for info in index.functions.values():
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted_name(node.func)
            if dotted is not None and dotted.split(".")[-1] == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        ref = resolve_func_ref(index, info, kw.value)
                        if ref:
                            roots.setdefault(
                                ref,
                                f"thread target launched by "
                                f"`{info.qualname}`",
                            )
                continue
            if isinstance(node.func, ast.Attribute):
                argidx = _THREAD_CALLABLE_ARG.get(node.func.attr)
                if argidx is None or len(node.args) <= argidx:
                    continue
                ref = resolve_func_ref(index, info, node.args[argidx])
                if ref:
                    roots.setdefault(
                        ref,
                        f"handed to an executor by `{info.qualname}` "
                        f"via {node.func.attr}",
                    )
    return roots


def classify_contexts(
    index: ProjectIndex, cfg: AnalysisConfig, graph: CallGraph | None = None
) -> ExecContext:
    """Classify every function by execution context (see module
    docstring). Loop reachability honors ``cfg.loop_cut_functions`` and
    iterates to a fixpoint over ``add_done_callback`` registrations:
    a done-callback registered by loop-context code runs on the loop
    (asyncio futures) or is a ``call_soon_threadsafe`` trampoline whose
    real target the scheduling pre-pass already captured."""
    graph = graph or CallGraph(index)
    loop_roots: dict[str, str] = {}
    for info in index.functions.values():
        if isinstance(info.node, ast.AsyncFunctionDef):
            loop_roots.setdefault(info.ref, "async def")
        elif info.class_name and _is_protocol_class(index, info.class_name):
            loop_roots.setdefault(
                info.ref, f"asyncio protocol callback on {info.class_name}"
            )
    loop_roots.update(_scheduled_loop_roots(index))
    for entry in cfg.loop_entries:
        if index.function(entry) is not None:
            loop_roots.setdefault(entry, "configured loop entry")

    cuts = set(cfg.loop_cut_functions)
    loop_paths = graph.reachable(loop_roots, cuts=cuts)
    while True:
        added = False
        for ref in list(loop_paths):
            info = index.function(ref)
            if info is None:
                continue
            for node in ast.walk(info.node):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_done_callback"
                    and node.args
                ):
                    continue
                for tgt in _callback_targets(index, info, node.args[0]):
                    if tgt not in loop_paths and tgt not in cuts:
                        loop_roots.setdefault(
                            tgt,
                            f"done-callback registered in loop context "
                            f"by `{info.qualname}`",
                        )
                        added = True
        if not added:
            break
        loop_paths = graph.reachable(loop_roots, cuts=cuts)

    thread_paths = graph.reachable(_thread_roots(index))
    return ExecContext(
        loop=loop_paths, thread=thread_paths, loop_roots=loop_roots
    )
