"""Checker 11 — env reads at import time or under a compiler trace.

The frozen-knob bug class: a ``KMLS_*`` knob read at module import time
(or inside a function that ``torch.compile`` traces) freezes its value —
into the process for import-time reads, into the compiled graph for
traced reads (the read runs once, at trace time, and its value becomes
a constant guarded by nothing the env can change) — so flipping the env
var later silently does nothing. The project contract is that knobs are
read LAZILY through the ``config._getenv_*`` helpers at call time, from
untraced code.

Two sweeps, both pure-AST:

- **import time** — ``os.getenv`` / ``os.environ.get`` /
  ``os.environ[...]`` / any configured project helper called at module
  scope (class bodies and module-level ``if``/``try`` blocks included;
  function bodies excluded — they run later).
- **compiler-traced** — the same reads inside any function reachable
  from a compile root. Roots are detected structurally:
  ``@torch.compile`` / ``@torch.compile(...)`` and ``@partial(
  torch.compile, …)`` decorators, module-level ``name =
  torch.compile(impl)`` wrappings, in-function ``torch.compile(fn)``
  calls with a resolvable target, and the same shapes of
  ``torch.jit.trace`` (which also records one run's values). The port
  has no such root today — it runs no ``torch.compile`` and no CUDA
  graph, and the anchor test pins that — so this sweep finds nothing in
  the tree; it is what stops the first compiled function from reading a
  knob inside its trace (a fixture test proves it fires). The finding
  key keeps the reference's ``jit:`` prefix.

Findings whose literal names a registered knob carry its
``KNOB_REGISTRY`` scope, cross-checked via the knobs checker's parser,
so the message says exactly which declared knob just got frozen.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .callgraph import CallGraph, _dotted_name, resolve_func_ref
from .core import (
    SEVERITY_ERROR,
    AnalysisConfig,
    Finding,
    ModuleInfo,
    ProjectIndex,
)
from .registries import parse_knob_registry


def _canon_dotted(mod: ModuleInfo, dotted: str) -> str:
    """Canonicalize the leading alias segment through the module's
    external imports ("getenv" -> "os.getenv", "environ.get" ->
    "os.environ.get")."""
    root, _, rest = dotted.partition(".")
    ext = mod.external_imports.get(root)
    if ext:
        return f"{ext}.{rest}" if rest else ext
    return dotted


def _literal_arg(node: ast.Call) -> str | None:
    if node.args:
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return str(first.value)
    return None


def _env_read(
    index: ProjectIndex,
    mod: ModuleInfo,
    node: ast.AST,
    helpers: frozenset[str],
) -> tuple[str, str | None] | None:
    """→ (construct, env-var literal or None) when ``node`` reads the
    environment; None otherwise."""
    if isinstance(node, ast.Subscript):
        dotted = _dotted_name(node.value)
        if dotted and _canon_dotted(mod, dotted) == "os.environ":
            name: str | None = None
            sub = node.slice
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                name = sub.value
            return "os.environ[...]", name
        return None
    if not isinstance(node, ast.Call):
        return None
    dotted = _dotted_name(node.func)
    if dotted is not None:
        canon = _canon_dotted(mod, dotted)
        if canon in ("os.getenv", "os.environ.get"):
            return canon, _literal_arg(node)
    # project helper call: same-module def or "from config import helper"
    if isinstance(node.func, ast.Name):
        name = node.func.id
        ref = None
        if (mod.relpath, name) in index.functions:
            ref = f"{mod.relpath}::{name}"
        elif name in mod.name_imports:
            src_rel, src_name = mod.name_imports[name]
            ref = f"{src_rel}::{src_name}"
        if ref is not None and ref in helpers:
            return f"{name}()", _literal_arg(node)
    return None


def _module_scope_nodes(mod: ModuleInfo) -> Iterator[ast.AST]:
    """Every node that executes at import time: the module body,
    descending through class bodies and control flow but NEVER into
    function/lambda bodies."""
    stack: list[ast.AST] = list(mod.tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# the calls whose first argument's body runs under a compiler trace
_COMPILE_CALLS = frozenset({"torch.compile", "torch.jit.trace"})


def _is_jit_expr(mod: ModuleInfo, node: ast.AST) -> bool:
    """True for ``torch.compile`` / ``torch.jit.trace``, the same called
    with options only (``torch.compile(mode=...)``, a decorator factory),
    and ``partial(torch.compile, …)`` expressions."""
    dotted = _dotted_name(node)
    if dotted is not None and _canon_dotted(mod, dotted) in _COMPILE_CALLS:
        return True
    if isinstance(node, ast.Call):
        func = _dotted_name(node.func)
        if func is not None and _canon_dotted(mod, func) in (
            "functools.partial",
            "partial",
        ):
            return bool(node.args) and _is_jit_expr(mod, node.args[0])
        if (
            func is not None
            and _canon_dotted(mod, func) in _COMPILE_CALLS
            and not node.args
        ):
            return True
    return False


def jit_roots(index: ProjectIndex) -> dict[str, str]:
    """Function refs whose bodies are traced by ``torch.compile`` or
    ``torch.jit.trace`` (see module docstring for the recognized shapes)
    → why."""
    roots: dict[str, str] = {}
    for info in index.functions.values():
        mod = index.modules[info.relpath]
        node = info.node
        decorators = getattr(node, "decorator_list", [])
        for dec in decorators:
            if _is_jit_expr(mod, dec):
                roots.setdefault(info.ref, "compile-decorated")
        # in-function torch.compile(fn) / partial(torch.compile, …)(fn)
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.Call) and sub.args):
                continue
            if _is_jit_expr(mod, sub.func) and not isinstance(
                sub.func, ast.Call
            ):
                # direct torch.compile(fn)
                ref = resolve_func_ref(index, info, sub.args[0])
                if ref:
                    roots.setdefault(
                        ref, f"compile-wrapped in `{info.qualname}`"
                    )
            elif isinstance(sub.func, ast.Call) and _is_jit_expr(
                mod, sub.func
            ):
                # partial(torch.compile, …)(fn)
                ref = resolve_func_ref(index, info, sub.args[0])
                if ref:
                    roots.setdefault(
                        ref, f"compile-wrapped in `{info.qualname}`"
                    )
    # module-level wrappings: name = torch.compile(impl) & co
    for relpath, mod in index.modules.items():
        for node in _module_scope_nodes(mod):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            if not _is_jit_expr(mod, node.func):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Name):
                info2 = index.functions.get((relpath, arg.id))
                if info2 is None and arg.id in mod.name_imports:
                    info2 = index.functions.get(mod.name_imports[arg.id])
                if info2 is not None:
                    roots.setdefault(
                        info2.ref, "compile-wrapped at module level"
                    )
    return roots


def _knob_note(
    name: str | None, knob_scopes: dict[str, str], prefix: str
) -> str:
    if name is None:
        return ""
    if name in knob_scopes:
        return (
            f" `{name}` is a registered {knob_scopes[name]}-scope knob —"
            " flipping it after this read silently does nothing."
        )
    if name.startswith(prefix):
        return f" `{name}` is not in KNOB_REGISTRY."
    return ""


def run(index: ProjectIndex, cfg: AnalysisConfig) -> list[Finding]:
    helpers = frozenset(cfg.envread_helper_functions)
    knob_scopes, _lines, _reg_line = parse_knob_registry(index, cfg)
    findings: list[Finding] = []

    # sweep 1: import-time reads (the config module itself is exempt —
    # its helpers' bodies are functions anyway, and its registry is data)
    for relpath in sorted(index.modules):
        mod = index.modules[relpath]
        for node in _module_scope_nodes(mod):
            hit = _env_read(index, mod, node, helpers)
            if hit is None:
                continue
            construct, name = hit
            findings.append(
                Finding(
                    checker="envread",
                    severity=SEVERITY_ERROR,
                    file=relpath,
                    line=getattr(node, "lineno", 0),
                    key=f"import-time:{name or construct}",
                    message=(
                        f"environment read `{construct}` at module "
                        "import time: the value freezes when the module "
                        "first loads, defeating lazy knob reads (the "
                        "frozen-knob bug class) — move it into the function that "
                        f"needs it.{_knob_note(name, knob_scopes, cfg.knob_prefix)}"
                    ),
                )
            )

    # sweep 2: reads inside compiler-traced functions
    graph = CallGraph(index)
    roots = jit_roots(index)
    paths = graph.reachable(roots)
    for ref in sorted(paths):
        info = index.function(ref)
        if info is None:
            continue
        mod = index.modules[info.relpath]
        for node in ast.walk(info.node):
            hit = _env_read(index, mod, node, helpers)
            if hit is None:
                continue
            construct, name = hit
            path = paths[ref]
            via = " -> ".join(p.split("::", 1)[1] for p in path)
            reason = roots.get(path[0], "compile root")
            findings.append(
                Finding(
                    checker="envread",
                    severity=SEVERITY_ERROR,
                    file=info.relpath,
                    line=getattr(node, "lineno", 0),
                    key=f"jit:{name or construct}@{info.qualname}",
                    message=(
                        f"environment read `{construct}` inside "
                        f"compiler-traced `{info.qualname}` (traced via "
                        f"{via}; root is {reason}): the value bakes "
                        "into the compiled graph at first trace — "
                        "read it at call time and pass it as an "
                        f"argument.{_knob_note(name, knob_scopes, cfg.knob_prefix)}"
                    ),
                )
            )
    return findings
