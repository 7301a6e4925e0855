"""Analyzer core: project index, findings, baseline, and the runner.

Everything here is stdlib-``ast`` based and import-free with respect to
the code under analysis — the analyzer PARSES the tree, it never imports
it, so it runs identically against the real package and against the tiny
fixture trees the test suite seeds with deliberate violations (and in a
job with no torch installed).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Any, Callable, Iterable

SEVERITY_ERROR = "error"
SEVERITY_WARN = "warn"

# inline suppression pragma, honored on the flagged line or the line
# directly above it: `# kmls-verify: allow[<checker>]`
PRAGMA_PREFIX = "kmls-verify: allow["


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation.

    ``key`` is the checker-specific STABLE identity (knob name, lock
    pair, construct@function, …) — deliberately line-free, so a baseline
    entry survives unrelated edits that shift line numbers."""

    checker: str
    severity: str
    file: str  # repo-relative path
    line: int
    key: str
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.checker}::{self.file}::{self.key}"

    def render(self) -> str:
        return (
            f"{self.severity}: {self.file}:{self.line} [{self.checker}] "
            f"{self.message}"
        )


@dataclasses.dataclass
class AnalysisConfig:
    """Project policy: what the checkers treat as entry points, hot
    locks, approved writers, registries. Defaults describe the port
    (``kmlserver_tpu_torch/``); tests override them to point at fixture
    trees."""

    # --- file discovery (repo-relative) ---
    package_dir: str = "kmlserver_tpu_torch"
    extra_code: tuple[str, ...] = ("chip_smoke.py",)
    tests_dir: str = "tests"
    # the test files whose literals count as exercising a fault knob: the
    # port's own tests only — a reference chaos test naming the same knob
    # drives the reference's site, not the port's
    tests_globs: tuple[str, ...] = ("test_torch_*.py", "torch_*util.py")
    # the whole README: the knob and series names are the reference's,
    # and its rows document them; a port-only name has its row in the
    # port's section
    readme: str = "README.md"
    manifest_files: tuple[str, ...] = (
        "kmlserver_tpu_torch/deploy/kubernetes/deployment.yaml",
        "kmlserver_tpu_torch/deploy/kubernetes/statefulset.yaml",
        "kmlserver_tpu_torch/deploy/kubernetes/serve-gang.yaml",
        "kmlserver_tpu_torch/deploy/kubernetes/job.yaml",
        "kmlserver_tpu_torch/deploy/kubernetes/job-multihost.yaml",
    )

    # --- hotpath checker ---
    # serving dispatch entry points, as "<relpath>::<qualname>". The
    # completion side (the finish() closures, which wait on the card BY
    # DESIGN) is excluded structurally: nested defs are never traversed
    # unless called directly.
    hotpath_entries: tuple[str, ...] = (
        "kmlserver_tpu_torch/serving/batcher.py::MicroBatcher.submit",
        "kmlserver_tpu_torch/serving/batcher.py::MicroBatcher._collect_loop",
        "kmlserver_tpu_torch/serving/batcher.py::AsyncMicroBatcher.submit",
        "kmlserver_tpu_torch/serving/batcher.py::AsyncMicroBatcher._flush",
        "kmlserver_tpu_torch/serving/engine.py::RecommendEngine.recommend_many_async",
        # the span recorder's request-path halves: begin() runs at
        # admission for every traced request, finish() on the completion
        # side holding the retention lock — neither may ever grow file
        # I/O, sleeps, or host syncs
        "kmlserver_tpu_torch/observability/trace.py::SpanRecorder.begin",
        "kmlserver_tpu_torch/observability/trace.py::SpanRecorder.finish",
        # the cost model's observation path: runs on the batch completion
        # side for every dispatched kernel — a few float adds under its
        # private lock, and it must stay that way
        "kmlserver_tpu_torch/observability/costmodel.py::CostModel.observe_kernel",
        # what the dispatch reaches through a callable PARAMETER, which no
        # call graph follows: _enqueue runs the lookup closure _launch
        # builds, so the device lookups are anchored EXPLICITLY (a rename
        # fails the anchor-existence test instead of silently taking them
        # out of the check)
        "kmlserver_tpu_torch/serving/engine.py::RecommendEngine._enqueue",
        "kmlserver_tpu_torch/ops/serve.py::recommend_batch",
        "kmlserver_tpu_torch/ops/serve.py::sharded_recommend",
        "kmlserver_tpu_torch/ops/serve.py::shard_partial_topk",
        "kmlserver_tpu_torch/ops/serve.py::merge_partial_topk",
        "kmlserver_tpu_torch/ops/embed.py::embed_topk",
    )
    # host-blocking constructs forbidden on the dispatch path, by resolved
    # dotted name. `np.asarray` / `.numpy()` are deliberately ABSENT: on a
    # CUDA tensor they raise rather than sync, and the dispatch calls them
    # only on host (pinned staging) tensors.
    hotpath_forbidden_calls: tuple[str, ...] = (
        "time.sleep",
        "open",
        "torch.cuda.synchronize",
        "pickle.load",
        "pickle.dump",
        "json.load",
        "json.dump",
        "subprocess.run",
        "subprocess.Popen",
        "subprocess.check_output",
        "os.replace",
        "os.rename",
    )
    # … by bare method name on ANY receiver (`x.item()` syncs the host on
    # a CUDA tensor whatever x is; `fut.result()` is a block) …
    hotpath_forbidden_methods: tuple[str, ...] = (
        "item",
        "tolist",
        "cpu",
        "synchronize",
        "result",
    )
    # … and by dotted name WITH a keyword: `torch.tensor(x, device=d)`
    # copies from pageable host memory, which PyTorch completes with a
    # stream synchronize (a Python scalar or a `torch.full` fill does not)
    hotpath_forbidden_kw_calls: tuple[tuple[str, str], ...] = (
        ("torch.tensor", "device"),
        ("torch.as_tensor", "device"),
    )

    # --- locks checker ---
    # hot-path locks as "<ClassName>.<attr>" or "<module relpath>::<name>"
    # for module-level locks. engine._reload_lock is deliberately ABSENT:
    # the reload path is cold by design and does file I/O under it.
    hot_locks: tuple[str, ...] = (
        "MicroBatcher._n_lock",
        "MicroBatcher._rate_lock",
        "RecommendEngine._dispatch_lock",
        "RecommendCache._lock",
        "ServingMetrics._lock",
        "LatencyReservoir._lock",
        "LatencyHistogram._lock",
        "SpanRecorder._lock",
        "RankWatchdog._guard_lock",
        "_Server.active_lock",
        "kmlserver_tpu_torch/faults.py::_lock",
    )
    locks_blocking_calls: tuple[str, ...] = (
        "time.sleep",
        "open",
        "os.replace",
        "os.rename",
        "os.fdopen",
        "pickle.load",
        "pickle.dump",
        "json.load",
        "json.dump",
        "subprocess.run",
        "subprocess.Popen",
        "subprocess.check_output",
        "socket.create_connection",
        "torch.cuda.synchronize",
    )
    locks_blocking_methods: tuple[str, ...] = ("result", "synchronize")

    # --- atomic-write checker ---
    # modules allowed to write bytes directly: the atomic writer itself
    # and the corruption harness, whose JOB is producing torn bytes.
    # (a trailing "/" makes an entry a directory prefix — the analysis
    # package is tooling writing its OWN state, not PVC artifacts)
    atomic_allowed_modules: tuple[str, ...] = (
        "kmlserver_tpu_torch/io/artifacts.py",
        "kmlserver_tpu_torch/faults.py",
        "kmlserver_tpu_torch/analysis/",
    )
    # functions allowed to write directly: the dataset-history append is
    # the reference's append-only log (readers skip torn tails line-wise;
    # byte-compat contract).
    atomic_allowed_functions: tuple[str, ...] = (
        "kmlserver_tpu_torch/io/registry.py::append_history_and_invalidate",
    )
    # the ONE function allowed to call os.replace/os.rename for an
    # artifact: publication-critical renames must carry the fsync-file +
    # fsync-parent-dir discipline, which only durable_replace implements —
    # a bare os.replace elsewhere is a publication that a power cut can
    # silently vanish.
    durable_rename_function: str = (
        "kmlserver_tpu_torch/io/artifacts.py::durable_replace"
    )
    # modules whose renames are NOT publication-critical; trailing "/" =
    # directory prefix, like atomic_allowed_modules. ops/cuda_build.py and
    # utils/nativelib.py rename a freshly built kernel / native library
    # (private tmp + os.replace) into the build cache under build/: a
    # lost rename there only means one more build at next use, never a
    # torn artifact on the PVC.
    rename_allowed_modules: tuple[str, ...] = (
        "kmlserver_tpu_torch/analysis/",
        "kmlserver_tpu_torch/ops/cuda_build.py",
        "kmlserver_tpu_torch/utils/nativelib.py",
    )

    # --- knob registry checker ---
    config_file: str = "kmlserver_tpu_torch/config.py"
    knob_registry_name: str = "KNOB_REGISTRY"
    # the reference knobs the port deliberately does not read (knob ->
    # reason): its keys are no code reference, and a read of one is a
    # finding
    knob_absent_name: str = "KNOBS_ABSENT"
    knob_prefix: str = "KMLS_"
    # scope -> manifest files at least one of which must mention the knob
    knob_scope_manifests: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: {
            # a serving knob may be bound in any serving manifest — the
            # stateless Deployment, the fleet-identity StatefulSet or the
            # serve gang; "both"-scope routing below keys on the basename
            # containing "deployment", so the StatefulSets join the
            # serving group here without widening that rule
            "serving": (
                "kmlserver_tpu_torch/deploy/kubernetes/deployment.yaml",
                "kmlserver_tpu_torch/deploy/kubernetes/statefulset.yaml",
                "kmlserver_tpu_torch/deploy/kubernetes/serve-gang.yaml",
            ),
            "mining": (
                "kmlserver_tpu_torch/deploy/kubernetes/job.yaml",
                "kmlserver_tpu_torch/deploy/kubernetes/job-multihost.yaml",
            ),
            "both": (
                "kmlserver_tpu_torch/deploy/kubernetes/deployment.yaml",
                "kmlserver_tpu_torch/deploy/kubernetes/job.yaml",
                "kmlserver_tpu_torch/deploy/kubernetes/job-multihost.yaml",
            ),
            # tool (benchmark/dev/test harness) and fault knobs never
            # ship in manifests
            "tool": (),
            "fault": (),
        }
    )

    # --- metric registry checker ---
    metrics_file: str = "kmlserver_tpu_torch/serving/metrics.py"
    metric_registry_name: str = "METRIC_REGISTRY"
    # exposition module -> the scope its series must be registered under
    metric_exposition_files: dict[str, str] = dataclasses.field(
        default_factory=lambda: {
            "kmlserver_tpu_torch/serving/metrics.py": "serving",
            "kmlserver_tpu_torch/observability/jobmetrics.py": "mining",
            # the cost-attribution block and the SLO burn-rate gauges
            # render their own lines into /metrics — their series
            # literals live in these modules, not metrics.py
            "kmlserver_tpu_torch/observability/costmodel.py": "serving",
            "kmlserver_tpu_torch/observability/slo.py": "serving",
        }
    )
    # (function ref, rendered prefix, scope): dict keys / subscript stores
    # in the function render as <prefix><key> series — the app's
    # robustness-state dict reaches /metrics through the kmls_ prefix
    metric_dynamic_sources: tuple[tuple[str, str, str], ...] = (
        (
            "kmlserver_tpu_torch/serving/app.py::RecommendApp._robustness_state",
            "kmls_",
            "serving",
        ),
    )

    # --- cost-spec checker ---
    costmodel_file: str = "kmlserver_tpu_torch/observability/costmodel.py"
    costspec_registry_name: str = "KERNEL_COST_SPECS"
    # the dispatched kernels that must stay registered — the anchor that
    # keeps a rename from silently hollowing the checker (tests assert
    # these names exist in the real tree). The reference's seven; the
    # port observes no kernel name the reference does not.
    costspec_required: tuple[str, ...] = (
        "serve_rules",
        "serve_sharded",
        "serve_native",
        "embed_topk",
        "als_sweep",
        "support_count",
        "delta_recount",
    )

    # --- fault-site checker ---
    faults_file: str = "kmlserver_tpu_torch/faults.py"

    # --- exit-code checker ---
    job_file: str = "kmlserver_tpu_torch/mining/job.py"
    job_manifests: tuple[str, ...] = (
        "kmlserver_tpu_torch/deploy/kubernetes/job.yaml",
        "kmlserver_tpu_torch/deploy/kubernetes/job-multihost.yaml",
    )

    # --- loopblock checker ---
    # Event-loop roots the classifier cannot auto-detect: the asyncio
    # transport calls these through locals/attrs the conservative graph
    # refuses to resolve (`app = state.app; app.handle(...)` inline in
    # `_Conn._dispatch` for non-recommend routes; the loop-native
    # batcher's admission/flush pair). Auto-detected roots — asyncio
    # Protocol callbacks, `async def`s, call_soon/call_later targets —
    # need no entry here.
    loop_entries: tuple[str, ...] = (
        "kmlserver_tpu_torch/serving/app.py::RecommendApp.handle",
        "kmlserver_tpu_torch/serving/app.py::RecommendApp.finish_recommend",
        "kmlserver_tpu_torch/serving/batcher.py::AsyncMicroBatcher.submit",
        "kmlserver_tpu_torch/serving/batcher.py::AsyncMicroBatcher._flush",
    )
    # Statically reachable from a loop entry but never RUN on the loop:
    # the asyncio transport intercepts recommend POSTs in `_dispatch`
    # (before the inline `app.handle` call) and routes them through the
    # engine pool / loop-native batcher, so `_post_recommend`'s and
    # `recommend_direct`'s blocking branches only execute on the
    # threaded front end. Cutting here keeps the loop map honest; the
    # anchor test pins both refs so a rename can't hollow the cut.
    loop_cut_functions: tuple[str, ...] = (
        "kmlserver_tpu_torch/serving/app.py::RecommendApp._post_recommend",
        "kmlserver_tpu_torch/serving/app.py::RecommendApp.recommend_direct",
    )
    # Blocking constructs forbidden in event-loop context, by resolved
    # dotted name. Staging copies (`.to(dev, non_blocking=True)`) are
    # deliberately ABSENT: the dispatch enqueues them on the loop by
    # design (bounded work), unlike the unbounded stalls below.
    loopblock_forbidden_calls: tuple[str, ...] = (
        "time.sleep",
        "open",
        "os.replace",
        "os.rename",
        "os.fsync",
        "os.fdopen",
        "os.statvfs",
        "subprocess.run",
        "subprocess.Popen",
        "subprocess.check_output",
        "socket.create_connection",
        "pickle.load",
        "pickle.dump",
        "json.load",
        "json.dump",
        "torch.cuda.synchronize",
    )
    # … and by bare method name on any receiver. `wait`/`acquire`/
    # `result` only match UN-awaited call sites — `await x.wait()`
    # yields to the loop, `x.wait()` freezes it.
    loopblock_forbidden_methods: tuple[str, ...] = (
        "result",
        "wait",
        "acquire",
        "item",
        "synchronize",
    )

    # --- lockown checker ---
    # minimum guarded accesses before a field's owning lock is inferred;
    # below this the evidence is too thin to call an unguarded write a
    # race (deliberately lock-free classes stay silent).
    lockown_min_guarded: int = 2
    # the repo's documented ownership-handoff convention: a method named
    # `*_locked` is only ever called with the owning lock already held
    # (forecast._roll_locked, mesh._close_locked). Such methods are
    # excluded from both the ownership vote and the unguarded-write
    # sweep — the suffix IS the documentation.
    lockown_held_suffix: str = "_locked"

    # --- envread checker ---
    # project wrappers around os.getenv — a call to one of these at
    # module import time freezes the knob exactly like a bare getenv
    envread_helper_functions: tuple[str, ...] = (
        "kmlserver_tpu_torch/config.py::_getenv_int",
        "kmlserver_tpu_torch/config.py::_getenv_float",
        "kmlserver_tpu_torch/config.py::_getenv_bool",
        "kmlserver_tpu_torch/config.py::_getenv_hybrid_mode",
        "kmlserver_tpu_torch/config.py::_getenv_blend_weight",
        "kmlserver_tpu_torch/config.py::_getenv_model_layout",
        "kmlserver_tpu_torch/config.py::_getenv_gang_rank",
        "kmlserver_tpu_torch/config.py::_getenv_bitpack_threshold",
    )


# ---------------------------------------------------------------------------
# project index
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModuleInfo:
    relpath: str
    tree: ast.Module
    source_lines: list[str]
    # local name -> project module relpath ("from . import native_serve",
    # "from ..io import artifacts", "import kmlserver_tpu_torch.faults as faults")
    module_imports: dict[str, str] = dataclasses.field(default_factory=dict)
    # local name -> (relpath, original name) for "from X import name"
    name_imports: dict[str, tuple[str, str]] = dataclasses.field(
        default_factory=dict
    )
    # local name -> dotted external root ("np" -> "numpy" … kept verbatim)
    external_imports: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FunctionInfo:
    relpath: str
    qualname: str  # "func" or "Class.method"
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    class_name: str | None

    @property
    def ref(self) -> str:
        return f"{self.relpath}::{self.qualname}"


def iter_nodes_shallow(root: ast.AST) -> Iterable[ast.AST]:
    """Walk ``root``'s body WITHOUT descending into nested function /
    lambda scopes — a closure that is merely defined (e.g. the batcher's
    ``finish()``) is not part of the enclosing function's behavior until
    something actually calls it."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class ProjectIndex:
    """Parsed view of a source tree: modules, top-level functions and
    methods, imports, and ``self.<attr>`` type hints scraped from
    ``__init__`` annotations/constructions."""

    def __init__(self, root: str, py_files: Iterable[str]):
        self.root = root
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[tuple[str, str], FunctionInfo] = {}
        # class name -> defining relpath (single definition expected)
        self.classes: dict[str, str] = {}
        # method name -> [FunctionInfo] (for diagnostics only)
        self.methods_by_name: dict[str, list[FunctionInfo]] = {}
        # (class, attr) -> class name of the attribute's value
        self.attr_types: dict[tuple[str, str], str] = {}
        # class name -> dotted base expressions ("asyncio.Protocol")
        self.class_bases: dict[str, list[str]] = {}
        # (relpath, NAME) -> class, for module-level singletons
        # ``MONITOR = IoHealthMonitor()`` — lets the call graph resolve
        # ``mod.MONITOR.m()`` the way attr_types resolves ``self.x.m()``
        self.module_attr_types: dict[tuple[str, str], str] = {}
        for relpath in sorted(py_files):
            self._index_file(relpath)
        self._scrape_module_singletons()

    # ---------- construction ----------

    @classmethod
    def from_config(cls, root: str, cfg: AnalysisConfig) -> "ProjectIndex":
        return cls(root, discover_py_files(root, cfg))

    def _index_file(self, relpath: str) -> None:
        path = os.path.join(self.root, relpath)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError:
            return
        try:
            tree = ast.parse(source, filename=relpath)
        except SyntaxError:
            return
        mod = ModuleInfo(relpath, tree, source.splitlines())
        self.modules[relpath] = mod
        self._index_imports(mod)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(relpath, node.name, node, None)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = relpath
                self.class_bases[node.name] = [
                    dotted
                    for base in node.bases
                    if (dotted := _dotted_expr(base)) is not None
                ]
                for item in node.body:
                    if isinstance(
                        item, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        self._add_function(
                            relpath, f"{node.name}.{item.name}", item, node.name
                        )
                        if item.name == "__init__":
                            self._scrape_attr_types(node.name, item)

    def _add_function(
        self,
        relpath: str,
        qualname: str,
        node: ast.AST,
        class_name: str | None,
    ) -> None:
        info = FunctionInfo(relpath, qualname, node, class_name)
        self.functions[(relpath, qualname)] = info
        method = qualname.rsplit(".", 1)[-1]
        self.methods_by_name.setdefault(method, []).append(info)

    def _scrape_module_singletons(self) -> None:
        """Second pass (all classes known): module-level ``NAME =
        ClassName()`` assignments, recorded so calls through the
        singleton resolve to that class's methods."""
        for relpath, mod in self.modules.items():
            for node in mod.tree.body:
                if not (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Name)
                ):
                    continue
                cls = node.value.func.id
                if cls not in self.classes and cls in mod.name_imports:
                    _src, orig = mod.name_imports[cls]
                    cls = orig
                if cls in self.classes:
                    self.module_attr_types[
                        (relpath, node.targets[0].id)
                    ] = cls

    def _index_imports(self, mod: ModuleInfo) -> None:
        """Best-effort: map local names onto project module relpaths.
        Project modules are identified by resolving the import back to a
        file that this index was (or will be) given."""
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    rel = self._module_to_relpath(alias.name)
                    if rel:
                        mod.module_imports[local] = rel
                    else:
                        mod.external_imports[local] = alias.name
            elif isinstance(node, ast.ImportFrom):
                base = self._resolve_from(mod.relpath, node)
                for alias in node.names:
                    local = alias.asname or alias.name
                    if base is None:
                        mod.external_imports[local] = (
                            f"{node.module or ''}.{alias.name}"
                        )
                        continue
                    # "from <pkg> import <name>": <name> may itself be a
                    # module file, else a function/class in <pkg>'s file
                    sub = self._module_to_relpath(f"{base}/{alias.name}")
                    if sub:
                        mod.module_imports[local] = sub
                    else:
                        target = self._module_to_relpath(base)
                        if target:
                            mod.name_imports[local] = (target, alias.name)

    def _module_to_relpath(self, dotted_or_path: str) -> str | None:
        """Dotted module or pseudo-path -> repo-relative file, if it is
        part of the analyzed tree."""
        frag = dotted_or_path.replace(".", "/")
        for candidate in (f"{frag}.py", f"{frag}/__init__.py"):
            if candidate in self.modules or os.path.exists(
                os.path.join(self.root, candidate)
            ):
                return candidate
        return None

    def _resolve_from(
        self, relpath: str, node: ast.ImportFrom
    ) -> str | None:
        """Resolve a ``from X import …`` to a pseudo-path base (slashes),
        or None for external imports."""
        if node.level == 0:
            if node.module is None:
                return None
            frag = node.module.replace(".", "/")
            if self._module_to_relpath(frag):
                return frag
            return None
        # relative import: climb from the importing file's package
        base = os.path.dirname(relpath)
        for _ in range(node.level - 1):
            base = os.path.dirname(base)
        if node.module:
            base = os.path.join(base, node.module.replace(".", "/"))
        return base.replace(os.sep, "/")

    def _scrape_attr_types(self, class_name: str, init: ast.AST) -> None:
        """Infer ``self.<attr>``'s class from __init__: either assigned
        from a parameter with a class annotation, or constructed from a
        known class name directly."""
        ann: dict[str, str] = {}
        args = getattr(init, "args", None)
        if args is not None:
            for a in list(args.args) + list(args.kwonlyargs):
                if a.annotation is not None:
                    name = _annotation_class_name(a.annotation)
                    if name:
                        ann[a.arg] = name
        for node in iter_nodes_shallow(init):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            if not (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                continue
            value = node.value
            if isinstance(value, ast.Name) and value.id in ann:
                self.attr_types[(class_name, target.attr)] = ann[value.id]
            elif isinstance(value, ast.Call) and isinstance(
                value.func, ast.Name
            ):
                self.attr_types[(class_name, target.attr)] = value.func.id

    # ---------- queries ----------

    def function(self, ref: str) -> FunctionInfo | None:
        relpath, _, qualname = ref.partition("::")
        return self.functions.get((relpath, qualname))

    def class_method(
        self, class_name: str, method: str
    ) -> FunctionInfo | None:
        relpath = self.classes.get(class_name)
        if relpath is None:
            return None
        return self.functions.get((relpath, f"{class_name}.{method}"))

    def source_line(self, relpath: str, lineno: int) -> str:
        lines = self.modules[relpath].source_lines
        if 1 <= lineno <= len(lines):
            return lines[lineno - 1]
        return ""


def _dotted_expr(node: ast.AST) -> str | None:
    """Flatten a Name/Attribute chain → "a.b.c" (None otherwise)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _annotation_class_name(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        # string annotation: take the last dotted segment, strip generics
        frag = node.value.split("[")[0].split(".")[-1].strip()
        return frag or None
    return None


def discover_py_files(root: str, cfg: AnalysisConfig) -> list[str]:
    """All .py files of the analyzed code: the package plus the extra
    top-level harness files (chip_smoke.py)."""
    out: list[str] = []
    roots = [cfg.package_dir, *cfg.extra_code]
    for entry in roots:
        path = os.path.join(root, entry)
        if os.path.isfile(path) and entry.endswith(".py"):
            out.append(entry)
            continue
        for dirpath, _dirnames, filenames in os.walk(path):
            for name in sorted(filenames):
                if name.endswith(".py"):
                    full = os.path.join(dirpath, name)
                    out.append(os.path.relpath(full, root).replace(os.sep, "/"))
    return sorted(set(out))


# ---------------------------------------------------------------------------
# baseline + pragma suppression
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> set[str]:
    """The accepted-finding fingerprints, or empty when absent."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return set()
    entries = data.get("findings", []) if isinstance(data, dict) else []
    return {
        e["fingerprint"]
        for e in entries
        if isinstance(e, dict) and "fingerprint" in e
    }


def load_baseline_entries(path: str) -> list[dict[str, Any]]:
    """Raw baseline entries (fingerprint + message), empty when absent."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return []
    entries = data.get("findings", []) if isinstance(data, dict) else []
    return [
        e for e in entries if isinstance(e, dict) and "fingerprint" in e
    ]


def write_baseline(
    path: str,
    findings: list[Finding],
    keep_entries: list[dict[str, Any]] | None = None,
) -> None:
    """Pin ``findings`` (plus ``keep_entries`` — pre-existing raw entries
    to carry over verbatim, used when only a CHECKER SUBSET ran: the
    unselected checkers' pins must survive the rewrite, or a partial
    --write-baseline would silently un-pin them and redden CI)."""
    payload = {
        "version": 1,
        "comment": (
            "Accepted pre-existing findings, pinned so the gate is "
            "zero-NEW-findings. Shrink this file; never grow it casually "
            "(see README 'Static invariants (port)')."
        ),
        "findings": sorted(
            {
                **{
                    e["fingerprint"]: {
                        "fingerprint": e["fingerprint"],
                        "message": e.get("message", ""),
                    }
                    for e in (keep_entries or [])
                },
                **{
                    f.fingerprint: {
                        "fingerprint": f.fingerprint,
                        "message": f.message,
                    }
                    for f in findings
                },
            }.values(),
            key=lambda e: e["fingerprint"],
        ),
    }
    # atomic, eating our own cooking (and the analysis package is
    # tooling, not runtime: stdlib-only, so io.artifacts — which imports
    # numpy — is off-limits here)
    data = json.dumps(payload, indent=1, sort_keys=True) + "\n"
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(data)
    os.replace(tmp, path)


def _pragma_suppressed(index: ProjectIndex, finding: Finding) -> bool:
    mod = index.modules.get(finding.file)
    if mod is None:
        return False
    needle = f"{PRAGMA_PREFIX}{finding.checker}]"
    lines = mod.source_lines
    if 1 <= finding.line <= len(lines) and needle in lines[finding.line - 1]:
        return True
    # walk the contiguous comment block directly above the flagged line
    lineno = finding.line - 1
    while 1 <= lineno <= len(lines):
        stripped = lines[lineno - 1].strip()
        if not stripped.startswith("#"):
            break
        if needle in stripped:
            return True
        lineno -= 1
    return False


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def all_checkers() -> dict[str, Callable[[ProjectIndex, AnalysisConfig], list[Finding]]]:
    from . import (
        atomicwrite,
        costspec,
        envread,
        exitcodes,
        hotpath,
        locking,
        lockown,
        loopblock,
        metricsreg,
        registries,
    )

    return {
        "hotpath": hotpath.run,
        "locks": locking.run,
        "atomic-write": atomicwrite.run,
        "knobs": registries.run_knobs,
        "fault-sites": registries.run_fault_sites,
        "exit-codes": exitcodes.run,
        "metrics": metricsreg.run,
        "costspec": costspec.run,
        "loopblock": loopblock.run,
        "lockown": lockown.run,
        "envread": envread.run,
    }


def run_analysis(
    root: str,
    cfg: AnalysisConfig | None = None,
    checkers: Iterable[str] | None = None,
    baseline: set[str] | None = None,
    index: ProjectIndex | None = None,
) -> dict[str, Any]:
    """Run the selected checkers → ``{"findings": new, "baselined": old,
    "suppressed": pragma'd}`` (each a list of :class:`Finding`). The CI
    gate fails iff ``findings`` is non-empty."""
    cfg = cfg or AnalysisConfig()
    index = index or ProjectIndex.from_config(root, cfg)
    registry = all_checkers()
    selected = list(checkers) if checkers else list(registry)
    unknown = [name for name in selected if name not in registry]
    if unknown:
        raise ValueError(f"unknown checker(s): {unknown}")
    raw: list[Finding] = []
    for name in selected:
        raw.extend(registry[name](index, cfg))
    raw.sort(key=lambda f: (f.file, f.line, f.checker, f.key))
    baseline = baseline or set()
    new: list[Finding] = []
    old: list[Finding] = []
    suppressed: list[Finding] = []
    for finding in raw:
        if _pragma_suppressed(index, finding):
            suppressed.append(finding)
        elif finding.fingerprint in baseline:
            old.append(finding)
        else:
            new.append(finding)
    return {"findings": new, "baselined": old, "suppressed": suppressed}
