"""Checkers 4 & 5 — env-knob registry and fault-site registry.

**knobs**: every ``KMLS_*`` environment knob referenced anywhere in the
code (package + chip_smoke.py) must be declared in
``config.KNOB_REGISTRY`` with a scope, mentioned in the README, and —
for runtime scopes — bound or documented in the matching Kubernetes
manifest(s). And the inverse: a registry entry nothing references is an
orphan (a knob that was removed from code but not from docs keeps
operators setting a dead variable). ``config.KNOBS_ABSENT`` lists the
reference's knobs the port deliberately does not read, each with its
reason: its keys are no code reference, a knob in both dicts is a
finding, and so is a read of an absent knob (the port grew the knob back
without taking it off the list).

Knob references are EXACT string literals (``ast.Constant``) matching
``^KMLS_[A-Z0-9][A-Z0-9_]*$`` (no trailing underscore — prefix strings
like ``"KMLS_FAULT_"`` are not knobs). AST literals, so comments and
prose never count, and docstrings can't match (a knob name embedded in
a sentence is not an exact literal).

**fault-sites**: every ``KMLS_FAULT_*`` knob parsed by
``faults.load_env`` must arm a site that some production module actually
``fire()``s, and must be exercised by at least one test that names the
knob or its site (the chaos suites) — only the test files matching
``cfg.tests_globs`` count, so a reference chaos test cannot stand in for
the port's. F-string sites (``mine.crash.{p}``) match by literal prefix.
"""

from __future__ import annotations

import ast
import fnmatch
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

_KNOB_RE = re.compile(r"^KMLS_[A-Z0-9][A-Z0-9_]*[A-Z0-9]$")
_KNOB_TOKEN_RE = re.compile(r"\bKMLS_[A-Z0-9_]+\b")

VALID_SCOPES = ("serving", "mining", "both", "tool", "fault")


def _docstring_node_ids(tree: ast.AST) -> set[int]:
    """ids of every Constant that is a module/class/function docstring."""
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


def _iter_knob_literals(tree: ast.AST) -> Iterator[tuple[str, int]]:
    """Knob names in string constants: exact literals (the getenv reads)
    plus tokens EMBEDDED in longer strings — a phase carried as a whole
    script in a string literal (a subprocess's ``-c`` program) reads its
    knobs for real. Comments never reach the AST, so a commented-out
    knob can't count — and DOCSTRINGS are skipped outright: prose that
    mentions a knob must neither count as the read that keeps it alive
    (it would neuter the orphan check) nor demand a registry entry for a
    knob-shaped example."""
    docstrings = _docstring_node_ids(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if id(node) in docstrings:
                continue
            if _KNOB_RE.match(node.value):
                yield node.value, node.lineno
            elif len(node.value) > len("KMLS_X"):
                for token in _KNOB_TOKEN_RE.findall(node.value):
                    if _KNOB_RE.match(token):
                        yield token, node.lineno


def _assign_span(
    index: ProjectIndex, relpath: str, name: str
) -> tuple[int, int] | None:
    """Line span of the module-level ``name = ...`` assignment."""
    mod = index.modules.get(relpath)
    if mod is None:
        return None
    for node in mod.tree.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        if isinstance(target, ast.Name) and target.id == name:
            return (node.lineno, node.end_lineno or node.lineno)
    return None


def collect_code_knobs(
    index: ProjectIndex, cfg: AnalysisConfig | None = None
) -> dict[str, tuple[str, int]]:
    """knob -> first (file, line) reference across the analyzed code.
    The analysis package itself is excluded (its checkers spell
    knob-shaped strings without reading any environment), and so are the
    KNOB_REGISTRY and KNOBS_ABSENT dicts' own spans — a registry key must
    not count as the code reference that keeps itself alive, or the
    orphan check could never fire."""
    spans: list[tuple[int, int]] = []
    config_file = cfg.config_file if cfg else None
    if cfg is not None:
        for name in (cfg.knob_registry_name, cfg.knob_absent_name):
            span = _assign_span(index, cfg.config_file, name)
            if span is not None:
                spans.append(span)
    refs: dict[str, tuple[str, int]] = {}
    for relpath in sorted(index.modules):
        if "/analysis/" in relpath:
            continue
        for knob, line in _iter_knob_literals(index.modules[relpath].tree):
            if relpath == config_file and any(
                lo <= line <= hi for lo, hi in spans
            ):
                continue
            refs.setdefault(knob, (relpath, line))
    return refs


def _parse_str_dict(
    index: ProjectIndex, relpath: str, name: str, *, keys_only: bool = False
) -> tuple[dict[str, str], dict[str, int], int]:
    """Parse ``name = {"KEY": "value", ...}`` out of a module WITHOUT
    importing it → (key -> value, key -> line, assignment line). An entry
    whose value is not a string literal (an implicitly concatenated
    string is one literal) is skipped, unless ``keys_only``: then every
    literal key counts, with the value "" where it is no literal."""
    mod = index.modules.get(relpath)
    if mod is None:
        return {}, {}, 0
    for node in mod.tree.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target = node.target
            value = node.value
        else:
            continue
        if (
            isinstance(target, ast.Name)
            and target.id == name
            and isinstance(value, ast.Dict)
        ):
            entries: dict[str, str] = {}
            lines: dict[str, int] = {}
            for k, v in zip(value.keys, value.values):
                if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                    continue
                literal = isinstance(v, ast.Constant) and isinstance(v.value, str)
                if literal or keys_only:
                    entries[k.value] = v.value if literal else ""
                    lines[k.value] = k.lineno
            return entries, lines, node.lineno
    return {}, {}, 0


def parse_knob_registry(
    index: ProjectIndex, cfg: AnalysisConfig
) -> tuple[dict[str, str], dict[str, int], int]:
    """Parse ``KNOB_REGISTRY = {...}`` out of config.py WITHOUT importing
    it → (knob -> scope, knob -> line, registry line)."""
    return _parse_str_dict(index, cfg.config_file, cfg.knob_registry_name)


def parse_knobs_absent(
    index: ProjectIndex, cfg: AnalysisConfig
) -> tuple[dict[str, str], dict[str, int]]:
    """Parse ``KNOBS_ABSENT = {...}`` → (knob -> reason, "" where the
    reason is no literal, knob -> line); empty when the module has none."""
    reasons, lines, _line = _parse_str_dict(
        index, cfg.config_file, cfg.knob_absent_name, keys_only=True
    )
    return reasons, lines


def _read_text(root: str, relpath: str) -> str:
    try:
        with open(os.path.join(root, relpath), "r", encoding="utf-8") as fh:
            return fh.read()
    except OSError:
        return ""


def run_knobs(index: ProjectIndex, cfg: AnalysisConfig) -> list[Finding]:
    refs = collect_code_knobs(index, cfg)
    scopes, reg_lines, reg_line = parse_knob_registry(index, cfg)
    findings: list[Finding] = []
    if not scopes:
        findings.append(
            Finding(
                checker="knobs",
                severity=SEVERITY_ERROR,
                file=cfg.config_file,
                line=1,
                key="registry-missing",
                message=(
                    f"no `{cfg.knob_registry_name}` dict found in "
                    f"{cfg.config_file}; every KMLS_* knob must be "
                    "declared there with a scope "
                    f"({'/'.join(VALID_SCOPES)})"
                ),
            )
        )
        return findings

    readme_text = _read_text(index.root, cfg.readme)
    manifest_text = {
        m: _read_text(index.root, m) for m in cfg.manifest_files
    }
    absent, absent_lines = parse_knobs_absent(index, cfg)
    for knob in sorted(absent):
        aline = absent_lines.get(knob, reg_line)
        if knob in scopes:
            findings.append(
                Finding(
                    checker="knobs",
                    severity=SEVERITY_ERROR,
                    file=cfg.config_file,
                    line=aline,
                    key=f"absent-and-declared:{knob}",
                    message=(
                        f"`{knob}` is both declared in "
                        f"{cfg.knob_registry_name} and listed in "
                        f"{cfg.knob_absent_name}; a knob is read or "
                        "deliberately not read, never both"
                    ),
                )
            )
        elif knob in refs:
            relpath, line = refs[knob]
            findings.append(
                Finding(
                    checker="knobs",
                    severity=SEVERITY_ERROR,
                    file=relpath,
                    line=line,
                    key=f"absent-but-read:{knob}",
                    message=(
                        f"env knob `{knob}` is read here but listed in "
                        f"config.{cfg.knob_absent_name} as not read; "
                        f"move it to {cfg.knob_registry_name} with a "
                        "scope"
                    ),
                )
            )

    for knob in sorted(refs):
        relpath, line = refs[knob]
        if knob not in scopes and knob not in absent:
            findings.append(
                Finding(
                    checker="knobs",
                    severity=SEVERITY_ERROR,
                    file=relpath,
                    line=line,
                    key=f"undeclared:{knob}",
                    message=(
                        f"env knob `{knob}` is read here but not "
                        f"declared in config.{cfg.knob_registry_name}; "
                        "add it with a scope and a README row"
                    ),
                )
            )
    for knob in sorted(scopes):
        scope = scopes[knob]
        kline = reg_lines.get(knob, reg_line)
        if scope not in VALID_SCOPES:
            findings.append(
                Finding(
                    checker="knobs",
                    severity=SEVERITY_ERROR,
                    file=cfg.config_file,
                    line=kline,
                    key=f"bad-scope:{knob}",
                    message=(
                        f"`{knob}` has unknown scope {scope!r}; expected "
                        f"one of {', '.join(VALID_SCOPES)}"
                    ),
                )
            )
            continue
        if knob not in refs:
            findings.append(
                Finding(
                    checker="knobs",
                    severity=SEVERITY_WARN,
                    file=cfg.config_file,
                    line=kline,
                    key=f"orphan:{knob}",
                    message=(
                        f"`{knob}` is declared in the registry but "
                        "nothing in the code reads it — remove the "
                        "entry (and its README row) or wire the knob up"
                    ),
                )
            )
        if readme_text and knob not in readme_text:
            findings.append(
                Finding(
                    checker="knobs",
                    severity=SEVERITY_WARN,
                    file=cfg.config_file,
                    line=kline,
                    key=f"undocumented:{knob}",
                    message=(
                        f"`{knob}` is not mentioned anywhere in "
                        f"{cfg.readme}; every knob needs a row in the "
                        "configuration tables"
                    ),
                )
            )
        required = cfg.knob_scope_manifests.get(scope, ())
        if scope == "both":
            # must appear in the serving manifest AND one job manifest
            groups = [
                tuple(
                    m for m in required if "deployment" in os.path.basename(m)
                ),
                tuple(
                    m
                    for m in required
                    if "deployment" not in os.path.basename(m)
                ),
            ]
        else:
            groups = [required] if required else []
        for group in groups:
            if not group:
                continue
            if not any(knob in manifest_text.get(m, "") for m in group):
                findings.append(
                    Finding(
                        checker="knobs",
                        severity=SEVERITY_WARN,
                        file=cfg.config_file,
                        line=kline,
                        key=f"unbound:{knob}:{group[0]}",
                        message=(
                            f"`{knob}` (scope {scope!r}) is neither "
                            "bound nor documented in "
                            f"{' / '.join(group)}; a runtime knob "
                            "operators can set must be visible in the "
                            "manifest that deploys it"
                        ),
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# fault sites
# ---------------------------------------------------------------------------


def _site_literal(node: ast.AST) -> str | None:
    """A fire()/inject() site argument → its literal value, or the
    literal PREFIX of an f-string (``f"mine.crash.{p}"`` → "mine.crash.")."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        prefix = ""
        for part in node.values:
            if isinstance(part, ast.Constant) and isinstance(part.value, str):
                prefix += part.value
            else:
                break
        return prefix or None
    return None


def _sites_match(a: str, b: str) -> bool:
    return a.startswith(b) or b.startswith(a)


def collect_fault_env_map(
    index: ProjectIndex, cfg: AnalysisConfig
) -> dict[str, tuple[str, int]]:
    """``load_env``'s knob → (site, line) pairing: each ``os.getenv(
    "KMLS_FAULT_X")`` read is associated with the next ``inject(site)``
    call in statement order."""
    info = index.function(f"{cfg.faults_file}::load_env")
    if info is None:
        return {}

    def _call_name(node: ast.Call) -> str | None:
        if isinstance(node.func, ast.Attribute) and isinstance(
            node.func.value, ast.Name
        ):
            return f"{node.func.value.id}.{node.func.attr}"
        if isinstance(node.func, ast.Name):
            return node.func.id
        return None

    def _getenv_knob(node: ast.Call) -> str | None:
        if _call_name(node) in ("os.getenv", "getenv") and node.args:
            lit = _site_literal(node.args[0])
            if lit and lit.startswith("KMLS_FAULT"):
                return lit
        return None

    mapping: dict[str, tuple[str, int]] = {}
    paired_getenvs: set[int] = set()
    inject_calls: list[ast.Call] = []
    # pass 1: a getenv NESTED inside an inject call pairs directly —
    # `inject("site", times=int(os.getenv("KMLS_FAULT_X")))` must never
    # depend on event ordering
    for node in ast.walk(info.node):
        if isinstance(node, ast.Call) and _call_name(node) == "inject":
            inject_calls.append(node)
            site = _site_literal(node.args[0]) if node.args else None
            if site is None:
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    knob = _getenv_knob(sub)
                    if knob is not None:
                        mapping[knob] = (site, sub.lineno)
                        paired_getenvs.add(id(sub))
                        break
    # pass 2: the remaining reads pair with the next inject in SOURCE
    # order — (lineno, col_offset), since ast.walk order is
    # breadth-first, not statement order
    events: list[tuple[int, int, str, str]] = []
    consumed_injects = {
        id(c) for c in inject_calls if any(
            isinstance(sub, ast.Call) and id(sub) in paired_getenvs
            for sub in ast.walk(c)
        )
    }
    for node in ast.walk(info.node):
        if not isinstance(node, ast.Call):
            continue
        knob = _getenv_knob(node)
        if knob is not None and id(node) not in paired_getenvs:
            events.append((node.lineno, node.col_offset, "knob", knob))
        elif (
            _call_name(node) == "inject"
            and node.args
            and id(node) not in consumed_injects
        ):
            site = _site_literal(node.args[0])
            if site:
                events.append((node.lineno, node.col_offset, "inject", site))
    pending: str | None = None
    pending_line = 0
    for line, _col, kind, value in sorted(events):
        if kind == "knob":
            pending, pending_line = value, line
        elif pending is not None:
            mapping.setdefault(pending, (value, pending_line))
            pending = None
    return mapping


def collect_fire_sites(index: ProjectIndex, cfg: AnalysisConfig) -> set[str]:
    sites: set[str] = set()
    for relpath, mod in index.modules.items():
        if not relpath.startswith(cfg.package_dir):
            continue
        if relpath == cfg.faults_file:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                func = node.func
                name = None
                if isinstance(func, ast.Attribute):
                    name = func.attr
                elif isinstance(func, ast.Name):
                    name = func.id
                # fire() raises/kills at the site; take()/take_io() are
                # the consume-style variants (fleet peer delays, storage
                # faults) — all three mean "this site is wired"
                if name in ("fire", "take", "take_io") and node.args:
                    site = _site_literal(node.args[0])
                    if site:
                        sites.add(site)
    return sites


def run_fault_sites(
    index: ProjectIndex, cfg: AnalysisConfig
) -> list[Finding]:
    env_map = collect_fault_env_map(index, cfg)
    fire_sites = collect_fire_sites(index, cfg)
    findings: list[Finding] = []
    if not env_map:
        findings.append(
            Finding(
                checker="fault-sites",
                severity=SEVERITY_ERROR,
                file=cfg.faults_file,
                line=1,
                key="no-env-map",
                message=(
                    f"could not extract any KMLS_FAULT_* -> site mapping "
                    f"from {cfg.faults_file}::load_env"
                ),
            )
        )
        return findings

    # tests: any string literal naming the knob or its site counts as
    # exercising it
    test_literals: set[str] = set()
    tests_root = os.path.join(index.root, cfg.tests_dir)
    if os.path.isdir(tests_root):
        for name in sorted(os.listdir(tests_root)):
            if not name.endswith(".py") or not any(
                fnmatch.fnmatch(name, pattern) for pattern in cfg.tests_globs
            ):
                continue
            try:
                with open(
                    os.path.join(tests_root, name), "r", encoding="utf-8"
                ) as fh:
                    tree = ast.parse(fh.read())
            except (OSError, SyntaxError):
                continue
            for node in ast.walk(tree):
                if isinstance(node, ast.Constant) and isinstance(
                    node.value, str
                ):
                    test_literals.add(node.value)

    # inverse direction: a production fire() site no env knob can arm is
    # dead chaos surface (programmatic inject still reaches it, so warn)
    armed_sites = {site for site, _line in env_map.values()}
    for site in sorted(fire_sites):
        if not any(_sites_match(site, armed) for armed in armed_sites):
            findings.append(
                Finding(
                    checker="fault-sites",
                    severity=SEVERITY_WARN,
                    file=cfg.faults_file,
                    line=1,
                    key=f"unarmed-site:{site}",
                    message=(
                        f"fire site `{site}` exists in code but no "
                        "KMLS_FAULT_* knob in load_env can arm it; add "
                        "an env knob so containers/CI chaos can reach it"
                    ),
                )
            )

    for knob in sorted(env_map):
        site, line = env_map[knob]
        if not any(_sites_match(site, fired) for fired in fire_sites):
            findings.append(
                Finding(
                    checker="fault-sites",
                    severity=SEVERITY_ERROR,
                    file=cfg.faults_file,
                    line=line,
                    key=f"dead-knob:{knob}",
                    message=(
                        f"`{knob}` arms site `{site}` but nothing in the "
                        "package ever fire()s that site — the knob is a "
                        "no-op; wire the site or delete the knob"
                    ),
                )
            )
            continue
        # strict matching: the knob name itself, the exact site, or — for
        # prefix sites like "mine.crash." — any literal under the prefix.
        # (Loose prefix matching here would let a stray short literal
        # mark a knob as exercised.)
        exercised = (
            knob in test_literals
            or site in test_literals
            or (
                site.endswith(".")
                and any(lit.startswith(site) for lit in test_literals)
            )
        )
        if not exercised:
            findings.append(
                Finding(
                    checker="fault-sites",
                    severity=SEVERITY_ERROR,
                    file=cfg.faults_file,
                    line=line,
                    key=f"untested:{knob}",
                    message=(
                        f"`{knob}` (site `{site}`) is not exercised by "
                        "any test — no chaos test names the knob or "
                        "injects its site; a recovery path nothing "
                        "drives is a recovery path that regresses "
                        "silently"
                    ),
                )
            )
    return findings
