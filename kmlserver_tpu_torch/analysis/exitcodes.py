"""Checker 6 — exit-code contract vs. podFailurePolicy.

The preemption contract: ``mining/job.py`` exits 0 (success), 64 (fatal
config — retrying burns GPU quota for the same failure), 75 (resumable — a
checkpoint restart makes progress) or 76 (dead-rank watchdog abort, also
resumable). The Kubernetes Job manifests encode the SAME policy as
``podFailurePolicy`` rules: FailJob on 64, Ignore on 75/76. Nothing ties
the two files together — an edit to either silently rots the other (a
new resumable code the manifest doesn't Ignore burns ``backoffLimit`` on
preemptions; a manifest Ignoring a code the job treats as fatal retries
a job that can never succeed). This checker diffs them.

The manifest side is parsed with a deliberately small line-based reader
(no yaml dependency in the analyzer): it tracks ``action:`` context and
collects the ``values: [..]`` lists under ``onExitCodes``. It also
verifies ``restartPolicy: Never`` — podFailurePolicy requires it, and a
kubelet-local restart would bypass the policy entirely.
"""

from __future__ import annotations

import ast
import os
import re

from .core import SEVERITY_ERROR, AnalysisConfig, Finding, ProjectIndex

_VALUES_RE = re.compile(r"values:\s*\[([0-9,\s]+)\]")
_ACTION_RE = re.compile(r"action:\s*(\w+)")


def parse_job_contract(
    index: ProjectIndex, cfg: AnalysisConfig
) -> tuple[dict[str, int], set[int]] | None:
    """→ ({EXIT_* name: code}, retryable codes) from mining/job.py."""
    mod = index.modules.get(cfg.job_file)
    if mod is None:
        return None
    consts: dict[str, int] = {}
    retryable_names: list[str] = []
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if not isinstance(target, ast.Name):
                continue
            if target.id.startswith("EXIT_") and isinstance(
                node.value, ast.Constant
            ):
                if isinstance(node.value.value, int):
                    consts[target.id] = node.value.value
            elif target.id == "RETRYABLE_EXIT_CODES" and isinstance(
                node.value, (ast.Tuple, ast.List)
            ):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Name):
                        retryable_names.append(elt.id)
                    elif isinstance(elt, ast.Constant) and isinstance(
                        elt.value, int
                    ):
                        consts[f"_literal_{elt.value}"] = elt.value
                        retryable_names.append(f"_literal_{elt.value}")
    if not consts:
        return None
    retryable = {consts[n] for n in retryable_names if n in consts}
    return consts, retryable


def parse_pod_failure_policy(text: str) -> dict[str, set[int]]:
    """action name -> exit-code set, from the manifest's podFailurePolicy
    block(s)."""
    out: dict[str, set[int]] = {}
    action: str | None = None
    for line in text.splitlines():
        stripped = line.split("#", 1)[0]
        m = _ACTION_RE.search(stripped)
        if m:
            action = m.group(1)
        m = _VALUES_RE.search(stripped)
        if m and action:
            codes = {
                int(v) for v in m.group(1).replace(",", " ").split() if v
            }
            out.setdefault(action, set()).update(codes)
    return out


def run(index: ProjectIndex, cfg: AnalysisConfig) -> list[Finding]:
    findings: list[Finding] = []
    contract = parse_job_contract(index, cfg)
    if contract is None:
        findings.append(
            Finding(
                checker="exit-codes",
                severity=SEVERITY_ERROR,
                file=cfg.job_file,
                line=1,
                key="contract-missing",
                message=(
                    f"could not parse EXIT_* constants / "
                    f"RETRYABLE_EXIT_CODES from {cfg.job_file}"
                ),
            )
        )
        return findings
    consts, retryable = contract
    # fatal = every declared non-zero exit code that is NOT retryable —
    # derived, not name-matched, so (a) a new fatal code (EXIT_FATAL_DATA
    # = 65) correctly demands a FailJob rule, and (b) a new code that is
    # neither fatal-classified nor in RETRYABLE_EXIT_CODES still shows up
    # as a mismatch instead of silently burning backoffLimit
    fatal = {
        code
        for code in consts.values()
        if code != 0 and code not in retryable
    }
    for manifest in cfg.job_manifests:
        path = os.path.join(index.root, manifest)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                text = fh.read()
        except OSError:
            findings.append(
                Finding(
                    checker="exit-codes",
                    severity=SEVERITY_ERROR,
                    file=manifest,
                    line=1,
                    key="manifest-missing",
                    message=f"job manifest {manifest} not found",
                )
            )
            continue
        policy = parse_pod_failure_policy(text)
        if not policy:
            findings.append(
                Finding(
                    checker="exit-codes",
                    severity=SEVERITY_ERROR,
                    file=manifest,
                    line=1,
                    key="policy-missing",
                    message=(
                        f"{manifest} has no parseable podFailurePolicy; "
                        "the 0/64/75/76 exit contract must be bound here"
                    ),
                )
            )
            continue
        fail_job = policy.get("FailJob", set())
        ignore = policy.get("Ignore", set())
        if fail_job != fatal:
            findings.append(
                Finding(
                    checker="exit-codes",
                    severity=SEVERITY_ERROR,
                    file=manifest,
                    line=1,
                    key=f"failjob-mismatch:{sorted(fail_job)}!={sorted(fatal)}",
                    message=(
                        f"{manifest} FailJob codes {sorted(fail_job)} != "
                        f"job.py's non-retryable EXIT_* codes "
                        f"{sorted(fatal)}; a fatal exit the policy "
                        "doesn't FailJob on retries a job that can never "
                        "succeed (and vice versa)"
                    ),
                )
            )
        if ignore != retryable:
            findings.append(
                Finding(
                    checker="exit-codes",
                    severity=SEVERITY_ERROR,
                    file=manifest,
                    line=1,
                    key=(
                        f"ignore-mismatch:{sorted(ignore)}"
                        f"!={sorted(retryable)}"
                    ),
                    message=(
                        f"{manifest} Ignore codes {sorted(ignore)} != "
                        f"job.py RETRYABLE_EXIT_CODES "
                        f"{sorted(retryable)}; a resumable exit the "
                        "policy counts against backoffLimit turns "
                        "preemptions into Job failures"
                    ),
                )
            )
        if "restartPolicy: Never" not in text:
            findings.append(
                Finding(
                    checker="exit-codes",
                    severity=SEVERITY_ERROR,
                    file=manifest,
                    line=1,
                    key="restart-policy",
                    message=(
                        f"{manifest} must set `restartPolicy: Never` — "
                        "podFailurePolicy requires it, and kubelet-local "
                        "container restarts would bypass the exit-code "
                        "policy entirely"
                    ),
                )
            )
    return findings
