"""kmls-verify for the port — project-invariant static analysis of
``kmlserver_tpu_torch/``.

The counterpart of the reference's ``kmlserver_tpu/analysis/`` (the same
eleven checkers, finding keys, fingerprints and pragma), with its own copy
of the code: the port imports nothing of the reference. Each checker is a
pure-``ast`` pass (stdlib only — the analyzer runs without torch, and
never imports the tree it checks):

- ``hotpath``      — no host-blocking construct reachable from the serving
                     dispatch entry points: no ``torch.cuda.synchronize``,
                     no ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                     ``.synchronize()`` / ``.result()``, no pageable
                     ``torch.tensor(..., device=...)`` copy, no file I/O,
                     no sleeps (the dispatch half of a batch only enqueues
                     work on the card);
- ``locks``        — no lock-acquisition-order cycles, no blocking calls
                     while a hot-path lock is held (the batcher / cache /
                     metrics locking discipline);
- ``atomic-write`` — every artifact write flows through io/artifacts.py's
                     tmp+``os.replace`` writer (no torn reads on the PVC);
- ``knobs``        — every ``KMLS_*`` env knob referenced in code is
                     declared in config.KNOB_REGISTRY, documented in the
                     README, and (runtime scopes) bound or documented in
                     the port's k8s manifests (``deploy/kubernetes/``) —
                     no orphans in either direction; a knob listed in
                     config.KNOBS_ABSENT must not be read at all;
- ``fault-sites``  — every ``KMLS_FAULT_*`` knob maps to a registered
                     faults.py site that is wired into the code and
                     exercised by at least one of the port's tests;
- ``exit-codes``   — the 0/64/75/76 contract in mining/job.py exactly
                     matches the ``podFailurePolicy`` rules in both Job
                     manifests (the preemption contract);
- ``metrics``      — every exported Prometheus series (serving
                     ``/metrics`` AND the mining ``job_metrics.prom``
                     textfile) is declared in
                     ``serving.metrics.METRIC_REGISTRY`` with a valid
                     type+scope and a README row, orphans flagged both
                     directions;
- ``costspec``     — every dispatched kernel named at an
                     ``observe_kernel``/``phase_cost`` call site has an
                     analytic cost spec in
                     ``observability.costmodel.KERNEL_COST_SPECS`` and
                     vice versa, the required kernel set stays
                     registered, and every cost-model series is in
                     ``METRIC_REGISTRY``;
- ``loopblock``    — no blocking constructs (sleeps, file/socket I/O,
                     un-awaited ``.result()``/``.wait()``, ``faults.
                     fire``, durable writers, device syncs) in EVENT-LOOP
                     context, on the async-aware call graph's
                     execution-context classification;
- ``lockown``      — for classes that own a lock, each mutable field's
                     owning lock is inferred by majority vote over
                     guarded accesses and unguarded WRITES are flagged
                     (conservative data-race inference);
- ``envread``      — no ``KMLS_*``/``os.environ`` reads at module import
                     time or inside ``torch.compile``-d functions, cross-
                     checked against ``config.KNOB_REGISTRY`` scopes (the
                     frozen-knob bug class).

Findings carry ``file:line``, a severity, an explanation, and a stable
fingerprint; pre-existing accepted findings live in
``analysis/baseline.json`` so the gate is zero-NEW-findings. One-off
intentional sites can instead carry an inline pragma on (or immediately
above) the flagged line::

    ids = host.numpy()  # kmls-verify: allow[hotpath] pinned host tensor

Run from the repo root: ``python -m kmlserver_tpu_torch.analysis`` (see
the README's "Static invariants (port)").
"""

from __future__ import annotations

from .core import (
    AnalysisConfig,
    Finding,
    ProjectIndex,
    load_baseline,
    run_analysis,
    write_baseline,
)

__all__ = [
    "AnalysisConfig",
    "Finding",
    "ProjectIndex",
    "load_baseline",
    "run_analysis",
    "write_baseline",
]
