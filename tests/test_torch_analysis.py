"""The port's kmls-verify (``kmlserver_tpu_torch/analysis/``): per-checker
fixture proofs + the real-tree acceptance gate — the twin of
``tests/test_analysis.py``.

Every checker gets one KNOWN-BAD fixture (a seeded violation it must
flag) and one KNOWN-GOOD fixture (the compliant twin it must stay quiet
on) — the analyzer parses trees rather than importing them, so fixtures
are tiny synthetic repos written into tmp_path. The acceptance test then
runs the full default configuration against the port's REAL tree and
requires zero non-baselined findings (once here, once as the CLI gate).
On top of the reference's cases: the torch host-sync constructs, the
knob registry's KNOBS_ABSENT, the port-only test scope of fault sites,
the compiler-trace roots, parity of findings with the reference's
analyzer on the shared fixtures, and the registry's parity with the
reference's KNOB_REGISTRY (this file imports both packages, as parity
tests may).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from kmlserver_tpu_torch.analysis import (
    AnalysisConfig,
    ProjectIndex,
    load_baseline,
    run_analysis,
    write_baseline,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(
    REPO_ROOT, "kmlserver_tpu_torch", "analysis", "baseline.json"
)


# ---------------------------------------------------------------------------
# fixture scaffolding
# ---------------------------------------------------------------------------


def write_tree(root, files: dict[str, str]) -> None:
    for relpath, content in files.items():
        path = os.path.join(root, relpath)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(textwrap.dedent(content))


def run_fixture(
    root, cfg: AnalysisConfig, checkers: list[str], baseline=None
):
    index = ProjectIndex.from_config(str(root), cfg)
    return run_analysis(
        str(root), cfg, checkers=checkers, baseline=baseline, index=index
    )


def fixture_cfg(**overrides) -> AnalysisConfig:
    cfg = AnalysisConfig(
        package_dir="pkg",
        extra_code=(),
        tests_dir="tests",
        readme="README.md",
        manifest_files=("k8s/deploy.yaml", "k8s/job.yaml"),
        config_file="pkg/config.py",
        faults_file="pkg/faults.py",
        job_file="pkg/job.py",
        job_manifests=("k8s/job.yaml",),
        atomic_allowed_modules=("pkg/writer.py",),
        atomic_allowed_functions=(),
        durable_rename_function="pkg/writer.py::save_pickle",
        rename_allowed_modules=(),
        hotpath_entries=("pkg/serve.py::Batcher.dispatch",),
        hot_locks=("Cache._lock",),
        tests_globs=("test_*.py",),
    )
    for key, value in overrides.items():
        setattr(cfg, key, value)
    cfg.knob_scope_manifests = {
        "serving": ("k8s/deploy.yaml",),
        "mining": ("k8s/job.yaml",),
        "both": ("k8s/deploy.yaml", "k8s/job.yaml"),
        "tool": (),
        "fault": (),
    }
    return cfg


def keys(result, checker=None):
    return {
        f.key
        for f in result["findings"]
        if checker is None or f.checker == checker
    }


# ---------------------------------------------------------------------------
# checker 1: hot-path purity
# ---------------------------------------------------------------------------

_HOTPATH_BAD = """
    import time

    import torch

    def helper(x):
        time.sleep(0.1)
        return torch.cuda.synchronize()

    class Batcher:
        def dispatch(self, batch):
            return helper(batch)
    """

_HOTPATH_GOOD = """
    import torch

    def helper(x):
        return [len(s) for s in x]

    class Batcher:
        def dispatch(self, batch):
            # defining (not calling) a blocking closure is fine: the
            # completion side waits on the card BY DESIGN and must not
            # be flagged
            def finish():
                torch.cuda.synchronize()
                return batch.tolist()

            helper(batch)
            return finish
    """


def test_hotpath_flags_seeded_violation(tmp_path):
    write_tree(tmp_path, {"pkg/serve.py": _HOTPATH_BAD})
    result = run_fixture(tmp_path, fixture_cfg(), ["hotpath"])
    got = keys(result, "hotpath")
    assert "time.sleep@helper" in got
    assert "torch.cuda.synchronize@helper" in got, got


def test_hotpath_quiet_on_good_tree_and_closures(tmp_path):
    write_tree(tmp_path, {"pkg/serve.py": _HOTPATH_GOOD})
    result = run_fixture(tmp_path, fixture_cfg(), ["hotpath"])
    assert result["findings"] == []


def test_hotpath_pragma_suppresses(tmp_path):
    bad = _HOTPATH_BAD.replace(
        "time.sleep(0.1)",
        "time.sleep(0.1)  # kmls-verify: allow[hotpath] fixture",
    )
    write_tree(tmp_path, {"pkg/serve.py": bad})
    result = run_fixture(tmp_path, fixture_cfg(), ["hotpath"])
    assert "time.sleep@helper" not in keys(result)
    assert any(
        f.key == "time.sleep@helper" for f in result["suppressed"]
    )


# ---------------------------------------------------------------------------
# checker 2: lock order + blocking under lock
# ---------------------------------------------------------------------------

_LOCKS_BAD = """
    import threading
    import time

    class Cache:
        def __init__(self):
            self._lock = threading.Lock()
            self._other = threading.Lock()

        def slow_get(self):
            with self._lock:
                time.sleep(0.5)

        def ab(self):
            with self._lock:
                with self._other:
                    pass

        def ba(self):
            with self._other:
                with self._lock:
                    pass
    """

_LOCKS_GOOD = """
    import threading
    import time

    class Cache:
        def __init__(self):
            self._lock = threading.Lock()
            self._other = threading.Lock()

        def fast_get(self):
            with self._lock:
                value = 1
            time.sleep(0.0)  # outside the critical section: fine
            return value

        def ordered_a(self):
            with self._lock:
                with self._other:
                    pass

        def ordered_b(self):
            # same global order as ordered_a: no cycle
            with self._lock:
                with self._other:
                    pass
    """

_LOCKS_INTERPROC_BAD = """
    import threading

    def do_io(path):
        with open(path, "r") as fh:
            return fh.read()

    class Cache:
        def __init__(self):
            self._lock = threading.Lock()

        def get(self, path):
            with self._lock:
                return do_io(path)
    """


def test_locks_flags_blocking_and_cycle(tmp_path):
    write_tree(tmp_path, {"pkg/serve.py": _LOCKS_BAD})
    result = run_fixture(tmp_path, fixture_cfg(), ["locks"])
    got = keys(result, "locks")
    assert "block:Cache._lock:time.sleep@Cache.slow_get" in got
    assert any(k.startswith("cycle:") for k in got), got


def test_locks_flags_blocking_through_calls(tmp_path):
    write_tree(tmp_path, {"pkg/serve.py": _LOCKS_INTERPROC_BAD})
    result = run_fixture(tmp_path, fixture_cfg(), ["locks"])
    assert "block:Cache._lock:open@Cache.get" in keys(result, "locks")


def test_locks_quiet_on_good_tree(tmp_path):
    write_tree(tmp_path, {"pkg/serve.py": _LOCKS_GOOD})
    result = run_fixture(tmp_path, fixture_cfg(), ["locks"])
    assert result["findings"] == []


# ---------------------------------------------------------------------------
# checker 3: atomic-write enforcement
# ---------------------------------------------------------------------------

_ATOMIC_BAD = """
    import pickle

    def publish(obj, path):
        with open(path, "wb") as fh:
            pickle.dump(obj, fh)
    """

_ATOMIC_GOOD_WRITER = """
    import os
    import pickle

    def save_pickle(obj, path):
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(obj, fh)
        os.replace(tmp, path)
    """

_ATOMIC_GOOD_CALLER = """
    from .writer import save_pickle

    def publish(obj, path):
        save_pickle(obj, path)

    def read(path):
        with open(path, "rb") as fh:
            return fh.read()
    """


def test_atomic_flags_bare_pickle_dump(tmp_path):
    write_tree(tmp_path, {"pkg/mine.py": _ATOMIC_BAD})
    result = run_fixture(tmp_path, fixture_cfg(), ["atomic-write"])
    got = keys(result, "atomic-write")
    assert "open(mode='wb')@publish" in got
    assert "pickle.dump@publish" in got


def test_atomic_allows_writer_module_and_reads(tmp_path):
    write_tree(
        tmp_path,
        {
            "pkg/writer.py": _ATOMIC_GOOD_WRITER,
            "pkg/mine.py": _ATOMIC_GOOD_CALLER,
        },
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["atomic-write"])
    assert result["findings"] == []


_ATOMIC_ROGUE_RENAME = """
    import os

    def publish(tmp, path):
        os.replace(tmp, path)
    """


def test_atomic_flags_rename_outside_durable_function(tmp_path):
    """A publication-critical rename anywhere but the
    designated durable-rename function is an ERROR — even inside an
    atomic-ALLOWED writer module (the rename rule is stricter than the
    direct-write rule)."""
    write_tree(
        tmp_path,
        {
            "pkg/writer.py": _ATOMIC_GOOD_WRITER,
            "pkg/rogue.py": _ATOMIC_ROGUE_RENAME,
        },
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["atomic-write"])
    got = keys(result, "atomic-write")
    assert got == {"os.replace@publish"}
    # ...and a rename-allowed module is exempt from the rename rule only
    result = run_fixture(
        tmp_path,
        fixture_cfg(rename_allowed_modules=("pkg/rogue.py",)),
        ["atomic-write"],
    )
    assert result["findings"] == []


# ---------------------------------------------------------------------------
# checker 4: env-knob registry
# ---------------------------------------------------------------------------

_KNOBS_CONFIG = """
    KNOB_REGISTRY: dict[str, str] = {
        "KMLS_GOOD_KNOB": "serving",
        "KMLS_ORPHAN_KNOB": "tool",
    }
    """

_KNOBS_CODE = """
    import os

    def read():
        good = os.getenv("KMLS_GOOD_KNOB", "1")
        rogue = os.getenv("KMLS_ROGUE_KNOB")
        return good, rogue
    """


def _knobs_tree(tmp_path, readme="KMLS_GOOD_KNOB KMLS_ORPHAN_KNOB",
                deploy="env: KMLS_GOOD_KNOB"):
    write_tree(
        tmp_path,
        {
            "pkg/config.py": _KNOBS_CONFIG,
            "pkg/serve.py": _KNOBS_CODE,
            "README.md": readme + "\n",
            "k8s/deploy.yaml": deploy + "\n",
            "k8s/job.yaml": "restartPolicy: Never\n",
        },
    )


def test_knobs_flags_undeclared_orphan_and_undocumented(tmp_path):
    _knobs_tree(tmp_path, readme="KMLS_ORPHAN_KNOB only", deploy="x: y")
    result = run_fixture(tmp_path, fixture_cfg(), ["knobs"])
    got = keys(result, "knobs")
    assert "undeclared:KMLS_ROGUE_KNOB" in got
    assert "orphan:KMLS_ORPHAN_KNOB" in got
    assert "undocumented:KMLS_GOOD_KNOB" in got
    assert "unbound:KMLS_GOOD_KNOB:k8s/deploy.yaml" in got


def test_knobs_quiet_when_registries_agree(tmp_path):
    _knobs_tree(tmp_path)
    write_tree(
        tmp_path,
        {
            "pkg/serve.py": """
                import os

                def read():
                    return os.getenv("KMLS_GOOD_KNOB", "1")
                """,
            "pkg/config.py": """
                KNOB_REGISTRY: dict[str, str] = {
                    "KMLS_GOOD_KNOB": "serving",
                }
                """,
            "README.md": "KMLS_GOOD_KNOB\n",
        },
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["knobs"])
    assert result["findings"] == []


def test_knobs_sees_literals_inside_embedded_scripts(tmp_path):
    # bench.py-style phase bracket: the knob read lives inside a string
    _knobs_tree(tmp_path)
    write_tree(
        tmp_path,
        {
            "pkg/serve.py": (
                "SCRIPT = '''\n"
                "import os\n"
                'qps = os.environ.get("KMLS_EMBEDDED_KNOB", "1")\n'
                "'''\n"
            ),
        },
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["knobs"])
    assert "undeclared:KMLS_EMBEDDED_KNOB" in keys(result, "knobs")


# ---------------------------------------------------------------------------
# checker 5: fault-site registry
# ---------------------------------------------------------------------------

_FAULTS_GOOD = """
    import os

    def inject(site, times=1):
        pass

    def fire(site, replica=None):
        pass

    def load_env():
        raw = os.getenv("KMLS_FAULT_WIRED")
        if raw:
            inject("engine.boom", times=int(raw))
    """

_FAULTS_FIRE_SITE = """
    from .faults import fire

    def load():
        fire("engine.boom")
    """

_FAULTS_DEAD_KNOB = """
    import os

    def inject(site, times=1):
        pass

    def fire(site, replica=None):
        pass

    def load_env():
        raw = os.getenv("KMLS_FAULT_DEAD")
        if raw:
            inject("nowhere.fired", times=int(raw))
    """


def test_fault_sites_quiet_when_wired_and_tested(tmp_path):
    write_tree(
        tmp_path,
        {
            "pkg/faults.py": _FAULTS_GOOD,
            "pkg/engine.py": _FAULTS_FIRE_SITE,
            "tests/test_chaos.py": (
                'def test_boom(monkeypatch):\n'
                '    monkeypatch.setenv("KMLS_FAULT_WIRED", "1")\n'
            ),
        },
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["fault-sites"])
    assert result["findings"] == []


def test_fault_sites_flags_dead_knob_and_untested(tmp_path):
    write_tree(
        tmp_path,
        {
            "pkg/faults.py": _FAULTS_DEAD_KNOB,
            "pkg/engine.py": _FAULTS_FIRE_SITE,
            "tests/test_chaos.py": "def test_nothing():\n    pass\n",
        },
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["fault-sites"])
    got = keys(result, "fault-sites")
    assert "dead-knob:KMLS_FAULT_DEAD" in got
    # engine.boom is fired but no knob arms it -> dead chaos surface
    assert "unarmed-site:engine.boom" in got


def test_fault_sites_flags_untested_knob(tmp_path):
    write_tree(
        tmp_path,
        {
            "pkg/faults.py": _FAULTS_GOOD,
            "pkg/engine.py": _FAULTS_FIRE_SITE,
            "tests/test_chaos.py": "def test_nothing():\n    pass\n",
        },
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["fault-sites"])
    assert "untested:KMLS_FAULT_WIRED" in keys(result, "fault-sites")


# ---------------------------------------------------------------------------
# checker 6: exit-code contract
# ---------------------------------------------------------------------------

_JOB_PY = """
    EXIT_OK = 0
    EXIT_FATAL_CONFIG = 64
    EXIT_RESUMABLE = 75
    EXIT_RANK_DEAD = 76
    RETRYABLE_EXIT_CODES = (EXIT_RESUMABLE, EXIT_RANK_DEAD)
    """

_JOB_YAML_GOOD = """
    spec:
      podFailurePolicy:
        rules:
          - action: FailJob
            onExitCodes:
              operator: In
              values: [64]
          - action: Ignore
            onExitCodes:
              operator: In
              values: [75, 76]
      template:
        spec:
          restartPolicy: Never
    """


def test_exit_codes_quiet_when_contract_matches(tmp_path):
    write_tree(
        tmp_path,
        {"pkg/job.py": _JOB_PY, "k8s/job.yaml": _JOB_YAML_GOOD},
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["exit-codes"])
    assert result["findings"] == []


def test_exit_codes_flags_drifted_policy(tmp_path):
    drifted = _JOB_YAML_GOOD.replace("[75, 76]", "[75]").replace(
        "restartPolicy: Never", "restartPolicy: OnFailure"
    )
    write_tree(
        tmp_path, {"pkg/job.py": _JOB_PY, "k8s/job.yaml": drifted}
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["exit-codes"])
    got = keys(result, "exit-codes")
    assert any(k.startswith("ignore-mismatch") for k in got), got
    assert "restart-policy" in got


def test_exit_codes_flags_new_code_without_policy(tmp_path):
    # a NEW resumable code in job.py the manifest does not Ignore: the
    # exact drift class this checker exists for
    job = _JOB_PY.replace(
        "RETRYABLE_EXIT_CODES = (EXIT_RESUMABLE, EXIT_RANK_DEAD)",
        "EXIT_LEASE_LOST = 77\n"
        "    RETRYABLE_EXIT_CODES = "
        "(EXIT_RESUMABLE, EXIT_RANK_DEAD, EXIT_LEASE_LOST)",
    )
    write_tree(
        tmp_path, {"pkg/job.py": job, "k8s/job.yaml": _JOB_YAML_GOOD}
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["exit-codes"])
    assert any(
        k.startswith("ignore-mismatch") for k in keys(result, "exit-codes")
    )


# ---------------------------------------------------------------------------
# checker 7: metric-series registry
# ---------------------------------------------------------------------------

_METRICS_GOOD = '''
    """Docstring naming kmls_prose_only_series must demand nothing."""

    METRIC_REGISTRY: dict[str, str] = {
        "kmls_good_total": "counter:serving",
        "kmls_lat_seconds": "histogram:serving",
        "kmls_job_thing": "gauge:mining",
        "kmls_dyn_state": "gauge:serving",
    }

    def render(n):
        return "\\n".join([
            "# TYPE kmls_good_total counter",
            f"kmls_good_total {n}",
            # histogram children are implementation suffixes, never
            # their own declarations
            "# TYPE kmls_lat_seconds histogram",
            'kmls_lat_seconds_bucket{le="+Inf"} 1',
            "kmls_lat_seconds_sum 0.5",
            "kmls_lat_seconds_count 1",
        ])
    '''

_JOBM_GOOD = """
    def render(v):
        return f"# TYPE kmls_job_thing gauge\\nkmls_job_thing {v}"
    """

_DYN_APP_GOOD = """
    class App:
        def state(self):
            out = {"dyn_state": 1.0}
            return out
    """


def _metrics_cfg(**overrides):
    return fixture_cfg(
        metrics_file="pkg/metrics.py",
        metric_exposition_files={
            "pkg/metrics.py": "serving",
            "pkg/jobm.py": "mining",
        },
        metric_dynamic_sources=(
            ("pkg/app.py::App.state", "kmls_", "serving"),
        ),
        **overrides,
    )


def _metrics_tree(tmp_path, metrics=_METRICS_GOOD, jobm=_JOBM_GOOD,
                  app=_DYN_APP_GOOD,
                  readme="kmls_good_total kmls_lat_seconds "
                         "kmls_job_thing kmls_dyn_state"):
    write_tree(
        tmp_path,
        {
            "pkg/metrics.py": metrics,
            "pkg/jobm.py": jobm,
            "pkg/app.py": app,
            "README.md": readme + "\n",
        },
    )


def test_metrics_quiet_when_registry_and_exposition_agree(tmp_path):
    _metrics_tree(tmp_path)
    result = run_fixture(tmp_path, _metrics_cfg(), ["metrics"])
    assert result["findings"] == []


def test_metrics_flags_unregistered_orphan_and_undocumented(tmp_path):
    _metrics_tree(
        tmp_path,
        metrics=_METRICS_GOOD.replace(
            '"kmls_good_total": "counter:serving",',
            '"kmls_orphan_gauge": "gauge:serving",',
        ),
        readme="kmls_lat_seconds kmls_job_thing kmls_dyn_state "
               "kmls_orphan_gauge",
    )
    got = keys(run_fixture(tmp_path, _metrics_cfg(), ["metrics"]), "metrics")
    assert "unregistered:kmls_good_total" in got
    assert "orphan:kmls_orphan_gauge" in got
    # registered + rendered but missing its README row
    _metrics_tree(tmp_path, readme="kmls_lat_seconds kmls_job_thing "
                                   "kmls_dyn_state")
    got = keys(run_fixture(tmp_path, _metrics_cfg(), ["metrics"]), "metrics")
    assert got == {"undocumented:kmls_good_total"}


def test_metrics_flags_malformed_entry_and_swapped_scope(tmp_path):
    _metrics_tree(
        tmp_path,
        metrics=_METRICS_GOOD.replace(
            '"kmls_job_thing": "gauge:mining",',
            '"kmls_job_thing": "gauge:serving",\n'
            '        "kmls_bad": "histo:everywhere",',
        ),
        readme="kmls_good_total kmls_lat_seconds kmls_job_thing "
               "kmls_dyn_state kmls_bad",
    )
    got = keys(run_fixture(tmp_path, _metrics_cfg(), ["metrics"]), "metrics")
    assert "bad-entry:kmls_bad" in got
    # the mining textfile module renders a series registered as serving
    assert "scope-mismatch:kmls_job_thing" in got


def test_metrics_flags_mismatch_on_second_exposition_surface(tmp_path):
    """A series BOTH surfaces render is checked at each surface: the
    serving-registered series leaking into the mining textfile must be
    flagged even though the serving module renders it first (and
    legitimately)."""
    _metrics_tree(
        tmp_path,
        jobm='''
    def render(v):
        return (f"# TYPE kmls_job_thing gauge\\nkmls_job_thing {v}\\n"
                "# TYPE kmls_good_total counter\\nkmls_good_total 0")
    ''',
    )
    got = keys(run_fixture(tmp_path, _metrics_cfg(), ["metrics"]), "metrics")
    assert got == {"scope-mismatch:kmls_good_total"}


def test_metrics_sees_dynamically_rendered_dict_keys(tmp_path):
    """The robustness-dict path: a key added to the dynamic source's
    dict is an exported series (prefixed at render time) and must be
    registered like any literal."""
    _metrics_tree(
        tmp_path,
        app=_DYN_APP_GOOD.replace(
            'out = {"dyn_state": 1.0}',
            'out = {"dyn_state": 1.0}\n'
            '            out["dyn_rogue"] = 2.0',
        ),
    )
    got = keys(run_fixture(tmp_path, _metrics_cfg(), ["metrics"]), "metrics")
    assert got == {"unregistered:kmls_dyn_rogue"}


def test_metrics_registry_keys_do_not_keep_themselves_alive(tmp_path):
    """The registry dict's own span is excluded from exposition
    collection — an entry whose only mention is its own key line is an
    orphan, not a live series."""
    _metrics_tree(
        tmp_path,
        metrics=_METRICS_GOOD.replace(
            '"kmls_dyn_state": "gauge:serving",',
            '"kmls_dyn_state": "gauge:serving",\n'
            '        "kmls_self_ref": "gauge:serving",',
        ),
        app=_DYN_APP_GOOD,
        readme="kmls_good_total kmls_lat_seconds kmls_job_thing "
               "kmls_dyn_state kmls_self_ref",
    )
    got = keys(run_fixture(tmp_path, _metrics_cfg(), ["metrics"]), "metrics")
    assert got == {"orphan:kmls_self_ref"}


# ---------------------------------------------------------------------------
# checker 8: kernel cost-spec registry
# ---------------------------------------------------------------------------

_COSTMODEL_GOOD = """
    KERNEL_COST_SPECS = {
        "serve_fast": None,
        "mine_count": None,
    }

    METRIC_REGISTRY_STUB = True
    """

_COSTMODEL_SERIES = """
    KERNEL_COST_SPECS = {
        "serve_fast": None,
    }

    def render():
        return ["kmls_mfu 1", "kmls_unknown_series 2"]
    """

_DISPATCH_GOOD = """
    def run(cm, shape):
        cm.observe_kernel("serve_fast", 0.5, b=shape)

    def mine(jm):
        return phase_cost("mine_count", p=10, v=4)
    """

_DISPATCH_BAD = """
    def run(cm, shape):
        cm.observe_kernel("serve_renamed", 0.5, b=shape)

    def forward(cm, kernel):
        cm.observe_kernel(kernel, 0.1)
    """


def _costspec_cfg(**overrides):
    return fixture_cfg(
        costmodel_file="pkg/costmodel.py",
        costspec_required=("serve_fast",),
        metrics_file="pkg/metrics.py",
        metric_exposition_files={"pkg/metrics.py": "serving"},
        metric_dynamic_sources=(),
        **overrides,
    )


def test_costspec_quiet_when_specs_and_sites_agree(tmp_path):
    write_tree(
        tmp_path,
        {
            "pkg/costmodel.py": _COSTMODEL_GOOD,
            "pkg/engine.py": _DISPATCH_GOOD,
            "pkg/metrics.py": 'METRIC_REGISTRY = {"kmls_mfu": "gauge:serving"}\n',
        },
    )
    result = run_fixture(tmp_path, _costspec_cfg(), ["costspec"])
    assert keys(result, "costspec") == set()


def test_costspec_flags_unregistered_orphan_unresolvable_and_required(
    tmp_path,
):
    write_tree(
        tmp_path,
        {
            "pkg/costmodel.py": (
                'KERNEL_COST_SPECS = {\n    "mine_count": None,\n}\n'
            ),
            "pkg/engine.py": _DISPATCH_BAD,
            "pkg/metrics.py": 'METRIC_REGISTRY = {"kmls_mfu": "gauge:serving"}\n',
        },
    )
    result = run_fixture(tmp_path, _costspec_cfg(), ["costspec"])
    got = keys(result, "costspec")
    # observed-but-unregistered kernel; spec nothing observes; variable
    # kernel name; the required anchor gone from the registry
    assert "unregistered:serve_renamed" in got
    assert "orphan:mine_count" in got
    assert any(k.startswith("unresolvable:") for k in got), got
    assert "required-missing:serve_fast" in got


def test_costspec_flags_series_missing_from_metric_registry(tmp_path):
    write_tree(
        tmp_path,
        {
            "pkg/costmodel.py": _COSTMODEL_SERIES,
            "pkg/engine.py": (
                'def run(cm):\n'
                '    cm.observe_kernel("serve_fast", 0.5)\n'
            ),
            "pkg/metrics.py": 'METRIC_REGISTRY = {"kmls_mfu": "gauge:serving"}\n',
        },
    )
    result = run_fixture(tmp_path, _costspec_cfg(), ["costspec"])
    got = keys(result, "costspec")
    assert got == {"series-unregistered:kmls_unknown_series"}


def test_costspec_missing_registry_is_one_loud_finding(tmp_path):
    write_tree(
        tmp_path,
        {
            "pkg/costmodel.py": "PEAKS = {}\n",
            "pkg/engine.py": _DISPATCH_GOOD,
        },
    )
    result = run_fixture(tmp_path, _costspec_cfg(), ["costspec"])
    assert keys(result, "costspec") == {"registry-missing"}


def test_costspec_pragma_suppresses_forwarding_helper(tmp_path):
    write_tree(
        tmp_path,
        {
            "pkg/costmodel.py": _COSTMODEL_GOOD,
            "pkg/engine.py": (
                'def run(cm, shape):\n'
                '    cm.observe_kernel("serve_fast", 0.5)\n'
                '    phase_cost("mine_count", p=1)\n'
                'def forward(cm, kernel):\n'
                '    # kmls-verify: allow[costspec] forwarding helper\n'
                '    cm.observe_kernel(kernel, 0.1)\n'
            ),
            "pkg/metrics.py": 'METRIC_REGISTRY = {"kmls_mfu": "gauge:serving"}\n',
        },
    )
    result = run_fixture(tmp_path, _costspec_cfg(), ["costspec"])
    assert keys(result, "costspec") == set()
    assert any(
        f.checker == "costspec" for f in result["suppressed"]
    ), "the forwarding site must be pragma-suppressed, not invisible"


# ---------------------------------------------------------------------------
# checker 9: event-loop blocking
# ---------------------------------------------------------------------------

# the regression class, reconstructed: an asyncio.Protocol callback
# dispatches into a project helper whose body blocks the loop
_LOOPBLOCK_FAULTS = """
    import time

    def fire(site, replica=None):
        time.sleep(0.05)

    def take(site, replica=None):
        return 0.05
    """

_LOOPBLOCK_BAD = """
    import asyncio

    from .faults import fire

    class _Conn(asyncio.Protocol):
        def connection_made(self, transport):
            self.transport = transport

        def data_received(self, data):
            self._dispatch(data)

        def _dispatch(self, data):
            fire("fleet.peer")
            self.transport.write(data)
    """

# the compliant twin — the fixed shape: take() the delay and
# schedule delivery with loop.call_later instead of sleeping inline
_LOOPBLOCK_GOOD = """
    import asyncio

    from .faults import take

    class _Conn(asyncio.Protocol):
        def connection_made(self, transport):
            self.transport = transport

        def data_received(self, data):
            self._dispatch(data)

        def _dispatch(self, data):
            delay = take("fleet.peer")
            loop = asyncio.get_running_loop()
            loop.call_later(delay, self._deliver, data)

        def _deliver(self, data):
            self.transport.write(data)
    """

_LOOPBLOCK_ASYNC = """
    import asyncio
    import pickle

    def load_model(path):
        with open(path, "rb") as fh:
            return pickle.load(fh)

    async def handler(pool, state, fut, path):
        # awaited calls yield, they don't block: exempt — including the
        # coroutine FACTORY handed to an awaited combinator
        await asyncio.wait_for(state.idle.wait(), timeout=1.0)
        # an executor hop ends the loop-context walk: load_model runs
        # on a worker thread even though it blocks
        pool.submit(load_model, path)
        # ...but an inline un-awaited result() IS a loop stall
        return fut.result()
    """


def test_loopblock_flags_protocol_dispatch_blocking(tmp_path):
    """The `_dispatch` stall: blocking reached FROM an asyncio
    protocol callback is flagged with the entry path and root reason."""
    write_tree(
        tmp_path,
        {"pkg/aio.py": _LOOPBLOCK_BAD, "pkg/faults.py": _LOOPBLOCK_FAULTS},
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["loopblock"])
    got = {f.key: f.message for f in result["findings"]}
    assert "time.sleep@fire" in got, got
    message = got["time.sleep@fire"]
    assert "_dispatch -> fire" in message
    assert "asyncio protocol callback on _Conn" in message


def test_loopblock_quiet_on_call_later_shape(tmp_path):
    write_tree(
        tmp_path,
        {"pkg/aio.py": _LOOPBLOCK_GOOD, "pkg/faults.py": _LOOPBLOCK_FAULTS},
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["loopblock"])
    assert result["findings"] == []


def test_loopblock_awaited_exempt_executor_escapes_result_flagged(
    tmp_path,
):
    write_tree(tmp_path, {"pkg/aio.py": _LOOPBLOCK_ASYNC})
    result = run_fixture(tmp_path, fixture_cfg(), ["loopblock"])
    got = keys(result, "loopblock")
    # the inline fut.result() on the loop is the ONLY finding: the
    # awaited .wait() is exempt and load_model escaped to the executor
    assert got == {".result()@handler"}, got


def test_loopblock_pragma_suppresses(tmp_path):
    bad = _LOOPBLOCK_FAULTS.replace(
        "time.sleep(0.05)",
        "time.sleep(0.05)  # kmls-verify: allow[loopblock] fixture",
    )
    write_tree(
        tmp_path, {"pkg/aio.py": _LOOPBLOCK_BAD, "pkg/faults.py": bad}
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["loopblock"])
    assert "time.sleep@fire" not in keys(result)
    assert any(
        f.key == "time.sleep@fire" for f in result["suppressed"]
    )


def test_loopblock_baseline_round_trip(tmp_path):
    write_tree(
        tmp_path,
        {"pkg/aio.py": _LOOPBLOCK_BAD, "pkg/faults.py": _LOOPBLOCK_FAULTS},
    )
    cfg = fixture_cfg()
    first = run_fixture(tmp_path, cfg, ["loopblock"])
    assert first["findings"]
    baseline_path = str(tmp_path / "baseline.json")
    write_baseline(baseline_path, first["findings"])
    second = run_fixture(
        tmp_path, cfg, ["loopblock"], baseline=load_baseline(baseline_path)
    )
    assert second["findings"] == []
    assert len(second["baselined"]) == len(first["findings"])


# ---------------------------------------------------------------------------
# checker 10: lock-ownership race inference
# ---------------------------------------------------------------------------

_LOCKOWN_BAD = """
    import threading

    class Tracker:
        def __init__(self):
            self._lock = threading.Lock()
            self._count = 0
            self._label = ""

        def incr(self):
            with self._lock:
                self._count += 1

        def read(self):
            with self._lock:
                return self._count

        def reset(self):
            self._count = 0
    """

_LOCKOWN_GOOD = """
    import threading

    class Tracker:
        def __init__(self):
            self._lock = threading.Lock()
            self._count = 0
            self._hint = 0

        def incr(self):
            with self._lock:
                self._count += 1
                self._roll_locked()

        def read(self):
            with self._lock:
                return self._count

        def _roll_locked(self):
            # `*_locked` handoff convention: caller holds the lock
            self._count = 0

        def hint(self):
            with self._lock:
                self._hint = 1

        def guess(self):
            # one guarded access is below the evidence bar: no owner is
            # inferred for _hint, so this write must NOT be flagged
            self._hint = 2
    """


def test_lockown_flags_unguarded_write_with_majority_owner(tmp_path):
    write_tree(tmp_path, {"pkg/state.py": _LOCKOWN_BAD})
    result = run_fixture(tmp_path, fixture_cfg(), ["lockown"])
    got = {f.key: f.message for f in result["findings"]}
    assert set(got) == {"unguarded:_count@Tracker.reset"}, got
    # the message names the inferred owning lock and the evidence count
    assert "Tracker._lock" in got["unguarded:_count@Tracker.reset"]
    # _label has no post-__init__ accesses: never voted, never flagged
    assert not any("_label" in k for k in got)


def test_lockown_quiet_on_locked_suffix_and_thin_evidence(tmp_path):
    write_tree(tmp_path, {"pkg/state.py": _LOCKOWN_GOOD})
    result = run_fixture(tmp_path, fixture_cfg(), ["lockown"])
    assert result["findings"] == []


def test_lockown_unguarded_reads_are_not_findings(tmp_path):
    # a snapshot read outside the lock is deliberate policy, not a race
    bad = _LOCKOWN_BAD.replace(
        "def reset(self):\n            self._count = 0",
        "def reset(self):\n            return self._count + 1",
    )
    write_tree(tmp_path, {"pkg/state.py": bad})
    result = run_fixture(tmp_path, fixture_cfg(), ["lockown"])
    assert result["findings"] == []


def test_lockown_pragma_suppresses(tmp_path):
    bad = _LOCKOWN_BAD.replace(
        "self._count = 0",
        "self._count = 0  # kmls-verify: allow[lockown] fixture",
    )
    write_tree(tmp_path, {"pkg/state.py": bad})
    result = run_fixture(tmp_path, fixture_cfg(), ["lockown"])
    assert result["findings"] == []
    assert any(
        f.key == "unguarded:_count@Tracker.reset"
        for f in result["suppressed"]
    )


# ---------------------------------------------------------------------------
# checker 11: env reads at import/compile time
# ---------------------------------------------------------------------------

_ENVREAD_CONFIG = """
    KNOB_REGISTRY: dict[str, str] = {
        "KMLS_DEADLINE_S": "serving",
        "KMLS_TOPK": "serving",
    }
    """

# the frozen-knob bug class: module-level reads freeze the knob at import
_ENVREAD_BAD = """
    import os

    DEADLINE = float(os.environ.get("KMLS_DEADLINE_S", "1200"))
    MODE = os.getenv("KMLS_MODE", "hybrid")

    def fn():
        return DEADLINE
    """

_ENVREAD_JIT = """
    import os

    import torch

    @torch.compile
    def kernel(x):
        k = int(os.environ["KMLS_TOPK"])
        return x * k

    def outer(x):
        return torch.compile(impl)(x)

    def impl(x):
        return float(os.getenv("KMLS_SCALE", "1.0")) * x
    """

_ENVREAD_GOOD = """
    import os

    DEADLINE_DEFAULT = 1200.0

    def deadline():
        return float(
            os.environ.get("KMLS_DEADLINE_S", str(DEADLINE_DEFAULT))
        )

    def kernel_host(x):
        return deadline() * x
    """


def test_envread_flags_import_time_reads_with_knob_scope(tmp_path):
    write_tree(
        tmp_path,
        {"pkg/bench.py": _ENVREAD_BAD, "pkg/config.py": _ENVREAD_CONFIG},
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["envread"])
    got = {f.key: f.message for f in result["findings"]}
    assert set(got) == {
        "import-time:KMLS_DEADLINE_S",
        "import-time:KMLS_MODE",
    }, got
    # the registered knob's scope is cross-checked into the message; the
    # unregistered one is called out as missing from KNOB_REGISTRY
    assert "serving-scope knob" in got["import-time:KMLS_DEADLINE_S"]
    assert "not in KNOB_REGISTRY" in got["import-time:KMLS_MODE"]


def test_envread_flags_reads_inside_compiled_functions(tmp_path):
    write_tree(
        tmp_path,
        {"pkg/ops.py": _ENVREAD_JIT, "pkg/config.py": _ENVREAD_CONFIG},
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["envread"])
    got = keys(result, "envread")
    # both root shapes: @torch.compile decorator AND in-function
    # torch.compile(fn)
    assert got == {"jit:KMLS_TOPK@kernel", "jit:KMLS_SCALE@impl"}, got


def test_envread_quiet_on_lazy_call_time_reads(tmp_path):
    write_tree(
        tmp_path,
        {"pkg/bench.py": _ENVREAD_GOOD, "pkg/config.py": _ENVREAD_CONFIG},
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["envread"])
    assert result["findings"] == []


def test_envread_sees_project_helper_calls_at_module_scope(tmp_path):
    write_tree(
        tmp_path,
        {
            "pkg/config.py": (
                "import os\n\n"
                "def getenv_int(name, default):\n"
                "    return int(os.getenv(name, str(default)))\n"
            ),
            "pkg/serve.py": (
                "from .config import getenv_int\n\n"
                'LIMIT = getenv_int("KMLS_LIMIT", 4)\n\n'
                "def ok():\n"
                '    return getenv_int("KMLS_LIMIT", 4)\n'
            ),
        },
    )
    result = run_fixture(
        tmp_path,
        fixture_cfg(
            envread_helper_functions=("pkg/config.py::getenv_int",)
        ),
        ["envread"],
    )
    # the module-scope helper call is flagged; the call-time one is not
    assert keys(result, "envread") == {"import-time:KMLS_LIMIT"}


# ---------------------------------------------------------------------------
# baseline round-trip + CLI gate
# ---------------------------------------------------------------------------


def test_baseline_round_trip(tmp_path):
    write_tree(tmp_path, {"pkg/serve.py": _HOTPATH_BAD})
    cfg = fixture_cfg()
    first = run_fixture(tmp_path, cfg, ["hotpath"])
    assert first["findings"]
    baseline_path = str(tmp_path / "baseline.json")
    write_baseline(baseline_path, first["findings"])
    baseline = load_baseline(baseline_path)
    second = run_fixture(tmp_path, cfg, ["hotpath"], baseline=baseline)
    assert second["findings"] == []
    assert len(second["baselined"]) == len(first["findings"])
    # the baseline pins EXISTING findings only: a fresh violation in the
    # same tree must still fail the gate
    write_tree(
        tmp_path,
        {
            "pkg/serve.py": _HOTPATH_BAD.replace(
                "return helper(batch)",
                "open('/tmp/x', 'r')\n            return helper(batch)",
            )
        },
    )
    third = run_fixture(tmp_path, cfg, ["hotpath"], baseline=baseline)
    assert "open@Batcher.dispatch" in keys(third)


def test_write_baseline_keeps_unselected_checkers_pins(tmp_path):
    """--write-baseline with a --checker subset must not un-pin the
    checkers it didn't run (CLI passes them via keep_entries)."""
    path = str(tmp_path / "baseline.json")
    write_tree(tmp_path, {"pkg/serve.py": _HOTPATH_BAD})
    first = run_fixture(tmp_path, fixture_cfg(), ["hotpath"])
    write_baseline(path, first["findings"])
    from kmlserver_tpu_torch.analysis.core import load_baseline_entries

    prior = load_baseline_entries(path)
    assert prior
    # a "knobs-only" rewrite with no knobs findings must keep them
    write_baseline(path, [], keep_entries=prior)
    assert load_baseline(path) == {e["fingerprint"] for e in prior}


def test_atomic_flags_writes_in_closures_and_module_level(tmp_path):
    """A bare pickle.dump hidden in a nested closure (or at module
    level) must still fail the gate — the closure exemption is a hotpath
    design stance, not an atomic-write one."""
    write_tree(
        tmp_path,
        {
            "pkg/mine.py": """
                import pickle

                def publish(obj, path):
                    def _w():
                        with open(path, "wb") as fh:
                            pickle.dump(obj, fh)
                    _w()

                with open("/tmp/side-effect", "a") as fh:
                    fh.write("x")
                """
        },
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["atomic-write"])
    got = keys(result, "atomic-write")
    assert "pickle.dump@publish" in got
    assert "open(mode='a')@<module>" in got


def test_knobs_docstring_mentions_do_not_count_as_reads(tmp_path):
    """A knob mentioned only in prose is an orphan (nothing reads it),
    and a knob-shaped token in a docstring demands no registry entry."""
    _knobs_tree(tmp_path)
    write_tree(
        tmp_path,
        {
            "pkg/serve.py": '''
                """Module docs mention KMLS_GOOD_KNOB and invent
                KMLS_DOCSTRING_ONLY_KNOB — neither is a read."""

                def helper():
                    """KMLS_ORPHAN_KNOB in prose is not a read either."""
                    return 1
                ''',
        },
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["knobs"])
    got = keys(result, "knobs")
    assert "orphan:KMLS_GOOD_KNOB" in got
    assert "orphan:KMLS_ORPHAN_KNOB" in got
    assert not any("KMLS_DOCSTRING_ONLY_KNOB" in k for k in got)


def test_fault_sites_pairs_nested_getenv_inject(tmp_path):
    """`inject("s", times=int(os.getenv(...)))` on one line must pair
    the knob with ITS OWN inject, not drift to a neighbor."""
    write_tree(
        tmp_path,
        {
            "pkg/faults.py": """
                import os

                def inject(site, times=1):
                    pass

                def fire(site, replica=None):
                    pass

                def load_env():
                    inject("engine.boom", times=int(os.getenv("KMLS_FAULT_WIRED") or 1))
                    raw = os.getenv("KMLS_FAULT_OTHER")
                    if raw:
                        inject("other.site", times=int(raw))
                """,
            "pkg/engine.py": _FAULTS_FIRE_SITE,
            "tests/test_chaos.py": (
                'X = ("KMLS_FAULT_WIRED", "KMLS_FAULT_OTHER")\n'
            ),
        },
    )
    from kmlserver_tpu_torch.analysis.registries import collect_fault_env_map

    cfg = fixture_cfg()
    index = ProjectIndex.from_config(str(tmp_path), cfg)
    env_map = collect_fault_env_map(index, cfg)
    assert env_map["KMLS_FAULT_WIRED"][0] == "engine.boom"
    assert env_map["KMLS_FAULT_OTHER"][0] == "other.site"


def test_exit_codes_accepts_second_fatal_code_when_policied(tmp_path):
    """A new fatal code with a matching FailJob rule is NOT a finding;
    the fatal set is derived (non-zero, non-retryable), not name-bound
    to EXIT_FATAL_CONFIG."""
    job = _JOB_PY.replace(
        "EXIT_FATAL_CONFIG = 64", "EXIT_FATAL_CONFIG = 64\n    EXIT_FATAL_DATA = 65"
    )
    good = _JOB_YAML_GOOD.replace("[64]", "[64, 65]")
    write_tree(tmp_path, {"pkg/job.py": job, "k8s/job.yaml": good})
    result = run_fixture(tmp_path, fixture_cfg(), ["exit-codes"])
    assert result["findings"] == []
    # …and without the manifest rule, it IS a finding
    write_tree(
        tmp_path, {"pkg/job.py": job, "k8s/job.yaml": _JOB_YAML_GOOD}
    )
    result = run_fixture(tmp_path, fixture_cfg(), ["exit-codes"])
    assert any(
        k.startswith("failjob-mismatch")
        for k in keys(result, "exit-codes")
    )


def test_baseline_file_is_valid_and_documented():
    with open(BASELINE, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    assert data["version"] == 1
    for entry in data["findings"]:
        assert entry["fingerprint"].count("::") == 2


# ---------------------------------------------------------------------------
# torch host syncs on the dispatch path
# ---------------------------------------------------------------------------

_TORCH_DISPATCH = """
    import numpy as np
    import torch

    def stage(rows, dev):
        host = torch.full((rows, 8), -1, dtype=torch.int32, pin_memory=True)
        arr = host.numpy()  # a host (pinned) tensor: no sync
        arr[0, 0] = 3
        return host.to(dev, non_blocking=True)

    def lookup(seeds):
        neg = torch.tensor(-3.0e38, device=seeds.device)
        best = seeds.max().item()
        torch.cuda.synchronize()
        return torch.where(seeds >= 0, seeds, neg), best

    class Batcher:
        def dispatch(self, rows, dev):
            return lookup(stage(rows, dev))
    """


def test_hotpath_flags_torch_host_syncs_but_not_host_numpy(tmp_path):
    write_tree(tmp_path, {"pkg/serve.py": _TORCH_DISPATCH})
    result = run_fixture(tmp_path, fixture_cfg(), ["hotpath"])
    assert keys(result, "hotpath") == {
        "torch.tensor(device=)@lookup",
        ".item()@lookup",
        "torch.cuda.synchronize@lookup",
    }


@pytest.mark.parametrize(
    "line, key",
    [
        ("x = seeds.tolist()", ".tolist()@lookup"),
        ("x = seeds.cpu()", ".cpu()@lookup"),
        ("x = done.synchronize()", ".synchronize()@lookup"),
        ("x = fut.result()", ".result()@lookup"),
        ("x = torch.as_tensor(seeds, device=dev)", "torch.as_tensor(device=)@lookup"),
        ("x = torch.tensor(seeds, device=dev)", "torch.tensor(device=)@lookup"),
    ],
)
def test_hotpath_torch_construct(tmp_path, line, key):
    write_tree(tmp_path, {"pkg/serve.py": f"""
        import torch

        def lookup(seeds, done, fut, dev):
            {line}
            return x

        class Batcher:
            def dispatch(self, seeds, done, fut, dev):
                return lookup(seeds, done, fut, dev)
        """})
    result = run_fixture(tmp_path, fixture_cfg(), ["hotpath"])
    assert keys(result, "hotpath") == {key}


@pytest.mark.parametrize(
    "line",
    [
        "x = torch.tensor(seeds)",  # a host tensor: no copy to the card
        "x = torch.full((2, 2), -3.0e38, device=dev)",  # a fill, no copy
        "x = torch.where(seeds >= 0, seeds, -3.0e38)",  # a Python scalar
        "x = seeds.to(dev, non_blocking=True)",  # from pinned memory
        "x = seeds.numpy()",  # raises on a card tensor, never syncs
    ],
)
def test_hotpath_quiet_on_sync_free_torch(tmp_path, line):
    write_tree(tmp_path, {"pkg/serve.py": f"""
        import torch

        def lookup(seeds, dev):
            {line}
            return x

        class Batcher:
            def dispatch(self, seeds, dev):
                return lookup(seeds, dev)
        """})
    result = run_fixture(tmp_path, fixture_cfg(), ["hotpath"])
    assert result["findings"] == []


def test_hotpath_reaches_a_lookup_only_through_its_anchor(tmp_path):
    """A lookup handed to the dispatch as a callable PARAMETER is beyond
    the call graph; anchoring it as an entry of its own brings it in."""
    write_tree(tmp_path, {"pkg/serve.py": """
        import torch

        def embed_lookup(seeds):
            return torch.tensor(0.0, device=seeds.device) + seeds

        class Engine:
            def _enqueue(self, lookup, seeds):
                return lookup(seeds)

            def dispatch(self, seeds):
                return self._enqueue(embed_lookup, seeds)
        """})
    cfg = fixture_cfg(hotpath_entries=("pkg/serve.py::Engine.dispatch",))
    assert run_fixture(tmp_path, cfg, ["hotpath"])["findings"] == []
    cfg = fixture_cfg(hotpath_entries=("pkg/serve.py::Engine.dispatch",
                                       "pkg/serve.py::embed_lookup"))
    got = keys(run_fixture(tmp_path, cfg, ["hotpath"]), "hotpath")
    assert got == {"torch.tensor(device=)@embed_lookup"}


def test_locks_flag_a_device_sync_under_a_hot_lock(tmp_path):
    write_tree(tmp_path, {"pkg/serve.py": """
        import threading

        import torch

        class Cache:
            def __init__(self):
                self._lock = threading.Lock()

            def get(self, done):
                with self._lock:
                    torch.cuda.synchronize()
                    done.synchronize()
        """})
    got = keys(run_fixture(tmp_path, fixture_cfg(), ["locks"]), "locks")
    assert got == {
        "block:Cache._lock:torch.cuda.synchronize@Cache.get",
        "block:Cache._lock:.synchronize()@Cache.get",
    }


def test_envread_compile_decorator_with_options_is_a_root(tmp_path):
    write_tree(tmp_path, {
        "pkg/ops.py": """
            import os
            from functools import partial

            import torch

            @torch.compile(mode="max-autotune")
            def kernel(x):
                return x * int(os.environ["KMLS_TOPK"])

            @partial(torch.compile, dynamic=False)
            def other(x):
                return x * float(os.getenv("KMLS_SCALE", "1"))

            def eager(x):
                return x * int(os.environ["KMLS_TOPK"])
            """,
        "pkg/config.py": _ENVREAD_CONFIG,
    })
    got = keys(run_fixture(tmp_path, fixture_cfg(), ["envread"]), "envread")
    assert got == {"jit:KMLS_TOPK@kernel", "jit:KMLS_SCALE@other"}


# ---------------------------------------------------------------------------
# KNOBS_ABSENT and the port-only test scope
# ---------------------------------------------------------------------------


def test_knobs_absent_keys_are_no_reads_and_a_read_is_flagged(tmp_path):
    _knobs_tree(tmp_path)
    write_tree(tmp_path, {
        "pkg/config.py": """
            KNOB_REGISTRY: dict[str, str] = {
                "KMLS_GOOD_KNOB": "serving",
                "KMLS_BOTH_WAYS": "tool",
            }
            KNOBS_ABSENT: dict[str, str] = {
                "KMLS_NOT_PORTED": "the reference's only",
                "KMLS_GREW_BACK": "the reference's only",
                "KMLS_BOTH_WAYS": "listed twice",
            }
            """,
        "pkg/serve.py": """
            import os

            def read():
                return (os.getenv("KMLS_GOOD_KNOB"), os.getenv("KMLS_GREW_BACK"),
                        os.getenv("KMLS_BOTH_WAYS"))
            """,
        "README.md": "KMLS_GOOD_KNOB KMLS_BOTH_WAYS\n",
    })
    got = keys(run_fixture(tmp_path, fixture_cfg(), ["knobs"]), "knobs")
    # the absent dict's own keys neither count as reads nor demand entries
    assert got == {"absent-but-read:KMLS_GREW_BACK", "absent-and-declared:KMLS_BOTH_WAYS"}


def test_fault_sites_count_only_the_configured_test_files(tmp_path):
    """A chaos test outside ``tests_globs`` (the reference's, for the
    port) does not exercise the port's knob."""
    write_tree(tmp_path, {
        "pkg/faults.py": _FAULTS_GOOD,
        "pkg/engine.py": _FAULTS_FIRE_SITE,
        "tests/test_chaos.py": 'X = "KMLS_FAULT_WIRED"\n',
    })
    cfg = fixture_cfg(tests_globs=("test_torch_*.py", "torch_*util.py"))
    assert keys(run_fixture(tmp_path, cfg, ["fault-sites"])) == {"untested:KMLS_FAULT_WIRED"}
    write_tree(tmp_path, {"tests/torch_chaos_util.py": 'X = "engine.boom"\n'})
    assert run_fixture(tmp_path, cfg, ["fault-sites"])["findings"] == []


# ---------------------------------------------------------------------------
# parity with the reference's analyzer on the shared fixture trees
# ---------------------------------------------------------------------------

_SHARED_TREES = {
    "locks": {"pkg/serve.py": _LOCKS_BAD},
    "locks-interproc": {"pkg/serve.py": _LOCKS_INTERPROC_BAD},
    "atomic-write": {"pkg/mine.py": _ATOMIC_BAD, "pkg/rogue.py": _ATOMIC_ROGUE_RENAME,
                     "pkg/writer.py": _ATOMIC_GOOD_WRITER},
    "knobs": {"pkg/config.py": _KNOBS_CONFIG, "pkg/serve.py": _KNOBS_CODE,
              "README.md": "KMLS_ORPHAN_KNOB only\n", "k8s/deploy.yaml": "x: y\n",
              "k8s/job.yaml": "restartPolicy: Never\n"},
    "fault-sites": {"pkg/faults.py": _FAULTS_DEAD_KNOB, "pkg/engine.py": _FAULTS_FIRE_SITE,
                    "tests/test_chaos.py": "def test_nothing():\n    pass\n"},
    "exit-codes": {"pkg/job.py": _JOB_PY,
                   "k8s/job.yaml": _JOB_YAML_GOOD.replace("[75, 76]", "[75]")},
    "loopblock": {"pkg/aio.py": _LOOPBLOCK_BAD, "pkg/faults.py": _LOOPBLOCK_FAULTS},
    "loopblock-async": {"pkg/aio.py": _LOOPBLOCK_ASYNC},
    "lockown": {"pkg/state.py": _LOCKOWN_BAD},
    "envread": {"pkg/bench.py": _ENVREAD_BAD, "pkg/config.py": _ENVREAD_CONFIG},
}


@pytest.mark.parametrize("tree", sorted(_SHARED_TREES))
def test_findings_equal_the_reference_analyzers(tmp_path, tree):
    """Same tree, same policy → the same findings, lines and
    fingerprints from both packages' analyzers."""
    import kmlserver_tpu.analysis as ref

    write_tree(tmp_path, _SHARED_TREES[tree])
    checker = tree.split("-")[0] if tree not in ("atomic-write", "fault-sites",
                                                 "exit-codes") else tree
    port_cfg = fixture_cfg()
    ref_cfg = ref.AnalysisConfig()
    for field in ("package_dir", "extra_code", "tests_dir", "readme", "manifest_files",
                  "config_file", "faults_file", "job_file", "job_manifests",
                  "atomic_allowed_modules", "atomic_allowed_functions",
                  "durable_rename_function", "rename_allowed_modules",
                  "hotpath_entries", "hot_locks", "knob_scope_manifests"):
        setattr(ref_cfg, field, getattr(port_cfg, field))
    port = run_fixture(tmp_path, port_cfg, [checker])
    want = ref.run_analysis(str(tmp_path), ref_cfg, checkers=[checker],
                            index=ref.ProjectIndex.from_config(str(tmp_path), ref_cfg))
    assert port["findings"], tree
    assert ([(f.fingerprint, f.line, f.severity) for f in port["findings"]]
            == [(f.fingerprint, f.line, f.severity) for f in want["findings"]])


def test_pragma_word_is_the_references():
    import kmlserver_tpu.analysis.core as ref_core
    from kmlserver_tpu_torch.analysis import core

    assert core.PRAGMA_PREFIX == ref_core.PRAGMA_PREFIX == "kmls-verify: allow["


# ---------------------------------------------------------------------------
# the registry against the reference's
# ---------------------------------------------------------------------------


def test_knob_registry_parity_with_the_reference():
    """KNOB_REGISTRY ∪ KNOBS_ABSENT == the reference's KNOB_REGISTRY plus
    the port-only knobs; shared knobs keep the reference's scope; every
    absent knob names its reason."""
    from kmlserver_tpu.config import KNOB_REGISTRY as REF
    from kmlserver_tpu_torch.config import KNOB_REGISTRY, KNOBS_ABSENT

    port_only = {"KMLS_TORCH_DEVICE"}
    assert not set(KNOB_REGISTRY) & set(KNOBS_ABSENT)
    assert set(KNOB_REGISTRY) | set(KNOBS_ABSENT) == set(REF) | port_only
    assert set(KNOBS_ABSENT) <= set(REF)
    for knob, scope in KNOB_REGISTRY.items():
        assert scope == REF.get(knob, scope), knob
    assert KNOB_REGISTRY["KMLS_TORCH_DEVICE"] == "both"
    assert all(isinstance(r, str) and len(r) > 10 for r in KNOBS_ABSENT.values())
    bench = {k for k in KNOBS_ABSENT if k.startswith("KMLS_BENCH_")}
    assert len(bench) == 45
    assert set(KNOBS_ABSENT) - bench == {
        "KMLS_REFERENCE_RACE_COMPAT", "KMLS_BITPACK_IMPL", "KMLS_JAX_CACHE_DIR"}


def test_registry_matches_what_the_port_reads():
    """The checker's own view: every knob the port or chip_smoke.py reads
    is declared, and nothing in KNOBS_ABSENT is read."""
    from kmlserver_tpu_torch.analysis.registries import (
        collect_code_knobs,
        parse_knob_registry,
        parse_knobs_absent,
    )
    from kmlserver_tpu_torch.config import KNOB_REGISTRY, KNOBS_ABSENT

    cfg = AnalysisConfig()
    index = ProjectIndex.from_config(REPO_ROOT, cfg)
    refs = collect_code_knobs(index, cfg)
    scopes, _lines, _line = parse_knob_registry(index, cfg)
    absent, _ = parse_knobs_absent(index, cfg)
    assert scopes == KNOB_REGISTRY and set(absent) == set(KNOBS_ABSENT)
    assert set(refs) == set(scopes)
    assert not set(refs) & set(absent)
    assert any(path == "chip_smoke.py" for path, _ in refs.values())


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------


def test_baseline_file_is_valid_and_empty():
    """The port's baseline starts empty: every finding is fixed or carries
    the reference's pragma at the reference's site."""
    with open(BASELINE, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    assert data["version"] == 1
    assert data["findings"] == []


def test_real_tree_runs_clean():
    """Acceptance: the shipped configuration + baseline yields zero new
    findings on the port's tree — the exact CLI gate."""
    result = run_analysis(
        REPO_ROOT, AnalysisConfig(), baseline=load_baseline(BASELINE)
    )
    assert result["findings"] == [], "\n".join(
        f.render() for f in result["findings"]
    )
    # the suppressions are the reference's pragma sites and the port's
    # one-time kernel build (nvcc and its two renames, reached from the
    # embedding lookup's first launch in a process), and only those
    assert sorted((f.checker, f.file.rsplit("/", 1)[1]) for f in result["suppressed"]) == [
        ("atomic-write", "replay.py"),
        ("hotpath", "cuda_build.py"),
        ("hotpath", "cuda_build.py"),
        ("hotpath", "cuda_build.py"),
        ("loopblock", "aioserver.py"),
        ("loopblock", "app.py"),
        ("loopblock", "app.py"),
        ("loopblock", "batcher.py"),
    ]


def test_real_tree_analyzes_the_port_only():
    cfg = AnalysisConfig()
    index = ProjectIndex.from_config(REPO_ROOT, cfg)
    assert "chip_smoke.py" in index.modules
    assert all(
        p == "chip_smoke.py" or p.startswith("kmlserver_tpu_torch/") for p in index.modules
    )
    for path in cfg.manifest_files + cfg.job_manifests:
        assert os.path.exists(os.path.join(REPO_ROOT, path)), path


def test_real_tree_anchors_exist():
    """Guard the analyzer's blind spots: every configured anchor — dispatch
    entries (those reached through _enqueue's parameter included), hot
    locks, loop entries and cuts, env helpers, writers, dynamic metric
    sources, required cost specs — exists in the port, or a rename would
    silently hollow its checker."""
    cfg = AnalysisConfig()
    index = ProjectIndex.from_config(REPO_ROOT, cfg)
    refs = (
        cfg.hotpath_entries + cfg.loop_entries + cfg.loop_cut_functions
        + cfg.envread_helper_functions + cfg.atomic_allowed_functions
        + (cfg.durable_rename_function,)
        + tuple(ref for ref, _prefix, _scope in cfg.metric_dynamic_sources)
    )
    for ref in refs:
        assert index.function(ref) is not None, ref
    for module in cfg.atomic_allowed_modules + cfg.rename_allowed_modules:
        assert os.path.exists(os.path.join(REPO_ROOT, module.rstrip("/"))), module
    from kmlserver_tpu_torch.analysis.locking import _parse_hot_locks, discover_locks

    locks, aliases = discover_locks(index)
    assert _parse_hot_locks(cfg) <= locks, sorted(
        lk.render() for lk in _parse_hot_locks(cfg) - locks)
    assert "RecommendEngine._staging_lock" not in cfg.hot_locks
    assert any(
        c.attr == "_pipe_cond" and aliases[c].attr == "_n_lock" for c in aliases
    )
    from kmlserver_tpu_torch.analysis.costspec import collect_observe_sites, parse_cost_specs

    specs, _reg_line = parse_cost_specs(index, cfg)
    assert set(cfg.costspec_required) <= set(specs)
    sites, unresolved = collect_observe_sites(index)
    assert unresolved == [], unresolved
    assert set(cfg.costspec_required) <= set(sites), sorted(sites)
    # the engine names both of its rule kernels literally
    assert {path for path, _ in sites["serve_rules"]} == {path for path, _ in sites[
        "serve_sharded"]} == {"kmlserver_tpu_torch/serving/engine.py"}
    # every name the port observes is one the reference's registry knows
    import kmlserver_tpu.analysis as ref

    ref_specs, _ = __import__(
        "kmlserver_tpu.analysis.costspec", fromlist=["parse_cost_specs"]
    ).parse_cost_specs(
        ref.ProjectIndex.from_config(REPO_ROOT, ref.AnalysisConfig()), ref.AnalysisConfig())
    assert set(sites) <= set(ref_specs)


def test_real_tree_indexes_the_things_checkers_depend_on():
    cfg = AnalysisConfig()
    index = ProjectIndex.from_config(REPO_ROOT, cfg)
    from kmlserver_tpu_torch.analysis.registries import (
        collect_fault_env_map,
        collect_fire_sites,
    )

    env_map = collect_fault_env_map(index, cfg)
    assert len(env_map) == 15, env_map
    assert env_map["KMLS_FAULT_EMBED_CORRUPT"][0] == "embed.artifact"
    assert env_map["KMLS_FAULT_DELTA_CORRUPT"][0] == "delta.apply"
    assert env_map["KMLS_FAULT_FLEET_PEER_DELAY_MS"][0] == "fleet.peer"
    assert env_map["KMLS_FAULT_MESH_PEER_DELAY_MS"][0] == "mesh.peer"
    assert env_map["KMLS_FAULT_IO_WRITE"][0] == "io.write"
    assert env_map["KMLS_FAULT_IO_READ"][0] == "io.read"
    assert env_map["KMLS_FAULT_IO_FSYNC"][0] == "io.fsync"
    sites = collect_fire_sites(index, cfg)
    assert {
        "engine.load", "replica.kernel", "ckpt.corrupt", "embed.artifact",
        "delta.apply", "fleet.peer", "mesh.peer", "io.write", "io.read", "io.fsync",
    } <= sites
    from kmlserver_tpu_torch.analysis.metricsreg import (
        collect_exposed_series,
        parse_metric_registry,
    )

    entries, _lines, _line = parse_metric_registry(index, cfg)
    assert len(entries) >= 40, sorted(entries)
    refs = collect_exposed_series(index, cfg)
    assert set(refs) == set(entries), set(refs) ^ set(entries)
    assert any(
        relpath == "kmlserver_tpu_torch/observability/jobmetrics.py"
        for surfaces in refs.values()
        for relpath, _line2, _scope in surfaces
    )


def test_real_tree_concurrency_anchors():
    """The execution-context model's structural roots keep resolving on
    the port: _Conn is an asyncio protocol whose _dispatch runs on the
    loop, the engine pool gives worker-thread context, module singletons
    resolve, and lockown's cross-context classes own discovered locks."""
    cfg = AnalysisConfig()
    index = ProjectIndex.from_config(REPO_ROOT, cfg)
    from kmlserver_tpu_torch.analysis.callgraph import (
        _is_protocol_class,
        classify_contexts,
    )

    assert _is_protocol_class(index, "_Conn")
    ctx = classify_contexts(index, cfg)
    dispatch = "kmlserver_tpu_torch/serving/aioserver.py::_Conn._dispatch"
    assert dispatch in ctx.loop
    assert "protocol callback" in ctx.loop_roots[ctx.loop[dispatch][0]]
    assert ctx.thread
    assert index.module_attr_types.get(
        ("kmlserver_tpu_torch/io/iohealth.py", "MONITOR")) == "IoHealthMonitor"
    from kmlserver_tpu_torch.analysis.locking import discover_locks

    locks, _aliases = discover_locks(index)
    assert {"IoHealthMonitor", "TrafficForecaster"} <= {lock.owner for lock in locks}


def test_real_tree_has_no_compiled_function():
    """The envread checker's compiler-trace sweep finds no root in the
    port: it runs no torch.compile and no CUDA graph. The first one to
    arrive joins the sweep (the fixture tests prove the rule fires)."""
    from kmlserver_tpu_torch.analysis.envread import jit_roots

    index = ProjectIndex.from_config(REPO_ROOT, AnalysisConfig())
    assert jit_roots(index) == {}
    for relpath, mod in index.modules.items():
        text = "\n".join(mod.source_lines)
        assert "torch.cuda.graph(" not in text and "CUDAGraph" not in text, relpath


def test_embed_dispatch_regression_is_caught(tmp_path):
    """Mutation check on a copy of the port: the pageable scalar copy the
    embedding lookup once made on every dispatch is a hotpath finding."""
    import shutil

    shutil.copytree(os.path.join(REPO_ROOT, "kmlserver_tpu_torch"),
                    tmp_path / "kmlserver_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "deploy"))
    path = tmp_path / "kmlserver_tpu_torch" / "ops" / "embed.py"
    text = path.read_text()
    anchor = "    factors_t = item_factors.t()\n"
    assert anchor in text
    path.write_text(text.replace(anchor, anchor + (
        "    neg = torch.tensor(NEG, dtype=item_factors.dtype, "
        "device=item_factors.device)\n")))
    result = run_analysis(str(tmp_path), AnalysisConfig(), checkers=["hotpath"])
    # the torch-op body is embed_topk_plain, which embed_topk calls
    assert keys(result, "hotpath") == {"torch.tensor(device=)@embed_topk_plain"}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(*args, cwd=REPO_ROOT):
    return subprocess.run(
        [sys.executable, "-m", "kmlserver_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd,
        env=dict(os.environ, PYTHONPATH=REPO_ROOT),
    )


def test_cli_exit_codes(tmp_path):
    """0 on the clean tree, 1 on findings, 2 on a usage error — the
    reference CLI's codes, under the same flags."""
    clean = _cli("--checker", "exit-codes")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "0 new finding(s)" in clean.stdout
    # the port's default paths under an empty root: every checker's
    # registry / manifest is missing
    dirty = _cli("--root", str(tmp_path), "--checker", "exit-codes", "--json")
    assert dirty.returncode == 1, dirty.stdout + dirty.stderr
    assert {f["key"] for f in json.loads(dirty.stdout)["findings"]} == {"contract-missing"}
    usage = _cli("--checker", "no-such-checker")
    assert usage.returncode == 2
    help_text = _cli("--help").stdout
    for flag in ("--checker", "--json", "--write-baseline", "--root", "--baseline"):
        assert flag in help_text


def test_cli_whole_tree_and_baseline_round_trip(tmp_path):
    """The whole gate exits 0; --write-baseline into a scratch file pins
    nothing (the tree is clean)."""
    gate = _cli()
    assert gate.returncode == 0, gate.stdout + gate.stderr
    baseline = tmp_path / "baseline.json"
    wrote = _cli("--write-baseline", "--baseline", str(baseline))
    assert wrote.returncode == 0, wrote.stderr
    assert load_baseline(str(baseline)) == set()


_CHECKERS = ["hotpath", "locks", "atomic-write", "knobs", "fault-sites",
             "exit-codes", "metrics", "costspec", "loopblock", "lockown",
             "envread"]


@pytest.mark.parametrize("checker", _CHECKERS)
def test_every_checker_registered(checker):
    from kmlserver_tpu_torch.analysis.core import all_checkers

    assert checker in all_checkers()


def test_checker_names_equal_the_references():
    """Eleven checkers, the reference's names — a dropped registration
    must fail loudly, not silently shrink the gate."""
    from kmlserver_tpu.analysis.core import all_checkers as ref_checkers
    from kmlserver_tpu_torch.analysis.core import all_checkers

    assert len(all_checkers()) == 11
    assert sorted(all_checkers()) == sorted(ref_checkers()) == sorted(_CHECKERS)
