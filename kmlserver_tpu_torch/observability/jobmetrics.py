"""Mining-side telemetry: ``pickles/job_metrics.prom`` in the Prometheus
textfile format — counterpart of
``kmlserver_tpu/observability/jobmetrics.py``.

The mining job is a batch pod with no ``/metrics`` to scrape; the
node-exporter *textfile collector* reads a file the job writes instead.
The file is rewritten after every phase through the port's durable writer
(``io/artifacts.atomic_write_text``: temp file + rename, so a scrape
never reads a torn file), so a preempted job leaves the telemetry of the
phases it finished, and a resumed job reports the compute it skipped as
``kmls_job_phase_resumed``. Every series name is looked up in
``serving.metrics.METRIC_REGISTRY`` at render time (KeyError = an
unregistered series). The file stays out of ``artifacts.manifest.json``:
it keeps changing through the run.
"""

from __future__ import annotations

import logging
import os
import time

from ..io import artifacts
from ..serving.metrics import METRIC_REGISTRY

logger = logging.getLogger("kmlserver_tpu_torch.mining")

JOB_METRICS_FILENAME = "job_metrics.prom"


def _fmt(value: float) -> str:
    # integers render without a trailing .0
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


class JobMetrics:
    """One mining run's counters, rewritten atomically as they move.
    Writer rank only."""

    def __init__(self, pickles_dir: str):
        self.path = os.path.join(pickles_dir, JOB_METRICS_FILENAME)
        self.t_start = time.time()
        # phase -> {"duration_s": float, "resumed": bool}
        self.phases: dict[str, dict] = {}
        self.dataset: dict[str, float] = {}
        self.artifact_bytes: dict[str, int] = {}
        # phase -> (flops, bytes_moved) from costmodel.phase_cost: the same
        # formulas the serving MFU uses
        self.phase_cost: dict[str, tuple[float, float]] = {}
        self.rule_generation_s: float | None = None
        self.fencing_token: int | None = None
        # (count_path, source) of the measured dispatch
        self.count_path: tuple[str, str] | None = None
        self.success = 0

    # ---------- accumulation ----------

    def phase_done(self, name: str, duration_s: float, resumed: bool = False) -> None:
        """Record one pipeline phase (a resumed phase reports the ORIGINAL
        compute duration from its checkpoint, flagged ``resumed=1``), then
        persist."""
        self.phases[name] = {"duration_s": max(duration_s, 0.0), "resumed": bool(resumed)}
        self.write()

    def set_dataset(self, rows: int, playlists: int, tracks: int) -> None:
        self.dataset = {
            "kmls_job_rows": rows,
            "kmls_job_playlists": playlists,
            "kmls_job_tracks": tracks,
        }

    def note_phase_cost(self, phase: str, flops: float, bytes_moved: float) -> None:
        """Attach the analytic FLOPs/bytes of ``phase``'s dominant kernel,
        then persist."""
        self.phase_cost[phase] = (max(flops, 0.0), max(bytes_moved, 0.0))
        self.write()

    def note_count_path(self, path: str, source: str) -> None:
        """Record which pair-count family the dispatch chose and why, then
        persist."""
        self.count_path = (path, source)
        self.write()

    def note_artifact(self, name: str, path: str) -> None:
        try:
            self.artifact_bytes[name] = os.path.getsize(path)
        except OSError:
            pass

    def finish(
        self,
        success: bool,
        rule_generation_s: float | None = None,
        fencing_token: int | None = None,
    ) -> None:
        self.success = int(bool(success))
        if rule_generation_s is not None:
            self.rule_generation_s = rule_generation_s
        if fencing_token is not None:
            self.fencing_token = fencing_token
        self.write()

    # ---------- exposition ----------

    @staticmethod
    def _type_of(name: str) -> str:
        # KeyError here is an unregistered series
        return METRIC_REGISTRY[name].split(":", 1)[0]

    def render(self) -> str:
        lines: list[str] = []

        def series(name: str, value: float, labels: str = "") -> None:
            if not any(line.startswith(f"# TYPE {name} ") for line in lines):
                lines.append(f"# TYPE {name} {self._type_of(name)}")
            lines.append(f"{name}{labels} {_fmt(value)}")

        for phase in sorted(self.phases):
            series("kmls_job_phase_duration_seconds",
                   self.phases[phase]["duration_s"], f'{{phase="{phase}"}}')
        for phase in sorted(self.phases):
            series("kmls_job_phase_resumed",
                   int(self.phases[phase]["resumed"]), f'{{phase="{phase}"}}')
        for phase in sorted(self.phase_cost):
            series("kmls_job_phase_flops", self.phase_cost[phase][0], f'{{phase="{phase}"}}')
        for phase in sorted(self.phase_cost):
            series("kmls_job_phase_bytes_moved", self.phase_cost[phase][1],
                   f'{{phase="{phase}"}}')
        if self.count_path is not None:
            series("kmls_job_count_path", 1,
                   f'{{path="{self.count_path[0]}",source="{self.count_path[1]}"}}')
        for name, value in self.dataset.items():
            series(name, value)
        for artifact in sorted(self.artifact_bytes):
            series("kmls_job_artifact_bytes", self.artifact_bytes[artifact],
                   f'{{artifact="{artifact}"}}')
        if self.rule_generation_s is not None:
            series("kmls_job_rule_generation_seconds", self.rule_generation_s)
        if self.fencing_token is not None:
            series("kmls_job_fencing_token", self.fencing_token)
        series("kmls_job_duration_seconds", time.time() - self.t_start)
        series("kmls_job_success", self.success)
        if self.success:
            series("kmls_job_last_success_timestamp_seconds", time.time())
        return "\n".join(lines) + "\n"

    def write(self) -> None:
        # a KeyError from an unregistered series propagates: render first
        text = self.render()
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            # atomic, but not durable: telemetry needs no fsync per phase,
            # and the next run regenerates a file lost to a crash
            artifacts.atomic_write_text(self.path, text, durable=False)
        except OSError as exc:
            # best-effort by contract: a transient volume error on this
            # file must never fail a run whose artifacts are fine
            logger.warning("job_metrics write skipped (%s): %s", self.path, exc)
