"""Serving observability — counterpart of ``kmlserver_tpu/serving/metrics.py``:
request counters and latency reservoirs exposed in Prometheus text format
at ``GET /metrics``, including the queue-vs-device attribution the
micro-batcher threads through (``kmls_queue_wait_ms`` / ``kmls_device_ms``
/ ``kmls_e2e_ms``, quantiles up to p999), which says WHERE a tail lives
instead of only that one exists.

Series names, types and label sets are the reference's; this module
renders the subset the port's serving front end produces. The fleet,
hedge, slow-peer and forecast series come through the app's robustness
dict, the forecast ones only while a forecaster is armed. The cost-model and SLO blocks come
from ``observability/costmodel.py`` and ``observability/slo.py``; the
mining job's ``job_metrics.prom`` (``observability/jobmetrics.py``) looks
its series up in the same registry.
"""

from __future__ import annotations

import bisect
import threading
import time

# every summary rendered below carries these quantiles; p999 needs the
# larger reservoir to mean anything (16384 samples → ~16 above p999)
_QUANTILES = (0.50, 0.95, 0.99, 0.999)

# The series this module (and the app's robustness dict) renders, as
# "<type>:<scope>" — each name, type and scope as in the reference's
# METRIC_REGISTRY, of which this is a subset.
METRIC_REGISTRY: dict[str, str] = {
    # --- request counters ---
    "kmls_requests_total": "counter:serving",
    "kmls_request_errors_total": "counter:serving",
    "kmls_requests_shed_total": "counter:serving",
    "kmls_requests_by_source": "counter:serving",
    # --- latency: reservoir summaries (windowed per bench run) and
    # fixed-bucket histograms (additive across a fleet) ---
    "kmls_request_latency_seconds": "summary:serving",
    "kmls_queue_wait_ms": "summary:serving",
    "kmls_device_ms": "summary:serving",
    "kmls_e2e_ms": "summary:serving",
    "kmls_queue_wait_seconds": "histogram:serving",
    "kmls_device_seconds": "histogram:serving",
    "kmls_e2e_seconds": "histogram:serving",
    # --- recommendation cache ---
    "kmls_cache_hits_total": "counter:serving",
    "kmls_cache_misses_total": "counter:serving",
    "kmls_cache_evictions_total": "counter:serving",
    "kmls_cache_singleflight_joins_total": "counter:serving",
    "kmls_cache_entries": "gauge:serving",
    "kmls_cache_hit_ratio": "gauge:serving",
    "kmls_cache_selective_invalidations_total": "counter:serving",
    "kmls_cache_invalidated_keys_total": "counter:serving",
    # --- fleet cache affinity (freshness/ring.py): would a rendezvous
    # router have kept the request on this replica ---
    "kmls_cache_affinity_local_total": "counter:serving",
    "kmls_cache_affinity_remote_total": "counter:serving",
    # --- the routing tier (KMLS_FLEET_PEERS): non-owned misses answered
    # here (routing drift) and the ring's size (0 = unarmed) ---
    "kmls_cache_misrouted_total": "counter:serving",
    "kmls_fleet_peers": "gauge:serving",
    # --- dispatch ---
    "kmls_device_dispatch_total": "counter:serving",
    # model-parallel serving: vocab shards of the published bundle, seed ids
    # dispatched per shard, and (on serve-gang members only) the gang's
    # shards by state; {state="missing"} > 0 is the condition /readyz names
    # serve_mesh_shard_missing:<rank>
    "kmls_model_shards": "gauge:serving",
    "kmls_shard_dispatch_total": "counter:serving",
    "kmls_serve_mesh_shards": "gauge:serving",
    # partial frames a gang worker shed because their deadline budget was
    # spent on arrival, and answers merged without a straggler's slab
    "kmls_mesh_expired_on_arrival_total": "counter:serving",
    "kmls_mesh_straggler_degraded_total": "counter:serving",
    # the gang coordinator's hedged merges (won, lost in the grace check,
    # cancelled for want of budget; all 0 with KMLS_HEDGE off) and its
    # slow-rank ladder (KMLS_PEER_SLOW_RATIO)
    "kmls_hedge_wins_total": "counter:serving",
    "kmls_hedge_losses_total": "counter:serving",
    "kmls_hedge_cancelled_total": "counter:serving",
    "kmls_peer_slow_ejections_total": "counter:serving",
    "kmls_peer_slow_readmissions_total": "counter:serving",
    "kmls_peer_slow": "gauge:serving",
    # --- fault tolerance / overload ---
    "kmls_degraded_total": "counter:serving",
    "kmls_degraded_by_reason": "counter:serving",
    "kmls_replica_ejections_total": "counter:serving",
    "kmls_replica_readmissions_total": "counter:serving",
    "kmls_redispatch_total": "counter:serving",
    "kmls_replicas_ejected": "gauge:serving",
    "kmls_utilization": "gauge:serving",
    "kmls_admission_degrade_total": "counter:serving",
    "kmls_deadline_expired_total": "counter:serving",
    "kmls_artifact_quarantines_total": "counter:serving",
    "kmls_reload_failures_total": "counter:serving",
    "kmls_reload_consecutive_failures": "gauge:serving",
    # --- hybrid serving: is the embedding merge live, how many embedding
    # loads degraded to rules only, and the effective blend weight ---
    "kmls_embedding_active": "gauge:serving",
    "kmls_embedding_load_failures_total": "counter:serving",
    "kmls_hybrid_blend_weight": "gauge:serving",
    # --- storage health (io/iohealth.py) ---
    "kmls_io_latency_seconds": "gauge:serving",
    "kmls_io_errors_total": "counter:serving",
    "kmls_io_retries_total": "counter:serving",
    "kmls_disk_free_bytes": "gauge:serving",
    "kmls_storage_slow": "gauge:serving",
    # --- artifact freshness; continuous freshness: delta bundles applied
    # in place vs rejected, the chain position serving, the serving
    # generation's chain length, the newest applied generation's age ---
    "kmls_artifact_age_seconds": "gauge:serving",
    # 1 while the artifact's age is over KMLS_ARTIFACT_MAX_AGE_S (all 0
    # with the bound off): the alertable twin of the age gauge
    "kmls_artifact_stale": "gauge:serving",
    "kmls_delta_applied_total": "counter:serving",
    "kmls_delta_rejected_total": "counter:serving",
    "kmls_delta_seq": "gauge:serving",
    "kmls_freshness_lag_seconds": "gauge:serving",
    "kmls_delta_chain_length": "gauge:serving",
    # --- observability: the decayed event-loop stall estimate the
    # admission ladder also folds in, and span-tracing bookkeeping
    # (began is the zero-cost proof counter) ---
    "kmls_loop_lag_ms": "gauge:serving",
    "kmls_traces_began_total": "counter:serving",
    "kmls_traces_retained_total": "counter:serving",
    "kmls_trace_buffer_entries": "gauge:serving",
    # --- cost attribution (observability/costmodel.py): per-kernel
    # device time + analytic FLOPs/bytes → achieved rates, MFU against
    # the peak table and the roofline class (1 = compute-bound) ---
    "kmls_kernel_device_seconds": "counter:serving",
    "kmls_kernel_dispatches_total": "counter:serving",
    "kmls_kernel_flops_per_second": "gauge:serving",
    "kmls_kernel_bytes_per_second": "gauge:serving",
    "kmls_mfu": "gauge:serving",
    "kmls_kernel_compute_bound": "gauge:serving",
    # first-shape dispatches after publication (unwarmed buckets)
    "kmls_compiles_total": "counter:serving",
    "kmls_costmodel_observations_total": "counter:serving",
    "kmls_costmodel_unspecced_total": "counter:serving",
    # memory: live allocator gauges per card, and the per-artifact tensor
    # residency against the budget
    "kmls_device_bytes_in_use": "gauge:serving",
    "kmls_device_bytes_limit": "gauge:serving",
    "kmls_model_tensor_bytes": "gauge:serving",
    "kmls_device_budget_bytes": "gauge:serving",
    "kmls_device_headroom_bytes": "gauge:serving",
    "kmls_publish_watermark_bytes": "gauge:serving",
    # --- predictive serving (serving/forecast.py), rendered only while
    # the forecaster is armed: the smoothed and predicted arrival rates,
    # their ratio, the observation counter (0 with KMLS_FORECAST=0), the
    # pre-fetches and pre-touches, and the forecast's added lead in
    # kmls_utilization ---
    "kmls_forecast_rate": "gauge:serving",
    "kmls_forecast_predicted_rate": "gauge:serving",
    "kmls_forecast_ratio": "gauge:serving",
    "kmls_forecast_observations_total": "counter:serving",
    "kmls_forecast_prefetch_total": "counter:serving",
    "kmls_forecast_prewarm_total": "counter:serving",
    "kmls_utilization_forecast": "gauge:serving",
    # --- SLO burn rates (observability/slo.py; slo ∈ latency_p99/
    # availability/quality, window ∈ fast/slow) ---
    "kmls_slo_burn_rate": "gauge:serving",
    # --- lifecycle ---
    "kmls_reloads_total": "counter:serving",
    "kmls_finished_loading": "gauge:serving",
    "kmls_uptime_seconds": "gauge:serving",
    # --- mining: the job_metrics.prom textfile (gauges: a batch job's
    # file restarts from scratch every run) ---
    "kmls_job_phase_duration_seconds": "gauge:mining",
    "kmls_job_phase_resumed": "gauge:mining",
    "kmls_job_rows": "gauge:mining",
    "kmls_job_playlists": "gauge:mining",
    "kmls_job_tracks": "gauge:mining",
    "kmls_job_artifact_bytes": "gauge:mining",
    "kmls_job_rule_generation_seconds": "gauge:mining",
    "kmls_job_fencing_token": "gauge:mining",
    "kmls_job_duration_seconds": "gauge:mining",
    "kmls_job_success": "gauge:mining",
    "kmls_job_last_success_timestamp_seconds": "gauge:mining",
    "kmls_job_phase_flops": "gauge:mining",
    "kmls_job_phase_bytes_moved": "gauge:mining",
    # which pair-count family the dispatch chose, {path, source}; always 1
    "kmls_job_count_path": "gauge:mining",
}

# The autoscaling signal: max of pipeline occupancy and admission queue
# pressure (1.0 = at capacity; with a forecaster, plus its bounded lead),
# rendered from the app's robustness dict.
UTILIZATION_SERIES = "kmls_utilization"


class LatencyReservoir:
    """Fixed-size ring of recent latencies; cheap percentile reads."""

    def __init__(self, size: int = 16384):
        self._buf = [0.0] * size
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._buf[self._n % len(self._buf)] = seconds
            self._n += 1

    def percentiles(self, *qs: float) -> list[float]:
        # copy under the lock, sort outside it: holding the observe lock
        # through an O(n log n) sort would stall every recording thread
        with self._lock:
            live = self._buf[: min(self._n, len(self._buf))]
        if not live:
            return [0.0 for _ in qs]
        live.sort()
        return [live[min(int(q * len(live)), len(live) - 1)] for q in qs]

    def reset(self) -> int:
        """Empty the ring → number of observations discarded."""
        with self._lock:
            n = self._n
            self._n = 0
        return n


# default latency buckets (seconds): sub-ms resolution where the serving
# p50 lives, decade coverage out to the deadline/backoff regime. Fixed
# buckets are the point: per-pod `_bucket` counters SUM across replicas.
LATENCY_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class LatencyHistogram:
    """Fixed-bucket Prometheus histogram (`_bucket`/`_sum`/`_count`).

    The reservoirs answer "what is THIS pod's p99 right now" (they reset
    per bench run); the histogram's cumulative bucket counters are
    additive across replicas, so ``histogram_quantile`` over a fleet
    works. Deliberately NOT reset by ``/metrics/reset``."""

    def __init__(self, buckets: tuple[float, ...] = LATENCY_BUCKETS_S):
        self.buckets = tuple(buckets)
        # counts[i] = observations <= buckets[i]; counts[-1] = +Inf band
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        idx = bisect.bisect_left(self.buckets, seconds)
        with self._lock:
            self._counts[idx] += 1
            self._sum += seconds
            self._count += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    def quantile(self, q: float) -> float:
        """Bucket-derived quantile (histogram_quantile semantics: linear
        interpolation inside the winning bucket; the +Inf band answers
        its finite lower edge)."""
        counts, _total_sum, n = self.snapshot()
        if n == 0:
            return 0.0
        target = q * n
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) else lo
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.buckets[-1]

    def render(self, name: str) -> list[str]:
        counts, total_sum, n = self.snapshot()
        lines = [f"# TYPE {name} histogram"]
        cum = 0
        for bound, count in zip(self.buckets, counts):
            cum += count
            lines.append(f'{name}_bucket{{le="{bound:g}"}} {cum}')
        lines += [
            f'{name}_bucket{{le="+Inf"}} {n}',
            f"{name}_sum {total_sum:.6f}",
            f"{name}_count {n}",
        ]
        return lines


class ServingMetrics:
    def __init__(self):
        self.started_at = time.time()
        self.requests_total = 0
        # "embed" / "hybrid" are the second model family's sources, present
        # from the start so the series always exist
        self.requests_by_source = {
            "rules": 0, "embed": 0, "hybrid": 0, "fallback": 0, "empty": 0,
        }
        self.errors_total = 0
        self.shed_total = 0
        # degraded answers by reason, plus the batcher's circuit-breaker
        # events — every recovery event is visible, not just logged
        self.degraded_by_reason: dict[str, int] = {}
        self.replica_ejections_total = 0
        self.replica_readmissions_total = 0
        self.redispatch_total = 0
        self.latency = LatencyReservoir()
        # per-request attribution from the micro-batcher: queue_wait =
        # enqueue→dispatch, device = dispatch→result on the host (device
        # compute + copies + the in-order queue), e2e = enqueue→done
        self.queue_wait = LatencyReservoir()
        self.device = LatencyReservoir()
        self.e2e = LatencyReservoir()
        self.queue_wait_hist = LatencyHistogram()
        self.device_hist = LatencyHistogram()
        self.e2e_hist = LatencyHistogram()
        self._lock = threading.Lock()

    def record(self, source: str, seconds: float) -> None:
        with self._lock:
            self.requests_total += 1
            self.requests_by_source[source] = self.requests_by_source.get(source, 0) + 1
        self.latency.observe(seconds)

    def record_error(self) -> None:
        with self._lock:
            self.errors_total += 1

    def record_shed(self) -> None:
        with self._lock:
            self.shed_total += 1

    def record_degraded(self, reason: str) -> None:
        """A request answered from the popularity fallback with an
        X-KMLS-Degraded header instead of an error."""
        with self._lock:
            self.degraded_by_reason[reason] = (
                self.degraded_by_reason.get(reason, 0) + 1
            )

    def record_replica_ejected(self) -> None:
        with self._lock:
            self.replica_ejections_total += 1

    def record_replica_readmitted(self) -> None:
        with self._lock:
            self.replica_readmissions_total += 1

    def record_redispatch(self, n: int = 1) -> None:
        with self._lock:
            self.redispatch_total += n

    def record_attribution(
        self, queue_wait_s: float, device_s: float, e2e_s: float
    ) -> None:
        self.queue_wait.observe(queue_wait_s)
        self.device.observe(device_s)
        self.e2e.observe(e2e_s)
        self.queue_wait_hist.observe(queue_wait_s)
        self.device_hist.observe(device_s)
        self.e2e_hist.observe(e2e_s)

    def reset_latency(self) -> int:
        """Clear the latency + attribution reservoirs (→ request-latency
        observations discarded), so a harness can window percentiles to
        one replay run. Counters and histograms stay cumulative (scrape-
        delta semantics)."""
        n = self.latency.reset()
        self.queue_wait.reset()
        self.device.reset()
        self.e2e.reset()
        return n

    @staticmethod
    def _summary_ms(name: str, reservoir: LatencyReservoir) -> list[str]:
        values = reservoir.percentiles(*_QUANTILES)
        lines = [f"# TYPE {name} summary"]
        for q, val in zip(_QUANTILES, values):
            lines.append(f'{name}{{quantile="{q:g}"}} {val * 1e3:.4f}')
        return lines

    def render(
        self, reload_counter: int, finished_loading: bool,
        cache=None, dispatch_counts=None, robustness=None, artifact_ages=None,
        io=None, cost=None, slo=None, artifact_stale=None,
        shard_counts=None, mesh_shards=None,
    ) -> str:
        """Prometheus text. ``cache`` (a serving.cache.RecommendCache),
        ``dispatch_counts`` (the engine's per-replica dispatch counters),
        ``robustness`` (a flat dict of engine/batcher state — names ending
        in ``_total`` render as counters, the rest as gauges, all under a
        ``kmls_`` prefix), ``artifact_ages`` (artifact → seconds since
        publication), ``artifact_stale`` (artifact → 0/1, from the same age
        snapshot), ``shard_counts`` (seed ids dispatched per vocab shard,
        sharded and mesh layouts), ``mesh_shards`` (a serve-gang member's
        ``{"serving": n, "missing": m}``), ``io`` (the IO-health monitor's
        snapshot), ``cost``
        (an observability.costmodel.CostModel) and ``slo`` (an
        observability.slo.SloTracker) are optional."""
        p50, p95, p99 = self.latency.percentiles(0.50, 0.95, 0.99)
        uptime = time.time() - self.started_at
        lines = [
            "# TYPE kmls_requests_total counter",
            f"kmls_requests_total {self.requests_total}",
            "# TYPE kmls_request_errors_total counter",
            f"kmls_request_errors_total {self.errors_total}",
            "# TYPE kmls_requests_shed_total counter",
            f"kmls_requests_shed_total {self.shed_total}",
            "# TYPE kmls_requests_by_source counter",
        ]
        for source, count in sorted(self.requests_by_source.items()):
            lines.append(f'kmls_requests_by_source{{source="{source}"}} {count}')
        lines += [
            "# TYPE kmls_request_latency_seconds summary",
            f'kmls_request_latency_seconds{{quantile="0.5"}} {p50:.6f}',
            f'kmls_request_latency_seconds{{quantile="0.95"}} {p95:.6f}',
            f'kmls_request_latency_seconds{{quantile="0.99"}} {p99:.6f}',
        ]
        lines += self._summary_ms("kmls_queue_wait_ms", self.queue_wait)
        lines += self._summary_ms("kmls_device_ms", self.device)
        lines += self._summary_ms("kmls_e2e_ms", self.e2e)
        lines += self.queue_wait_hist.render("kmls_queue_wait_seconds")
        lines += self.device_hist.render("kmls_device_seconds")
        lines += self.e2e_hist.render("kmls_e2e_seconds")
        if cache is not None:
            lines += [
                "# TYPE kmls_cache_hits_total counter",
                f"kmls_cache_hits_total {cache.hits}",
                "# TYPE kmls_cache_misses_total counter",
                f"kmls_cache_misses_total {cache.misses}",
                "# TYPE kmls_cache_evictions_total counter",
                f"kmls_cache_evictions_total {cache.evictions}",
                "# TYPE kmls_cache_singleflight_joins_total counter",
                f"kmls_cache_singleflight_joins_total {cache.singleflight_joins}",
                "# TYPE kmls_cache_entries gauge",
                f"kmls_cache_entries {len(cache)}",
                "# TYPE kmls_cache_hit_ratio gauge",
                f"kmls_cache_hit_ratio {cache.hit_ratio():.4f}",
                "# TYPE kmls_cache_selective_invalidations_total counter",
                f"kmls_cache_selective_invalidations_total {cache.selective_invalidations}",
                "# TYPE kmls_cache_invalidated_keys_total counter",
                f"kmls_cache_invalidated_keys_total {cache.invalidated_keys}",
            ]
        if dispatch_counts:
            # per-replica device dispatch counters: the evidence that the
            # least-loaded dispatcher actually spreads work
            lines.append("# TYPE kmls_device_dispatch_total counter")
            lines += [
                f'kmls_device_dispatch_total{{device="{i}"}} {count}'
                for i, count in enumerate(dispatch_counts)
            ]
        if shard_counts:
            lines.append("# TYPE kmls_shard_dispatch_total counter")
            lines += [
                f'kmls_shard_dispatch_total{{shard="{i}"}} {count}'
                for i, count in enumerate(shard_counts)
            ]
        if mesh_shards:
            # gang members only: serving + missing is the gang size
            lines.append("# TYPE kmls_serve_mesh_shards gauge")
            lines += [
                f'kmls_serve_mesh_shards{{state="{state}"}} {count}'
                for state, count in sorted(mesh_shards.items())
            ]
        with self._lock:
            degraded = dict(self.degraded_by_reason)
            ejections = self.replica_ejections_total
            readmissions = self.replica_readmissions_total
            redispatches = self.redispatch_total
        lines += [
            "# TYPE kmls_degraded_total counter",
            f"kmls_degraded_total {sum(degraded.values())}",
            "# TYPE kmls_degraded_by_reason counter",
        ]
        lines += [
            f'kmls_degraded_by_reason{{reason="{reason}"}} {count}'
            for reason, count in sorted(degraded.items())
        ]
        lines += [
            "# TYPE kmls_replica_ejections_total counter",
            f"kmls_replica_ejections_total {ejections}",
            "# TYPE kmls_replica_readmissions_total counter",
            f"kmls_replica_readmissions_total {readmissions}",
            "# TYPE kmls_redispatch_total counter",
            f"kmls_redispatch_total {redispatches}",
            "# TYPE kmls_reloads_total counter",
            f"kmls_reloads_total {reload_counter}",
            "# TYPE kmls_finished_loading gauge",
            f"kmls_finished_loading {int(finished_loading)}",
            "# TYPE kmls_uptime_seconds gauge",
            f"kmls_uptime_seconds {uptime:.1f}",
        ]
        if cost is not None:
            lines += cost.render_lines()
        if slo is not None:
            lines += slo.render_lines()
        if artifact_ages:
            lines.append("# TYPE kmls_artifact_age_seconds gauge")
            lines += [
                f'kmls_artifact_age_seconds{{artifact="{name}"}} '
                f"{artifact_ages[name]:.3f}"
                for name in sorted(artifact_ages)
            ]
        if artifact_stale:
            lines.append("# TYPE kmls_artifact_stale gauge")
            lines += [
                f'kmls_artifact_stale{{artifact="{name}"}} {int(artifact_stale[name])}'
                for name in sorted(artifact_stale)
            ]
        if io is not None:
            # the IO-health monitor: latency EWMAs as gauges (the
            # conviction's exact inputs), errors by errno, and the 0/1
            # conviction behind /readyz's "storage-slow"
            lines.append("# TYPE kmls_io_latency_seconds gauge")
            lines += [
                f'kmls_io_latency_seconds{{op="{op}"}} {ewma:.6f}'
                for op, ewma in sorted(io.get("latency_s", {}).items())
            ]
            lines.append("# TYPE kmls_io_errors_total counter")
            lines += [
                f'kmls_io_errors_total{{op="{op}",errno="{err}"}} {count}'
                for (op, err), count in sorted(io.get("errors", {}).items())
            ]
            lines += [
                "# TYPE kmls_io_retries_total counter",
                f"kmls_io_retries_total {int(io.get('retries', 0))}",
                "# TYPE kmls_storage_slow gauge",
                f"kmls_storage_slow {int(bool(io.get('storage_slow')))}",
            ]
            free = io.get("disk_free_bytes")
            if free is not None:
                lines += [
                    "# TYPE kmls_disk_free_bytes gauge",
                    f"kmls_disk_free_bytes {int(free)}",
                ]
        if robustness:
            # a dynamic entry colliding with a series rendered above is
            # dropped whole: a second `# TYPE` line for one name is
            # invalid exposition
            typed = {
                line.split(" ", 3)[2]
                for line in lines
                if line.startswith("# TYPE ")
            }
            for name, value in robustness.items():
                full = f"kmls_{name}"
                if full in typed:
                    continue
                typed.add(full)
                mtype = "counter" if name.endswith("_total") else "gauge"
                lines += [f"# TYPE {full} {mtype}", f"{full} {value}"]
        return "\n".join(lines) + "\n"
