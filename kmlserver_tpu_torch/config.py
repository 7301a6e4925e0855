"""Configuration over the reference's env-var contract — the fields this
slice of the port reads, with the same names, defaults and parsing as
``kmlserver_tpu/config.py`` (``MiningConfig``, ``ServingConfig``).

``KMLS_TORCH_DEVICE`` is the port's own knob: the device the two
``python -m`` entry points run on (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels).
"""

from __future__ import annotations

import dataclasses
import os

from .utils.envfile import load_dotenv

# Columns dropped from the raw CSV before any processing
# (reference: machine-learning/main.py:42).
DROP_COLUMNS = ("duration_ms",)

# First dataset index in the rotation scheme (reference: machine-learning/main.py:46).
BASE_INDEX = 1


def _getenv_int(name: str, default: int) -> int:
    raw = os.getenv(name)
    return int(raw) if raw not in (None, "") else default


def _getenv_float(name: str, default: float) -> float:
    raw = os.getenv(name)
    return float(raw) if raw not in (None, "") else default


def _getenv_bool(name: str, default: bool) -> bool:
    raw = os.getenv(name)
    if raw in (None, ""):
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def _getenv_bitpack_threshold() -> int | str | None:
    """``KMLS_BITPACK_THRESHOLD_ELEMS``: "auto" (HBM-fit dispatch, the
    default), "none"/"never" (dense always), or an explicit element count."""
    raw = os.getenv("KMLS_BITPACK_THRESHOLD_ELEMS")
    if raw in (None, ""):
        return "auto"
    word = raw.strip().lower()
    if word == "auto":
        return "auto"
    if word in ("none", "never"):
        return None
    return int(raw)


def _getenv_hybrid_mode() -> str:
    """``KMLS_HYBRID_MODE``: ``rules``, ``embed`` or ``blend`` (the
    default), case-insensitive. An unrecognized value falls back to
    ``rules`` with a warning — the fail-safe direction: a typo while
    pinning the legacy path must never turn on the hybrid merge."""
    raw = os.getenv("KMLS_HYBRID_MODE")
    if raw in (None, ""):
        return "blend"
    word = raw.strip().lower()
    if word in ("rules", "embed", "blend"):
        return word
    import logging

    logging.getLogger("kmlserver_tpu_torch.serving").warning(
        "KMLS_HYBRID_MODE=%r is not one of rules/embed/blend; serving rules-only", raw,
    )
    return "rules"


def _getenv_blend_weight() -> tuple[float, bool]:
    """``KMLS_HYBRID_BLEND_WEIGHT``: a float, or ``measured`` (serve the
    blend optimum published in ``quality.report.json``) → ``(weight,
    measured)``. An explicit float wins over a report; anything
    unparseable falls back to the default 0.5 with a warning."""
    raw = os.getenv("KMLS_HYBRID_BLEND_WEIGHT")
    if raw in (None, ""):
        return 0.5, False
    if raw.strip().lower() == "measured":
        return 0.5, True
    try:
        return float(raw), False
    except ValueError:
        import logging

        logging.getLogger("kmlserver_tpu_torch.serving").warning(
            "KMLS_HYBRID_BLEND_WEIGHT=%r is neither a float nor 'measured'; "
            "using the default 0.5", raw,
        )
        return 0.5, False


def _getenv_model_layout() -> str:
    """``KMLS_MODEL_LAYOUT``: ``replicated`` (default), ``sharded`` or
    ``auto``, validated by ``parallel.layout.validate_layout`` (a typo
    fails safe to ``replicated``)."""
    from .parallel.layout import validate_layout

    return validate_layout(os.getenv("KMLS_MODEL_LAYOUT", "replicated"))


def torch_device_from_env() -> str:
    """``KMLS_TORCH_DEVICE`` (default ``cuda``)."""
    return os.getenv("KMLS_TORCH_DEVICE") or "cuda"


# ---- the serving entry point's process knobs (reference:
# kmlserver_tpu/serving/server.py, aioserver.py) ----


def http_impl_from_env() -> str:
    """``KMLS_HTTP_IMPL``: ``async`` (the asyncio transport, default) or
    ``threaded`` (the stdlib ``ThreadingHTTPServer``)."""
    impl = os.environ.get("KMLS_HTTP_IMPL", "async").strip().lower()
    return "threaded" if impl == "threaded" else "async"


def gil_switch_s_from_env() -> float | None:
    """``KMLS_GIL_SWITCH_S``: the interpreter's thread switch interval;
    unset leaves the interpreter's default."""
    raw = os.environ.get("KMLS_GIL_SWITCH_S")
    return float(raw) if raw else None


def drain_settle_s_from_env() -> float:
    """``KMLS_DRAIN_SETTLE_S``: how long a SIGTERM drain waits for
    in-flight requests (default 2 s)."""
    return float(os.getenv("KMLS_DRAIN_SETTLE_S") or 2.0)


# ---- the artifact plane's IO knobs, read at call time so a test or an
# operator can change them without a restart (reference:
# kmlserver_tpu/io/artifacts.py, io/iohealth.py) ----


def io_retries_from_env() -> int:
    """``KMLS_IO_RETRIES``: retries of a write that failed with a
    transient errno (EIO, EAGAIN, ESTALE); default 2."""
    return max(_getenv_int("KMLS_IO_RETRIES", 2), 0)


def io_retry_base_s_from_env() -> float:
    """``KMLS_IO_RETRY_BASE_MS``: the first retry's backoff, doubling per
    retry; default 50 ms."""
    return max(_getenv_float("KMLS_IO_RETRY_BASE_MS", 50.0), 0.0) / 1e3


def io_slow_s_from_env(default_ms: float) -> float:
    """``KMLS_IO_SLOW_MS``: the latency EWMA over which the IO-health
    monitor convicts the volume as slow."""
    return _getenv_float("KMLS_IO_SLOW_MS", default_ms) / 1e3


@dataclasses.dataclass(frozen=True)
class MiningConfig:
    """Batch mining job config (reference: machine-learning/main.py:17-49,
    kubernetes/job.yaml:24-40)."""

    base_dir: str = "./api-data"
    datasets_dir: str = ""
    regex_filename: str = "2023_spotify_ds*.csv"
    min_support: float = 0.05
    pickles_folder: str = "pickles"
    recommendations_file: str = "recommendations.pickle"
    best_tracks_file: str = "best_tracks.pickle"
    data_invalidation_file: str = "last_execution.txt"
    top_tracks_save_percentile: float = 0.03
    artists_mapping_file: str = "artistsMapping.pickle"
    repeated_tracks_file: str = "trackNameToRepeatedUris.pickle"
    track_info_file: str = "trackIdsToInfo.pickle"
    datasets_list_file: str = "datasets_list.txt"
    dataset_history_file: str = "dataset_history.csv"
    sample_ratio: float = 1.0
    # max itemset length: 2 reproduces the reference fast path's output;
    # 3/4 add the itemset census and, in confidence mode, the merged
    # multi-antecedent confidences
    max_itemset_len: int = 2
    # padded per-antecedent rule-row capacity (consequents kept per song)
    k_max_consequents: int = 256
    # "support" = the reference fast path's semantics; "confidence" = the
    # dormant slow path's asymmetric pairwise confidence
    confidence_mode: str = "support"
    min_confidence: float = 0.04
    # above this vocabulary size, prune infrequent items (exact, by the
    # Apriori property) before pair counting
    prune_vocab_threshold: int = 512
    # bit-packed vs dense count (mining/miner.py::bitpack_wanted): "auto"
    # (fit the budget below), an int element count, or None (never)
    bitpack_threshold_elems: int | str | None = "auto"
    # device bytes the auto dispatch plans against. The reference's
    # default, kept on an 80 GB card so one configuration dispatches the
    # same in both packages
    hbm_budget_bytes: int = 12 * (1 << 30)
    # "auto" (the measured table, then the heuristic) or a pinned family:
    # "dense", "bitpack", "sparse" (mining/dispatch.py)
    count_path: str = "auto"
    # an alternative measured dispatch table (JSON); empty = the packaged one
    dispatch_table: str = ""
    # baskets longer than this leave the sparse route's pair expansion for
    # the bit-packed sub-count; 0 = the ops/sparse.py default (256)
    sparse_long_basket: int = 0
    write_tensor_artifact: bool = True
    write_manifest: bool = True
    # the optional ``embed`` phase after ``rules`` (mining/als.py): ALS item
    # embeddings over the playlist x track matrix, published as
    # embeddings.npz beside the rule tensors; off by default
    embed_enabled: bool = False
    # factorization rank, alternating sweeps, L2 regularization
    als_rank: int = 32
    als_iters: int = 8
    als_reg: float = 0.1
    # interaction-matrix storage of the half-sweeps: "auto" (dense while the
    # dense f32 matrix fits hbm_budget_bytes, compressed when it does not),
    # "always" or "never"; a typo resolves to "auto" (als.resolve_als_sparse)
    als_sparse: str = "auto"
    # rank mesh for the multi-rank job: "auto" (every rank when the job is
    # distributed, none in a single process), "1x1"/"" (none), "DPxTP",
    # or "hybrid"/"hybrid:tpN" (tp = the ranks of one host)
    mesh_shape: str = "auto"
    # "replicated", "sharded" or "auto" (parallel/layout.py)
    model_layout: str = "replicated"
    # phase checkpoints (mining/checkpoint.py): after encode, mine and
    # rules the writer rank saves the phase's host payload, keyed by a
    # config + dataset fingerprint, and a restarted job resumes from it
    checkpoint_enabled: bool = True
    # the checkpoint store (and the watchdog's heartbeat files); empty =
    # <base_dir>/mining_checkpoint
    checkpoint_dir: str = ""
    # a checkpoint whose bytes verify but fail to unpickle this many
    # consecutive loads is quarantined; 0 disables quarantining
    checkpoint_quarantine_after: int = 2
    # lease-fenced publication (io/artifacts.py PublicationLease): the
    # writer takes a heartbeat lease with a monotonic fencing token before
    # the phases and re-checks it before its first artifact write and
    # before the token rewrite
    lease_enabled: bool = True
    # a lease whose heartbeat is older than this has a dead writer
    lease_ttl_s: float = 60.0
    # heartbeat period; 0 = ttl/3
    lease_heartbeat_interval_s: float = 0.0
    # a heartbeat write slower than this fraction of the TTL self-fences
    # the writer (0 disables)
    lease_stall_fraction: float = 0.5
    # the publication preflight needs max(estimated artifact bytes, this)
    # free on the volume, reclaims, then exits resumable; 0 disables it
    disk_min_free_bytes: int = 64 * (1 << 20)
    # dead-rank watchdog (distributed jobs only): a peer silent for
    # rank_timeout_s aborts the rank with exit 76; 0 disables
    rank_timeout_s: float = 300.0
    rank_heartbeat_interval_s: float = 5.0
    # deadline of one guarded collective section (the mine); 0 = 6 x rank_timeout_s
    collective_timeout_s: float = 1800.0
    # pickles/job_metrics.prom (textfile-collector format), rewritten as
    # each phase completes (observability/jobmetrics.py)
    job_metrics: bool = True
    # continuous freshness (freshness/delta.py): after a full publication
    # the writer saves a base state; a later run over an append-only CSV
    # publishes a delta-<seq>.bundle instead of re-mining everything
    delta_enabled: bool = False
    # at this many bundles on one base the next run re-mines in full; 0 = no cap
    delta_max_chain: int = 16
    # fold the chain into a new base once it holds this many bundles
    # (quality/lifecycle.py); 0 disables compaction
    delta_compact_after: int = 0

    @property
    def pickles_dir(self) -> str:
        return os.path.join(self.base_dir, self.pickles_folder)

    @property
    def checkpoint_path(self) -> str:
        return self.checkpoint_dir or os.path.join(self.base_dir, "mining_checkpoint")

    @staticmethod
    def from_env(dotenv_path: str | None = ".env") -> "MiningConfig":
        if dotenv_path:
            load_dotenv(dotenv_path)
        base_dir = os.getenv("BASE_DIR", "./api-data")
        return MiningConfig(
            base_dir=base_dir,
            datasets_dir=os.getenv("DATASETS_DIR", os.path.join(base_dir, "datasets")),
            regex_filename=os.getenv("REGEX_FILENAME", "2023_spotify_ds*.csv"),
            min_support=_getenv_float("MIN_SUPPORT", 0.05),
            pickles_folder=os.getenv("PICKLES_FOLDER", "pickles"),
            recommendations_file=os.getenv("RECOMMENDATIONS_FILE", "recommendations.pickle"),
            best_tracks_file=os.getenv("BEST_TRACKS_FILE", "best_tracks.pickle"),
            data_invalidation_file=os.getenv("DATA_INVALIDATION_FILE", "last_execution.txt"),
            top_tracks_save_percentile=_getenv_float("TOP_TRACKS_SAVE_PERCENTILE", 0.03),
            artists_mapping_file=os.getenv("ARTISTS_MAPPING_FILE", "artistsMapping.pickle"),
            repeated_tracks_file=os.getenv("REPEATED_TRACKS_FILE", "trackNameToRepeatedUris.pickle"),
            track_info_file=os.getenv("TRACK_INFO_FILE", "trackIdsToInfo.pickle"),
            datasets_list_file=os.getenv("DATASETS_LIST_FILE", "datasets_list.txt"),
            dataset_history_file=os.getenv("DATASET_HISTORY_FILE", "dataset_history.csv"),
            sample_ratio=_getenv_float("SAMPLE_RATIO", 1.0),
            max_itemset_len=_getenv_int("KMLS_MAX_ITEMSET_LEN", 2),
            k_max_consequents=_getenv_int("KMLS_K_MAX_CONSEQUENTS", 256),
            confidence_mode=os.getenv("KMLS_CONFIDENCE_MODE", "support"),
            min_confidence=_getenv_float("KMLS_MIN_CONFIDENCE", 0.04),
            prune_vocab_threshold=_getenv_int("KMLS_PRUNE_VOCAB_THRESHOLD", 512),
            bitpack_threshold_elems=_getenv_bitpack_threshold(),
            hbm_budget_bytes=_getenv_int("KMLS_HBM_BUDGET_BYTES", 12 * (1 << 30)),
            count_path=os.getenv("KMLS_COUNT_PATH", "auto"),
            dispatch_table=os.getenv("KMLS_DISPATCH_TABLE", ""),
            sparse_long_basket=_getenv_int("KMLS_SPARSE_LONG_BASKET", 0),
            write_tensor_artifact=_getenv_bool("KMLS_WRITE_TENSOR_ARTIFACT", True),
            write_manifest=_getenv_bool("KMLS_WRITE_MANIFEST", True),
            embed_enabled=_getenv_bool("KMLS_EMBED_ENABLED", False),
            als_rank=_getenv_int("KMLS_ALS_RANK", 32),
            als_iters=_getenv_int("KMLS_ALS_ITERS", 8),
            als_reg=_getenv_float("KMLS_ALS_REG", 0.1),
            als_sparse=os.getenv("KMLS_ALS_SPARSE", "auto"),
            mesh_shape=os.getenv("KMLS_MESH_SHAPE", "auto"),
            model_layout=_getenv_model_layout(),
            checkpoint_enabled=_getenv_bool("KMLS_CKPT_ENABLED", True),
            checkpoint_dir=os.getenv("KMLS_CKPT_DIR", ""),
            checkpoint_quarantine_after=_getenv_int("KMLS_CKPT_QUARANTINE_AFTER", 2),
            lease_enabled=_getenv_bool("KMLS_LEASE_ENABLED", True),
            lease_ttl_s=_getenv_float("KMLS_LEASE_TTL_S", 60.0),
            lease_heartbeat_interval_s=_getenv_float("KMLS_LEASE_HEARTBEAT_S", 0.0),
            lease_stall_fraction=_getenv_float("KMLS_LEASE_STALL_FRACTION", 0.5),
            disk_min_free_bytes=_getenv_int("KMLS_DISK_MIN_FREE_BYTES", 64 * (1 << 20)),
            rank_timeout_s=_getenv_float("KMLS_RANK_TIMEOUT_S", 300.0),
            rank_heartbeat_interval_s=_getenv_float("KMLS_RANK_HEARTBEAT_S", 5.0),
            collective_timeout_s=_getenv_float("KMLS_COLLECTIVE_TIMEOUT_S", 1800.0),
            job_metrics=_getenv_bool("KMLS_JOB_METRICS", True),
            delta_enabled=_getenv_bool("KMLS_DELTA_ENABLED", False),
            delta_max_chain=_getenv_int("KMLS_DELTA_MAX_CHAIN", 16),
            delta_compact_after=_getenv_int("KMLS_DELTA_COMPACT_AFTER", 0),
        )


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Online API config (reference: rest_api/app/main.py:31-50,
    kubernetes/deployment.yaml:33-53)."""

    version: str = "V1.1"
    base_dir: str = "./api-data/"
    pickle_dir: str = "pickles/"
    # a directory whose templates/ and static/ re-skin the client page
    # (reference: rest_api/app/main.py:44-48, :138)
    app_path_from_root: str = "/app"
    recommendations_file: str = "recommendations.pickle"
    best_tracks_file: str = "best_tracks.pickle"
    data_invalidation_file: str = "last_execution.txt"
    k_best_tracks: int = 10
    polling_wait_in_minutes: float = 5.0
    port: int = 80
    # max seed songs per request that reach the lookup (the rest are cut);
    # seed lengths are bucketed up to it
    max_seed_tracks: int = 128
    # micro-batching window (ms) for grouping concurrent requests into one
    # device call; 0 disables batching. With the adaptive window on, this
    # is the ceiling and the wait follows the observed arrival rate
    batch_window_ms: float = 2.0
    batch_max_size: int = 32
    batch_adaptive_window: bool = True
    batch_window_min_ms: float = 1.0
    # admission ladder: pressure = effective queue wait / this budget (ms).
    # Below soft_ratio admit; up to 1.0 degrade a rising share of misses to
    # the popularity fallback; up to hard_ratio shed a rising share (429);
    # past it shed all. 0 disables admission control
    shed_queue_budget_ms: float = 250.0
    shed_retry_after_s: float = 1.0
    shed_soft_ratio: float = 0.6
    shed_hard_ratio: float = 1.5
    # Retry-After is uniform on base·(1 ± this), so shed clients do not
    # come back in one wave
    shed_retry_jitter: float = 0.5
    # batches dispatched but not finished, per replica
    batch_max_inflight: int = 4
    # serving replicas: 0 = every card (one on the CPU); N > 0 = min(N, cards)
    # (on the CPU, N copies on the host)
    serve_devices: int = 0
    # epoch-keyed answer cache in front of the batcher
    cache_enabled: bool = True
    cache_max_entries: int = 8192
    # load rule tensors from the .npz twin when present (else the pickle)
    prefer_tensor_artifact: bool = True
    # check the artifacts against the mining job's manifest before a bundle
    # publishes: a mismatched pickle aborts the reload (last-good keeps
    # serving), a mismatched npz falls back to the pickle
    verify_manifest: bool = True
    # quarantine an artifact that fails to parse after this many
    # consecutive failed reloads; 0 disables quarantining
    quarantine_after_failures: int = 2
    # backoff between failed reload attempts: base, doubling per
    # consecutive failure, up to max
    reload_backoff_base_s: float = 0.5
    reload_backoff_max_s: float = 30.0
    # deadline on reload-path artifact reads (a hung read fails the reload
    # into the backoff above); 0 = no deadline
    io_read_deadline_s: float = 0.0
    # per-replica circuit breaker: eject after this many consecutive batch
    # failures (0 = off), probe an ejected replica every interval, and
    # re-queue a failed request at most this many times
    replica_eject_threshold: int = 3
    replica_probe_interval_s: float = 5.0
    redispatch_max_retries: int = 3
    # per-request deadline (ms); on exhaustion the answer degrades to the
    # popularity fallback with X-KMLS-Degraded. 0 = no deadline
    request_deadline_ms: float = 0.0
    # budget for the degraded fallback answer itself (ms)
    fallback_budget_ms: float = 50.0
    # per-device bytes the cost model's headroom gauge measures the rule
    # tensors against (the reference's layout budget)
    device_budget_bytes: int = 12 * (1 << 30)
    # span tracing (observability/trace.py): baseline retention probability
    # of OK traces; 0 disables tracing entirely. Shed, degraded and error
    # traces and the slowest trace_slow_n OK ones are always kept, in a
    # ring of trace_buffer entries served at GET /debug/traces
    trace_sample: float = 0.0
    trace_buffer: int = 512
    trace_slow_n: int = 32
    # half-life of the event-loop stall estimate (kmls_loop_lag_ms) the
    # admission ladder folds into its pressure; 0 disables the collector
    loop_lag_half_life_s: float = 1.0
    # per-kernel cost attribution (observability/costmodel.py); off = the
    # engine holds no cost model at all
    costmodel_enabled: bool = True
    # SLO burn rates (observability/slo.py): the p99 target (snapped up to
    # a histogram bucket), the availability and quality budgets, and the
    # fast/slow alerting windows
    slo_p99_ms: float = 25.0
    slo_error_budget: float = 0.001
    slo_degrade_budget: float = 0.01
    slo_fast_window_s: float = 300.0
    slo_slow_window_s: float = 3600.0
    # hybrid rule ∪ embedding serving when embeddings.npz is published:
    # "rules" ignores it, "embed" answers from the embedding top-k (rules
    # only for seeds the embedding vocabulary lacks), "blend" unions both
    # candidate lists. Without a usable artifact every mode serves rules.
    hybrid_mode: str = "blend"
    # blend score = (1 - w)·rule confidence + w·cosine similarity
    hybrid_blend_weight: float = 0.5
    # KMLS_HYBRID_BLEND_WEIGHT=measured: the weight comes from
    # quality.report.json when one is published (else the weight above)
    hybrid_blend_measured: bool = False
    # apply the delta bundles published between full re-mines in place
    # (engine.apply_pending_deltas); off = a chain on the PVC is ignored
    delta_enabled: bool = False
    # rendezvous-hash affinity accounting (freshness/ring.py): count the
    # requests this replica would own among the peers (comma-separated
    # identities; this replica's own, default the hostname, is added)
    cache_affinity: bool = False
    cache_affinity_peers: str = ""
    cache_affinity_self: str = ""

    @property
    def pickles_dir(self) -> str:
        return os.path.join(self.base_dir, self.pickle_dir)

    @staticmethod
    def from_env(dotenv_path: str | None = ".env") -> "ServingConfig":
        if dotenv_path:
            load_dotenv(dotenv_path)
        blend_weight, blend_measured = _getenv_blend_weight()
        return ServingConfig(
            version=os.getenv("VERSION", "V1.1"),
            base_dir=os.getenv("BASE_DIR", "./api-data/"),
            pickle_dir=os.getenv("PICKLE_DIR", "pickles/"),
            app_path_from_root=os.getenv("APP_PATH_FROM_ROOT", "/app"),
            recommendations_file=os.getenv("RECOMMENDATIONS_FILE", "recommendations.pickle"),
            best_tracks_file=os.getenv("BEST_TRACKS_FILE", "best_tracks.pickle"),
            data_invalidation_file=os.getenv("DATA_INVALIDATION_FILE", "last_execution.txt"),
            k_best_tracks=_getenv_int("K_BEST_TRACKS", 10),
            polling_wait_in_minutes=_getenv_float("POLLING_WAIT_IN_MINUTES", 5.0),
            port=_getenv_int("KMLS_PORT", 80),
            max_seed_tracks=_getenv_int("KMLS_MAX_SEED_TRACKS", 128),
            batch_window_ms=_getenv_float("KMLS_BATCH_WINDOW_MS", 2.0),
            batch_max_size=_getenv_int("KMLS_BATCH_MAX_SIZE", 32),
            batch_adaptive_window=_getenv_bool("KMLS_BATCH_ADAPTIVE", True),
            batch_window_min_ms=_getenv_float("KMLS_BATCH_WINDOW_MIN_MS", 1.0),
            shed_queue_budget_ms=_getenv_float("KMLS_SHED_QUEUE_BUDGET_MS", 250.0),
            shed_retry_after_s=_getenv_float("KMLS_SHED_RETRY_AFTER_S", 1.0),
            shed_soft_ratio=_getenv_float("KMLS_SHED_SOFT_RATIO", 0.6),
            shed_hard_ratio=_getenv_float("KMLS_SHED_HARD_RATIO", 1.5),
            shed_retry_jitter=_getenv_float("KMLS_SHED_RETRY_JITTER", 0.5),
            batch_max_inflight=_getenv_int("KMLS_BATCH_MAX_INFLIGHT", 4),
            serve_devices=_getenv_int("KMLS_SERVE_DEVICES", 0),
            cache_enabled=_getenv_bool("KMLS_CACHE_ENABLED", True),
            cache_max_entries=_getenv_int("KMLS_CACHE_MAX_ENTRIES", 8192),
            prefer_tensor_artifact=_getenv_bool("KMLS_PREFER_TENSOR_ARTIFACT", True),
            verify_manifest=_getenv_bool("KMLS_VERIFY_MANIFEST", True),
            quarantine_after_failures=_getenv_int("KMLS_QUARANTINE_AFTER_FAILURES", 2),
            reload_backoff_base_s=_getenv_float("KMLS_RELOAD_BACKOFF_BASE_S", 0.5),
            reload_backoff_max_s=_getenv_float("KMLS_RELOAD_BACKOFF_MAX_S", 30.0),
            io_read_deadline_s=_getenv_float("KMLS_IO_READ_DEADLINE_S", 0.0),
            replica_eject_threshold=_getenv_int("KMLS_REPLICA_EJECT_THRESHOLD", 3),
            replica_probe_interval_s=_getenv_float("KMLS_REPLICA_PROBE_INTERVAL_S", 5.0),
            redispatch_max_retries=_getenv_int("KMLS_REDISPATCH_MAX_RETRIES", 3),
            request_deadline_ms=_getenv_float("KMLS_REQUEST_DEADLINE_MS", 0.0),
            fallback_budget_ms=_getenv_float("KMLS_FALLBACK_BUDGET_MS", 50.0),
            device_budget_bytes=_getenv_int("KMLS_DEVICE_BUDGET_BYTES", 12 * (1 << 30)),
            trace_sample=_getenv_float("KMLS_TRACE_SAMPLE", 0.0),
            trace_buffer=_getenv_int("KMLS_TRACE_BUFFER", 512),
            trace_slow_n=_getenv_int("KMLS_TRACE_SLOW_N", 32),
            loop_lag_half_life_s=_getenv_float("KMLS_LOOP_LAG_HALF_LIFE_S", 1.0),
            costmodel_enabled=_getenv_bool("KMLS_COSTMODEL", True),
            slo_p99_ms=_getenv_float("KMLS_SLO_P99_MS", 25.0),
            slo_error_budget=_getenv_float("KMLS_SLO_ERROR_BUDGET", 0.001),
            slo_degrade_budget=_getenv_float("KMLS_SLO_DEGRADE_BUDGET", 0.01),
            slo_fast_window_s=_getenv_float("KMLS_SLO_FAST_WINDOW_S", 300.0),
            slo_slow_window_s=_getenv_float("KMLS_SLO_SLOW_WINDOW_S", 3600.0),
            hybrid_mode=_getenv_hybrid_mode(),
            hybrid_blend_weight=blend_weight,
            hybrid_blend_measured=blend_measured,
            delta_enabled=_getenv_bool("KMLS_DELTA_ENABLED", False),
            cache_affinity=_getenv_bool("KMLS_CACHE_AFFINITY", False),
            cache_affinity_peers=os.getenv("KMLS_CACHE_AFFINITY_PEERS", ""),
            cache_affinity_self=os.getenv("KMLS_CACHE_AFFINITY_SELF", ""),
        )
