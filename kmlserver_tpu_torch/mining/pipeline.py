"""The batch mining job, end to end — counterpart of
``kmlserver_tpu/mining/pipeline.py`` (reference orchestration:
machine-learning/main.py:421-484):

dataset list → rotation index → CSV read → vocab/aux maps → baskets →
mining on the device → artifacts (pickles, npz twin, manifest) → history
append + invalidation-token rewrite, with the reference's progress lines.

The run is split into the reference's checkpointed phases
(``mining/checkpoint.py``):

- **encode** — CSV read, vocab validation and aux maps, basket encoding;
- **mine**   — pair counting and rule-tensor extraction on the device;
- **rules**  — expansion into the reference's pickle dict;
- **embed**  — with ``KMLS_EMBED_ENABLED``: ALS item embeddings over the
  same baskets (``mining/als.py``), published as ``embeddings.npz``.

After each phase the writer rank saves a sha256-manifested checkpoint
keyed by a config + dataset fingerprint; a restarted job resumes from the
last completed phase and publishes the same bytes. All artifact writes
happen in one publication step after the phases, and the token is
rewritten last, so a job that dies mid-run leaves the served set
untouched. Before the phases the writer runs the free-space preflight and
takes the publication lease (``io/artifacts.py PublicationLease``), which
it re-checks before its first artifact write and before the token
rewrite; the manifest records the lease's fencing token, the store is
cleared after publication, and the lease is released on every exit. Over
a rank mesh (reference ``pipeline.py:255-266``) every rank reads the
dataset list, the run index and the store and mines; only rank 0, the
writer, saves checkpoints and publishes. The writer also keeps
``pickles/job_metrics.prom`` (``observability/jobmetrics.py``), rewritten
as each phase completes: phase durations (a resumed phase reports its
checkpointed duration, flagged), the dataset's size, the count route, the
mine and embed phases' analytic FLOPs and bytes, artifact sizes and
success.

With ``KMLS_DELTA_ENABLED`` the job first tries the delta route
(``freshness/delta.py``): over an append-only CSV it publishes a
``delta-<seq>.bundle`` instead of running the phases, records a ``delta``
phase in ``job_metrics.prom`` and compacts the chain once it reaches
``KMLS_DELTA_COMPACT_AFTER`` bundles (``quality/lifecycle.py``). Anything
ineligible falls through to the full pipeline, whose publication retires
the chain and saves the next delta's base state. The eval phase is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import faults
from ..config import BASE_INDEX, MiningConfig
from ..data.csv import read_tracks
from ..io import artifacts, registry
from ..observability import costmodel
from ..observability.jobmetrics import JobMetrics
from ..parallel import layout
from ..parallel.distributed import RankWatchdog, barrier
from ..parallel.mesh import RankMesh, this_rank
from ..quality.lifecycle import manifest_filenames
from ..utils.profiling import format_phases
from ..utils.timeutil import get_current_time_str, get_current_time_str_precise
from . import checkpoint as ckpt_mod
from . import vocab as vocab_mod
from .miner import MiningResult, mine


@dataclasses.dataclass
class JobSummary:
    dataset: str
    run_index: int
    n_rows: int
    n_playlists: int
    n_tracks: int
    n_songs_missing: int
    rule_generation_s: float
    token: str
    artifact_paths: dict[str, str]
    count_path: str | None = None
    # how the count dispatch decided (MiningResult.count_path_source)
    count_path_source: str | None = None
    # popcount kernel launches of THIS run (0 when the mine phase resumed)
    kernel_launches: int = 0
    # phases skipped because a verified checkpoint covered them
    resumed_phases: tuple[str, ...] = ()
    # the publication lease's fencing token (None: lease disabled / reader)
    fencing_token: int | None = None
    # the embed phase's training seconds (None: phase off or skipped)
    als_train_s: float | None = None
    # the chain sequence number when this run published a delta bundle
    # instead of a full artifact set (None: a full publication)
    delta_seq: int | None = None


def _crash_site(phase: str) -> None:
    """Deterministic preemption stand-in: ``KMLS_FAULT_MINE_CRASH_PHASE``
    aborts the job right after ``phase``'s checkpoint is saved."""
    faults.fire(f"mine.crash.{phase}")


def _run_encode_phase(cfg: MiningConfig, selected: str) -> dict:
    """CSV read + vocab validation/aux maps + basket encoding → the encode
    payload (host objects only)."""
    table = read_tracks(selected, cfg.sample_ratio)
    print(
        f"Loaded {len(table)} rows, {table.n_playlists} playlists, "
        f"{table.n_tracks} unique tracks"
    )
    return {
        "n_rows": len(table),
        "artists": vocab_mod.validate_and_map_artists(table),
        "repeated": vocab_mod.extract_repeated_track_names(table),
        "info": vocab_mod.map_track_ids_to_info(table),
        "best": vocab_mod.most_frequent_tracks(table, cfg.top_tracks_save_percentile),
        "baskets": vocab_mod.build_baskets(table),
        # the pid values behind playlist_rows: the delta base state
        # extends them with appended pids without re-reading the CSV
        "pid_values": np.unique(table.pid),
    }


# a stored encode payload without these keys predates the delta route and
# is re-encoded (checkpoint.CheckpointStore.load's ``require``)
ENCODE_KEYS = ("baskets", "pid_values")


def _run_delta_route(cfg: MiningConfig, device) -> JobSummary | None:
    """The delta route (``KMLS_DELTA_ENABLED``) → its summary, or None when
    the run is ineligible and the full pipeline must run. A delta
    publication refreshes ``job_metrics.prom`` (a ``delta`` phase, the
    recount's analytic cost, the bundle's size) and triggers the
    compaction check."""
    from ..freshness import delta as delta_mod
    from ..quality import lifecycle

    # built before the run so an abort still records success=0; it writes
    # nothing until a phase completes, so an ineligible run leaves no trace
    jm = JobMetrics(cfg.pickles_dir) if cfg.job_metrics and this_rank() == 0 else None
    try:
        res = delta_mod.run_delta_job(cfg, device=device)
    except delta_mod.DeltaIneligible as exc:
        print(f"Delta mining ineligible ({exc}); running the full pipeline")
        return None
    except BaseException:
        if jm is not None:
            try:
                jm.finish(False)
            except Exception:
                pass
        raise
    if res.phase_timings:
        print("Delta " + format_phases(res.phase_timings))
    if jm is not None:
        try:
            jm.phase_done("delta", res.duration_s)
            if res.bundle_path:
                flops, moved = costmodel.phase_cost(
                    "delta_recount", p=res.n_playlists, v=res.n_tracks, rows=res.n_touched,
                )
                jm.note_phase_cost("delta", flops, moved)
                jm.note_artifact("delta", res.bundle_path)
            jm.finish(True, rule_generation_s=res.duration_s, fencing_token=res.fencing_token)
        except Exception as exc:
            # the bundle is published: telemetry must not fail the job
            print(f"WARNING: success telemetry skipped ({jm.path}): {exc!r}")
    if res.bundle_path:
        lifecycle.maybe_compact(cfg)
    print(f"Job finished at {get_current_time_str()}")
    return JobSummary(
        dataset=res.dataset,
        run_index=res.run_index,
        n_rows=res.n_new_rows,
        n_playlists=0,
        n_tracks=0,
        n_songs_missing=0,
        rule_generation_s=res.duration_s,
        token=res.base_token,
        artifact_paths={"delta": res.bundle_path} if res.bundle_path else {},
        fencing_token=res.fencing_token,
        delta_seq=res.seq if res.bundle_path else None,
    )


def _save_freshness_state(cfg: MiningConfig, encoded: dict, result: MiningResult,
                          paths: dict[str, str], token: str, run_index: int,
                          selected: str) -> None:
    """After a full publication: retire the chain of the previous
    generation and, with the delta route armed, save the base state the
    next delta extends. Best-effort: the artifacts are already published,
    so a failure here only means the next run re-mines in full."""
    artifacts.retire_delta_chain(cfg.pickles_dir)
    if not cfg.delta_enabled:
        return
    from ..freshness import delta as delta_mod

    try:
        npz_sha = None
        if "rule_tensors" in paths:
            npz_sha = artifacts.file_digest(paths["rule_tensors"])["sha256"]
        delta_mod.save_base_state(
            cfg,
            token=token,
            run_index=run_index,
            dataset_path=selected,
            baskets=encoded["baskets"],
            pid_values=encoded["pid_values"],
            published=delta_mod.published_from_tensors(result.tensors, result.vocab_names),
            npz_sha256=npz_sha,
        )
        print("Freshness base state saved (delta mining armed)")
    except Exception as exc:
        print(f"WARNING: freshness base state skipped: {exc!r}")


def _report_mining(result: MiningResult, cfg: MiningConfig, launches: int) -> None:
    tensors = result.tensors
    if result.pruned_vocab is not None:
        print(
            f"Apriori pruning: {result.n_tracks} -> {result.pruned_vocab} "
            f"candidate tracks before pair counting"
        )
    print(f"Songs without recommendations: {tensors.n_songs_missing}")
    print(f"Time elapsed in rule generation: {result.duration_s:.2f}s")
    if result.phase_timings:
        print(format_phases(result.phase_timings).capitalize())
    if result.count_path:
        print(f"Pair-count path: {result.count_path}")
    if result.itemset_census is not None:
        census = ", ".join(
            f"len {k}: {'not enumerated' if v < 0 else v}"
            for k, v in sorted(result.itemset_census.items())
        )
        print(f"Frequent itemsets — {census}")
    print(f"Popcount kernel launches: {launches}")
    if tensors.overflow_rows:
        print(
            f"WARNING: {tensors.overflow_rows} songs exceeded the "
            f"K_max={cfg.k_max_consequents} consequent capacity (truncated "
            f"to the highest-support rules)"
        )


def _note_mine_metrics(jm: JobMetrics, encoded: dict, result: MiningResult) -> None:
    """The mine's telemetry: the dataset's size, the count route and what
    decided it, and the analytic cost of the phase's dominant kernel — the
    pair-support contraction over the mined shape, or the sparse route's
    nnz-proportional work (the reference's attribution)."""
    jm.set_dataset(rows=encoded["n_rows"], playlists=result.n_playlists,
                   tracks=result.n_tracks)
    if result.count_path:
        jm.note_count_path(result.count_path, result.count_path_source or "")
    if result.count_path and result.count_path.startswith("sparse"):
        flops, moved = costmodel.phase_cost(
            "sparse_count", events=result.sparse_events or 0, nnz=encoded["n_rows"],
            v=result.pruned_vocab or result.n_tracks,
        )
    else:
        flops, moved = costmodel.phase_cost(
            "support_count", p=result.n_playlists, v=result.n_tracks
        )
    jm.note_phase_cost("mine", flops, moved)


def _run_embed_phase(phase, cfg: MiningConfig, baskets, device, mesh,
                     jm: JobMetrics | None) -> dict | None:
    """The checkpointed ``embed`` phase → its payload, or None when the
    HBM-fit guard declined to train (a rules-only generation, said so)."""
    from . import als

    payload = phase("embed", lambda: als.train_embeddings(baskets, cfg, mesh=mesh, device=device))
    if payload.get("item_factors") is None:
        print(f"ALS embed phase skipped: {payload.get('skipped')}")
        return None
    print(
        f"ALS embeddings trained: rank {payload['rank']}, {payload['iters']} iters, "
        f"final loss {payload['final_loss']:.3f} ({payload['duration_s']:.2f}s)"
    )
    if jm is not None:
        # the phase's analytic cost: the half-sweep loop over the dense
        # matrix or over its nnz events (the reference's attribution)
        dims = dict(p=baskets.n_playlists, v=baskets.n_tracks, r=payload["rank"],
                    iters=payload["iters"])
        if payload.get("storage") == "sparse":
            flops, moved = costmodel.phase_cost(
                "als_sweep_sparse", nnz=payload.get("nnz", len(baskets.playlist_rows)), **dims
            )
        else:
            flops, moved = costmodel.phase_cost("als_sweep", **dims)
        jm.note_phase_cost("embed", flops, moved)
    return payload


def _publish(
    cfg: MiningConfig,
    encoded: dict,
    result: MiningResult,
    rules_dict: dict,
    emb_payload: dict | None,
    run_index: int,
    selected: str,
    lease: artifacts.PublicationLease | None,
) -> tuple[str, dict[str, str]]:
    """Write the artifact set, the manifest and the token (writer only,
    lease-fenced) → (token, artifact paths)."""
    if lease is not None:
        # fence point 1: a zombie aborts BEFORE its first write
        lease.check()

    def path_of(filename: str) -> str:
        return os.path.join(cfg.pickles_dir, filename)

    paths = {"artists_mapping": path_of(cfg.artists_mapping_file)}
    artifacts.save_pickle(encoded["artists"], paths["artists_mapping"])
    if encoded["repeated"]:
        # the reference saves this one conditionally (main.py:86-109)
        paths["repeated_tracks"] = path_of(cfg.repeated_tracks_file)
        artifacts.save_pickle(encoded["repeated"], paths["repeated_tracks"])
    paths["track_info"] = path_of(cfg.track_info_file)
    artifacts.save_pickle(encoded["info"], paths["track_info"])
    paths["best_tracks"] = path_of(cfg.best_tracks_file)
    artifacts.save_pickle(encoded["best"], paths["best_tracks"])
    print(
        f"Saved {len(encoded['best'])} best tracks "
        f"(top {cfg.top_tracks_save_percentile:.0%})"
    )
    # the token value exists before the manifest so the manifest can be
    # stamped with the generation it describes
    token_value = get_current_time_str_precise()
    tensors = result.tensors
    paths["recommendations"] = path_of(cfg.recommendations_file)
    artifacts.save_pickle(rules_dict, paths["recommendations"])
    if cfg.write_tensor_artifact:
        paths["rule_tensors"] = artifacts.tensor_artifact_path(paths["recommendations"])
        artifacts.save_rule_tensors(
            paths["rule_tensors"],
            vocab=result.vocab_names,
            rule_ids=tensors.rule_ids,
            rule_counts=tensors.rule_counts,
            item_counts=np.asarray(tensors.item_counts),
            n_playlists=result.n_playlists,
            min_support=cfg.min_support,
            mode=tensors.mode,
            min_confidence=tensors.min_confidence,
            rule_confs64=tensors.rule_confs64,
        )
    if emb_payload is None:
        # embed phase off or skipped: a previous generation's embeddings
        # must not survive into this manifest, against other rules
        artifacts.remove_embeddings(cfg.pickles_dir)
    else:
        paths["embeddings"] = artifacts.embeddings_artifact_path(cfg.pickles_dir)
        artifacts.save_embeddings(
            paths["embeddings"],
            vocab=encoded["baskets"].vocab.names,
            item_factors=emb_payload["item_factors"],
            rank=emb_payload["rank"],
            iters=emb_payload["iters"],
            reg=emb_payload["reg"],
            final_loss=emb_payload["final_loss"],
        )
    artifacts.retire_unpublished(cfg.pickles_dir)
    if cfg.write_manifest:
        paths["manifest"] = artifacts.write_manifest(
            cfg.pickles_dir, manifest_filenames(cfg), token=token_value,
            fencing_token=lease.fencing_token if lease else None,
        )
    if lease is not None:
        # fence point 2: the last instant a zombie can be stopped before
        # the token rewrite makes its set authoritative
        lease.check()
    token = registry.append_history_and_invalidate(
        cfg, run_index, selected, timestamp=token_value
    )
    return token, paths


def run_mining_job(
    cfg: MiningConfig,
    device: str | torch.device = "cuda",
    mesh: RankMesh | None = None,
    watchdog: RankWatchdog | None = None,
) -> JobSummary:
    """One rotation run of the mining job on ``device`` (default ``cuda``;
    raises when no card is present and ``device`` is not ``"cpu"``). With a
    ``mesh`` every rank of it runs this; ``watchdog`` guards the mine."""
    print(f"Job starting at {get_current_time_str()}")
    if cfg.delta_enabled:
        summary = _run_delta_route(cfg, device)
        if summary is not None:
            return summary
    mesh = layout.mining_mesh(cfg, mesh)
    # every rank takes part in the collectives, but only rank 0 touches the
    # shared volume: duplicate history appends would corrupt the rotation
    is_writer = this_rank() == 0
    datasets = registry.get_dataset_list(cfg, persist=is_writer)
    run_index = registry.get_next_run_index(cfg, datasets)
    selected = datasets[run_index - BASE_INDEX]
    print(f"Selected dataset {run_index}/{len(datasets)}: {selected}")
    # every rank reads the store (identical skip decisions keep the
    # collectives aligned); the writer saves. The completed-phase set is
    # snapshotted here.
    store = ckpt_mod.open_store(cfg, selected, run_index, writer=is_writer)
    # every rank has read the rotation state and the store before the
    # writer can append to or retire them: the mine's all-reduce orders
    # that, but a resumed or pruned-to-nothing mine runs no collective
    barrier()
    resumed: list[str] = []
    # pickles/job_metrics.prom, writer rank only like every volume write
    jm = JobMetrics(cfg.pickles_dir) if is_writer and cfg.job_metrics else None

    def phase(name: str, compute, require: tuple[str, ...] = ()):
        """Resume ``name`` from its checkpoint or compute and save it. The
        crash site fires after the save — where a preemption that already
        banked the phase would land. Either way the phase's compute
        duration reaches the telemetry file (a resumed phase's from its
        checkpoint, flagged resumed)."""
        payload = store.load(name, require) if store is not None else None
        if payload is not None:
            resumed.append(name)
            print(f"Resumed phase {name!r} from checkpoint ({store.age_s(name):.0f}s old)")
            if jm is not None:
                jm.phase_done(name, store.duration_s(name), resumed=True)
            return payload
        t_phase = time.perf_counter()
        payload = compute()
        duration_s = time.perf_counter() - t_phase
        if store is not None:
            store.save(name, payload, duration_s=duration_s)
        if jm is not None:
            jm.phase_done(name, duration_s)
        _crash_site(name)
        return payload

    lease = None
    if is_writer:
        # the free-space preflight BEFORE the phases: the next publication
        # is estimated from the last manifest; short → reclaim, still short
        # → StorageExhaustedError (exit 75) rather than a torn publication
        free = artifacts.ensure_free_space(
            cfg.pickles_dir,
            max(artifacts.estimate_publication_bytes(cfg.pickles_dir), cfg.disk_min_free_bytes),
            extra_dirs=ckpt_mod.retired_dirs(cfg),
        )
        print(f"Disk preflight: {free / (1 << 20):.0f} MiB free on PVC")
        if cfg.lease_enabled:
            # taken BEFORE the phases: its heartbeats prove liveness for the
            # whole mine, and a superseding run fences this one out
            lease = artifacts.PublicationLease.acquire(
                cfg.pickles_dir,
                ttl_s=cfg.lease_ttl_s,
                heartbeat_interval_s=cfg.lease_heartbeat_interval_s or None,
                stall_fraction=cfg.lease_stall_fraction,
            )
            lease.start_heartbeat()
            print(f"Publication lease acquired (fencing token {lease.fencing_token})")
    try:
        encoded = phase("encode", lambda: _run_encode_phase(cfg, selected), ENCODE_KEYS)
        baskets = encoded["baskets"]

        def _mine() -> MiningResult:
            if watchdog is not None:
                # a dead or hung peer turns the mine's all-reduce into a
                # forever-hang: bound it
                with watchdog.guard("mine"):
                    return mine(baskets, cfg, device=device, mesh=mesh)
            return mine(baskets, cfg, device=device, mesh=mesh)

        result: MiningResult = phase("mine", _mine)
        launches = 0 if "mine" in resumed else result.kernel_launches
        _report_mining(result, cfg, launches)
        tensors = result.tensors
        if jm is not None:
            _note_mine_metrics(jm, encoded, result)
        rules_dict = phase("rules", lambda: tensors.to_rules_dict(result.vocab_names))
        emb_payload = (
            _run_embed_phase(phase, cfg, baskets, device, mesh, jm) if cfg.embed_enabled else None
        )
        summary = JobSummary(
            dataset=selected,
            run_index=run_index,
            n_rows=encoded["n_rows"],
            n_playlists=result.n_playlists,
            n_tracks=result.n_tracks,
            n_songs_missing=tensors.n_songs_missing,
            rule_generation_s=result.duration_s,
            token="",
            artifact_paths={},
            count_path=result.count_path,
            count_path_source=result.count_path_source,
            kernel_launches=launches,
            resumed_phases=tuple(resumed),
            fencing_token=lease.fencing_token if lease else None,
            als_train_s=emb_payload["duration_s"] if emb_payload is not None else None,
        )
        if not is_writer:
            print(f"Rank {this_rank()}: not the writer; rank 0 publishes")
            print(f"Job finished at {get_current_time_str()}")
            return summary
        token, paths = _publish(
            cfg, encoded, result, rules_dict, emb_payload, run_index, selected, lease
        )
        _save_freshness_state(cfg, encoded, result, paths, token, run_index, selected)
        if store is not None:
            # published: the next rotation run must start fresh
            store.clear()
        if jm is not None:
            # success telemetry LAST. Publication already succeeded, so
            # nothing from telemetry may fail the job or skip the lease
            # release (the abort path would record success=0)
            try:
                for artifact_name, artifact_path in paths.items():
                    jm.note_artifact(artifact_name, artifact_path)
                jm.finish(True, rule_generation_s=result.duration_s,
                          fencing_token=lease.fencing_token if lease else None)
            except Exception as exc:
                print(f"WARNING: success telemetry skipped ({jm.path}): {exc!r}")
        if lease is not None:
            lease.release()
    except BaseException:
        if jm is not None:
            # the abort is telemetry too: success=0 beside the finished
            # phases; nothing from it may mask the abort's cause
            try:
                jm.finish(False)
            except Exception:
                pass
        if lease is not None:
            # a Python-level abort releases: this process writes nothing
            # more, and its successor must not wait out the TTL
            try:
                lease.release()
            except (artifacts.LeaseLostError, OSError):
                pass  # already fenced or unwritable: nothing to hand back
        raise
    finally:
        if lease is not None:
            lease.stop_heartbeat()
    print(f"Job finished at {get_current_time_str()}")
    return dataclasses.replace(summary, token=token, artifact_paths=paths)
