"""The batch mining job, end to end — counterpart of
``kmlserver_tpu/mining/pipeline.py`` (reference orchestration:
machine-learning/main.py:421-484):

dataset list → rotation index → CSV read → vocab/aux maps → baskets →
mining on the device → artifacts (pickles, npz twin, manifest) → history
append + invalidation-token rewrite, with the reference's progress lines.

All artifact writes happen in one publication step after the compute, and
the token is rewritten last, so a job that dies mid-run leaves the served
artifact set untouched. Checkpoints, the publication lease, job metrics and
the delta/embed/eval phases are not part of this slice.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..config import BASE_INDEX, MiningConfig
from ..data.csv import read_tracks
from ..io import artifacts, registry
from ..utils.timeutil import get_current_time_str, get_current_time_str_precise
from . import vocab as vocab_mod
from .miner import MiningResult, format_phases, mine


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
    kernel_launches: int = 0


def manifest_filenames(cfg: MiningConfig) -> list[str]:
    """The manifest file set of a full publication (the reference's set)."""
    return [
        cfg.best_tracks_file,
        cfg.recommendations_file,
        cfg.recommendations_file + artifacts.TENSOR_ARTIFACT_SUFFIX,
        cfg.artists_mapping_file,
        cfg.track_info_file,
        cfg.repeated_tracks_file,
        artifacts.EMBEDDINGS_FILENAME,
        artifacts.QUALITY_REPORT_FILENAME,
    ]


def _report_mining(result: MiningResult, cfg: MiningConfig) -> None:
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
    print(f"Popcount kernel launches: {result.kernel_launches}")
    if tensors.overflow_rows:
        print(
            f"WARNING: {tensors.overflow_rows} songs exceeded the "
            f"K_max={cfg.k_max_consequents} consequent capacity (truncated "
            f"to the highest-support rules)"
        )


def run_mining_job(
    cfg: MiningConfig, device: str | torch.device = "cuda"
) -> JobSummary:
    """One rotation run of the mining job on ``device`` (default ``cuda``;
    raises when no card is present and ``device`` is not ``"cpu"``)."""
    print(f"Job starting at {get_current_time_str()}")
    datasets = registry.get_dataset_list(cfg)
    run_index = registry.get_next_run_index(cfg, datasets)
    selected = datasets[run_index - BASE_INDEX]
    print(f"Selected dataset {run_index}/{len(datasets)}: {selected}")

    table = read_tracks(selected, cfg.sample_ratio)
    print(
        f"Loaded {len(table)} rows, {table.n_playlists} playlists, "
        f"{table.n_tracks} unique tracks"
    )
    artists = vocab_mod.validate_and_map_artists(table)
    repeated = vocab_mod.extract_repeated_track_names(table)
    info = vocab_mod.map_track_ids_to_info(table)
    best = vocab_mod.most_frequent_tracks(table, cfg.top_tracks_save_percentile)
    baskets = vocab_mod.build_baskets(table)

    result = mine(baskets, cfg, device=device)
    _report_mining(result, cfg)
    tensors = result.tensors
    rules_dict = tensors.to_rules_dict(result.vocab_names)

    # ---------- publication ----------
    def path_of(filename: str) -> str:
        return os.path.join(cfg.pickles_dir, filename)

    paths = {"artists_mapping": path_of(cfg.artists_mapping_file)}
    artifacts.save_pickle(artists, paths["artists_mapping"])
    if repeated:
        # the reference saves this one conditionally (main.py:86-109)
        paths["repeated_tracks"] = path_of(cfg.repeated_tracks_file)
        artifacts.save_pickle(repeated, paths["repeated_tracks"])
    paths["track_info"] = path_of(cfg.track_info_file)
    artifacts.save_pickle(info, paths["track_info"])
    paths["best_tracks"] = path_of(cfg.best_tracks_file)
    artifacts.save_pickle(best, paths["best_tracks"])
    print(
        f"Saved {len(best)} best tracks "
        f"(top {cfg.top_tracks_save_percentile:.0%})"
    )
    # the token value exists before the manifest so the manifest can be
    # stamped with the generation it describes
    token_value = get_current_time_str_precise()
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
    artifacts.retire_unpublished(cfg.pickles_dir)
    if cfg.write_manifest:
        paths["manifest"] = artifacts.write_manifest(
            cfg.pickles_dir, manifest_filenames(cfg), token=token_value
        )
    token = registry.append_history_and_invalidate(
        cfg, run_index, selected, timestamp=token_value
    )
    print(f"Job finished at {get_current_time_str()}")
    return JobSummary(
        dataset=selected,
        run_index=run_index,
        n_rows=len(table),
        n_playlists=result.n_playlists,
        n_tracks=result.n_tracks,
        n_songs_missing=tensors.n_songs_missing,
        rule_generation_s=result.duration_s,
        token=token,
        artifact_paths=paths,
        count_path=result.count_path,
        kernel_launches=result.kernel_launches,
    )
