"""Artifact lifecycle — counterpart of ``kmlserver_tpu/quality/lifecycle.py``:
the one manifest file set of a full publication, and the delta-chain
compactor.

Once the delta chain holds ``KMLS_DELTA_COMPACT_AFTER`` bundles, the writer
folds base ∘ chain into a new base without re-mining: the fold is
``freshness/delta.py::apply_delta_to_tensors``, the one application mining
and serving already use, so compacted snapshot == base ∘ chain == full
re-mine holds by construction.

To readers the compaction is an ordinary full publication: a new npz and
recommendations pickle, the manifest re-stamped, the invalidation token
rewritten (the server hot-swaps), the chain retired, and the base state
rolled onto the new token so the next delta extends the compacted base.
The dataset rotation history is not appended: the same logical generation
is re-published, no dataset is mined. The lease is checked before the
first write and before the token rewrite, as every writer does.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np

from ..config import MiningConfig
from ..io import artifacts, registry
from ..utils.timeutil import get_current_time_str_precise


def manifest_filenames(cfg: MiningConfig) -> list[str]:
    """The manifest file set of a full publication (the reference's set),
    shared by the mining pipeline and the compactor."""
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


@dataclasses.dataclass
class CompactionResult:
    """What one compaction did."""

    n_folded: int  # delta bundles folded into the new base
    token: str  # the new invalidation token published
    npz_sha256: str  # digest of the compacted tensor artifact
    duration_s: float


class CompactionIneligible(RuntimeError):
    """The chain cannot be compacted now (none, torn, or bound to a
    generation no longer published): the chain stays."""


def _folded_tensors(cfg: MiningConfig, state: dict[str, Any], token: str) -> dict[str, Any]:
    """The base npz ∘ every chain bundle → the logical tensors, through the
    one application. Any binding or validation failure raises
    :class:`CompactionIneligible`: a torn chain compacts nothing."""
    from ..freshness import delta as delta_mod

    npz_path = artifacts.tensor_artifact_path(
        os.path.join(cfg.pickles_dir, cfg.recommendations_file)
    )
    if not os.path.exists(npz_path):
        raise CompactionIneligible("no tensor artifact to fold onto")
    if artifacts.file_digest(npz_path)["sha256"] != state.get("base_npz_sha256"):
        raise CompactionIneligible("chain bound to different base bytes")
    loaded = artifacts.load_rule_tensors(npz_path)
    if loaded.get("rule_confs64") is not None:
        raise CompactionIneligible("merged-confidence artifact (delta-ineligible lineage)")
    prev: dict[str, Any] = {
        "vocab": list(loaded["vocab"]),
        "rule_ids": np.asarray(loaded["rule_ids"], dtype=np.int32),
        "rule_counts": np.asarray(loaded["rule_counts"], dtype=np.int32),
        "item_counts": np.asarray(loaded["item_counts"], dtype=np.int32),
        "n_playlists": int(loaded["n_playlists"]),
        "min_support": float(loaded["min_support"]),
        "mode": str(loaded["mode"]),
        "min_confidence": float(loaded["min_confidence"]),
    }
    for entry in sorted(state["entries"], key=lambda e: e.get("seq", 0)):
        path = os.path.join(cfg.pickles_dir, str(entry.get("file", "")))
        try:
            bundle = artifacts.load_delta_bundle(path, expect_sha256=entry.get("sha256"))
            if bundle["base_token"] != token:
                raise ValueError("bundle bound to another generation")
            prev = delta_mod.apply_delta_to_tensors(prev, bundle)
        except (OSError, ValueError) as exc:
            raise CompactionIneligible(f"chain entry {entry.get('seq')} unusable: {exc}")
    return prev


def compact_delta_chain(cfg: MiningConfig) -> CompactionResult:
    """Fold the current chain into a new base (writer side, lease-fenced).
    Raises :class:`CompactionIneligible` when there is nothing sound to
    compact."""
    t0 = time.perf_counter()
    state = artifacts.read_delta_state(cfg.pickles_dir)
    if state is None or not state.get("entries"):
        raise CompactionIneligible("no delta chain on the PVC")
    token_path = registry.token_path_for(cfg.base_dir, cfg.data_invalidation_file)
    try:
        token = artifacts.read_text(token_path)
    except FileNotFoundError:
        raise CompactionIneligible("no invalidation token on the PVC")
    if state.get("base_token") != token:
        raise CompactionIneligible("chain bound to another generation")

    folded = _folded_tensors(cfg, state, token)

    lease = None
    if cfg.lease_enabled:
        lease = artifacts.PublicationLease.acquire(
            cfg.pickles_dir,
            ttl_s=cfg.lease_ttl_s,
            heartbeat_interval_s=cfg.lease_heartbeat_interval_s or None,
        )
        lease.start_heartbeat()
        print(f"Compaction lease acquired (fencing token {lease.fencing_token})")
    try:
        if lease is not None:
            lease.check()  # fence point 1: before the first write
        new_token = get_current_time_str_precise()
        rec_path = os.path.join(cfg.pickles_dir, cfg.recommendations_file)
        npz_path = artifacts.tensor_artifact_path(rec_path)
        # the pickle twin through the one expansion a load of the npz uses,
        # so npz and pickle cannot drift
        artifacts.save_pickle(
            artifacts.rules_dict_from_tensors({**folded, "rule_confs64": None}), rec_path
        )
        artifacts.save_rule_tensors(
            npz_path,
            vocab=folded["vocab"],
            rule_ids=folded["rule_ids"],
            rule_counts=folded["rule_counts"],
            item_counts=folded["item_counts"],
            n_playlists=folded["n_playlists"],
            min_support=folded["min_support"],
            mode=folded["mode"],
            min_confidence=folded["min_confidence"],
        )
        npz_sha = artifacts.file_digest(npz_path)["sha256"]
        if cfg.write_manifest:
            artifacts.write_manifest(
                cfg.pickles_dir, manifest_filenames(cfg), token=new_token,
                fencing_token=lease.fencing_token if lease else None,
            )
        if lease is not None:
            lease.check()  # fence point 2: before the token rewrite
        # no history append: the rotation must not advance for a re-publication
        artifacts.atomic_write_text(token_path, new_token)
        artifacts.retire_delta_chain(cfg.pickles_dir)
        # the next delta extends the compacted base (its `published` is
        # already base ∘ chain: the delta route rolled it per bundle)
        from ..freshness import delta as delta_mod

        base = delta_mod.load_base_state(cfg.pickles_dir)
        if base is not None and base.get("token") == token:
            base["token"] = new_token
            base["npz_sha256"] = npz_sha
            base["published"] = folded
            artifacts.save_pickle(base, delta_mod.base_state_path(cfg.pickles_dir))
        if lease is not None:
            lease.release()
        duration = time.perf_counter() - t0
        print(
            f"Delta chain compacted: {len(state['entries'])} bundles folded into a "
            f"new base ({duration:.2f}s, token {new_token})"
        )
        return CompactionResult(
            n_folded=len(state["entries"]), token=new_token, npz_sha256=npz_sha,
            duration_s=duration,
        )
    except BaseException:
        if lease is not None:
            lease.stop_heartbeat()
            try:
                lease.release()
            except (artifacts.LeaseLostError, OSError):
                pass
        raise
    finally:
        if lease is not None:
            lease.stop_heartbeat()


def maybe_compact(cfg: MiningConfig) -> CompactionResult | None:
    """The pipeline's trigger: compact once the chain holds
    ``delta_compact_after`` bundles (0 disables). Never raises: a skipped
    compaction keeps the chain, the next delta re-triggers, and
    ``delta_max_chain`` stays the backstop."""
    threshold = cfg.delta_compact_after
    if threshold <= 0:
        return None
    state = artifacts.read_delta_state(cfg.pickles_dir)
    if state is None or len(state.get("entries", ())) < threshold:
        return None
    try:
        return compact_delta_chain(cfg)
    except CompactionIneligible as exc:
        print(f"Delta compaction skipped ({exc})")
        return None
    except artifacts.LeaseHeldError as exc:
        print(f"Delta compaction deferred (lease held: {exc})")
        return None
    except Exception as exc:
        print(f"WARNING: delta compaction failed: {exc!r}")
        return None
