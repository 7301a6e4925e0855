"""Phase-level mining checkpoints — counterpart of
``kmlserver_tpu/mining/checkpoint.py``.

The mining job is killed on every GitOps resync and preempted at will, so
after each expensive phase the writer rank persists the phase's host-side
payload to the PVC, and a restarted job resumes from the last completed
phase and publishes byte-identical artifacts. Payloads are host numpy
(the rule tensors, the baskets), so a checkpoint written on the card
resumes on the CPU and the other way round.

Correctness is guarded on three axes, as in the reference:

- **fingerprint**: the store is keyed by a sha256 over the mining-relevant
  config fields, the selected dataset's bytes and the rotation index. A
  checkpoint written for another config or dataset never resumes — the
  store self-retires to full recompute (stale state, deleted rather than
  quarantined). The identity also names this package: the reference keeps
  its store in the same directory, and its payloads are pickles of the
  JAX package's classes, which this package must never unpickle — a
  reference store reads as a fingerprint mismatch and is retired unread.
- **integrity**: each payload is pickled, written through the shared
  durable writer (``io.artifacts._atomic_write_bytes``) and manifested
  with size + sha256 in the store's ``state.json``. Bytes that disagree
  with it (a torn write, bit rot) retire that phase on the spot.
- **parse strikes**: bytes that verify but fail to unpickle are a poison
  payload (``KMLS_FAULT_CKPT_CORRUPT`` writes exactly this). After
  ``quarantine_after`` consecutive failures the file moves to the
  quarantine dir (``io.artifacts.quarantine_file``).

Multi-rank discipline: every rank reads the store (the completed-phase set
is snapshotted once at job start, so all ranks make the same skip
decisions); only the writer rank saves.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import time
from typing import Any

from .. import faults
from ..config import MiningConfig
from ..io import artifacts
from ..io.artifacts import _atomic_write_bytes, file_digest, quarantine_file

# ordered checkpoint phases of the mining pipeline (mining/pipeline.py):
# encode — CSV read + vocab/aux maps + basket encoding
# mine   — pair counting + rule-tensor extraction (the device compute)
# rules  — expansion of the rule tensors into the reference's pickle dict
# embed  — ALS item embeddings (mining/als.py), with KMLS_EMBED_ENABLED
# eval   — offline evaluation on a held-out split (quality/eval.py), with
#          KMLS_EVAL_ENABLED; its payload is the published quality report
PHASES = ("encode", "mine", "rules", "embed", "eval")
# the phases this package's pipeline runs at the default config
RUN_PHASES = PHASES[:3]


def run_phases(cfg: MiningConfig) -> tuple[str, ...]:
    """The phases the pipeline runs under ``cfg``: :data:`RUN_PHASES`,
    then ``embed`` and ``eval`` when each is enabled."""
    return (
        RUN_PHASES
        + (("embed",) if cfg.embed_enabled else ())
        + (("eval",) if cfg.eval_enabled else ())
    )

STATE_FILENAME = "state.json"
# the reference's checkpoint format version (its v6 identity fields)
CKPT_VERSION = 6
# the identity key that tells this package's stores from the reference's
PACKAGE = "kmlserver_tpu_torch"

# MiningConfig fields that can change the bytes of the final artifacts or
# of a phase payload — the reference's list. Anything not listed (the count
# route, the device, the popcount knobs) selects another route to the same
# exact result, so a checkpoint survives a card-to-CPU restart.
_FINGERPRINT_FIELDS = (
    "model_layout",
    "min_support",
    "sample_ratio",
    "top_tracks_save_percentile",
    "max_itemset_len",
    "k_max_consequents",
    "confidence_mode",
    "min_confidence",
    "prune_vocab_threshold",
    "embed_enabled",
    "als_rank",
    "als_iters",
    "als_reg",
    "als_sparse",
    "delta_enabled",
    "eval_enabled",
    "eval_holdout_n",
    "eval_k",
    "eval_max_playlists",
)


def fingerprint_identity(
    cfg: MiningConfig, dataset_path: str, run_index: int
) -> dict[str, Any]:
    """The config + dataset identity a checkpoint is keyed by: the
    reference's identity dict plus :data:`PACKAGE`."""
    ident: dict[str, Any] = {
        "version": CKPT_VERSION,
        "package": PACKAGE,
        "run_index": run_index,
        "dataset": os.path.basename(dataset_path),
        "dataset_digest": file_digest(dataset_path),
    }
    for field in _FINGERPRINT_FIELDS:
        ident[field] = getattr(cfg, field)
    if cfg.model_layout != "replicated":
        # the shard topology joins the identity as in the reference; the
        # replicated default omits it so a card-to-CPU restart resumes
        from ..parallel.mesh import world_ranks

        ident["shard_topology"] = len(world_ranks())
    return ident


def compute_fingerprint(
    cfg: MiningConfig, dataset_path: str, run_index: int
) -> str:
    blob = json.dumps(
        fingerprint_identity(cfg, dataset_path, run_index), sort_keys=True
    ).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()


@dataclasses.dataclass
class ResumeInfo:
    """What :meth:`CheckpointStore.load` actually did, for the job log."""

    phase: str
    age_s: float


class CheckpointStore:
    """One mining run's phase checkpoints under ``directory``.

    ``writer=False`` (non-zero ranks of a multi-rank job) reads but never
    mutates the shared store — no saves, no retires, no strike counting.
    """

    def __init__(
        self,
        directory: str,
        fingerprint: str,
        quarantine_after: int = 2,
        writer: bool = True,
    ):
        self.directory = directory
        self.fingerprint = fingerprint
        self.quarantine_after = quarantine_after
        self.writer = writer
        self._state = self._load_state()
        # snapshotted ONCE: phases completed by a PREVIOUS incarnation.
        # Mid-run saves are deliberately not re-read — on a multi-rank job
        # every rank must make identical skip decisions from identical
        # state, or the collectives desynchronize.
        self.completed: frozenset[str] = frozenset(self._state["phases"])

    # ---------- state file ----------

    def _state_path(self) -> str:
        return os.path.join(self.directory, STATE_FILENAME)

    def _phase_path(self, phase: str) -> str:
        return os.path.join(self.directory, f"{phase}.ckpt")

    def _load_state(self) -> dict[str, Any]:
        empty: dict[str, Any] = {
            "version": CKPT_VERSION,
            "fingerprint": self.fingerprint,
            "phases": {},
        }
        try:
            with open(self._state_path(), "r", encoding="utf-8") as fh:
                state = json.load(fh)
            if not isinstance(state.get("phases"), dict):
                raise ValueError("malformed checkpoint state")
        except FileNotFoundError:
            return empty
        except (OSError, ValueError):
            # unreadable state: nothing in the store can be trusted
            print("Mining checkpoint state unreadable — retiring to full recompute")
            self._retire_all()
            return empty
        if state.get("fingerprint") != self.fingerprint or state.get(
            "version"
        ) != CKPT_VERSION:
            # a different config/dataset/format wrote this: STALE, not
            # corrupt — delete rather than quarantine, recompute fully
            print(
                "Mining checkpoint fingerprint mismatch (config or dataset "
                "changed) — ignoring and retiring the stale checkpoint"
            )
            self._retire_all()
            return empty
        return state

    def _write_state(self) -> None:
        _atomic_write_bytes(
            self._state_path(),
            json.dumps(self._state, indent=1, sort_keys=True).encode("utf-8"),
        )

    def _retire_all(self) -> None:
        if not self.writer:
            return
        try:
            for name in os.listdir(self.directory):
                if name == STATE_FILENAME or name.endswith(".ckpt"):
                    try:
                        os.unlink(os.path.join(self.directory, name))
                    except OSError:
                        pass
        except OSError:
            pass

    def _drop_phase(self, phase: str) -> None:
        """Retire one phase to recompute (torn/rotted bytes). Writer only —
        a reader rank must not mutate the shared store."""
        if not self.writer:
            return
        try:
            os.unlink(self._phase_path(phase))
        except OSError:
            pass
        if self._state["phases"].pop(phase, None) is not None:
            self._write_state()

    # ---------- the phase API ----------

    def load(self, phase: str, require: tuple[str, ...] = ()) -> Any | None:
        """The phase's verified payload, or None → recompute.

        None paths: never completed; digest mismatch (torn/rotted bytes —
        phase retires immediately); unpickle failure (strike; quarantined
        after ``quarantine_after`` consecutive strikes); a dict payload
        lacking a key of ``require`` (written by an older format of the
        phase — retired to recompute, like torn bytes)."""
        if phase not in self.completed:
            return None
        entry = self._state["phases"].get(phase)
        path = self._phase_path(phase)
        if entry is None or not os.path.exists(path):
            return None
        try:
            digest = file_digest(path)
        except OSError:
            return None
        if (
            digest["bytes"] != entry.get("bytes")
            or digest["sha256"] != entry.get("sha256")
        ):
            print(
                f"Checkpoint phase {phase!r} fails its sha256 manifest — "
                "retiring to recompute"
            )
            self._drop_phase(phase)
            return None
        try:
            with open(path, "rb") as fh:
                payload = pickle.load(fh)
        except Exception:
            strikes = int(entry.get("load_failures", 0)) + 1
            if self.writer:
                entry["load_failures"] = strikes
                if self.quarantine_after and strikes >= self.quarantine_after:
                    dest = quarantine_file(path)
                    print(
                        f"Checkpoint phase {phase!r} failed parsing "
                        f"{strikes}x — quarantined to {dest}"
                    )
                    self._state["phases"].pop(phase, None)
                else:
                    print(
                        f"Checkpoint phase {phase!r} failed parsing "
                        f"(strike {strikes}/{self.quarantine_after}) — "
                        "recomputing"
                    )
                self._write_state()
            return None
        missing = [k for k in require if not (isinstance(payload, dict) and k in payload)]
        if missing:
            print(
                f"Checkpoint phase {phase!r} lacks {missing} (an older "
                "payload format) — retiring to recompute"
            )
            self._drop_phase(phase)
            return None
        return payload

    def age_s(self, phase: str) -> float:
        entry = self._state["phases"].get(phase) or {}
        saved = float(entry.get("saved_at", 0.0))
        return max(time.time() - saved, 0.0) if saved else 0.0

    def duration_s(self, phase: str) -> float:
        """The original compute duration annotated at save time, so a
        resumed job can report the compute it skipped; 0.0 when absent."""
        entry = self._state["phases"].get(phase) or {}
        return float(entry.get("duration_s", 0.0))

    def save(
        self, phase: str, payload: Any, duration_s: float | None = None
    ) -> str | None:
        """Persist the phase payload atomically + manifest it. Writer rank
        only (no-op otherwise). ``duration_s`` is the phase's measured
        compute wall clock, carried in the manifest entry as a span
        annotation. The ``ckpt.corrupt`` fault site corrupts
        the BYTES here (digest recorded over the corrupt bytes), modeling
        a writer that silently produced garbage — the next load then
        passes integrity but fails parsing, the two-strike path."""
        if not self.writer:
            return None
        data = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            faults.fire("ckpt.corrupt")
        except faults.FaultInjected:
            # truncation, not a bit flip: a flipped byte inside a pickled
            # string still parses (to wrong data); a truncated stream
            # deterministically fails to UNPICKLE while its digest —
            # recorded below over the corrupt bytes — still verifies.
            # That is the poison-payload shape the strike path exists for.
            data = data[: max(len(data) // 2, 1)]
        path = self._phase_path(phase)
        _atomic_write_bytes(path, data)
        self._state["phases"][phase] = {
            "bytes": len(data),
            "sha256": hashlib.sha256(data).hexdigest(),
            "saved_at": time.time(),
            "load_failures": 0,
            "duration_s": round(max(float(duration_s or 0.0), 0.0), 6),
        }
        self._write_state()
        return path

    def clear(self) -> None:
        """Retire the whole store after a successful publication — the next
        rotation run mines a different dataset and must start fresh (and a
        SAME-dataset re-run re-mining to a fresh token should re-pay its
        compute rather than silently replaying this run's)."""
        if not self.writer:
            return
        self._retire_all()
        self._state = {
            "version": CKPT_VERSION,
            "fingerprint": self.fingerprint,
            "phases": {},
        }
        self.completed = frozenset()


def open_store(
    cfg: MiningConfig, dataset_path: str, run_index: int, writer: bool
) -> CheckpointStore | None:
    """The pipeline's one constructor: None when checkpointing is off."""
    if not cfg.checkpoint_enabled:
        return None
    directory = cfg.checkpoint_path
    if writer:
        os.makedirs(directory, exist_ok=True)
    elif not os.path.isdir(directory):
        # non-writer before the writer ever created the dir: nothing to
        # resume, and creating it isn't this rank's job
        return None
    return CheckpointStore(
        directory,
        compute_fingerprint(cfg, dataset_path, run_index),
        quarantine_after=cfg.checkpoint_quarantine_after,
        writer=writer,
    )


def heartbeat_dir(cfg: MiningConfig) -> str:
    """Where the dead-rank watchdog's per-rank heartbeat files live —
    under the checkpoint dir so one volume path owns all resume state."""
    return os.path.join(cfg.checkpoint_path, "heartbeats")


def retired_dirs(cfg: MiningConfig) -> tuple[str, ...]:
    """Checkpoint-side directories whose contents are safe to delete when
    the PVC runs short (``io.artifacts.reclaim_space`` extra_dirs): the
    store's quarantine of corrupt ``.ckpt`` files. The live store is
    never offered — deleting it would cost this run its resume state."""
    return (os.path.join(cfg.checkpoint_path, artifacts.QUARANTINE_DIRNAME),)
