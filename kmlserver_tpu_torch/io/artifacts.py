"""Artifact I/O — the wire contract between the mining job and the API, in
the formats of ``kmlserver_tpu/io/artifacts.py`` so a PVC published by
either package is served by the other:

- pickles with the reference's object shapes and filenames, written
  atomically (temp file, fsync, ``os.replace``, fsync of the directory);
- the ``.tensors.npz`` twin of ``recommendations.pickle`` (padded rule
  tensors + vocabulary + provenance);
- the integrity manifest ``artifacts.manifest.json`` (size + sha256 per
  artifact, stamped with the generation's token).

The publication lease, fault sites, ENOSPC ladder, IO-health monitor,
embeddings and delta bundles are not part of this slice.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import tempfile
import time
from typing import Any

import numpy as np

TENSOR_ARTIFACT_SUFFIX = ".tensors.npz"
MANIFEST_FILENAME = "artifacts.manifest.json"
# artifacts of features this slice does not publish; a full publication
# retires any left on the PVC so the new manifest cannot re-bless them
EMBEDDINGS_FILENAME = "embeddings.npz"
QUALITY_REPORT_FILENAME = "quality.report.json"
DELTA_STATE_FILENAME = "delta.state.json"


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to a temp file beside ``path``, fsync it, rename it
    over ``path`` and fsync the directory: readers see the old bytes or
    the new ones, never a torn file."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp_path = tempfile.mkstemp(dir=directory, prefix=".tmp_", suffix=".part")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        # mkstemp creates 0600; artifacts are read by the API replicas
        os.chmod(tmp_path, 0o644)
        os.replace(tmp_path, path)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise
    dfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dfd)
    except OSError:
        pass  # some filesystems refuse directory fsync; the rename stands
    finally:
        os.close(dfd)


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def save_pickle(obj: Any, path: str) -> None:
    _atomic_write_bytes(path, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def load_pickle(path: str) -> Any:
    return pickle.loads(_read_bytes(path))


def atomic_write_text(path: str, text: str) -> None:
    _atomic_write_bytes(path, text.encode("utf-8"))


def read_text(path: str) -> str:
    return _read_bytes(path).decode("utf-8")


def tensor_artifact_path(recommendations_pickle_path: str) -> str:
    """Path of the npz rule-tensor artifact shadowing a recommendations pickle."""
    return recommendations_pickle_path + TENSOR_ARTIFACT_SUFFIX


def manifest_path(pickles_dir: str) -> str:
    return os.path.join(pickles_dir, MANIFEST_FILENAME)


def file_digest(path: str) -> dict[str, Any]:
    """→ ``{"bytes": n, "sha256": hex}`` (streamed)."""
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as fh:
        while chunk := fh.read(1 << 20):
            h.update(chunk)
            n += len(chunk)
    return {"bytes": n, "sha256": h.hexdigest()}


def write_manifest(
    pickles_dir: str, filenames: list[str], token: str | None = None
) -> str:
    """Write the integrity sidecar for an artifact set (files that don't
    exist are skipped), stamped with the generation's ``token``, AFTER the
    artifacts and BEFORE the token rewrite. → the manifest path."""
    files = {
        name: file_digest(os.path.join(pickles_dir, name))
        for name in filenames
        if os.path.exists(os.path.join(pickles_dir, name))
    }
    out = manifest_path(pickles_dir)
    payload = {"version": 1, "written_at": time.time(), "token": token, "files": files}
    _atomic_write_bytes(
        out, json.dumps(payload, indent=1, sort_keys=True).encode("utf-8")
    )
    return out


def load_manifest(pickles_dir: str) -> dict[str, Any] | None:
    """The parsed manifest, or None when absent or unreadable."""
    try:
        data = json.loads(read_text(manifest_path(pickles_dir)))
    except (OSError, ValueError):
        return None
    return data if isinstance(data.get("files"), dict) else None


def retire_unpublished(pickles_dir: str) -> None:
    """Remove the artifacts of features this slice does not publish
    (embeddings, quality report, delta chain) — the reference job does the
    same when those features are off, so neither package's manifest can
    bless a previous generation's leftovers."""
    try:
        names = os.listdir(pickles_dir)
    except OSError:
        return
    for name in names:
        if name in (EMBEDDINGS_FILENAME, QUALITY_REPORT_FILENAME, DELTA_STATE_FILENAME) or (
            name.startswith("delta-") and name.endswith(".bundle")
        ):
            try:
                os.unlink(os.path.join(pickles_dir, name))
            except FileNotFoundError:
                pass


def save_rule_tensors(
    path: str,
    *,
    vocab: list[str],
    rule_ids: np.ndarray,
    rule_counts: np.ndarray,
    item_counts: np.ndarray,
    n_playlists: int,
    min_support: float,
    mode: str = "support",
    min_confidence: float = 0.0,
    rule_confs64: np.ndarray | None = None,
) -> None:
    """Write the padded rule tensors + vocabulary as one ``.npz`` (counts,
    not floats: consumers re-derive confidences with the same float64
    arithmetic as the pickle path, so the two artifacts never drift)."""
    if rule_ids.shape != rule_counts.shape:
        raise ValueError(f"rule_ids {rule_ids.shape} != rule_counts {rule_counts.shape}")
    if rule_ids.shape[0] != len(vocab) or len(item_counts) != len(vocab):
        raise ValueError(
            f"rows {rule_ids.shape[0]}/{len(item_counts)} != vocab size {len(vocab)}"
        )
    arrays = dict(
        vocab=np.asarray(vocab, dtype=object),
        rule_ids=rule_ids.astype(np.int32),
        rule_counts=rule_counts.astype(np.int32),
        item_counts=item_counts.astype(np.int32),
        n_playlists=np.int64(n_playlists),
        min_support=np.float64(min_support),
        mode=np.asarray(mode),
        min_confidence=np.float64(min_confidence),
    )
    if rule_confs64 is not None:
        arrays["rule_confs64"] = rule_confs64.astype(np.float64)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    _atomic_write_bytes(path, buf.getvalue())


def load_rule_tensors(path: str) -> dict[str, Any]:
    """Load the npz artifact, deriving serving-ready float32 confidences."""
    from ..ops.rules import derive_confs

    with np.load(io.BytesIO(_read_bytes(path)), allow_pickle=True) as npz:
        rule_ids = npz["rule_ids"]
        rule_counts = npz["rule_counts"]
        item_counts = npz["item_counts"]
        n_playlists = int(npz["n_playlists"])
        mode = str(npz["mode"])
        confs64 = npz["rule_confs64"] if "rule_confs64" in npz.files else None
        if confs64 is None and bool(((rule_ids >= 0) & (rule_counts <= 0)).any()):
            # valid rules with zero counts come only from a triple-merged
            # artifact whose rule_confs64 was stripped
            raise ValueError(
                f"{path}: rules present with zero counts and no rule_confs64 "
                "— corrupt or stripped artifact"
            )
        confs = (
            confs64.astype(np.float32)
            if confs64 is not None
            else derive_confs(rule_counts, item_counts, n_playlists, mode)
        )
        return {
            "vocab": [str(s) for s in npz["vocab"]],
            "rule_ids": rule_ids,
            "rule_counts": rule_counts,
            "rule_confs": confs,
            "rule_confs64": confs64,
            "item_counts": item_counts,
            "n_playlists": n_playlists,
            "min_support": float(npz["min_support"]),
            "mode": mode,
            "min_confidence": float(npz["min_confidence"]),
        }


def tensors_from_rules_dict(
    rules: dict[str, dict[str, float]], vocab: list[str], k_max: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pickle dict → ``(rule_ids, rule_confs, known_mask)`` for a PVC that
    carries no npz (e.g. written by the original job): ``known_mask`` marks
    vocab entries that are dict KEYS, empty rows included."""
    index = {name: i for i, name in enumerate(vocab)}
    v = len(vocab)
    rule_ids = np.full((v, k_max), -1, dtype=np.int32)
    rule_confs = np.zeros((v, k_max), dtype=np.float32)
    known_mask = np.zeros(v, dtype=bool)
    for name, row in rules.items():
        i = index.get(name)
        if i is None:
            continue
        known_mask[i] = True
        resolved = [(index[o], conf) for o, conf in row.items() if o in index]
        resolved.sort(key=lambda jc: -jc[1])
        for k, (j, conf) in enumerate(resolved[:k_max]):
            rule_ids[i, k] = j
            rule_confs[i, k] = conf
    return rule_ids, rule_confs, known_mask
