"""Artifact I/O — the wire contract between the mining job and the API, in
the formats of ``kmlserver_tpu/io/artifacts.py`` so a PVC published by
either package is served by the other:

- pickles with the reference's object shapes and filenames, and the
  ``.tensors.npz`` twin of ``recommendations.pickle`` (padded rule tensors
  + vocabulary + provenance);
- the integrity manifest ``artifacts.manifest.json`` (size + sha256 per
  artifact, stamped with the generation's token and the publication
  lease's fencing token), checked by the engine before a bundle publishes
  (:func:`verify_files`), with :func:`quarantine_file` for bytes that
  keep failing;
- the publication lease ``publish.lease.json`` (:class:`PublicationLease`:
  heartbeat + monotonic fencing token), so a zombie job cannot publish
  over a newer run;
- the durable-write discipline: every write goes to a temp file, is
  fsynced, renamed over the destination (:func:`durable_replace`) and the
  directory fsynced. Transient errnos (EIO, EAGAIN, ESTALE) retry with a
  bounded exponential backoff; ENOSPC never retries (the
  :func:`ensure_free_space` preflight and the resumable exit own it) and
  neither does a failed fsync (:class:`FsyncFailedError`). Every byte in
  or out passes the path-scoped fault gate (``faults.take_io``) and feeds
  the IO-health monitor (``io/iohealth.py``);
- the embedding artifact ``embeddings.npz`` (ALS item factors);
- the continuous-freshness delta bundles ``delta-<seq>.bundle`` and their
  chain file ``delta.state.json`` (:func:`save_delta_bundle`,
  :func:`load_delta_bundle` with its strict validation,
  :func:`write_delta_state`, :func:`retire_delta_chain`), in the
  reference's format: either package reads the other's bundles.
"""

from __future__ import annotations

import errno
import hashlib
import io
import json
import os
import pickle
import socket
import tempfile
import threading
import time
from typing import Any

import numpy as np

from .. import faults
from ..config import _getenv_float, io_retries_from_env, io_retry_base_s_from_env
from .iohealth import MONITOR

TENSOR_ARTIFACT_SUFFIX = ".tensors.npz"
MANIFEST_FILENAME = "artifacts.manifest.json"
QUARANTINE_DIRNAME = "quarantine"
# the embed phase's artifact (ALS item factors) and its format version
EMBEDDINGS_FILENAME = "embeddings.npz"
EMBEDDINGS_VERSION = 1
# the eval phase's quality report (quality/eval.py): held-out recall@k /
# MRR / coverage per serving mode and the blend sweep whose argmax the
# engine serves under KMLS_HYBRID_BLEND_WEIGHT=measured. Deterministic
# content, so a resumed publication writes the same bytes
QUALITY_REPORT_FILENAME = "quality.report.json"
# continuous freshness (freshness/delta.py): the chain file listing the
# delta bundles of one base generation in application order, and the
# bundles' format version. Deltas never rewrite the invalidation token:
# the engine applies them in place
DELTA_STATE_FILENAME = "delta.state.json"
DELTA_BUNDLE_VERSION = 1


def delta_bundle_filename(seq: int) -> str:
    return f"delta-{int(seq):06d}.bundle"


def delta_state_path(pickles_dir: str) -> str:
    return os.path.join(pickles_dir, DELTA_STATE_FILENAME)


class ArtifactIntegrityError(RuntimeError):
    """An artifact's bytes disagree with the manifest that shipped it.

    ``paths`` lists the offending files, so the engine can quarantine the
    right bytes instead of guessing."""

    def __init__(self, message: str, paths: list[str]):
        super().__init__(message)
        self.paths = paths


class StorageExhaustedError(RuntimeError):
    """The artifact volume is out of space even after reclamation.
    Resumable (exit 75): checkpoints are already on disk, so the retried
    job skips straight back to publication once an operator (or the
    cluster autoscaler) restores capacity."""


class FsyncFailedError(OSError):
    """``fsync`` reported failure on a publication-critical file.

    NEVER retried (the fsyncgate lesson): after a failed fsync, Linux
    marks the dirty pages clean — a second fsync returns success while
    the bytes were silently dropped. The only safe move is to abort the
    publication with the destination untouched and re-run from
    checkpoints, which rewrites the bytes from scratch."""


class IoStallError(OSError):
    """A deadline-bounded artifact read outlived its deadline — the
    hung-NFS-mount shape. The reader thread is parked (daemon) and the
    caller fails the operation instead of wedging; the engine turns this
    into a normal reload failure (backoff + last-good serving)."""


# the NFS/Filestore gray-failure errno set: worth one bounded retry
# ladder. ENOSPC is deliberately absent (the reclamation ladder owns
# it) and fsync failures bypass retries entirely (FsyncFailedError).
_TRANSIENT_ERRNOS = (errno.EIO, errno.EAGAIN, errno.ESTALE)


def _fsync_file(path: str, dest_path: str) -> None:
    """fsync ``path`` (the temp file about to be renamed over
    ``dest_path``, which is the path fault scopes match against).
    Raises :class:`FsyncFailedError` — and only that — on failure."""
    try:
        stall = faults.take_io("io.fsync", dest_path)
        if stall > 0:
            time.sleep(stall)
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError as exc:
        raise FsyncFailedError(
            exc.errno or errno.EIO, f"fsync failed for {dest_path}: {exc}"
        ) from exc


def _fsync_dir(directory: str) -> None:
    """fsync the parent directory so the RENAME itself is durable. Best
    effort on refusal: some filesystems reject directory fsync (EINVAL)
    and the file fsync already carried the data — only the name's
    durability window remains, which a re-run closes."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def durable_replace(src: str, dst: str, *, durable: bool = True) -> None:
    """THE publication rename: fsync ``src``, ``os.replace`` it over
    ``dst``, fsync the parent directory. Every rename that publishes
    bytes readers trust (manifest, token, lease, checkpoints) comes
    through here. ``durable=False`` skips both fsyncs for best-effort writers
    (telemetry, quarantine moves) that still want the atomic rename."""
    if durable:
        _fsync_file(src, dst)
    os.replace(src, dst)
    if durable:
        _fsync_dir(os.path.dirname(os.path.abspath(dst)))


def _atomic_write_once(
    path: str, data: bytes, *, durable: bool, op: str
) -> None:
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp_path = tempfile.mkstemp(dir=directory, prefix=".tmp_", suffix=".part")
    torn = False
    start = time.monotonic()
    try:
        with os.fdopen(fd, "wb") as fh:
            try:
                stall = faults.take_io("io.write", path)
            except faults.TornWrite as exc:
                # a torn write IS the crash artifact: leave the short
                # temp file behind (reclaim_space collects orphans), the
                # destination is never touched
                torn = True
                fh.write(data[: exc.keep_bytes])
                raise
            if stall > 0:
                time.sleep(stall)
            fh.write(data)
        # mkstemp creates 0600; artifacts are read by the API replicas
        # (possibly a different uid on the shared volume)
        os.chmod(tmp_path, 0o644)
        durable_replace(tmp_path, path, durable=durable)
        MONITOR.note_latency(op, time.monotonic() - start)
    except BaseException:
        if not torn:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
        raise


def _atomic_write_bytes(
    path: str, data: bytes, *, durable: bool = True, op: str = "write"
) -> None:
    """Atomic (and by default durable) write with the bounded transient-
    errno retry ladder. The retry set is deliberately narrow: EIO/
    EAGAIN/ESTALE (a flaky NFS mount) retry up to ``KMLS_IO_RETRIES``
    times with ``KMLS_IO_RETRY_BASE_MS`` exponential backoff; ENOSPC
    surfaces immediately (reclamation + resumable exit own it),
    :class:`FsyncFailedError` surfaces immediately (retrying a failed
    fsync masks dropped pages), torn writes surface immediately (they
    model a dead writer — nobody is left to retry)."""
    attempt = 0
    while True:
        try:
            _atomic_write_once(path, data, durable=durable, op=op)
            return
        except (FsyncFailedError, faults.TornWrite) as exc:
            MONITOR.note_error(op, exc.errno or 0)
            raise
        except OSError as exc:
            MONITOR.note_error(op, exc.errno or 0)
            if (
                exc.errno not in _TRANSIENT_ERRNOS
                or attempt >= io_retries_from_env()
            ):
                raise
            MONITOR.note_retry()
            time.sleep(io_retry_base_s_from_env() * (2**attempt))
            attempt += 1


def _read_bytes(
    path: str, *, op: str = "read", deadline_s: float | None = None
) -> bytes:
    """Read ``path`` through the fault gate + IO-health ledger.

    With ``deadline_s`` the read runs on a parked daemon thread and
    :class:`IoStallError` fires at the deadline — a hung NFS read must
    park the RELOAD in backoff (last-good keeps serving), not wedge the
    reload thread forever."""

    def _do_read() -> bytes:
        stall = faults.take_io("io.read", path)
        if stall > 0:
            time.sleep(stall)
        with open(path, "rb") as fh:
            return fh.read()

    start = time.monotonic()
    if deadline_s is None or deadline_s <= 0:
        try:
            data = _do_read()
        except OSError as exc:
            MONITOR.note_error(op, exc.errno or 0)
            raise
        MONITOR.note_latency(op, time.monotonic() - start)
        return data
    result: list[bytes] = []
    error: list[BaseException] = []

    def _worker() -> None:
        try:
            result.append(_do_read())
        except BaseException as exc:  # noqa: BLE001 — relayed below
            error.append(exc)

    thread = threading.Thread(
        target=_worker, name="kmls-io-read", daemon=True
    )
    thread.start()
    thread.join(deadline_s)
    if thread.is_alive():
        # the read's latency is AT LEAST the deadline — feed that floor
        # to the EWMA so a silently hung mount still convicts
        MONITOR.note_error(op, errno.ETIMEDOUT)
        MONITOR.note_latency(op, deadline_s)
        raise IoStallError(
            errno.ETIMEDOUT,
            f"read of {path} exceeded its {deadline_s:.3f}s deadline",
        )
    if error:
        exc = error[0]
        if isinstance(exc, OSError):
            MONITOR.note_error(op, exc.errno or 0)
        raise exc
    MONITOR.note_latency(op, time.monotonic() - start)
    return result[0]


def save_pickle(obj: Any, path: str) -> None:
    """Pickle ``obj`` to ``path`` atomically and durably (the reference's
    ``save_pickle``, machine-learning/main.py:136-145, rewrote in place)."""
    _atomic_write_bytes(path, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def load_pickle(
    path: str, *, op: str = "read", deadline_s: float | None = None
) -> Any:
    return pickle.loads(_read_bytes(path, op=op, deadline_s=deadline_s))


def atomic_write_text(
    path: str, text: str, *, durable: bool = True, op: str = "write"
) -> None:
    _atomic_write_bytes(path, text.encode("utf-8"), durable=durable, op=op)


def read_text(
    path: str, *, op: str = "read", deadline_s: float | None = None
) -> str:
    return _read_bytes(path, op=op, deadline_s=deadline_s).decode("utf-8")


def tensor_artifact_path(recommendations_pickle_path: str) -> str:
    """Path of the npz rule-tensor artifact shadowing a recommendations pickle."""
    return recommendations_pickle_path + TENSOR_ARTIFACT_SUFFIX


# ---------- integrity manifest + quarantine ----------


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
    pickles_dir: str,
    filenames: list[str],
    token: str | None = None,
    fencing_token: int | None = None,
) -> str:
    """Write the integrity sidecar for an artifact set (files that don't
    exist are skipped) AFTER the artifacts and BEFORE the token rewrite.
    ``token`` stamps the generation it describes: readers validate only
    when the published token matches, so a manifest left behind can never
    condemn the fresh bytes of a manifest-less writer. ``fencing_token``
    records the publication lease's token of the writer that produced the
    set. → the manifest path."""
    files = {
        name: file_digest(os.path.join(pickles_dir, name))
        for name in filenames
        if os.path.exists(os.path.join(pickles_dir, name))
    }
    out = manifest_path(pickles_dir)
    payload: dict[str, Any] = {
        "version": 1, "written_at": time.time(), "token": token, "files": files,
    }
    if fencing_token is not None:
        payload["fencing_token"] = fencing_token
    _atomic_write_bytes(
        out, json.dumps(payload, indent=1, sort_keys=True).encode("utf-8")
    )
    return out


def load_manifest(
    pickles_dir: str, *, deadline_s: float | None = None
) -> dict[str, Any] | None:
    """The parsed manifest, or None when absent or unreadable (a PVC written
    by a manifest-less writer is not checked)."""
    try:
        data = json.loads(read_text(manifest_path(pickles_dir), deadline_s=deadline_s))
    except (OSError, ValueError):
        return None
    return data if isinstance(data.get("files"), dict) else None


def verify_files(
    pickles_dir: str, filenames: list[str], token: str | None = None
) -> list[str]:
    """Check ``filenames`` (relative to ``pickles_dir``) against the
    manifest → the list of paths whose on-disk bytes MISMATCH it (size or
    sha256). Files absent from the manifest, or missing on disk, are not
    mismatches (missing-on-disk surfaces as FileNotFoundError at load
    time, which the engine already treats as not-ready).

    ``token`` (the current invalidation-token value) gates validation to
    the manifest's own generation: a manifest stamped for a DIFFERENT
    token is stale — some other writer has published since — and
    validating fresh bytes against it would condemn good artifacts, so
    it is skipped entirely. ``token=None`` validates unconditionally
    (tests, offline checks)."""
    manifest = load_manifest(pickles_dir)
    if manifest is None:
        return []
    if token is not None and manifest.get("token") != token:
        return []
    bad: list[str] = []
    for name in filenames:
        entry = manifest["files"].get(name)
        path = os.path.join(pickles_dir, name)
        if entry is None or not os.path.exists(path):
            continue
        if os.path.getsize(path) != entry.get("bytes"):
            bad.append(path)
            continue
        if file_digest(path)["sha256"] != entry.get("sha256"):
            bad.append(path)
    return bad


def quarantine_file(path: str) -> str | None:
    """Move a corrupt artifact aside (``<pickles_dir>/quarantine/<name>.
    <epoch>``) so the next mining run writes fresh bytes and the bad ones
    stay inspectable. Never raises — a read-only volume must not turn a
    fail-soft reload into a crash. → the quarantine path, or None."""
    try:
        directory = os.path.dirname(os.path.abspath(path))
        qdir = os.path.join(directory, QUARANTINE_DIRNAME)
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(
            qdir, f"{os.path.basename(path)}.{int(time.time())}"
        )
        # atomic but NOT durable: quarantine is forensics, not
        # publication — losing the move in a crash costs nothing
        durable_replace(path, dest, durable=False)
        return dest
    except OSError:
        return None


# ---------- the ENOSPC ladder (free space before publication) ----------


def disk_free_bytes(path: str) -> int:
    """Free bytes available to this process on ``path``'s filesystem."""
    stat = os.statvfs(path)
    return stat.f_bavail * stat.f_frsize


def estimate_publication_bytes(pickles_dir: str) -> int:
    """Expected size of the NEXT artifact set, estimated from the last
    manifest (generation-over-generation sizes move slowly — the vocab
    and rule caps are config-pinned). 0 with no manifest: the preflight
    then falls back to the operator floor alone."""
    manifest = load_manifest(pickles_dir)
    if manifest is None:
        return 0
    total = 0
    for entry in manifest.get("files", {}).values():
        try:
            total += int(entry.get("bytes", 0))
        except (TypeError, ValueError):
            continue
    return total


def reclaim_space(
    pickles_dir: str, extra_dirs: tuple[str, ...] | list[str] = ()
) -> int:
    """Delete every reclaimable byte the artifact plane owns → bytes
    freed (by file size, best effort, never raises).

    The ladder, cheapest-to-lose first: quarantined corpses (forensics
    only), orphaned ``.tmp_*.part`` files (dead writers' leftovers),
    then ``extra_dirs`` (retired checkpoint stores a caller explicitly
    hands over — NEVER the live store, which resume depends on).
    Delta bundles are deliberately NOT reclaimed here: pre-publication
    the serving fleet may still be applying them to last-good."""
    freed = 0

    def _unlink(path: str) -> None:
        nonlocal freed
        try:
            size = os.path.getsize(path)
            os.unlink(path)
            freed += size
        except OSError:
            pass

    qdir = os.path.join(pickles_dir, QUARANTINE_DIRNAME)
    try:
        for name in os.listdir(qdir):
            _unlink(os.path.join(qdir, name))
    except OSError:
        pass
    try:
        for name in os.listdir(pickles_dir):
            if name.startswith(".tmp_") and name.endswith(".part"):
                _unlink(os.path.join(pickles_dir, name))
    except OSError:
        pass
    for directory in extra_dirs:
        try:
            entries = os.listdir(directory)
        except OSError:
            continue
        for name in entries:
            path = os.path.join(directory, name)
            if os.path.isfile(path):
                _unlink(path)
    return freed


def ensure_free_space(
    pickles_dir: str,
    min_free_bytes: int,
    extra_dirs: tuple[str, ...] | list[str] = (),
) -> int:
    """The publication preflight: require ``min_free_bytes`` free on the
    artifact volume, reclaiming (:func:`reclaim_space`) if short, and
    raising :class:`StorageExhaustedError` (→ resumable exit 75) if
    still short — so publication NEVER starts a write it cannot finish:
    the failure mode is \"last-good keeps serving, job retries under
    k8s backoff\", never a torn artifact set. → free bytes after."""
    if min_free_bytes <= 0:
        return 0
    # first run: the artifact dir may not exist yet — the preflight runs
    # before any write, and the writer owns creating it anyway
    os.makedirs(pickles_dir, exist_ok=True)
    free = disk_free_bytes(pickles_dir)
    MONITOR.watch_disk(pickles_dir)
    if free >= min_free_bytes:
        return free
    freed = reclaim_space(pickles_dir, extra_dirs)
    free = disk_free_bytes(pickles_dir)
    if free >= min_free_bytes:
        print(
            f"Artifact volume short on space — reclaimed {freed} bytes "
            f"({free} now free, {min_free_bytes} required)"
        )
        return free
    raise StorageExhaustedError(
        f"artifact volume has {free} free bytes after reclaiming {freed}; "
        f"publication needs {min_free_bytes} — exiting resumable rather "
        "than risking a torn publication"
    )


# ---------- lease-fenced publication ----------


LEASE_FILENAME = "publish.lease.json"


class LeaseHeldError(RuntimeError):
    """Another writer holds a live publication lease. Resumable: the k8s
    Job retries after backoff, and wins once the holder finishes or its
    heartbeat expires."""


class LeaseLostError(RuntimeError):
    """This writer's lease was superseded (a newer fencing token is on
    disk) — it is a ZOMBIE and must not publish."""


def lease_path(pickles_dir: str) -> str:
    return os.path.join(pickles_dir, LEASE_FILENAME)


def _read_lease(pickles_dir: str) -> dict[str, Any] | None:
    try:
        data = json.loads(
            _read_bytes(lease_path(pickles_dir)).decode("utf-8")
        )
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


class PublicationLease:
    """Heartbeat lease + monotonic fencing token over the artifact set.

    The reference's GitOps loop recreates the mining Job with ArgoCD
    ``Force=true,Replace=true`` — which can leave a ZOMBIE of the previous
    run alive (slow termination, a hung host) while its replacement is
    already mining. Without fencing, the zombie's late artifact writes
    would tear or roll back what the newer run published. The fix is the
    classic fencing-token protocol:

    - :meth:`acquire` reads the lease file; a live lease (not released,
      heartbeat younger than its TTL) → :class:`LeaseHeldError` (the
      caller exits resumable and retries under k8s backoff). A dead or
      released lease is taken over with ``fencing_token = previous + 1``
      — the token only ever increases, across arbitrarily many writer
      generations.
    - a background heartbeat (:meth:`start_heartbeat`) refreshes
      ``heartbeat_at`` every ``ttl/3`` so a LIVE writer is never
      expropriated mid-mine, no matter how long the mine takes.
    - :meth:`check` re-reads the file and raises :class:`LeaseLostError`
      the moment a newer (owner, token) is on disk. The pipeline calls it
      immediately before its first artifact write AND immediately before
      the invalidation-token rewrite, so a fenced zombie aborts without
      having torn anything.

    The lease file lives on the same PVC as the artifacts it guards
    (atomic tmp+rename writes). Acquisition is read-modify-write with a
    read-back confirmation — not a true CAS, which a shared POSIX FS
    cannot provide — so two same-instant acquirers may both think they
    won briefly; the loser's next :meth:`check`/heartbeat sees the other
    (owner, token) on disk and self-fences. That is exactly the fail-safe
    direction: over-fencing costs a retry, under-fencing would cost data.
    """

    def __init__(
        self,
        pickles_dir: str,
        owner: str,
        fencing_token: int,
        ttl_s: float,
        heartbeat_interval_s: float | None = None,
        stall_fraction: float | None = None,
    ):
        self.pickles_dir = pickles_dir
        self.owner = owner
        self.fencing_token = fencing_token
        self.ttl_s = ttl_s
        self.heartbeat_interval_s = heartbeat_interval_s or max(ttl_s / 3, 0.05)
        # self-fencing threshold: a heartbeat WRITE that takes longer
        # than this fraction of the TTL means the mount is hung badly
        # enough that our on-disk heartbeat may already look dead to a
        # challenger — assume expropriated rather than risk two writers
        self.stall_fraction = (
            stall_fraction
            if stall_fraction is not None
            else _getenv_float("KMLS_LEASE_STALL_FRACTION", 0.5)
        )
        self.lost = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @classmethod
    def acquire(
        cls,
        pickles_dir: str,
        ttl_s: float = 60.0,
        owner: str | None = None,
        heartbeat_interval_s: float | None = None,
        stall_fraction: float | None = None,
    ) -> "PublicationLease":
        """Take the publication lease or raise :class:`LeaseHeldError`."""
        owner = owner or (
            f"{socket.gethostname()}:{os.getpid()}:{os.urandom(4).hex()}"
        )
        current = _read_lease(pickles_dir)
        prev_token = 0
        if current is not None:
            prev_token = int(current.get("fencing_token", 0))
            age = time.time() - float(current.get("heartbeat_at", 0.0))
            live = not current.get("released") and age < float(
                current.get("ttl_s", ttl_s)
            )
            if live and current.get("owner") != owner:
                raise LeaseHeldError(
                    f"publication lease held by {current.get('owner')!r} "
                    f"(token {prev_token}, heartbeat {age:.1f}s ago, ttl "
                    f"{current.get('ttl_s')}s)"
                )
        lease = cls(
            pickles_dir, owner, prev_token + 1, ttl_s, heartbeat_interval_s,
            stall_fraction=stall_fraction,
        )
        lease._write()
        # read-back: in a same-instant race the later rename wins; the
        # loser must find out NOW, not at publication time
        lease.check()
        return lease

    def _write(self, released: bool = False) -> None:
        _atomic_write_bytes(
            lease_path(self.pickles_dir),
            json.dumps(
                {
                    "version": 1,
                    "owner": self.owner,
                    "fencing_token": self.fencing_token,
                    "ttl_s": self.ttl_s,
                    "heartbeat_at": time.time(),
                    "released": released,
                },
                indent=1, sort_keys=True,
            ).encode("utf-8"),
        )

    def check(self) -> None:
        """Raise :class:`LeaseLostError` unless the on-disk lease is still
        (our owner, our token) and unreleased. Sticky: once lost, always
        lost — a released lease is lost too (this handle gave it up; any
        later write through it would race the next acquirer)."""
        if not self.lost:
            current = _read_lease(self.pickles_dir)
            if (
                current is not None
                and current.get("owner") == self.owner
                and int(current.get("fencing_token", -1)) == self.fencing_token
                and not current.get("released")
            ):
                return
            self.lost = True
        raise LeaseLostError(
            f"publication lease (token {self.fencing_token}) superseded — "
            "this writer is a zombie and must not publish"
        )

    def heartbeat(self) -> None:
        """One ownership-checked heartbeat (raises when fenced).

        SELF-FENCES on its own slowness: if the heartbeat write stalls
        past ``stall_fraction·ttl_s`` (a hung NFS mount), this writer
        cannot know whether its on-disk heartbeat is still younger than
        the TTL — a challenger may already hold a newer token. The only
        safe belief is "lost": mark sticky-lost and raise, so the
        pipeline's next :meth:`check` aborts resumable BEFORE any
        artifact write a real holder wouldn't have raced."""
        self.check()
        start = time.monotonic()
        self._write()
        elapsed = time.monotonic() - start
        if self.stall_fraction > 0 and elapsed > self.ttl_s * self.stall_fraction:
            self.lost = True
            raise LeaseLostError(
                f"lease heartbeat stalled {elapsed:.2f}s (> "
                f"{self.stall_fraction:.2f}·ttl {self.ttl_s:.2f}s) — this "
                "writer cannot prove it still holds the lease and "
                "self-fences"
            )

    def start_heartbeat(self) -> None:
        """Refresh the lease every ``heartbeat_interval_s`` until
        :meth:`stop_heartbeat` — or until fenced, which stops silently
        (the publication-path :meth:`check` raises the loud error)."""
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self.heartbeat_interval_s):
                try:
                    self.heartbeat()
                except (LeaseLostError, OSError):
                    return

        self._thread = threading.Thread(
            target=loop, name="kmls-lease-heartbeat", daemon=True
        )
        self._thread.start()

    def stop_heartbeat(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def release(self) -> None:
        """Mark the lease released (token RETAINED — the next acquirer
        still increments past it; monotonicity is the whole point).

        Called on BOTH the success path and a Python-level abort (the
        pipeline's except block): an exiting process provably writes
        nothing more, so handing the lease back immediately beats making
        its own k8s-restarted successor wait out the TTL. Only a hard
        kill (SIGKILL preemption) leaves the lease to expiry.

        Stops the heartbeat thread FIRST: a beat racing the release could
        land after ``released: true`` and resurrect the lease, making the
        next acquirer wait out the TTL against a dead owner."""
        self.stop_heartbeat()
        self.check()
        self._write(released=True)


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


def load_rule_tensors(
    path: str, *, deadline_s: float | None = None
) -> dict[str, Any]:
    """Load the npz artifact, deriving serving-ready float32 confidences.
    The bytes come through :func:`_read_bytes` (fault gate, IO health,
    optional deadline); parsing happens on a BytesIO."""
    from ..ops.rules import derive_confs

    raw = io.BytesIO(_read_bytes(path, deadline_s=deadline_s))
    with np.load(raw, allow_pickle=True) as npz:
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


def rules_dict_from_tensors(loaded: dict[str, Any]) -> dict[str, dict[str, float]]:
    """A :func:`load_rule_tensors`-shaped dict → the reference's pickle
    object ``{song: {other_song: confidence}}`` through the one expansion
    in ``ops/rules.py``, so an npz and its pickle twin cannot drift."""
    from ..ops.rules import expand_rules_dict

    return expand_rules_dict(
        loaded["vocab"],
        loaded["rule_ids"],
        loaded["rule_counts"],
        loaded["item_counts"],
        n_playlists=loaded["n_playlists"],
        min_support=loaded["min_support"],
        mode=loaded["mode"],
        rule_confs64=loaded.get("rule_confs64"),
    )


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


def embeddings_artifact_path(pickles_dir: str) -> str:
    return os.path.join(pickles_dir, EMBEDDINGS_FILENAME)


def save_embeddings(
    path: str,
    *,
    vocab: list[str],
    item_factors: np.ndarray,
    rank: int,
    iters: int,
    reg: float,
    final_loss: float | None = None,
) -> None:
    """Write the embedding artifact as one atomic ``.npz``, byte-compatible
    with the reference's: ``item_factors`` f32 (V, rank), rows
    L2-normalized, over the full encode-phase vocabulary (broader than the
    pruned rule vocabulary: the two families merge by name)."""
    if item_factors.ndim != 2 or item_factors.shape[0] != len(vocab):
        raise ValueError(
            f"item_factors {item_factors.shape} does not match vocab size {len(vocab)}"
        )
    arrays = dict(
        version=np.int64(EMBEDDINGS_VERSION),
        vocab=np.asarray(vocab, dtype=object),
        item_factors=item_factors.astype(np.float32),
        rank=np.int64(rank),
        iters=np.int64(iters),
        reg=np.float64(reg),
    )
    if final_loss is not None:
        arrays["final_loss"] = np.float64(final_loss)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    _atomic_write_bytes(path, buf.getvalue())


def remove_embeddings(pickles_dir: str) -> bool:
    """Retire the embedding artifact (an embed-disabled publication must
    not leave a previous generation's on disk for the new manifest to
    bless). → True if removed."""
    try:
        os.unlink(embeddings_artifact_path(pickles_dir))
        return True
    except FileNotFoundError:
        return False


def load_embeddings(path: str, *, deadline_s: float | None = None) -> dict[str, Any]:
    """Load and validate the embedding artifact. Raises ``ValueError`` on
    any structural problem (not an embedding artifact, another format
    version, a shape that disagrees with the vocabulary, non-finite or
    rank-0 factors): the engine treats every raise as corrupt and serves
    rules only."""
    raw = io.BytesIO(_read_bytes(path, deadline_s=deadline_s))
    with np.load(raw, allow_pickle=True) as npz:
        if "item_factors" not in npz.files or "vocab" not in npz.files:
            raise ValueError(f"{path}: not an embedding artifact")
        version = int(npz["version"]) if "version" in npz.files else 0
        if version != EMBEDDINGS_VERSION:
            raise ValueError(
                f"{path}: embedding artifact version {version} != {EMBEDDINGS_VERSION}"
            )
        vocab = [str(s) for s in npz["vocab"]]
        factors = np.asarray(npz["item_factors"], dtype=np.float32)
        if factors.ndim != 2 or factors.shape[0] != len(vocab):
            raise ValueError(
                f"{path}: item_factors {factors.shape} does not match vocab size {len(vocab)}"
            )
        if factors.shape[1] < 1 or not np.isfinite(factors).all():
            raise ValueError(f"{path}: non-finite or rank-0 item factors")
        return {
            "vocab": vocab,
            "item_factors": factors,
            "rank": int(npz["rank"]) if "rank" in npz.files else factors.shape[1],
            "iters": int(npz["iters"]) if "iters" in npz.files else 0,
            "reg": float(npz["reg"]) if "reg" in npz.files else 0.0,
        }


def quality_report_path(pickles_dir: str) -> str:
    return os.path.join(pickles_dir, QUALITY_REPORT_FILENAME)


def save_quality_report(pickles_dir: str, report: dict[str, Any]) -> str:
    """Write the quality report atomically, keys sorted, in the reference's
    form byte for byte: the same content gives the same bytes, so the
    manifest's sha256 covers a resumed publication too. → its path."""
    path = quality_report_path(pickles_dir)
    _atomic_write_bytes(path, json.dumps(report, indent=1, sort_keys=True).encode("utf-8"))
    return path


def remove_quality_report(pickles_dir: str) -> bool:
    """Retire the quality report: an eval-off publication must not leave a
    previous generation's measurements for its manifest to re-bless. → True
    if a file was removed."""
    try:
        os.unlink(quality_report_path(pickles_dir))
        return True
    except FileNotFoundError:
        return False


def load_quality_report(pickles_dir: str) -> dict[str, Any] | None:
    """The parsed quality report (either package's), or None when absent
    or unreadable (the measured blend weight then falls back to its
    default)."""
    try:
        data = json.loads(_read_bytes(quality_report_path(pickles_dir)).decode("utf-8"))
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


# ---------- continuous-freshness delta bundles ----------

_DELTA_KEYS = (
    "version", "seq", "base_token", "base_npz_sha256", "n_playlists",
    "min_count", "vocab", "changed_rows", "changed_rule_ids",
    "changed_rule_counts", "changed_item_counts", "tombstones",
)


def save_delta_bundle(
    path: str,
    *,
    seq: int,
    base_token: str,
    base_npz_sha256: str,
    n_playlists: int,
    min_count: int,
    vocab: list[str],
    changed_rows: np.ndarray,
    changed_rule_ids: np.ndarray,
    changed_rule_counts: np.ndarray,
    changed_item_counts: np.ndarray,
    tombstones: list[str],
) -> None:
    """Write one delta bundle atomically, in the reference's format.

    ``vocab`` is the complete new (possibly pruned) row space; row identity
    travels by name, so an apply re-maps unchanged base rows into it and
    overwrites ``changed_rows`` (indices into ``vocab``). ``tombstones``
    are base names absent from ``vocab``. ``base_npz_sha256`` binds the
    bundle to the exact base artifact bytes it patches."""
    if changed_rule_ids.shape != changed_rule_counts.shape:
        raise ValueError(
            f"changed_rule_ids {changed_rule_ids.shape} != "
            f"changed_rule_counts {changed_rule_counts.shape}"
        )
    if not len(changed_rows) == changed_rule_ids.shape[0] == len(changed_item_counts):
        raise ValueError(
            f"changed row count mismatch: {len(changed_rows)} rows vs "
            f"{changed_rule_ids.shape[0]} id rows / {len(changed_item_counts)} item counts"
        )
    arrays = dict(
        version=np.int64(DELTA_BUNDLE_VERSION),
        seq=np.int64(seq),
        base_token=np.asarray(base_token),
        base_npz_sha256=np.asarray(base_npz_sha256),
        n_playlists=np.int64(n_playlists),
        min_count=np.int64(min_count),
        vocab=np.asarray(vocab, dtype=object),
        changed_rows=np.asarray(changed_rows, dtype=np.int32),
        changed_rule_ids=changed_rule_ids.astype(np.int32),
        changed_rule_counts=changed_rule_counts.astype(np.int32),
        changed_item_counts=np.asarray(changed_item_counts, dtype=np.int32),
        tombstones=np.asarray(list(tombstones), dtype=object),
    )
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    _atomic_write_bytes(path, buf.getvalue())


def load_delta_bundle(path: str, expect_sha256: str | None = None) -> dict[str, Any]:
    """Load and strictly validate a delta bundle. Raises ``ValueError`` on
    any structural problem — a digest that disagrees with the chain entry,
    a missing key, another version, malformed or out-of-range rows or ids,
    duplicate rows — which the engine treats as a rejection: the base keeps
    serving."""
    if expect_sha256 is not None:
        digest = file_digest(path)["sha256"]
        if digest != expect_sha256:
            raise ValueError(
                f"{path}: bundle sha256 {digest} != chain entry "
                f"{expect_sha256} (torn or tampered delta)"
            )
    raw = io.BytesIO(_read_bytes(path))
    with np.load(raw, allow_pickle=True) as npz:
        missing = [k for k in _DELTA_KEYS if k not in npz.files]
        if missing:
            raise ValueError(f"{path}: not a delta bundle (missing {missing})")
        version = int(npz["version"])
        if version != DELTA_BUNDLE_VERSION:
            raise ValueError(
                f"{path}: delta bundle version {version} != {DELTA_BUNDLE_VERSION}"
            )
        vocab = [str(s) for s in npz["vocab"]]
        rows = np.asarray(npz["changed_rows"], dtype=np.int32)
        ids = np.asarray(npz["changed_rule_ids"], dtype=np.int32)
        counts = np.asarray(npz["changed_rule_counts"], dtype=np.int32)
        items = np.asarray(npz["changed_item_counts"], dtype=np.int32)
        if ids.shape != counts.shape or ids.ndim != 2:
            raise ValueError(f"{path}: malformed changed-row tensors")
        if len(rows) != ids.shape[0] or len(rows) != len(items):
            raise ValueError(f"{path}: changed-row count mismatch")
        if len(rows) and (rows.min() < 0 or rows.max() >= len(vocab)):
            raise ValueError(f"{path}: changed_rows outside the new vocab")
        if len(rows) != len(set(rows.tolist())):
            raise ValueError(f"{path}: duplicate changed_rows")
        if ids.size and ids.max() >= len(vocab):
            raise ValueError(f"{path}: rule ids outside the new vocab")
        return {
            "version": version,
            "seq": int(npz["seq"]),
            "base_token": str(npz["base_token"]),
            "base_npz_sha256": str(npz["base_npz_sha256"]),
            "n_playlists": int(npz["n_playlists"]),
            "min_count": int(npz["min_count"]),
            "vocab": vocab,
            "changed_rows": rows,
            "changed_rule_ids": ids,
            "changed_rule_counts": counts,
            "changed_item_counts": items,
            "tombstones": [str(s) for s in npz["tombstones"]],
        }


def read_delta_state(pickles_dir: str) -> dict[str, Any] | None:
    """The parsed chain file, or None when absent or unreadable (no chain
    is the normal state between full publications)."""
    try:
        data = json.loads(_read_bytes(delta_state_path(pickles_dir)).decode("utf-8"))
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict) or not isinstance(data.get("entries"), list):
        return None
    return data


def write_delta_state(
    pickles_dir: str,
    base_token: str,
    base_npz_sha256: str,
    entries: list[dict[str, Any]],
) -> str:
    """Atomically (re)write the chain file, after the bundle bytes it lists
    (the manifest-then-token order): a reader that sees an entry can find
    its bundle."""
    out = delta_state_path(pickles_dir)
    _atomic_write_bytes(
        out,
        json.dumps(
            {
                "version": 1,
                "base_token": base_token,
                "base_npz_sha256": base_npz_sha256,
                "entries": entries,
            },
            indent=1, sort_keys=True,
        ).encode("utf-8"),
    )
    return out


def retire_delta_chain(pickles_dir: str) -> int:
    """Remove the chain file and every bundle: a full publication
    supersedes every delta of the previous generation. Never raises. →
    files removed."""
    removed = 0
    try:
        names = os.listdir(pickles_dir)
    except OSError:
        return 0
    for name in names:
        if name == DELTA_STATE_FILENAME or (
            name.startswith("delta-") and name.endswith(".bundle")
        ):
            try:
                os.unlink(os.path.join(pickles_dir, name))
                removed += 1
            except OSError:
                pass
    return removed
