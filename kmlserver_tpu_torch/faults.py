"""Deterministic fault injection — counterpart of ``kmlserver_tpu/faults.py``,
the switchboard every recovery path of the port is tested through.

Code calls :func:`fire` (or :func:`take`, :func:`take_io`) at named sites;
nothing happens unless a fault is armed for that site, and the disarmed
check is one module-global read, so the hooks cost nothing on the hot path.

Sites wired in this package:

- ``"engine.load"`` — inside :meth:`RecommendEngine.load`'s artifact
  block, before publication: a fail fault fails the reload like a torn
  artifact would (last-good bundle kept, invalidation token not consumed).
- ``"replica.kernel"`` (keyed by replica index) — in the ``finish()``
  closure of :meth:`RecommendEngine.recommend_many_async`, before the
  wait on the batch's CUDA event: a fail fault raises (the batcher's
  circuit breaker and re-dispatch), a delay fault sleeps (the deadline
  degradation).
- ``"mine.crash.<phase>"`` — by the mining pipeline right after the
  phase's checkpoint is saved (``encode``/``mine``/``rules``/``embed``):
  the restarted job must resume from it and publish the same bytes.
- ``"embed.artifact"`` — inside the engine's embedding-artifact load: a
  fail fault makes ``embeddings.npz`` unloadable like a torn file, and the
  reload still publishes, serving rules only (never a failed reload,
  never a 5xx).
- ``"ckpt.corrupt"`` — inside :meth:`CheckpointStore.save`: the store
  truncates the bytes it writes (digest over the corrupt bytes), so the
  next load verifies but fails to parse — the two-strike quarantine.
- ``"rank.heartbeat"`` (keyed by rank) — in the dead-rank watchdog's beat
  loop: a fail fault silences that rank's heartbeats for good.
- ``"delta.apply"`` — in :meth:`RecommendEngine.apply_pending_deltas`,
  before a chain entry's bundle is read: a fail fault rejects the bundle
  like a torn one (the base generation keeps serving, the poll backs off,
  and a later apply lands the same bundle).
- ``"mesh.peer"`` (keyed by gang rank) — in the serve-gang worker's
  partial handler (:meth:`RecommendEngine._mesh_serve_partial`), on the
  answer path of a REMOTE rank: a fail fault makes the coordinating peer
  read that rank as a missing shard, a delay fault makes it a straggler
  (alive, correct, late) that ``KMLS_HEDGE`` leaves out of the merge.
- ``"io.write"`` / ``"io.read"`` / ``"io.fsync"`` — the storage plane,
  consumed through :func:`take_io` inside ``io/artifacts.py``'s one writer
  and reader, path-scoped (each armed fault carries an optional path
  substring). Kinds: ``enospc``, ``eio``, ``torn@N`` (write the first N
  bytes to the temp file, then raise :class:`TornWrite`), ``stall`` (the
  caller sleeps) and ``fail`` for fsync (never retried).

- ``"fleet.peer"`` (keyed by the replica's index in the sorted
  ``KMLS_FLEET_PEERS``, None off the routing tier) — once per recommend
  request: the asyncio transport takes it with :func:`take` and delays the
  request on a loop timer (a gray peer: alive, correct, late); the
  threaded transport fires it in ``RecommendApp._post_recommend``.

Arming, two ways:

- programmatic (tests): ``faults.inject("replica.kernel", replica=1,
  times=3)`` / ``faults.inject("replica.kernel", replica=0,
  delay_s=0.2, times=-1)``; ``faults.clear()`` in teardown.
- env knobs, parsed once at the first fire (or by :func:`load_env`), with
  the reference's names and grammar:

  - ``KMLS_FAULT_RELOAD_FAIL=N`` — fail the next N engine reloads;
  - ``KMLS_FAULT_REPLICA_FAIL=idx[:N]`` — replica ``idx``'s kernel
    raises on its next N completions (default 1; ``-1`` = forever);
  - ``KMLS_FAULT_REPLICA_DELAY_MS=idx:ms[:N]`` — replica ``idx``'s
    kernel sleeps ``ms`` per completion (default every completion);
  - ``KMLS_FAULT_MINE_CRASH_PHASE=phase[:N]`` — crash the mining job
    right after checkpointing ``phase`` (N jobs; default 1);
  - ``KMLS_FAULT_CKPT_CORRUPT=N`` — corrupt the next N checkpoint
    payloads at save time;
  - ``KMLS_FAULT_RANK_DEAD=rank`` — silence rank ``rank``'s watchdog
    heartbeats permanently;
  - ``KMLS_FAULT_EMBED_CORRUPT=N`` — fail the next N embedding-artifact
    loads;
  - ``KMLS_FAULT_DELTA_CORRUPT=N`` — reject the next N delta applies;
  - ``KMLS_FAULT_MESH_PEER_DELAY_MS=rank:ms[:N]`` — gang rank ``rank``'s
    worker sleeps ``ms`` before each of its next N partials (default
    every partial);
  - ``KMLS_FAULT_FLEET_PEER_DELAY_MS=idx:ms[:N]`` — fleet replica
    ``idx`` stalls ``ms`` on each of its next N recommend requests
    (default every request);
  - ``KMLS_FAULT_IO_WRITE=kind[:N][:substr]`` — next N artifact-plane
    writes whose destination contains ``substr`` fail with ``kind`` ∈
    ``enospc`` | ``eio`` | ``torn@BYTES`` (default N=1, any path);
  - ``KMLS_FAULT_IO_WRITE_STALL_MS=ms[:N][:substr]`` — stall matching
    writes ``ms`` each (default every write, any path);
  - ``KMLS_FAULT_IO_READ=N[:substr]`` — next N matching reads raise
    ``OSError(EIO)``;
  - ``KMLS_FAULT_IO_READ_STALL_MS=ms[:N][:substr]`` — stall matching
    reads ``ms`` each (default every read);
  - ``KMLS_FAULT_IO_FSYNC=N[:substr]`` — next N matching fsyncs fail.

:func:`truncate_file` and :func:`flip_byte` corrupt BYTES on a real
filesystem (what an interrupted writer or bit rot leaves behind), for the
integrity and quarantine machinery's tests.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import threading
import time

# fast-path gate: fire() returns immediately while nothing is armed.
# Benign race: a stale False read can only skip a fault armed
# concurrently with the dispatch it would have hit — tests arm faults
# before driving traffic.
_armed = False
_env_loaded = False
_lock = threading.Lock()


class FaultInjected(RuntimeError):
    """Raised by :func:`fire` when a fail fault triggers."""


class TornWrite(OSError):
    """Raised by :func:`take_io` for a ``torn@N`` write fault: the caller
    must write only the first ``keep_bytes`` bytes to the TEMP file and
    then re-raise — reproducing exactly what a writer killed mid-write
    leaves behind (a short temp file, never a torn destination)."""

    def __init__(self, site: str, keep_bytes: int):
        super().__init__(errno.EIO, f"injected torn write at {site}")
        self.keep_bytes = keep_bytes


@dataclasses.dataclass
class _Fault:
    remaining: int  # -1 = unlimited
    delay_s: float = 0.0
    fired: int = 0


@dataclasses.dataclass
class _IoFault:
    """A path-scoped storage fault (``io.*`` sites only)."""

    kind: str  # "enospc" | "eio" | "torn" | "stall" | "fail"
    remaining: int  # -1 = unlimited
    stall_s: float = 0.0
    torn_at: int = -1
    path_substr: str = ""
    fired: int = 0


# (site, replica-or-None) -> _Fault; a replica-keyed lookup falls back to
# the site-wide (replica=None) entry
_faults: dict[tuple[str, int | None], _Fault] = {}

# "io.write"/"io.read"/"io.fsync" -> armed storage faults, consumed in
# arming order by the first fault whose path_substr matches
_io_faults: dict[str, list[_IoFault]] = {}


def inject(
    site: str,
    *,
    replica: int | None = None,
    times: int = 1,
    delay_s: float = 0.0,
    kind: str = "",
    torn_at: int = -1,
    path: str = "",
) -> None:
    """Arm a fault at ``site``: ``delay_s > 0`` sleeps per fire (a slow
    kernel), otherwise the fire raises :class:`FaultInjected` (a failing
    kernel / reload). ``times=-1`` keeps firing until :func:`clear`.

    ``io.*`` sites route to the path-scoped storage plane instead:
    ``kind`` picks the failure (``enospc``/``eio``/``torn``/``stall``/
    ``fail``; defaults to ``stall`` when ``delay_s > 0``, else ``eio``
    for reads/writes and ``fail`` for fsync), ``torn_at`` is the byte
    count kept by a torn write, and ``path`` scopes the fault to
    destinations containing that substring (empty = every path)."""
    global _armed
    if site.startswith("io."):
        if not kind:
            if delay_s > 0:
                kind = "stall"
            elif torn_at >= 0:
                kind = "torn"
            else:
                kind = "fail" if site == "io.fsync" else "eio"
        with _lock:
            _io_faults.setdefault(site, []).append(
                _IoFault(
                    kind=kind,
                    remaining=times,
                    stall_s=delay_s,
                    torn_at=torn_at,
                    path_substr=path,
                )
            )
            _armed = True
        return
    with _lock:
        _faults[(site, replica)] = _Fault(remaining=times, delay_s=delay_s)
        _armed = True


def clear() -> None:
    """Disarm everything (test teardown). Also forgets the env parse so a
    later :func:`load_env` re-reads the knobs."""
    global _armed, _env_loaded
    with _lock:
        _faults.clear()
        _io_faults.clear()
        _armed = False
        _env_loaded = False


def active() -> dict[tuple[str, int | None], int]:
    """Snapshot of armed faults → remaining counts (diagnostics)."""
    with _lock:
        snap = {k: f.remaining for k, f in _faults.items()}
        for site, lst in _io_faults.items():
            for i, io_fault in enumerate(lst):
                snap[(f"{site}#{i}", None)] = io_fault.remaining
        return snap


def fired_counts() -> dict[tuple[str, int | None], int]:
    with _lock:
        return {k: f.fired for k, f in _faults.items()}


def take(site: str, replica: int | None = None) -> float:
    """Consume one armed fault for ``(site, replica)`` or ``(site,
    None)`` → its delay in seconds (0.0 when nothing is armed). Fail
    faults raise :class:`FaultInjected` exactly like :func:`fire`.
    A loop-native caller uses this to put the stall on a timer: a
    blocking sleep on the event loop would stall every in-flight request."""
    if not _armed and _env_loaded:
        return 0.0
    _ensure_env()
    if not _armed:
        return 0.0
    with _lock:
        fault = _faults.get((site, replica)) or _faults.get((site, None))
        if fault is None or fault.remaining == 0:
            return 0.0
        if fault.remaining > 0:
            fault.remaining -= 1
        fault.fired += 1
        delay = fault.delay_s
    if delay > 0:
        return delay
    raise FaultInjected(f"injected fault at {site}"
                        + (f" (replica {replica})" if replica is not None else ""))


def fire(site: str, replica: int | None = None) -> None:
    """Trigger point, called from instrumented code. No-op unless a fault is
    armed for ``(site, replica)`` or ``(site, None)``. Delay faults
    sleep (on the calling thread — see :func:`take` for the loop-native
    form); fail faults raise :class:`FaultInjected`."""
    delay = take(site, replica)
    if delay > 0:
        time.sleep(delay)


def take_io(site: str, path: str) -> float:
    """Consume one armed storage fault at ``site`` whose path scope
    matches ``path`` → stall seconds (0.0 when nothing matches; the
    CALLER sleeps, so read stalls can run under a deadline thread).
    Error kinds raise the errno a real bad mount would: ``enospc`` →
    ``OSError(ENOSPC)``, ``eio`` → ``OSError(EIO)``, ``torn`` →
    :class:`TornWrite` (caller keeps ``keep_bytes`` then re-raises),
    ``fail`` (fsync) → ``OSError(EIO)``."""
    if not _armed and _env_loaded:
        return 0.0
    _ensure_env()
    if not _armed:
        return 0.0
    with _lock:
        fault = None
        for candidate in _io_faults.get(site, ()):
            if candidate.remaining != 0 and candidate.path_substr in path:
                fault = candidate
                break
        if fault is None:
            return 0.0
        if fault.remaining > 0:
            fault.remaining -= 1
        fault.fired += 1
        kind, stall_s, torn_at = fault.kind, fault.stall_s, fault.torn_at
    if kind == "stall":
        return stall_s
    if kind == "enospc":
        raise OSError(errno.ENOSPC, f"injected ENOSPC at {site}: {path}")
    if kind == "torn":
        raise TornWrite(site, max(torn_at, 0))
    # "eio" and fsync "fail" both surface as the mount's EIO
    raise OSError(errno.EIO, f"injected EIO at {site}: {path}")


def load_env(force: bool = False) -> None:
    """Parse the ``KMLS_FAULT_*`` env knobs into armed faults. Runs once
    per process (lazily, at the first :func:`fire`); ``force=True``
    re-reads after an env change."""
    global _env_loaded
    with _lock:
        if _env_loaded and not force:
            return
        _env_loaded = True
    raw = os.getenv("KMLS_FAULT_RELOAD_FAIL")
    if raw:
        inject("engine.load", times=int(raw))
    raw = os.getenv("KMLS_FAULT_REPLICA_FAIL")
    if raw:
        parts = raw.split(":")
        inject(
            "replica.kernel", replica=int(parts[0]),
            times=int(parts[1]) if len(parts) > 1 else 1,
        )
    raw = os.getenv("KMLS_FAULT_REPLICA_DELAY_MS")
    if raw:
        parts = raw.split(":")
        inject(
            "replica.kernel", replica=int(parts[0]),
            delay_s=float(parts[1]) / 1e3,
            times=int(parts[2]) if len(parts) > 2 else -1,
        )
    raw = os.getenv("KMLS_FAULT_MINE_CRASH_PHASE")
    if raw:
        parts = raw.split(":")
        inject(
            f"mine.crash.{parts[0]}",
            times=int(parts[1]) if len(parts) > 1 else 1,
        )
    raw = os.getenv("KMLS_FAULT_CKPT_CORRUPT")
    if raw:
        inject("ckpt.corrupt", times=int(raw))
    raw = os.getenv("KMLS_FAULT_RANK_DEAD")
    if raw:
        inject("rank.heartbeat", replica=int(raw), times=-1)
    raw = os.getenv("KMLS_FAULT_EMBED_CORRUPT")
    if raw:
        inject("embed.artifact", times=int(raw))
    raw = os.getenv("KMLS_FAULT_DELTA_CORRUPT")
    if raw:
        inject("delta.apply", times=int(raw))
    raw = os.getenv("KMLS_FAULT_MESH_PEER_DELAY_MS")
    if raw:
        parts = raw.split(":")
        inject(
            "mesh.peer", replica=int(parts[0]),
            delay_s=float(parts[1]) / 1e3,
            times=int(parts[2]) if len(parts) > 2 else -1,
        )
    raw = os.getenv("KMLS_FAULT_FLEET_PEER_DELAY_MS")
    if raw:
        parts = raw.split(":")
        inject(
            "fleet.peer", replica=int(parts[0]),
            delay_s=float(parts[1]) / 1e3,
            times=int(parts[2]) if len(parts) > 2 else -1,
        )
    raw = os.getenv("KMLS_FAULT_IO_WRITE")
    if raw:
        parts = raw.split(":")
        kind, _, torn = parts[0].partition("@")
        inject(
            "io.write",
            kind="torn" if kind == "torn" else kind,
            torn_at=int(torn) if torn else -1,
            times=int(parts[1]) if len(parts) > 1 else 1,
            path=parts[2] if len(parts) > 2 else "",
        )
    raw = os.getenv("KMLS_FAULT_IO_WRITE_STALL_MS")
    if raw:
        parts = raw.split(":")
        inject(
            "io.write",
            kind="stall",
            delay_s=float(parts[0]) / 1e3,
            times=int(parts[1]) if len(parts) > 1 else -1,
            path=parts[2] if len(parts) > 2 else "",
        )
    raw = os.getenv("KMLS_FAULT_IO_READ")
    if raw:
        parts = raw.split(":")
        inject(
            "io.read",
            kind="eio",
            times=int(parts[0]) if parts[0] else 1,
            path=parts[1] if len(parts) > 1 else "",
        )
    raw = os.getenv("KMLS_FAULT_IO_READ_STALL_MS")
    if raw:
        parts = raw.split(":")
        inject(
            "io.read",
            kind="stall",
            delay_s=float(parts[0]) / 1e3,
            times=int(parts[1]) if len(parts) > 1 else -1,
            path=parts[2] if len(parts) > 2 else "",
        )
    raw = os.getenv("KMLS_FAULT_IO_FSYNC")
    if raw:
        parts = raw.split(":")
        inject(
            "io.fsync",
            kind="fail",
            times=int(parts[0]) if parts[0] else 1,
            path=parts[1] if len(parts) > 1 else "",
        )


def _ensure_env() -> None:
    if not _env_loaded:
        load_env()


# ---------- artifact corruption helpers (bytes, not call sites) ----------


def truncate_file(path: str, keep_fraction: float = 0.5) -> int:
    """Tear ``path`` the way an interrupted writer does: keep the leading
    ``keep_fraction`` of its bytes, drop the rest. → bytes kept."""
    size = os.path.getsize(path)
    keep = max(0, int(size * keep_fraction))
    with open(path, "rb+") as fh:
        fh.truncate(keep)
    return keep


def flip_byte(path: str, offset: int | None = None) -> int:
    """Flip one byte in place (silent bit-rot / bad sector). ``offset``
    defaults to the middle of the file. → the offset flipped."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path} is empty; nothing to corrupt")
    if offset is None:
        offset = size // 2
    with open(path, "rb+") as fh:
        fh.seek(offset)
        byte = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([byte[0] ^ 0xFF]))
    return offset
