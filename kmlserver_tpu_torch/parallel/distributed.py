"""Multi-rank runtime — counterpart of ``kmlserver_tpu/parallel/distributed.py``.

The reference runs one JAX process per host, bootstrapped by
``jax.distributed.initialize`` (``:51-106``), and lays a host's chips out
as a ``Mesh``. The port runs ONE PROCESS PER GPU under
``torch.distributed``, bootstrapped by the same env triple:

- ``KMLS_COORDINATOR_ADDRESS`` — host:port of rank 0 (unset → single
  process, no runtime);
- ``KMLS_NUM_PROCESSES`` — world size;
- ``KMLS_PROCESS_ID`` — the rank, falling back to ``JOB_COMPLETION_INDEX``.

Rank r takes ``cuda:(r % torch.cuda.device_count())``. The collective's
backend follows one rule (:func:`choose_backend`): NCCL when every rank
has a card of its own, gloo when ranks share a card (NCCL refuses two
ranks on one device) or run on the CPU. Gloo carries only ``all_reduce``
and ``broadcast`` on CUDA tensors (through the host), so the port uses
only those on the card; everything else (host names, barriers) runs over
the gloo world group on the host. The kernels run on the card either way.

Not ported: the serve-gang bootstrap (``:56-197``; the serve mesh is on
ROADMAP).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os
import socket
import threading
import time

from .. import faults
from .mesh import RankMesh, make_mesh, world_ranks

logger = logging.getLogger("kmlserver_tpu_torch.distributed")

COORDINATOR_ENV = "KMLS_COORDINATOR_ADDRESS"
NUM_PROCESSES_ENV = "KMLS_NUM_PROCESSES"
PROCESS_ID_ENV = "KMLS_PROCESS_ID"
K8S_INDEX_ENV = "JOB_COMPLETION_INDEX"


@dataclasses.dataclass(frozen=True)
class Runtime:
    rank: int
    backend: str  # the backend of the dp all-reduce: "nccl" or "gloo"
    group: object  # its process group (None = the gloo world group)
    hostnames: tuple[str, ...]  # per rank


_runtime: Runtime | None = None


def distributed_env() -> tuple[str, int, int] | None:
    """→ (coordinator, num_processes, process_id) or None (single-process)."""
    coordinator = os.getenv(COORDINATOR_ENV)
    if not coordinator:
        return None
    num = int(os.getenv(NUM_PROCESSES_ENV, "1"))
    raw_id = os.getenv(PROCESS_ID_ENV) or os.getenv(K8S_INDEX_ENV) or "0"
    process_id = int(raw_id)
    if process_id >= num:
        # e.g. an indexed k8s Job where KMLS_NUM_PROCESSES was forgotten:
        # fail with a clear config error instead of a bootstrap hang
        raise ValueError(
            f"process_id {process_id} >= num_processes {num}: set "
            f"{NUM_PROCESSES_ENV} to the Job's completion count"
        )
    return coordinator, num, process_id


def choose_backend(device_type: str, peers: list[tuple[str, int]]) -> str:
    """The collective's backend from every rank's ``(hostname, cuda
    device count)``: ``nccl`` when each rank has a card of its own (rank r
    takes card ``r % count`` of its host), else ``gloo``."""
    if device_type != "cuda":
        return "gloo"
    cards = {(host, rank % count) for rank, (host, count) in enumerate(peers)}
    return "nccl" if len(cards) == len(peers) else "gloo"


def maybe_initialize(device: str | None = None, timeout_s: float | None = None) -> bool:
    """Join the multi-rank runtime when the env triple is set; idempotent;
    False in a single process. Must run before the first touch of the
    device: it pins the rank's card. ``timeout_s`` is torch's own limit
    on each collective (None = torch's default); the job sets it above the
    watchdog's so that the watchdog, not torch, decides a hang."""
    global _runtime
    if _runtime is not None:
        return True
    env = distributed_env()
    if env is None:
        return False
    import torch
    import torch.distributed as dist

    from ..config import torch_device_from_env
    from ..utils.device import resolve_device

    coordinator, num_processes, rank = env
    dev = resolve_device(device or torch_device_from_env())
    count = 0
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        torch.cuda.set_device(rank % count)
    timeout = datetime.timedelta(seconds=timeout_s) if timeout_s else None
    logger.info(
        "joining distributed runtime: coordinator=%s rank=%d/%d",
        coordinator, rank, num_processes,
    )
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=rank, timeout=timeout,
    )
    peers: list = [None] * num_processes
    dist.all_gather_object(peers, (socket.gethostname(), count))
    backend = choose_backend(dev.type, peers)
    group = dist.new_group(backend="nccl", timeout=timeout) if backend == "nccl" else None
    if backend == "nccl":
        why = "one card per rank"
    elif dev.type == "cuda":
        why = "ranks share a card"
    else:
        why = "ranks on the CPU"
    where = f"cuda:{rank % count}" if dev.type == "cuda" else "cpu"
    print(
        f"Distributed runtime: rank {rank}/{num_processes} on {where}, "
        f"backend {backend} ({why})",
        flush=True,
    )
    _runtime = Runtime(
        rank=rank, backend=backend, group=group,
        hostnames=tuple(host for host, _ in peers),
    )
    return True


def runtime() -> Runtime | None:
    """The joined runtime, or None in a single process."""
    return _runtime


def collective_group():
    """The process group of the dp all-reduce (None = the default group)."""
    return _runtime.group if _runtime is not None else None


def barrier() -> None:
    """Every rank waits for all the others (on the host; no-op alone)."""
    if _runtime is not None:
        import torch.distributed as dist

        dist.barrier()


def shutdown() -> None:
    """Leave the runtime (no-op in a single process)."""
    global _runtime
    if _runtime is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        _runtime = None


# ---------- dead-rank watchdog ----------


class RankWatchdog:
    """Bounded-time abort for the multi-rank forever-hang — the reference's
    ``RankWatchdog`` (``kmlserver_tpu/parallel/distributed.py:203-413``),
    with its ``rank.heartbeat`` fault site.

    A collective has no application-level timeout that ends the job with
    the right exit code: when one rank dies, every surviving rank blocks in
    the next all-reduce (or fails with an unclassified error). Two
    independent detectors turn that into a bounded-time, *retryable*
    failure:

    - **peer heartbeats**: every rank's writer thread rewrites
      ``<dir>/rank<N>.hb`` (a shared-volume file holding ``time.time()``)
      every ``heartbeat_interval_s``; the monitor aborts when any peer's
      heartbeat is older than ``timeout_s``. Catches a DEAD process.
    - **collective guard**: :meth:`guard` brackets a collective section
      with a deadline (``collective_timeout_s``, default 6× the staleness
      timeout); the monitor aborts when the section is still open past it.
      Catches a HUNG peer whose heartbeat thread still runs. It is separate
      from, and much larger than, the staleness timeout: the guard
      brackets real compute, and a long mine must not read as a hang.

    Abort = ``on_abort(reason)``, default ``os._exit(exit_code)`` —
    ``sys.exit`` would only raise in the monitor thread while the main
    thread stays blocked in the collective. The default exit code is the
    job's resumable ``EXIT_RANK_DEAD`` (76).

    A peer that never wrote, or whose file was stamped before this
    watchdog started (a leftover of the previous gang), is aged from this
    watchdog's start, so a slow-booting pod gets the full ``timeout_s``.
    ``stop`` unlinks this rank's own file.
    """

    def __init__(
        self,
        directory: str,
        rank: int,
        num_processes: int,
        heartbeat_interval_s: float = 5.0,
        timeout_s: float = 300.0,
        collective_timeout_s: float | None = None,
        exit_code: int = 76,
        on_abort=None,
    ):
        self.directory = directory
        self.rank = rank
        self.num_processes = num_processes
        self.heartbeat_interval_s = heartbeat_interval_s
        self.timeout_s = timeout_s
        self.collective_timeout_s = (
            collective_timeout_s if collective_timeout_s is not None else 6 * timeout_s
        )
        self.exit_code = exit_code
        self.on_abort = on_abort or self._default_abort
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._t0 = 0.0
        self._t0_wall = 0.0
        self._guard_lock = threading.Lock()
        self._guard_name: str | None = None
        self._guard_deadline: float | None = None
        self.aborted_reason: str | None = None

    def _default_abort(self, reason: str) -> None:
        print(
            f"RANK WATCHDOG ABORT (rank {self.rank}): {reason} — exiting "
            f"{self.exit_code} (resumable)",
            flush=True,
        )
        os._exit(self.exit_code)

    def _beat_path(self, rank: int) -> str:
        return os.path.join(self.directory, f"rank{rank}.hb")

    def beat_once(self) -> bool:
        """Write this rank's heartbeat; False once the rank is fault-dead
        (the ``rank.heartbeat`` site, ``KMLS_FAULT_RANK_DEAD``)."""
        try:
            faults.fire("rank.heartbeat", replica=self.rank)
        except faults.FaultInjected:
            logger.warning("rank %d heartbeat silenced by injected fault", self.rank)
            return False
        from ..io.artifacts import atomic_write_text

        try:
            atomic_write_text(self._beat_path(self.rank), repr(time.time()))
        except OSError as exc:
            # a full/unwritable volume must not kill the job via its own
            # watchdog; peers age this rank out if it persists
            logger.warning("heartbeat write failed: %s", exc)
        return True

    def peer_ages(self) -> dict[int, float]:
        """Seconds since each PEER rank's last heartbeat; never-seen peers
        (no file, an unreadable one, or one stamped before this watchdog
        started) are aged from the watchdog's start."""
        now = time.time()
        since_start = time.monotonic() - self._t0
        ages: dict[int, float] = {}
        for rank in range(self.num_processes):
            if rank == self.rank:
                continue
            try:
                with open(self._beat_path(rank), "r", encoding="utf-8") as fh:
                    stamp = float(fh.read().strip())
            except (OSError, ValueError):
                ages[rank] = since_start
                continue
            ages[rank] = now - stamp if stamp >= self._t0_wall else since_start
        return ages

    def stale_peers(self) -> list[int]:
        return sorted(r for r, age in self.peer_ages().items() if age > self.timeout_s)

    @contextlib.contextmanager
    def guard(self, name: str):
        """Deadline-bracket a collective section: still open after
        ``collective_timeout_s`` → abort. One section at a time."""
        with self._guard_lock:
            self._guard_name = name
            self._guard_deadline = time.monotonic() + self.collective_timeout_s
        try:
            yield
        finally:
            with self._guard_lock:
                self._guard_name = None
                self._guard_deadline = None

    def _abort(self, reason: str) -> None:
        if self.aborted_reason is None:
            self.aborted_reason = reason
            self.on_abort(reason)

    def _beat_loop(self) -> None:
        while not self._stop.is_set():
            if not self.beat_once():
                return  # fault-dead: silent for good
            self._stop.wait(self.heartbeat_interval_s)

    def _monitor_loop(self) -> None:
        poll = min(self.heartbeat_interval_s, max(self.timeout_s / 10, 0.05))
        while not self._stop.wait(poll):
            with self._guard_lock:
                g_name, g_deadline = self._guard_name, self._guard_deadline
            if g_deadline is not None and time.monotonic() > g_deadline:
                self._abort(
                    f"collective section {g_name!r} exceeded "
                    f"{self.collective_timeout_s:.0f}s — a peer rank is hung or dead"
                )
                return
            stale = self.stale_peers()
            if stale:
                ages = self.peer_ages()
                detail = ", ".join(f"rank {r}: {ages[r]:.0f}s" for r in stale)
                self._abort(
                    f"peer heartbeat(s) stale past {self.timeout_s:.0f}s "
                    f"({detail}) — dead rank(s), collectives would hang"
                )
                return

    def start(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        self._t0 = time.monotonic()
        self._t0_wall = time.time()
        self.beat_once()  # first beat before any peer could judge us stale
        for target, name in (
            (self._beat_loop, "kmls-rank-heartbeat"),
            (self._monitor_loop, "kmls-rank-monitor"),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        try:
            os.unlink(self._beat_path(self.rank))
        except OSError:
            pass


# ---------- meshes over the ranks ----------


def hostnames() -> tuple[str, ...]:
    """Every rank's host name (this host's alone in a single process)."""
    if _runtime is not None:
        return _runtime.hostnames
    return (socket.gethostname(),)


def make_hybrid_mesh(
    dp_per_host: int | None = None,
    tp: int | None = None,
    ranks: list[int] | None = None,
) -> RankMesh:
    """A ``(dp, tp)`` mesh laid out for the fabric (reference ``:416-444``):
    ``tp`` packed within each host's ranks, ``dp`` across hosts × the
    leftover intra-host factor. Ranks are ordered host-major (a host keyed
    by its lowest rank), so each ``tp`` row stays on one host."""
    ranks = ranks if ranks is not None else world_ranks()
    hosts = hostnames()
    first_rank_of: dict[str, int] = {}
    for r in sorted(ranks):
        first_rank_of.setdefault(hosts[r], r)
    n = len(ranks)
    local = n // max(len(first_rank_of), 1)
    if tp is None:
        tp = local if dp_per_host is None else max(local // dp_per_host, 1)
    if local % tp != 0:
        raise ValueError(f"tp={tp} must divide the per-host rank count {local}")
    ordered = sorted(ranks, key=lambda r: (first_rank_of[hosts[r]], r))
    return make_mesh((n // tp, tp), ranks=ordered)


def resolve_mesh(mesh_shape: str, distributed: bool = False) -> RankMesh | None:
    """The ``KMLS_MESH_SHAPE`` string → mesh, with the reference's
    semantics (``:447-477``): ``""``/``"1x1"`` = no mesh;
    ``"hybrid"``/``"hybrid:tpN"`` = the host-aware layout; ``"auto"`` =
    hybrid when distributed, no mesh in a single process (one process
    drives one card here, so there is nothing local to shard over);
    anything else = an explicit ``DPxTP`` shape."""
    if mesh_shape in ("", "1x1"):
        return None
    if mesh_shape.startswith("hybrid"):
        if mesh_shape == "hybrid":
            return make_hybrid_mesh()
        if mesh_shape.startswith("hybrid:tp") and mesh_shape[9:].isdigit():
            return make_hybrid_mesh(tp=int(mesh_shape[9:]))
        raise ValueError(
            f"mesh shape must be 'hybrid' or 'hybrid:tpN', got {mesh_shape!r}"
        )
    if mesh_shape == "auto":
        return make_hybrid_mesh() if distributed else None
    return make_mesh(mesh_shape)
