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
ranks on one device) or run on the CPU. Each mesh axis gets a group of
the same backend (:func:`subgroup`). Gloo carries no send, receive or
all-gather of CUDA tensors, so ``parallel/collectives.py`` stages those
through host tensors whenever the group's backend is gloo; host names,
barriers and the delta route's outcome run over the gloo world group on
the host. The kernels run on the card either way.

The serve gang's identity (``:56-142``): ``KMLS_SERVE_GANG_COORDINATOR``,
``KMLS_SERVE_GANG_SIZE`` and ``KMLS_SERVE_GANG_RANK`` (falling back to the
StatefulSet ordinal, :func:`gang_rank_fallback`). :func:`choose_gang_transport`
picks how a gang exchanges its partials, from each member's own env alone:
the collective transport — one torch.distributed world over the gang
(:func:`maybe_initialize_serve_gang`, the reference's ``:145-197``) and the
rounds of ``serving/mesh.py::CollectiveGang`` — where every member has a
card of its own, else the socket transport of ``serving/mesh.py``.
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
# the serving twin of the env triple above (a StatefulSet gang of API pods
# whose vocab slabs form one logical replica); names of their own, so a pod
# can belong to a mining world and a serve gang at once
SERVE_GANG_COORDINATOR_ENV = "KMLS_SERVE_GANG_COORDINATOR"
SERVE_GANG_SIZE_ENV = "KMLS_SERVE_GANG_SIZE"
SERVE_GANG_RANK_ENV = "KMLS_SERVE_GANG_RANK"


@dataclasses.dataclass(frozen=True)
class Runtime:
    rank: int
    backend: str  # the backend of the dp all-reduce: "nccl" or "gloo"
    group: object  # its process group (None = the gloo world group)
    hostnames: tuple[str, ...]  # per rank
    timeout: object = None  # torch's limit on each collective (None = its default)
    # a serve gang's bound on a silent or hung member (jax's
    # heartbeat_timeout_seconds); None in a mining world
    heartbeat_timeout_s: float | None = None


_runtime: Runtime | None = None
# the axis groups made so far, by their ranks (every rank makes them in
# the same order, so the same key names the same group on every rank)
_subgroups: dict[tuple[int, ...], object] = {}


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


def gang_rank_fallback(default: int = 0) -> int:
    """The serve gang's rank when ``KMLS_SERVE_GANG_RANK`` is unset:
    ``JOB_COMPLETION_INDEX``, else the hostname's trailing ordinal (under a
    StatefulSet ``serve-gang-1`` is rank 1), else ``default``."""
    raw = os.getenv(K8S_INDEX_ENV)
    if raw is not None and raw.isdigit():
        return int(raw)
    _, _, ordinal = socket.gethostname().rpartition("-")
    return int(ordinal) if ordinal.isdigit() else default


def serve_gang_env() -> tuple[str, int, int] | None:
    """→ (coordinator, gang size, rank), or None with no gang armed. A rank
    outside the declared size is a config error raised at boot, never a
    hang."""
    coordinator = os.getenv(SERVE_GANG_COORDINATOR_ENV)
    if not coordinator:
        return None
    size = int(os.getenv(SERVE_GANG_SIZE_ENV, "1"))
    raw = os.getenv(SERVE_GANG_RANK_ENV)
    rank = int(raw) if raw not in (None, "") else gang_rank_fallback()
    if rank >= size:
        raise ValueError(
            f"serve gang rank {rank} >= gang size {size}: set "
            f"{SERVE_GANG_SIZE_ENV} to the StatefulSet's replica count"
        )
    return coordinator, size, rank


def choose_backend(device_type: str, peers: list[tuple[str, int]]) -> str:
    """The collective's backend from every rank's ``(hostname, cuda
    device count)``: ``nccl`` when each rank has a card of its own (rank r
    takes card ``r % count`` of its host), else ``gloo``."""
    if device_type != "cuda":
        return "gloo"
    cards = {(host, rank % count) for rank, (host, count) in enumerate(peers)}
    return "nccl" if len(cards) == len(peers) else "gloo"


def choose_gang_transport(device_type: str, gang, device_count: int) -> str:
    """How a serve gang exchanges its partials: ``"collective"`` (one
    torch.distributed world, :func:`maybe_initialize_serve_gang`) where
    the members cannot share a card — the gang's addresses
    (``GangConfig.peer_address``) name a host for each member, as the
    ``-0`` ordinal DNS form does, or one host has a card for each member
    (member r pins card ``r % device_count``, the NCCL condition of
    :func:`choose_backend`) — else ``"socket"``: on the CPU (the
    reference's CPU gate, ``:166-179``) and where members share a card,
    where a world would stage every tensor through the host as gloo does
    and give up the socket transport's failure model. Every member
    computes the same answer from its own env; nothing is exchanged."""
    if device_type != "cuda" or gang is None or gang.size <= 1:
        return "socket"
    hosts = {gang.peer_address(r)[0] for r in range(gang.size)}
    if len(hosts) == gang.size:
        return "collective"
    if len(hosts) == 1 and device_count >= gang.size:
        return "collective"
    return "socket"


def _join_world(coordinator: str, size: int, rank: int, device,
                timeout_s: float | None) -> tuple[str, str, str, list]:
    """The ``tcp://`` bootstrap both worlds share: pin the rank's card,
    join the gloo world, learn every rank's ``(host, card count)`` and make
    the NCCL group where :func:`choose_backend` says so → ``(backend, why,
    where, peers)``; the caller latches ``_runtime``."""
    import torch
    import torch.distributed as dist

    from ..config import torch_device_from_env
    from ..utils.device import resolve_device

    dev = resolve_device(device or torch_device_from_env())
    count = 0
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        torch.cuda.set_device(rank % count)
    timeout = datetime.timedelta(seconds=timeout_s) if timeout_s else None
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=size, rank=rank, timeout=timeout,
    )
    peers: list = [None] * size
    dist.all_gather_object(peers, (socket.gethostname(), count))
    backend = choose_backend(dev.type, peers)
    if backend == "nccl":
        why = "one card per rank"
    elif dev.type == "cuda":
        why = "ranks share a card"
    else:
        why = "ranks on the CPU"
    where = f"cuda:{rank % count}" if dev.type == "cuda" else "cpu"
    return backend, why, where, peers


def _latch(rank: int, backend: str, peers: list, timeout_s: float | None,
           heartbeat_timeout_s: float | None = None) -> None:
    global _runtime
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=timeout_s) if timeout_s else None
    group = dist.new_group(backend="nccl", timeout=timeout) if backend == "nccl" else None
    _runtime = Runtime(
        rank=rank, backend=backend, group=group,
        hostnames=tuple(host for host, _ in peers),
        timeout=timeout, heartbeat_timeout_s=heartbeat_timeout_s,
    )


def maybe_initialize(device: str | None = None, timeout_s: float | None = None) -> bool:
    """Join the multi-rank runtime when the env triple is set; idempotent;
    False in a single process. Must run before the first touch of the
    device: it pins the rank's card. ``timeout_s`` is torch's own limit
    on each collective (None = torch's default); the job sets it above the
    watchdog's so that the watchdog, not torch, decides a hang."""
    if _runtime is not None:
        return True
    env = distributed_env()
    if env is None:
        return False
    coordinator, num_processes, rank = env
    logger.info(
        "joining distributed runtime: coordinator=%s rank=%d/%d",
        coordinator, rank, num_processes,
    )
    backend, why, where, peers = _join_world(coordinator, num_processes, rank, device, timeout_s)
    print(
        f"Distributed runtime: rank {rank}/{num_processes} on {where}, "
        f"backend {backend} ({why})",
        flush=True,
    )
    _latch(rank, backend, peers, timeout_s)
    return True


def maybe_initialize_serve_gang(coordinator: str, size: int, rank: int, device=None,
                                heartbeat_timeout_s: float = 100.0) -> bool:
    """Join the serve gang's one torch.distributed world — the reference's
    ``maybe_initialize_serve_gang`` (``:145-197``) — over the gang's
    triple, through :func:`maybe_initialize`'s ``tcp://`` bootstrap and its
    latch (a process belongs to one world; a second call is a no-op). The
    backend is :func:`choose_backend`'s: NCCL where each member has a card
    of its own, else gloo. ``heartbeat_timeout_s`` mirrors jax's
    ``heartbeat_timeout_seconds`` and its default: the bound after which
    the gang's watchdog ends a member whose peer is silent or hung
    (``serving/mesh.py::CollectiveGang``). False for a gang of one; a
    failed bootstrap raises (the engine decides whether to fall back)."""
    if size <= 1:
        return False
    if _runtime is not None:
        return True
    logger.info(
        "joining serve-gang runtime: coordinator=%s rank=%d/%d",
        coordinator, rank, size,
    )
    backend, why, where, peers = _join_world(coordinator, size, rank, device, None)
    print(
        f"Serve gang: rank {rank}/{size} on {where}, backend {backend} ({why})",
        flush=True,
    )
    _latch(rank, backend, peers, None, heartbeat_timeout_s)
    return True


def runtime() -> Runtime | None:
    """The joined runtime, or None in a single process."""
    return _runtime


def collective_group():
    """The process group of the dp all-reduce (None = the default group)."""
    return _runtime.group if _runtime is not None else None


def subgroup(ranks: tuple[int, ...]):
    """The process group over ``ranks`` (a mesh axis), in the runtime's
    backend: None for one rank or in a single process (no collective
    runs), the collective group for the whole world, else a group made on
    first use. Every rank must call this for every axis in the same order:
    ``new_group`` is collective over the world."""
    if _runtime is None or len(ranks) <= 1:
        return None
    key = tuple(sorted(ranks))
    if len(key) == len(world_ranks()):
        return collective_group()
    if key not in _subgroups:
        import torch.distributed as dist

        _subgroups[key] = dist.new_group(list(key), timeout=_runtime.timeout,
                                         backend=_runtime.backend)
    return _subgroups[key]


def barrier() -> None:
    """Every rank waits for all the others (on the host; no-op alone)."""
    if _runtime is not None:
        import torch.distributed as dist

        dist.barrier()


def broadcast_from_writer(obj):
    """``obj`` as rank 0 holds it, on every rank (pickled over the gloo
    world group on the host; ``obj`` itself in a single process)."""
    if _runtime is None:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shutdown() -> None:
    """Leave the runtime (no-op in a single process)."""
    global _runtime
    if _runtime is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        _runtime = None
        _subgroups.clear()


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

    def abort(self, reason: str) -> None:
        """End this rank now through ``on_abort`` (once): a caller that saw
        the collective fail, or a peer leave, need not wait for the
        monitor."""
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
                self.abort(
                    f"collective section {g_name!r} exceeded "
                    f"{self.collective_timeout_s:.0f}s — a peer rank is hung or dead"
                )
                return
            stale = self.stale_peers()
            if stale:
                ages = self.peer_ages()
                detail = ", ".join(f"rank {r}: {ages[r]:.0f}s" for r in stale)
                self.abort(
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
