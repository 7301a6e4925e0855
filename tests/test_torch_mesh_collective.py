"""The port's collective serve gang (``serving/mesh.py::CollectiveGang``,
``parallel/distributed.py::maybe_initialize_serve_gang`` and
``choose_gang_transport``, the engine's ``gang_transport``) on the CPU over
gloo, held against the JAX package's replicated ``RecommendEngine``.

Every multi-process case starts its members as ``python
tests/torch_gang_worker.py`` (the port alone, one torch.distributed world
over the gang); the reference's answers, and its lookup's ids and
confidences on each batch's staged seeds, are computed here. A member whose
generation differs is a missing shard, never a merged answer; a killed or
hung member ends its survivor with exit 76 within the heartbeat bound, and
a member that closes ends its peers at once.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from kmlserver_tpu.ops.serve import recommend_batch as ref_recommend_batch
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu_torch.io import registry
from kmlserver_tpu_torch.parallel import distributed
from kmlserver_tpu_torch.serving import mesh
from kmlserver_tpu_torch.serving.engine import RecommendEngine
from kmlserver_tpu_torch.serving.mesh import GangConfig

from .torch_chaos_util import (  # noqa: F401  (clean_chaos_state: autouse)
    SERVE_KNOBS,
    clean_chaos_state,
    port_serving_cfg,
    ref_serving_cfg,
    serving_pvc,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_gang_worker.py")
MEMBER_TIMEOUT_S = 60  # each member process's own limit
KILL_HEARTBEAT_S = 3.0  # the dead or hung member cases' bound
SLACK_S = 5.0  # what the bound may be overrun by (the watchdog's poll, process exit)


@pytest.fixture(scope="module")
def gang_pvc(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("collective") / "pvc")
    serving_pvc(base)
    return base


@pytest.fixture(scope="module")
def reference(gang_pvc):
    engine = RefEngine(ref_serving_cfg(gang_pvc))
    assert engine.load()
    return engine


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _known(reference) -> list[str]:
    bundle = reference.bundle
    return [s for s in bundle.vocab if bundle.known_mask[bundle.index[s]]]


def _batches(known: list[str], rng, n: int, max_rows: int) -> list:
    """``n`` batches of 1..max_rows seed sets of 1..4 known seeds, some with
    an unknown seed or none known (the fallback)."""
    out = []
    for _ in range(n):
        rows = []
        for _ in range(int(rng.integers(1, max_rows + 1))):
            seeds = [known[i] for i in rng.choice(len(known), int(rng.integers(1, 5)),
                                                  replace=False)]
            roll = rng.random()
            if roll < 0.15:
                seeds.append("definitely-not-a-track")
            elif roll < 0.2:
                seeds = ["definitely-not-a-track"]
            rows.append(seeds)
        out.append(rows)
    return out


class Gang:
    """S member processes over one PVC (or one per member), their specs
    and their results."""

    def __init__(self, tmp_path, pvcs: list[str], threads: list[list], after: list[str],
                 heartbeat_s: float, expect_missing: bool = False):
        self.dir = str(tmp_path)
        self.barrier = os.path.join(self.dir, "barrier")
        os.makedirs(self.barrier)
        coordinator = f"127.0.0.1:{_port()}"
        self.size = len(pvcs)
        self.procs, self.logs = [], []
        for rank, pvc in enumerate(pvcs):
            spec = dict(rank=rank, size=self.size, coordinator=coordinator,
                        heartbeat_timeout_s=heartbeat_s, base_dir=pvc, knobs=SERVE_KNOBS,
                        threads=threads[rank], out=self.out(rank), barrier_dir=self.barrier,
                        after=after[rank], expect_missing=expect_missing)
            path = os.path.join(self.dir, f"spec{rank}.json")
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(spec, fh)
            log = open(os.path.join(self.dir, f"member{rank}.log"), "w+", encoding="utf-8")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, WORKER, path], cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)))

    def out(self, rank: int) -> str:
        return os.path.join(self.dir, f"out{rank}.json")

    def result(self, rank: int) -> dict:
        with open(self.out(rank), encoding="utf-8") as fh:
            return json.load(fh)

    def output(self, rank: int) -> str:
        self.logs[rank].flush()
        with open(self.logs[rank].name, encoding="utf-8") as fh:
            return fh.read()

    def wait_files(self, prefix: str, count: int) -> None:
        deadline = time.monotonic() + MEMBER_TIMEOUT_S
        while sum(n.startswith(prefix) for n in os.listdir(self.barrier)) < count:
            dead = [r for r, p in enumerate(self.procs) if p.poll() is not None]
            assert not dead and time.monotonic() < deadline, (
                f"waiting for {prefix}: members {dead} ended\n" + self.outputs())
            time.sleep(0.02)

    def wait(self, rank: int, timeout_s: float = MEMBER_TIMEOUT_S) -> int:
        try:
            return self.procs[rank].wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"member {rank} still running\n" + self.outputs()) from None

    def outputs(self) -> str:
        return "\n".join(f"--- member {r}\n{self.output(r)[-3000:]}" for r in range(self.size))

    def stop(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        for log in self.logs:
            log.close()


@pytest.fixture
def gangs():
    started: list[Gang] = []
    yield started
    for gang in started:
        gang.stop()


def _hold_to_reference(reference, rows: list) -> int:
    """Every answered batch: the answers the reference engine's, and the
    merged ids and confidences its lookup's on the staged seeds, bit for
    bit → batches checked."""
    bundle = reference.bundle
    for row in rows:
        assert "error_rank" not in row, row
        want = reference.recommend_many(row["batch"])
        assert [tuple(a) for a in row["answers"]] == [tuple(a) for a in want], row["batch"]
        seeds = np.asarray(row["seeds"], dtype=np.int32)
        ids, confs = ref_recommend_batch(bundle.rule_ids, bundle.rule_confs, seeds,
                                         k_best=SERVE_KNOBS["k_best_tracks"])
        np.testing.assert_array_equal(np.asarray(row["ids"], dtype=np.int32), np.asarray(ids))
        np.testing.assert_array_equal(np.asarray(row["confs_bits"], dtype=np.uint32),
                                      np.asarray(confs, dtype=np.float32).view(np.uint32))
    return len(rows)


@pytest.mark.parametrize("size", [2, 3])
def test_gang_answers_as_the_reference(size, gang_pvc, reference, tmp_path, gangs):
    """S members answer concurrent batches of unequal sizes (two threads a
    member; at S = 3 the last member idle, and 19 tracks are no multiple of
    3) exactly as the reference's replicated engine, with zero unwarmed
    dispatches; /metrics and /readyz read the gang. Rank 0 closes once all
    are done and the others end with exit 76, naming it."""
    rng = np.random.default_rng(size)
    known = _known(reference)
    threads = [[_batches(known, rng, 12, 1 + 3 * (r + t)) for t in range(2)]
               for r in range(size)]
    if size == 3:
        threads[2] = []  # an idle member: every round it joins has none of its rows
    gang = Gang(tmp_path, [gang_pvc] * size, threads, ["close"] + ["stay"] * (size - 1), 30.0)
    gangs.append(gang)
    assert gang.wait(0) == 0, gang.outputs()
    for rank in range(1, size):
        assert gang.wait(rank) == 76, gang.outputs()
        assert "serve gang rank 0 left the gang" in gang.output(rank)
    checked = 0
    for rank in range(size):
        text = gang.output(rank)
        assert text.count("Serve gang: rank") == 1, text  # the engine's call: a no-op
        assert f"Serve gang: rank {rank}/{size} on cpu, backend gloo (ranks on the CPU)" in text
        assert (f"NOTE: serve gang rank {rank}/{size}: collective transport (asked for; members "
                "on the CPU)") in text
        result = gang.result(rank)
        assert result["transport"] == "collective"
        assert result["unwarmed"] == 0 and result["missing"] == []
        assert f'kmls_serve_mesh_shards{{state="serving"}} {size}' in result["metrics"]
        assert f"kmls_model_shards {size}" in result["metrics"]
        assert result["readyz"][0] == 200 and result["readyz"][1]["status"] == "ready"
        stats = result["stats"]
        assert stats["rounds"] >= stats["empty_rounds"] > 0 and stats["bytes_received"] > 0
        checked += sum(_hold_to_reference(reference, rows) for rows in result["threads"])
    assert checked == sum(len(b) for t in threads for b in t)


def test_another_generation_is_a_missing_shard(gang_pvc, reference, tmp_path, gangs):
    """Rank 1 serves a PVC whose token differs: each member's batches
    raise ``MeshShardUnavailable`` naming the other, never a merged
    answer, and /readyz names the missing shard."""
    other = str(tmp_path / "other_pvc")
    shutil.copytree(gang_pvc, other)
    token = registry.token_path_for(other, port_serving_cfg(other).data_invalidation_file)
    with open(token, "a", encoding="utf-8") as fh:
        fh.write("-next")
    known = _known(reference)
    rng = np.random.default_rng(7)
    threads = [[_batches(known, rng, 4, 3)] for _ in range(2)]
    gang = Gang(tmp_path / "run", [gang_pvc, other], threads, ["close", "stay"], 60.0,
                expect_missing=True)
    gangs.append(gang)
    assert gang.wait(0) == 0, gang.outputs()
    assert gang.wait(1) == 76, gang.outputs()
    for rank in range(2):
        result = gang.result(rank)
        peer = 1 - rank
        rows = [row for t in result["threads"] for row in t]
        assert rows and all(row.get("error_rank") == peer for row in rows), rows
        assert all("model token mismatch" in row["reason"] for row in rows)
        assert result["missing"] == [peer]
        status, body = result["readyz"]
        assert status == 200 and body["status"] == "degraded"
        assert f"serve_mesh_shard_missing:{peer}" in body["reasons"]


@pytest.mark.parametrize("sig, survivor", [
    (signal.SIGKILL, "submit_forever"),  # the collective fails at once
    (signal.SIGKILL, "stay"),  # the gang parked: the peer's heartbeat goes stale
    (signal.SIGSTOP, "submit_forever"),  # hung: the round's guard or the heartbeat
], ids=["killed-busy", "killed-idle", "hung-busy"])
def test_dead_or_hung_member_ends_its_survivor_with_76(sig, survivor, gang_pvc, reference,
                                                        tmp_path, gangs):
    """Rank 1 killed or stopped while rank 0 keeps submitting or idles:
    rank 0 exits 76 within the heartbeat bound (plus the watchdog's poll
    and the exit), never waiting on a hung collective."""
    known = _known(reference)
    rng = np.random.default_rng(11)
    threads = [[_batches(known, rng, 3, 4)] for _ in range(2)]
    gang = Gang(tmp_path, [gang_pvc] * 2, threads, [survivor, "stay"], KILL_HEARTBEAT_S)
    gangs.append(gang)
    gang.wait_files("done.", 2)
    t_kill = time.monotonic()
    gang.procs[1].send_signal(sig)
    assert gang.wait(0, KILL_HEARTBEAT_S + SLACK_S + 5) == 76, gang.outputs()
    assert time.monotonic() - t_kill <= KILL_HEARTBEAT_S + SLACK_S, gang.outputs()
    assert "RANK WATCHDOG ABORT (rank 0)" in gang.output(0)
    _hold_to_reference(reference, [row for t in gang.result(0)["threads"] for row in t])


def test_closing_member_ends_its_peers_at_once(gang_pvc, reference, tmp_path, gangs):
    """A member's close() (the SIGTERM drain's) rides its next header: its
    peer ends with exit 76 at once, long before the 60 s heartbeat bound."""
    known = _known(reference)
    rng = np.random.default_rng(13)
    threads = [[_batches(known, rng, 2, 2)] for _ in range(2)]
    gang = Gang(tmp_path, [gang_pvc] * 2, threads, ["stay", "close_now"], 60.0)
    gangs.append(gang)
    gang.wait_files("closing.", 1)
    t_close = time.monotonic()
    assert gang.wait(0, SLACK_S + 10) == 76, gang.outputs()
    assert time.monotonic() - t_close <= SLACK_S, gang.outputs()
    assert "serve gang rank 1 left the gang" in gang.output(0)
    assert gang.wait(1) == 0 and "CLOSED" in gang.output(1), gang.outputs()


# ---------------------------------------------------------------------------
# in one process: the transport choice, the bootstrap latch, the NOTE lines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_type, coordinator, count, want", [
    ("cpu", "127.0.0.1:9000", 0, "socket"),  # the reference's CPU gate
    ("cpu", "serve-gang-0.mesh:8477", 0, "socket"),
    ("cuda", "127.0.0.1:9000", 1, "socket"),  # every member on one card
    ("cuda", "127.0.0.1:9000", 2, "collective"),  # one host, a card a member
    ("cuda", "127.0.0.1:9000", 8, "collective"),
    ("cuda", "serve-gang-0.serve-mesh:8477", 1, "collective"),  # the -0 ordinal DNS form
    ("cuda", "fast-api-gang-0:8477", 1, "collective"),
])
def test_choose_gang_transport(device_type, coordinator, count, want):
    gang = GangConfig(coordinator, 2, 1)
    assert distributed.choose_gang_transport(device_type, gang, count) == want


def test_choose_gang_transport_needs_a_card_a_member():
    gang = GangConfig("127.0.0.1:9000", 3, 2)
    assert distributed.choose_gang_transport("cuda", gang, 2) == "socket"
    assert distributed.choose_gang_transport("cuda", gang, 3) == "collective"
    assert distributed.choose_gang_transport("cuda", None, 3) == "socket"


def test_serve_gang_bootstrap_latch(monkeypatch):
    """A gang of one joins nothing; with a world joined a second call is a
    no-op (no bootstrap runs)."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("bootstrap ran")

    monkeypatch.setattr(distributed, "_join_world", refuse)
    assert distributed.maybe_initialize_serve_gang("127.0.0.1:1", 1, 0, "cpu") is False
    monkeypatch.setattr(distributed, "_runtime", distributed.Runtime(
        rank=0, backend="gloo", group=None, hostnames=("h", "h"), heartbeat_timeout_s=3.0))
    assert distributed.maybe_initialize_serve_gang("127.0.0.1:1", 2, 0, "cpu") is True


def _gang_engine(gang_pvc, transport: str = "auto", rank: int = 0):
    cfg = port_serving_cfg(gang_pvc, serve_gang_coordinator="127.0.0.1:9", serve_gang_size=2,
                           serve_gang_rank=rank, serve_gang_port=0)
    return RecommendEngine(cfg, device="cpu", gang_transport=transport)


@pytest.mark.parametrize("transport, why", [
    ("auto", "members on the CPU"), ("socket", "asked for; members on the CPU")])
def test_socket_transport_note(transport, why, gang_pvc, capsys):
    engine = _gang_engine(gang_pvc, transport)
    try:
        assert engine.gang_transport == "socket" and engine.mesh_coordinator is None
    finally:
        engine.close()
    assert f"NOTE: serve gang rank 0/2: socket transport ({why})" in capsys.readouterr().out


def test_failed_bootstrap_falls_back_under_auto_and_raises_when_asked(gang_pvc, monkeypatch,
                                                                      capsys):
    """The reference's fail-soft path: under ``auto`` a failed collective
    bootstrap names the exception and the socket transport serves; under
    an explicit ``collective`` it raises."""
    def boom(*_args, **_kwargs):
        raise RuntimeError("no coordinator")

    monkeypatch.setattr(distributed, "choose_gang_transport", lambda *_a: "collective")
    monkeypatch.setattr(distributed, "maybe_initialize_serve_gang", boom)
    engine = _gang_engine(gang_pvc, "auto")
    try:
        assert engine.gang_transport == "socket"
    finally:
        engine.close()
    out = capsys.readouterr().out
    assert ("NOTE: serve gang rank 0/2: the collective bootstrap failed (RuntimeError: no "
            "coordinator); the socket transport serves") in out
    assert ("NOTE: serve gang rank 0/2: socket transport (the collective bootstrap failed)"
            in out)
    with pytest.raises(RuntimeError, match="no coordinator"):
        _gang_engine(gang_pvc, "collective")
    with pytest.raises(ValueError, match="gang_transport"):
        _gang_engine(gang_pvc, "nccl")


def test_token_digest_is_fixed_width_and_never_zero():
    digests = {mesh.token_digest(t) for t in ("", "a", "b", "2026-10-18T07:00:00")}
    assert len(digests) == 4 and 0 not in digests
    assert all(-(1 << 63) <= d < (1 << 63) for d in digests)
    assert mesh.token_digest("a") == mesh.token_digest("a")
