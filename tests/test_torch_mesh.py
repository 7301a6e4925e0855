"""The serve gang of the port (``serving/mesh.py``, the engine's ``mesh``
layout, the app's shard-loss answer) held against the JAX package's: gang
addressing, the wire protocol — byte for byte, a frame written by either
package decodes in the other — and a real two-member gang answering every
request exactly as a single engine serving the whole catalog does, both in
process and as two ``python -m kmlserver_tpu_torch.serving.server``
processes on the CPU; a dead member is a degraded answer naming its rank,
never a 5xx, and a respawned one is re-admitted.

Not here: the reference's ``TestGangAsRingPeer`` and
``TestRoutedReplayMeshPolicy`` (``tests/test_mesh.py:216-340``) — the gang
as one peer of the fleet router, and the router's 503 +
``X-KMLS-Mesh-Unavailable`` branch — wait for the port's fleet router.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from kmlserver_tpu.config import ServingConfig as RefServingConfig
from kmlserver_tpu.parallel import distributed as ref_distributed
from kmlserver_tpu.serving import mesh as ref_mesh
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu_torch import faults
from kmlserver_tpu_torch.config import ServingConfig
from kmlserver_tpu_torch.parallel import distributed
from kmlserver_tpu_torch.parallel.layout import resolve_serve_span
from kmlserver_tpu_torch.serving import mesh
from kmlserver_tpu_torch.serving.app import RecommendApp
from kmlserver_tpu_torch.serving.engine import RecommendEngine
from kmlserver_tpu_torch.serving.mesh import (
    GangConfig,
    MeshCoordinator,
    MeshPeerClient,
    MeshShardUnavailable,
    MeshWorkerServer,
    gang_from_config,
)

from .torch_chaos_util import (  # noqa: F401  (clean_chaos_state: autouse)
    clean_chaos_state,
    port_serving_cfg,
    ref_serving_cfg,
    serving_pvc,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestGangAddressing:
    """Every peer's address derives from the one coordinator value: the
    pod-DNS ordinal recipe and the bare-host port-offset recipe."""

    def test_pod_dns_ordinal_substitution(self):
        gang = GangConfig("fast-api-gang-0.fast-api-gang:8477", 3, 1)
        assert gang.peer_address(0) == ("fast-api-gang-0.fast-api-gang", 8477)
        assert gang.peer_address(2) == ("fast-api-gang-2.fast-api-gang", 8477)
        assert gang.my_address == ("fast-api-gang-1.fast-api-gang", 8477)

    def test_bare_ordinal_host(self):
        assert GangConfig("gang-0:9000", 2, 0).peer_address(1) == ("gang-1", 9000)

    def test_bare_host_offsets_ports(self):
        gang = GangConfig("127.0.0.1:9000", 3, 2)
        assert gang.peer_address(0) == ("127.0.0.1", 9000)
        assert gang.peer_address(2) == ("127.0.0.1", 9002)

    @pytest.mark.parametrize("coordinator", [
        "fast-api-gang-0.fast-api-gang:8477", "gang-0:9000", "127.0.0.1:9000",
        "serve-gang-0.serve-mesh.default.svc.cluster.local:8477", "host:1",
    ])
    def test_addresses_are_the_references(self, coordinator):
        for rank in range(4):
            assert GangConfig(coordinator, 4, 0).peer_address(rank) == (
                ref_mesh.GangConfig(coordinator, 4, 0).peer_address(rank))

    def test_malformed_coordinator_rejected(self):
        with pytest.raises(ValueError):
            GangConfig("no-port-here", 2, 0).peer_address(1)

    def test_gang_from_config_off_by_default(self):
        assert gang_from_config(ServingConfig()) is None
        assert gang_from_config(ServingConfig(serve_gang_size=2)) is None
        assert gang_from_config(ServingConfig(serve_gang_coordinator="127.0.0.1:9000")) is None

    def test_gang_from_config_fails_fast_on_bad_rank(self):
        cfg = ServingConfig(serve_gang_coordinator="127.0.0.1:9000", serve_gang_size=2,
                            serve_gang_rank=2)
        with pytest.raises(ValueError, match="rank 2 >= gang size 2"):
            gang_from_config(cfg)

    def test_resolve_serve_span_gang_is_decisive(self):
        for layout in ("replicated", "sharded", "auto"):
            assert resolve_serve_span(layout, 10, 5, 4, gang_size=2) == "mesh"
        assert resolve_serve_span("replicated", 10, 5, 4) == "replicated"
        assert resolve_serve_span("auto", 10, 5, 4) == "sharded"

    @pytest.mark.parametrize("env", [
        {},
        {"KMLS_SERVE_GANG_COORDINATOR": "gang-0.svc:8477", "KMLS_SERVE_GANG_SIZE": "3",
         "KMLS_SERVE_GANG_RANK": "2", "KMLS_SERVE_GANG_PORT": "9100"},
        {"KMLS_SERVE_GANG_COORDINATOR": "127.0.0.1:9000", "KMLS_SERVE_GANG_SIZE": "2",
         "JOB_COMPLETION_INDEX": "1", "KMLS_HEDGE": "1", "KMLS_HEDGE_DELAY_MS": "250",
         "KMLS_HEDGE_MAX_FRAC": "0.2", "KMLS_PEER_SLOW_RATIO": "3"},
        {"KMLS_SERVE_GANG_COORDINATOR": "127.0.0.1:9000", "KMLS_SERVE_GANG_SIZE": "2",
         "KMLS_MODEL_LAYOUT": "Sharded", "KMLS_DEVICE_BUDGET_BYTES": "64"},
        {"KMLS_MODEL_LAYOUT": "shard-it-all"},
    ])
    def test_env_knobs_parse_as_the_references(self, env, monkeypatch):
        """The serving fields the gang and the layout read, from the env,
        as the reference parses them (rank fallback included)."""
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        port, ref = ServingConfig.from_env(None), RefServingConfig.from_env(None)
        for field in ("model_layout", "device_budget_bytes", "serve_gang_coordinator",
                      "serve_gang_size", "serve_gang_rank", "serve_gang_port", "hedge_enabled",
                      "hedge_delay_ms", "hedge_max_frac", "peer_slow_ratio"):
            assert getattr(port, field) == getattr(ref, field), field
        assert distributed.serve_gang_env() == ref_distributed.serve_gang_env()
        assert distributed.gang_rank_fallback() == ref_distributed.gang_rank_fallback()

    def test_serve_gang_env_fails_fast_on_bad_rank(self, monkeypatch):
        monkeypatch.setenv("KMLS_SERVE_GANG_COORDINATOR", "127.0.0.1:9000")
        monkeypatch.setenv("KMLS_SERVE_GANG_SIZE", "2")
        monkeypatch.setenv("KMLS_SERVE_GANG_RANK", "5")
        with pytest.raises(ValueError, match="rank 5 >= gang size 2"):
            distributed.serve_gang_env()


def _start_worker(serve_partial, token="tok", module=mesh):
    return module.MeshWorkerServer(
        serve_partial, lambda: {"rank": 1, "token": token}, host="127.0.0.1", port=0,
    ).start()


def _echo_partial(token="tok"):
    """serve_partial double: ids = seeds clipped to >= 0, confs = row index."""

    def serve(seeds):
        ids = np.maximum(seeds, 0).astype(np.int32)
        confs = np.broadcast_to(
            np.arange(seeds.shape[0], dtype=np.float32)[:, None], seeds.shape
        ).astype(np.float32)
        return ids, confs, token

    return serve


def _frame_bytes(send, header, payload) -> bytes:
    """The bytes one package's ``_send_frame`` puts on the wire."""
    a, b = socket.socketpair()
    with a, b:
        send(a, header, payload)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while chunk := b.recv(1 << 16):
            chunks.append(chunk)
    return b"".join(chunks)


class TestWireProtocol:
    def test_partial_round_trip(self):
        worker = _start_worker(_echo_partial())
        try:
            client = MeshPeerClient(1, ("127.0.0.1", worker.port))
            seeds = np.array([[3, -1, 7], [2, 2, -1]], dtype=np.int32)
            ids, confs = client.partial(seeds, "tok")
            np.testing.assert_array_equal(ids, [[3, 0, 7], [2, 2, 0]])
            np.testing.assert_array_equal(confs, [[0, 0, 0], [1, 1, 1]])
            assert client.ready()["rank"] == 1
            client.close()
        finally:
            worker.stop()

    def test_token_mismatch_reads_as_missing_shard(self):
        worker = _start_worker(_echo_partial(token="other"))
        try:
            client = MeshPeerClient(1, ("127.0.0.1", worker.port))
            with pytest.raises(MeshShardUnavailable) as exc:
                client.partial(np.zeros((1, 2), dtype=np.int32), "tok")
            assert exc.value.rank == 1 and "token" in exc.value.reason
            client.close()
        finally:
            worker.stop()

    def test_dead_peer_raises_missing_shard(self):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        client = MeshPeerClient(0, ("127.0.0.1", port), connect_timeout_s=0.2)
        with pytest.raises(MeshShardUnavailable) as exc:
            client.partial(np.zeros((1, 1), dtype=np.int32), "tok")
        assert exc.value.rank == 0

    def test_stop_then_rebind_same_port(self):
        """stop() frees the port and drops the connections (a killed
        member's sockets all die), so a restarted member binds its rank's
        address again and the same client is served by it."""
        worker = _start_worker(_echo_partial())
        port = worker.port
        client = MeshPeerClient(1, ("127.0.0.1", port), connect_timeout_s=0.5)
        seeds = np.zeros((1, 2), dtype=np.int32)
        client.partial(seeds, "tok")
        worker.stop()
        with pytest.raises(MeshShardUnavailable):
            client.partial(seeds, "tok")
        reborn = MeshWorkerServer(_echo_partial(), lambda: {}, host="127.0.0.1", port=port).start()
        try:
            ids, _ = client.partial(seeds, "tok")
            np.testing.assert_array_equal(ids, [[0, 0]])
        finally:
            reborn.stop()
            client.close()

    def test_coordinator_probe_rate_limit_and_recovery(self):
        worker = _start_worker(_echo_partial())
        port = worker.port
        clock = [0.0]
        coord = MeshCoordinator(GangConfig(f"127.0.0.1:{port}", 2, 1), connect_timeout_s=0.3,
                                probe_min_interval_s=1.0, clock=lambda: clock[0])
        try:
            assert coord.missing_shards() == []
            worker.stop()
            finish = coord.fetch_partials(np.zeros((1, 1), dtype=np.int32), "tok")
            with pytest.raises(MeshShardUnavailable):
                finish()
            assert coord.missing_shards() == [0]
            clock[0] = 0.5
            assert coord.missing_shards(probe=True) == [0]
            reborn = MeshWorkerServer(_echo_partial(), lambda: {"ok": True}, host="127.0.0.1",
                                      port=port).start()
            try:
                clock[0] = 0.9  # inside the interval: no probe
                assert coord.missing_shards(probe=True) == [0]
                clock[0] = 2.0
                assert coord.missing_shards(probe=True) == []
            finally:
                reborn.stop()
        finally:
            coord.close()
            worker.stop()

    def test_expired_budget_is_shed_on_arrival(self):
        """A partial whose deadline budget arrived spent is shed, counted,
        and dropped from the merge (not blamed as a missing shard)."""
        worker = _start_worker(_echo_partial())
        coord = MeshCoordinator(GangConfig(f"127.0.0.1:{worker.port}", 2, 1))
        try:
            finish = coord.fetch_partials(np.zeros((1, 1), dtype=np.int32), "tok", budget_ms=0.0)
            assert finish() == {} and finish.dropped == [0]
            assert worker.expired_on_arrival == 1 and coord.missing_shards() == []
        finally:
            coord.close()
            worker.stop()

    @pytest.mark.parametrize("header,payload", [
        ({"op": "ready"}, b""),
        ({"op": "partial", "token": "tok-1", "shape": [2, 3], "payload_bytes": 24,
          "budget_ms": 12.5}, np.arange(6, dtype=np.int32).tobytes()),
        ({"ok": True, "token": "tök", "shape": [1, 2], "payload_bytes": 16},
         np.int32([4, -1]).tobytes() + np.float32([0.5, 0.0]).tobytes()),
        ({"ok": False, "error": "deadline-expired"}, b""),
    ])
    def test_frames_are_the_references_byte_for_byte(self, header, payload):
        """The same header and payload make the same bytes in both
        packages, and each package decodes the other's frame."""
        ours = _frame_bytes(mesh._send_frame, header, payload)
        assert ours == _frame_bytes(ref_mesh._send_frame, header, payload)
        for send, recv in ((mesh._send_frame, ref_mesh._recv_frame),
                           (ref_mesh._send_frame, mesh._recv_frame)):
            a, b = socket.socketpair()
            with a, b:
                send(a, header, payload)
                assert recv(b) == (header, payload)

    @pytest.mark.parametrize("worker_pkg,client_pkg", [(mesh, ref_mesh), (ref_mesh, mesh)])
    def test_each_package_serves_the_others_client(self, worker_pkg, client_pkg):
        worker = _start_worker(_echo_partial(), module=worker_pkg)
        try:
            client = client_pkg.MeshPeerClient(1, ("127.0.0.1", worker.port))
            seeds = np.array([[5, -1], [0, 9], [1, 1]], dtype=np.int32)
            ids, confs = client.partial(seeds, "tok", budget_ms=50.0)
            np.testing.assert_array_equal(ids, np.maximum(seeds, 0))
            np.testing.assert_array_equal(confs[:, 0], [0, 1, 2])
            assert client.ready()["rank"] == 1
            client.close()
        finally:
            worker.stop()


# ---------------------------------------------------------------------------
# end to end: a real two-member gang against one engine with the whole catalog
# ---------------------------------------------------------------------------


def _gang_ports() -> int:
    """Two consecutive free localhost ports (rank 0 on base, rank 1 on
    base + 1: the bare-host addressing recipe)."""
    for _ in range(50):
        with socket.socket() as s0:
            s0.bind(("127.0.0.1", 0))
            base = s0.getsockname()[1]
        if base + 1 > 65535:
            continue
        try:
            with socket.socket() as s1:
                s1.bind(("127.0.0.1", base + 1))
            return base
        except OSError:
            continue
    raise RuntimeError("no consecutive free port pair found")


@pytest.fixture(scope="module")
def mesh_pvc(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("mesh") / "pvc")
    serving_pvc(base)
    return base


def _gang_cfg(base, port, rank, **knobs) -> ServingConfig:
    return port_serving_cfg(base, serve_gang_coordinator=f"127.0.0.1:{port}", serve_gang_size=2,
                            serve_gang_rank=rank, serve_gang_port=port + rank, **knobs)


@pytest.fixture
def gang_pair(mesh_pvc):
    """(the reference's engine over the whole catalog, [rank 0, rank 1])."""
    reference = RefEngine(ref_serving_cfg(mesh_pvc))
    assert reference.load()
    port = _gang_ports()
    members = [RecommendEngine(_gang_cfg(mesh_pvc, port, rank), device="cpu")
               for rank in range(2)]
    try:
        for engine in members:
            assert engine.load()
        yield reference, members
    finally:
        for engine in members:
            engine.close()


def _seed_sets(engine) -> list[list[str]]:
    bundle = engine.bundle
    known = [s for s in bundle.vocab if bundle.known_mask[bundle.index[s]]]
    return [known[:3], known[3:5], known[5:9] + ["definitely-not-a-track"],
            ["definitely-not-a-track"], known[-1:], ["loner"], known[::4]]


class TestMeshEndToEnd:
    def test_gang_layout_published(self, gang_pair):
        _, members = gang_pair
        for rank, engine in enumerate(members):
            bundle = engine.replicas[0]
            assert bundle.layout == "mesh" and engine.model_layout == "mesh"
            assert bundle.n_shards == 2 and bundle.gang_rank == rank
            # the slab really is a slice: half the padded rows
            assert bundle.rule_ids.shape[0] == bundle.shard_size
            assert bundle.shard_size * 2 == bundle.mesh_v
            assert bundle.mesh_lo == rank * bundle.shard_size

    def test_identity_and_zero_unwarmed(self, gang_pair):
        """Every member answers every request as the reference's engine
        over the whole catalog, with zero unwarmed dispatches of either
        half."""
        reference, members = gang_pair
        sets = _seed_sets(members[0])
        want = [a for i in range(0, len(sets), 4) for a in reference.recommend_many(sets[i:i + 4])]
        for engine in members:
            got = [a for i in range(0, len(sets), 4) for a in engine.recommend_many(sets[i:i + 4])]
            assert got == want
            assert [engine.recommend(s) for s in sets] == [reference.recommend(s) for s in sets]
        assert all(e.unwarmed_dispatches == 0 for e in members)
        assert all(e.mesh_missing_shards() == [] for e in members)
        assert all(e.cost_model.compiles_post_publish().get("serve_mesh", 0) == 0
                   and e.cost_model.compiles_post_publish().get("serve_mesh_merge", 0) == 0
                   for e in members)
        assert sum(members[0].shard_dispatch_counts) > 0

    def test_member_death_and_reform(self, gang_pair):
        """A dead rank 1 is MeshShardUnavailable(rank=1) at rank 0, named by
        mesh_missing_shards; a re-formed worker on the same port is
        re-admitted by the rate-limited probe, answers identical again."""
        reference, members = gang_pair
        seeds = _seed_sets(members[0])[0]
        assert members[0].recommend(seeds) == reference.recommend(seeds)
        members[1].mesh_worker.stop()
        with pytest.raises(MeshShardUnavailable) as exc:
            members[0].recommend(seeds)
        assert exc.value.rank == 1
        assert members[0].mesh_missing_shards() == [1]
        members[1].mesh_worker = None
        members[1]._ensure_mesh_runtime()
        time.sleep(1.1)  # past the coordinator's probe rate limit
        assert members[0].mesh_missing_shards(probe=True) == []
        assert members[0].recommend(seeds) == reference.recommend(seeds)

    def test_armed_mesh_peer_fault_is_a_missing_shard(self, gang_pair):
        """``mesh.peer`` on rank 1, once: rank 0's next answer raises for
        rank 1, and the one after (the fault spent, the probe due) is the
        full-catalog answer again."""
        reference, members = gang_pair
        seeds = _seed_sets(members[0])[1]
        faults.inject("mesh.peer", replica=1, times=1)
        with pytest.raises(MeshShardUnavailable) as exc:
            members[0].recommend(seeds)
        assert exc.value.rank == 1
        time.sleep(1.1)
        assert members[0].mesh_missing_shards(probe=True) == []
        assert members[0].recommend(seeds) == reference.recommend(seeds)

    def test_hedged_straggler_is_a_degraded_answer(self, mesh_pvc):
        """With ``KMLS_HEDGE`` on rank 0, a rank 1 slowed past the straggler
        bound is left out of the merge: the answers are
        ``degraded:mesh-straggler`` and counted; the rank is not blamed."""
        port = _gang_ports()
        members = [RecommendEngine(_gang_cfg(mesh_pvc, port, rank, hedge_enabled=True,
                                             hedge_delay_ms=20.0, hedge_max_frac=1.0),
                                   device="cpu") for rank in range(2)]
        try:
            for engine in members:
                assert engine.load()
            faults.inject("mesh.peer", replica=1, delay_s=0.5, times=1)
            out = members[0].recommend_many(_seed_sets(members[0])[:2])
            assert [src for _songs, src in out] == ["degraded:mesh-straggler"] * 2
            assert members[0].mesh_straggler_degraded == 2
            assert members[0].mesh_coordinator.hedge_wins == 1
            assert members[0].mesh_missing_shards() == []
        finally:
            for engine in members:
                engine.close()

    def test_app_answers_shard_loss_degraded_and_readyz_names_it(self, gang_pair):
        """The app on rank 0 with rank 1 dead: 200 from the popularity
        fallback with ``X-KMLS-Degraded: mesh-shard-missing:1`` (mid-flight
        and then from the pre-check), ``/readyz`` degraded naming
        ``serve_mesh_shard_missing:1``, the gang gauge; all clear again
        after the re-form."""
        reference, members = gang_pair
        app = RecommendApp(members[0].cfg, engine=members[0], device="cpu")
        try:
            status, _, body = app.handle("GET", "/metrics", None)
            assert 'kmls_serve_mesh_shards{state="serving"} 2' in body.decode()
            members[1].mesh_worker.stop()
            sets = _seed_sets(members[0])
            for seeds in sets[:2]:
                status, headers, body = app.handle(
                    "POST", "/api/recommend/", json.dumps({"songs": seeds}).encode())
                assert status == 200, body
                assert headers["X-KMLS-Degraded"] == "mesh-shard-missing:1"
                assert json.loads(body)["songs"] == members[0].static_recommendation(seeds)
            status, _, body = app.handle("GET", "/readyz", None)
            ready = json.loads(body)
            assert status == 200 and ready["status"] == "degraded"
            assert "serve_mesh_shard_missing:1" in ready["reasons"]
            text = app.handle("GET", "/metrics", None)[2].decode()
            assert 'kmls_serve_mesh_shards{state="missing"} 1' in text
            assert 'kmls_degraded_by_reason{reason="mesh-shard-missing:1"} 2' in text
            members[1].mesh_worker = None
            members[1]._ensure_mesh_runtime()
            time.sleep(1.1)
            status, _, body = app.handle("GET", "/readyz", None)
            assert json.loads(body)["status"] == "ready"
            seeds = sets[2]
            status, headers, body = app.handle(
                "POST", "/api/recommend/", json.dumps({"songs": seeds}).encode())
            assert status == 200 and "X-KMLS-Degraded" not in headers
            assert json.loads(body)["songs"] == reference.recommend(seeds)[0]
        finally:
            app.close()


# ---------------------------------------------------------------------------
# the gang through the entry point: two server processes on the CPU
# ---------------------------------------------------------------------------


class _Server:
    """``python -m kmlserver_tpu_torch.serving.server`` on the CPU."""

    def __init__(self, env: dict):
        full = dict(os.environ, PYTHONPATH=REPO, KMLS_TORCH_DEVICE="cpu", KMLS_PORT="0",
                    OMP_NUM_THREADS="1", **env)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kmlserver_tpu_torch.serving.server"], cwd=REPO, env=full,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines: list[str] = []
        self.port: int | None = None
        self._bound = threading.Event()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())
            if "serving on" in line and self.port is None:
                self.port = int(line.split("serving on", 1)[1].split()[0].rsplit(":", 1)[1])
                self._bound.set()

    def get(self, path: str) -> tuple[int, dict]:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}", timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read() or b"{}")

    def post(self, seeds: list[str]) -> tuple[int, dict, dict]:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/api/recommend/",
            data=json.dumps({"songs": seeds}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, dict(r.headers), json.loads(r.read())
        except urllib.error.HTTPError as exc:
            return exc.code, dict(exc.headers), {}

    def wait_ready(self, want: str = "ready", timeout_s: float = 120.0) -> None:
        assert self._bound.wait(timeout_s), "\n".join(self.lines[-30:])
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            assert self.proc.poll() is None, "\n".join(self.lines[-30:])
            status, body = self.get("/readyz")
            if status == 200 and body.get("status") == want:
                return
            time.sleep(0.2)
        raise AssertionError(f"never {want}: {body}\n" + "\n".join(self.lines[-30:]))

    def stop(self, sig=signal.SIGTERM) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def test_two_server_processes_answer_as_one_engine(mesh_pvc):
    """The acceptance path on the CPU: two gang members started through the
    entry point answer every request as the replicated engine does, at
    either member; a SIGKILLed rank 1 is a 200 with ``X-KMLS-Degraded:
    mesh-shard-missing:1`` and a degraded ``/readyz`` naming it, never a
    5xx; the respawned rank 1 (same env) is re-admitted and uncached
    answers are the whole catalog's again."""
    port = _gang_ports()
    want_engine = RecommendEngine(port_serving_cfg(mesh_pvc), device="cpu")
    assert want_engine.load()
    sets = _seed_sets(want_engine)

    def env(rank: int) -> dict:
        return dict(BASE_DIR=mesh_pvc, KMLS_SERVE_GANG_COORDINATOR=f"127.0.0.1:{port}",
                    KMLS_SERVE_GANG_SIZE="2", KMLS_SERVE_GANG_RANK=str(rank),
                    KMLS_SERVE_GANG_PORT=str(port + rank), KMLS_MAX_SEED_TRACKS="8",
                    KMLS_BATCH_MAX_SIZE="8", K_BEST_TRACKS="5", KMLS_CACHE_ENABLED="0")

    servers = [_Server(env(rank)) for rank in range(2)]
    try:
        for server in servers:
            server.wait_ready()
        assert any(line.startswith("NOTE: serve gang rank") for line in servers[0].lines)
        for server in servers:
            for seeds in sets:
                status, headers, body = server.post(seeds)
                assert status == 200 and "X-KMLS-Degraded" not in headers, (seeds, headers)
                assert body["songs"] == want_engine.recommend(seeds)[0], seeds
        servers[1].stop(signal.SIGKILL)
        statuses = []
        for seeds in sets[:3]:
            status, headers, body = servers[0].post(seeds)
            statuses.append(status)
            assert status == 200
            assert headers.get("X-KMLS-Degraded") == "mesh-shard-missing:1", headers
        status, body = servers[0].get("/readyz")
        assert status == 200 and body["status"] == "degraded"
        assert "serve_mesh_shard_missing:1" in body["reasons"]
        servers[1] = _Server(env(1))
        servers[1].wait_ready()
        servers[0].wait_ready()  # the /readyz probe re-admits rank 1
        deadline = time.monotonic() + 30
        while True:  # the batcher's breaker may hold the replica a probe longer
            status, headers, body = servers[0].post(sets[-1])
            assert status == 200
            if "X-KMLS-Degraded" not in headers or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        for seeds in sets:
            status, headers, body = servers[0].post(seeds)
            assert status == 200 and "X-KMLS-Degraded" not in headers, headers
            assert body["songs"] == want_engine.recommend(seeds)[0]
    finally:
        for server in servers:
            server.stop()
    assert all(s.proc.returncode in (0, -signal.SIGKILL) for s in servers)
