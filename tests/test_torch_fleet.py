"""The port's fleet routing tier (kmlserver_tpu_torch/freshness/ring.py
``FleetRouter`` / ``_PeerHealth``, serving/replay.py
``replay_fleet_http``) against the JAX package's: the reference's own ring,
router, slow-ladder and gang-as-peer cases run against both packages,
seeded op scripts drive both routers step for step on one fake clock, and
the two packages' routed replays drive one fleet of three port servers on
the CPU."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kmlserver_tpu.freshness import ring as ref_ring
from kmlserver_tpu.serving import replay as ref_replay
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu_torch.freshness import ring
from kmlserver_tpu_torch.serving import replay
from kmlserver_tpu_torch.serving.app import RecommendApp
from kmlserver_tpu_torch.serving.engine import RecommendEngine

from . import test_fleet, test_grayfailure, test_mesh
from .torch_serving_util import (
    ServerThread, mine_pvc, port_cfg, rebound_class, reference_cases, ref_cfg, seed_sets,
)

PACKAGES = {"reference": ref_ring, "port": ring}
RING_NAMES = ("FleetRouter", "RendezvousRing", "_weight", "seeds_key", "simulate_fleet")


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize(
    "cls,name",
    reference_cases(test_fleet.TestRingEdgeCases, test_fleet.TestFleetRouter,
                    test_grayfailure.TestSlowPeerLadder, test_mesh.TestGangAsRingPeer),
)
def test_reference_router_case(package, cls, name):
    """The reference's ring, breaker, slow-ladder and gang-as-peer cases
    (tests/test_fleet.py, test_grayfailure.py::TestSlowPeerLadder,
    test_mesh.py::TestGangAsRingPeer), their bodies run with each
    package's ring objects."""
    mod = PACKAGES[package]
    case = rebound_class(cls, **{n: getattr(mod, n) for n in RING_NAMES})
    getattr(case(), name)()


# ---------------------------------------------------------------- op scripts

PEERS = ["replica-0", "replica-1", "replica-2", "gang"]
LATENCIES = (0.0, 0.004, 0.01, 0.012, 0.05, 0.2, 1.5)

_op = st.one_of(
    st.tuples(st.just("route"), st.integers(0, 40)),
    st.tuples(st.just("fail"), st.sampled_from(PEERS + ["stranger"]),
              st.one_of(st.none(), st.integers(0, 3))),
    st.tuples(st.just("ok"), st.sampled_from(PEERS)),
    st.tuples(st.just("lat"), st.sampled_from(PEERS), st.sampled_from(LATENCIES)),
    st.tuples(st.just("tick"), st.sampled_from((0.0, 0.3, 1.0, 2.5))),
)


def _state(router, floor_s: float) -> dict:
    return {
        "ejected": router.ejected_peers(), "slow": router.slow_peers(),
        "shards": router.failed_shards(),
        "counters": (router.ejections, router.readmissions, router.probes, router.spills,
                     router.slow_ejections),
        "latency": [router.peer_latency_s(p) for p in PEERS],
        "hedge": [router.hedge_delay_s(p, floor_s) for p in PEERS],
    }


@pytest.mark.parametrize("eject_threshold,slow_ratio", [(1, 0.0), (3, 3.0), (2, 1.5)])
@settings(max_examples=40, deadline=None, derandomize=True)
@given(ops=st.lists(_op, min_size=1, max_size=80))
def test_router_scripts_match_the_reference_step_for_step(eject_threshold, slow_ratio, ops):
    """Seeded scripts of route / mark_failure / mark_success / mark_latency
    and clock steps: ``route()``, every counter, the EWMAs and
    ``hedge_delay_s`` equal the reference's after every step."""
    clock = [0.0]
    kw = dict(eject_threshold=eject_threshold, probe_interval_s=1.0, slow_ratio=slow_ratio,
              clock=lambda: clock[0])
    got, want = ring.FleetRouter(PEERS, **kw), ref_ring.FleetRouter(PEERS, **kw)
    for op in ops:
        if op[0] == "route":
            key = ring.seeds_key([f"track {op[1]}", "seed"])
            assert got.route(key) == want.route(key)
        elif op[0] == "fail":
            got.mark_failure(op[1], shard=op[2])
            want.mark_failure(op[1], shard=op[2])
        elif op[0] == "ok":
            got.mark_success(op[1])
            want.mark_success(op[1])
        elif op[0] == "lat":
            got.mark_latency(op[1], op[2])
            want.mark_latency(op[1], op[2])
        else:
            clock[0] += op[1]
        assert _state(got, 0.02) == _state(want, 0.02)


@pytest.mark.parametrize("n_replicas,capacity", [(3, 512), (2, 64), (5, 16)])
def test_fleet_multiplier_matches_the_reference(n_replicas, capacity):
    payloads = replay.sample_seed_sets([f"t{i}" for i in range(60)], 3000, zipf_s=0.9,
                                       zipf_pool=int(capacity * (n_replicas + 1.5)))
    keys = [ring.seeds_key(p) for p in payloads]
    assert ring.fleet_multiplier(keys, n_replicas, capacity) == ref_ring.fleet_multiplier(
        keys, n_replicas, capacity)


# ---------------------------------------------------------------- the replay

REPLAYS = {"reference": ref_replay, "port": replay}


@pytest.mark.parametrize("package", sorted(REPLAYS))
def test_unknown_policy_raises(package):
    with pytest.raises(ValueError):
        REPLAYS[package].replay_fleet_http({"a": "http://127.0.0.1:1"}, [["x"]], qps=10.0,
                                           policy="bogus")


@pytest.mark.parametrize("package", sorted(REPLAYS))
def test_routed_replay_against_a_dead_fleet_reports_errors(package):
    """Every peer refuses: every request burns its re-dispatch budget and
    counts as an error; the client neither hangs nor raises."""
    peer_urls = {f"replica-{i}": "http://127.0.0.1:9" for i in range(3)}
    payloads = [[f"s{i}"] for i in range(40)]
    report, fleet = REPLAYS[package].replay_fleet_http(
        peer_urls, payloads, qps=2000.0, redispatch_max=2, eject_threshold=2,
        probe_interval_s=0.05,
    )
    assert report.n_errors == len(payloads)
    assert fleet["http_5xx"] == 0 and fleet["ejections"] >= 1
    assert report.achieved_qps == 0.0


def _stub_server(status: int, headers: dict, body: bytes) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):  # noqa: N802 (stdlib API)
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(status)
            for k, v in {**headers, "Content-Type": "application/json",
                         "Content-Length": str(len(body))}.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.mark.parametrize("package", sorted(REPLAYS))
def test_gang_degraded_503_spills_not_5xx(package):
    """The reference's TestRoutedReplayMeshPolicy: a 503 with
    X-KMLS-Mesh-Unavailable is a peer failure (spill, shard blame), never
    a served 5xx."""
    gang = _stub_server(503, {"X-KMLS-Mesh-Unavailable": "1", "Retry-After": "1"},
                        b'{"detail": "shard 1 unavailable"}')
    solo = _stub_server(200, {}, json.dumps({"songs": ["t"]}).encode())
    try:
        payloads = [[f"s{i}"] for i in range(30)]
        report, fleet = REPLAYS[package].replay_fleet_http(
            {"gang": f"http://127.0.0.1:{gang.server_port}",
             "solo": f"http://127.0.0.1:{solo.server_port}"},
            payloads, qps=2000.0, eject_threshold=1, redispatch_max=4, probe_interval_s=30.0,
        )
    finally:
        gang.shutdown()
        solo.shutdown()
    assert report.n_errors == 0 and fleet["http_5xx"] == 0
    assert fleet["mesh_unavailable"] >= 1 and fleet["ejections"] >= 1
    assert fleet["failed_shards"] == {"gang": 1}
    assert fleet["answered_by"] == {"gang": 0, "solo": len(payloads)}


FLEET = [f"replica-{i}" for i in range(3)]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Three of the port's async servers on the CPU over one mined PVC, as
    kubernetes/statefulset.yaml names them."""
    pvc = mine_pvc(tmp_path_factory.mktemp("torch_fleet"))
    servers, apps = {}, []
    for me in FLEET:
        app = RecommendApp(port_cfg(pvc, fleet_self=me, fleet_peers=",".join(FLEET)),
                           device="cpu", defer_batcher=True)
        assert app.engine.load()
        apps.append(app)
        servers[me] = ServerThread(app, "async")
    yield pvc, servers, apps
    for srv in servers.values():
        srv.drain()
    for srv in servers.values():
        assert srv.join() == 0


@pytest.mark.parametrize("policy", ["ring", "roundrobin"])
def test_routed_replay_matches_the_reference_against_one_fleet(fleet, policy):
    """Both packages' routed replays against the same three servers: equal
    per-peer answer counts and owner stamps, no error, and every answer
    equal to the reference engine's on the PVC."""
    pvc, servers, apps = fleet
    urls = {me: srv.url for me, srv in servers.items()}
    payloads = seed_sets(pvc, 60, seed=3) * 2
    responses: list = []
    got_rep, got = replay.replay_fleet_http(urls, payloads, qps=300.0, policy=policy,
                                            window_end=60, responses=responses)
    want_rep, want = ref_replay.replay_fleet_http(urls, payloads, qps=300.0, policy=policy,
                                                  window_end=60)
    assert got_rep.n_errors == want_rep.n_errors == 0
    for key in ("answered_by", "owner_stamped", "http_5xx", "rerouted", "ejections",
                "window_requests", "peers", "policy"):
        assert got[key] == want[key], key
    if policy == "ring":
        assert got["owner_stamped"] == 0  # every request reached its owner
        owners = ring.RendezvousRing(FLEET)
        assert all(owners.owner(ring.seeds_key(payloads[i])) == peer
                   for i, peer, *_ in responses)
    else:
        assert got["owner_stamped"] > 0
    ref = RefEngine(ref_cfg(pvc))
    assert ref.load()
    assert len(responses) == len(payloads)
    for i, _peer, status, _head, body in responses:
        assert status == 200
        assert json.loads(body)["songs"] == ref.recommend(payloads[i])[0]


@pytest.mark.cuda
def test_cuda_routed_replica_answers_like_the_cpu_engine(tmp_path):
    """On the card: one routed replica stamps the owner of every request it
    does not own and answers exactly like the CPU engine."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    pvc = mine_pvc(tmp_path)
    app = RecommendApp(port_cfg(pvc, fleet_self="replica-0", fleet_peers=",".join(FLEET)),
                       device="cuda")
    cpu = RecommendEngine(port_cfg(pvc), device="cpu")
    try:
        assert app.engine.load() and cpu.load()
        owners = ring.RendezvousRing(FLEET)
        for seeds in seed_sets(pvc, 50, seed=4):
            status, headers, body = app.handle("POST", "/api/recommend/",
                                               json.dumps({"songs": seeds}).encode())
            assert status == 200
            assert json.loads(body)["songs"] == cpu.recommend(seeds)[0]
            owner = owners.owner(ring.seeds_key(seeds))
            assert headers.get("X-KMLS-Cache-Owner") == (None if owner == "replica-0" else owner)
    finally:
        app.close()
