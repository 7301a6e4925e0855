"""The serving side of the port's chaos suite — twin of the engine half of
``tests/test_chaos.py``, each scenario run on the port's engine (or app)
and the JAX package's over the same PVC with the same fault, and the two
held equal.

A failed reload keeps the last-good bundle and does not consume the
invalidation token; retries back off exponentially; torn, truncated and
bit-flipped artifacts are caught by the manifest (a flipped npz byte falls
back to the pickle in both packages, with equal answers); persistent
parse failures are quarantined and the engine recovers once the miner
republishes; ``replica.kernel`` faults degrade through the port's batchers
instead of answering 5xx; ``/readyz`` and ``/metrics`` report the recovery
state as the reference's app does. Rule ids outside the vocabulary (an npz
that parses cleanly) give the reference's answers instead of raising.
"""

import dataclasses
import json
import logging
import os
import shutil
import time

import numpy as np
import pytest
import torch

from kmlserver_tpu import faults as ref_faults
from kmlserver_tpu.io import artifacts as ref_artifacts
from kmlserver_tpu.ops.serve import recommend_batch as ref_recommend_batch
from kmlserver_tpu.serving.app import RecommendApp as RefApp
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu_torch import faults
from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.io import artifacts, registry
from kmlserver_tpu_torch.mining.pipeline import run_mining_job
from kmlserver_tpu_torch.ops.serve import recommend_batch
from kmlserver_tpu_torch.serving import engine as engine_mod
from kmlserver_tpu_torch.serving.app import RecommendApp
from kmlserver_tpu_torch.serving.engine import RecommendEngine

from .torch_chaos_util import (  # noqa: F401  (autouse fixture)
    clean_chaos_state,
    port_serving_cfg,
    ref_serving_cfg,
    serving_pvc,
)

pytestmark = pytest.mark.chaos


@pytest.fixture
def pvc(tmp_path):
    """A PVC mined by the port on the CPU → its mining config."""
    return serving_pvc(str(tmp_path / "pvc"))


@pytest.fixture
def port_apps():
    """Builds port apps on the CPU and closes them after the test."""
    built = []

    def make(cfg) -> RecommendApp:
        app = RecommendApp(cfg, device="cpu")
        built.append(app)
        return app

    yield make
    for app in built:
        app.close()


def _invalidate(base: str) -> None:
    registry.append_history_and_invalidate(MiningConfig(base_dir=base), 1, "chaos-ds")


def _paths(base: str) -> dict:
    pickles = os.path.join(base, "pickles")
    rec = os.path.join(pickles, "recommendations.pickle")
    return {"pickles": pickles, "best": os.path.join(pickles, "best_tracks.pickle"),
            "rec": rec, "npz": artifacts.tensor_artifact_path(rec)}


def _engines(base: str, **knobs):
    return (RecommendEngine(port_serving_cfg(base, **knobs), device="cpu"),
            RefEngine(ref_serving_cfg(base, **knobs)))


def _seed_sets(vocab: list[str]) -> list[list[str]]:
    sets = [[v] for v in vocab] + [vocab[i:i + 3] for i in range(0, len(vocab), 2)]
    return sets + [[vocab[0], "No Such Track"], ["No Such Track"]]


def _post(app, songs):
    return app.handle("POST", "/api/recommend/", json.dumps({"songs": songs}).encode())


def _view(response):
    status, headers, body = response
    kept = {k: v for k, v in headers.items() if k.startswith("X-KMLS-Degraded")}
    return status, kept, json.loads(body)


class TestReloadFaults:
    def test_failed_reload_does_not_swallow_token(self, pvc):
        base = pvc.base_dir
        port, ref = _engines(base)
        assert port.load() and ref.load()
        before = port.cache_value
        assert ref.cache_value == before
        _invalidate(base)
        faults.inject("engine.load", times=1)
        ref_faults.inject("engine.load", times=1)
        for engine in (port, ref):
            engine.reload_if_required()  # fails (injected)
            assert engine.cache_value == before  # token NOT consumed
            assert engine.finished_loading  # last-good still serving
            assert engine.reload_failures == 1
            assert engine.is_data_stale()  # the staleness signal survived
            engine._backoff_until = 0.0  # collapse the backoff for the test
            engine.reload_if_required()  # the next poll retries...
            assert engine.cache_value != before  # ...and succeeds
            assert engine.consecutive_reload_failures == 0
        assert port.cache_value == ref.cache_value

    def test_env_knob_arms_reload_fault(self, pvc, monkeypatch):
        monkeypatch.setenv("KMLS_FAULT_RELOAD_FAIL", "1")
        faults.load_env(force=True)
        ref_faults.load_env(force=True)
        for engine in _engines(pvc.base_dir):
            assert engine.load() is False  # injected failure
            assert engine.load()  # fault spent; the next attempt succeeds

    def test_failed_reload_backs_off_exponentially(self, pvc):
        """The poll path is gated while the backoff runs (the armed fault
        is not consumed), and each consecutive failure doubles it."""
        base = pvc.base_dir
        port, ref = _engines(base, reload_backoff_base_s=30.0, reload_backoff_max_s=100.0)
        assert port.load() and ref.load()
        _invalidate(base)
        faults.inject("engine.load", times=5)
        ref_faults.inject("engine.load", times=5)
        waits = {}
        for name, engine in (("port", port), ("ref", ref)):
            engine.reload_if_required()
            assert engine.consecutive_reload_failures == 1
            first = engine._backoff_until - time.monotonic()
            engine.reload_if_required()  # gated: a no-op
            assert engine.consecutive_reload_failures == 1
            engine._backoff_until = 0.0
            engine.reload_if_required()
            assert engine.consecutive_reload_failures == 2
            second = engine._backoff_until - time.monotonic()
            waits[name] = (round(first), round(second))
        assert waits["port"] == waits["ref"] == (30, 60)


class TestTornArtifacts:
    def _survives(self, base, port_apps, corrupt):
        """Both apps load, the artifacts are corrupted and the token moves:
        both keep their last-good bundle, answer 200, and /readyz says
        degraded (200) with equal reasons."""
        port = port_apps(port_serving_cfg(base))
        ref = RefApp(ref_serving_cfg(base))
        apps = (port, ref)
        for app in apps:
            assert app.engine.load()
        good = [app.engine.bundle for app in apps]
        token = port.engine.cache_value
        seeds = port.engine.bundle.vocab[:2]
        corrupt()
        _invalidate(base)
        for app, bundle in zip(apps, good):
            assert app.engine.is_data_stale()
            assert app.engine.load() is False  # fail-soft
            assert app.engine.bundle is bundle  # last-good serving
            assert app.engine.cache_value == token  # token unconsumed
            assert app.engine._backoff_until > time.monotonic()  # backoff armed
        answers = [_view(_post(app, seeds)) for app in apps]
        assert answers[0] == answers[1] and answers[0][0] == 200
        ready = [app.handle("GET", "/readyz", None) for app in apps]
        bodies = [json.loads(r[2]) for r in ready]
        assert [r[0] for r in ready] == [200, 200]
        assert bodies[0]["status"] == bodies[1]["status"] == "degraded"
        assert bodies[0]["reasons"] == bodies[1]["reasons"] == [
            "reload failing x1 (serving last-good bundle)"]

    def test_truncated_pickle_keeps_last_good(self, pvc, port_apps):
        paths = _paths(pvc.base_dir)

        def corrupt():
            faults.truncate_file(paths["rec"], keep_fraction=0.4)
            faults.truncate_file(paths["npz"], keep_fraction=0.4)

        self._survives(pvc.base_dir, port_apps, corrupt)

    def test_mid_replace_torn_read_simulation(self, pvc, port_apps):
        paths = _paths(pvc.base_dir)

        def corrupt():
            with open(paths["rec"], "rb") as fh:
                new_bytes = fh.read()
            with open(paths["rec"], "wb") as fh:
                fh.write(new_bytes[: len(new_bytes) // 2])
            faults.truncate_file(paths["npz"], keep_fraction=0.5)

        self._survives(pvc.base_dir, port_apps, corrupt)

    def test_truncated_npz_falls_back_to_pickle_via_manifest(self, pvc):
        base = pvc.base_dir
        engines = _engines(base)
        for engine in engines:
            assert engine.load()
        faults.truncate_file(_paths(base)["npz"], keep_fraction=0.3)
        _invalidate(base)
        for engine in engines:
            assert engine.load()  # the pickle carries the reload
            assert engine.consecutive_reload_failures == 0
        vocab = engines[1].bundle.vocab
        assert engines[0].bundle.vocab == vocab
        for seeds in _seed_sets(vocab):
            assert engines[0].recommend(seeds) == engines[1].recommend(seeds)

    def test_flipped_npz_byte_gives_the_references_answers(self, pvc, caplog):
        """One flipped byte in the npz: both packages' manifest checks
        catch it, both engines fall back to the pickle, and their answers
        are equal."""
        base = pvc.base_dir
        paths = _paths(base)
        faults.flip_byte(paths["npz"])
        assert artifacts.verify_files(paths["pickles"], [os.path.basename(paths["npz"])]) == [
            paths["npz"]]
        port, ref = _engines(base)
        with caplog.at_level(logging.WARNING):
            assert port.load() and ref.load()
        fallbacks = [r.name for r in caplog.records if "falling back to the pickle" in r.message]
        assert sorted(fallbacks) == ["kmlserver_tpu.serving", "kmlserver_tpu_torch.serving"]
        assert port.bundle.vocab == ref.bundle.vocab
        assert port.consecutive_reload_failures == ref.consecutive_reload_failures == 0
        for seeds in _seed_sets(port.bundle.vocab):
            assert port.recommend(seeds) == ref.recommend(seeds), seeds

    def test_checksum_mismatch_detected_by_manifest(self, pvc, port_apps):
        """Same-size bit rot in the pickle: only the sha256 catches it. With
        no prior bundle both apps fail soft (readyz 503), never publish."""
        base = pvc.base_dir
        paths = _paths(base)
        assert artifacts.verify_files(paths["pickles"], ["recommendations.pickle"]) == []
        faults.flip_byte(paths["rec"])
        assert artifacts.verify_files(paths["pickles"], ["recommendations.pickle"]) == [
            paths["rec"]]
        port, ref = port_apps(port_serving_cfg(base)), RefApp(ref_serving_cfg(base))
        for app in (port, ref):
            assert app.engine.load() is False
            assert app.handle("GET", "/readyz", None)[0] == 503

    def test_manifestless_writer_retires_stale_manifest(self, pvc):
        """A manifest-less writer republishes under this miner's old
        manifest: the manifest's token stamp makes it step aside instead of
        condemning (and quarantining) the fresh bytes."""
        base = pvc.base_dir
        engines = _engines(base, quarantine_after_failures=1)
        for engine in engines:
            assert engine.load()
        run_mining_job(dataclasses.replace(pvc, write_manifest=False, min_support=0.15),
                       device="cpu")
        assert artifacts.load_manifest(_paths(base)["pickles"]) is not None
        for engine in engines:
            assert engine.is_data_stale()
            assert engine.load()
            assert engine.consecutive_reload_failures == 0
            assert engine.artifact_quarantines == 0

    def test_quarantine_after_repeated_failures_then_recovery(self, pvc, tmp_path):
        """Each package on its own copy of the PVC: two parse failures
        quarantine the corrupt files, the miner's next publication brings
        the engine back, and both packages count the same."""
        outcomes = []
        for side in ("port", "ref"):
            base = str(tmp_path / side)
            shutil.copytree(pvc.base_dir, base)
            port, ref = _engines(base, quarantine_after_failures=2, reload_backoff_base_s=0.0)
            engine = port if side == "port" else ref
            assert engine.load()
            paths = _paths(base)
            faults.truncate_file(paths["rec"], keep_fraction=0.3)
            faults.truncate_file(paths["npz"], keep_fraction=0.3)
            _invalidate(base)
            first = engine.load(), engine.artifact_quarantines
            second = engine.load(), engine.artifact_quarantines
            qdir = os.path.join(paths["pickles"], artifacts.QUARANTINE_DIRNAME)
            moved = sorted(n.split(".1")[0] for n in os.listdir(qdir))
            gone = not os.path.exists(paths["rec"])
            run_mining_job(dataclasses.replace(pvc, base_dir=base,
                                               datasets_dir=os.path.join(base, "datasets")),
                           device="cpu")
            engine._backoff_until = 0.0
            engine.reload_if_required()
            outcomes.append((first, second, moved, gone, engine.consecutive_reload_failures,
                             engine.recommend(engine.bundle.vocab[:1])))
        assert outcomes[0] == outcomes[1]
        first, second, moved, gone, consecutive, _ = outcomes[0]
        assert first == (False, 0) and second[0] is False and second[1] >= 1
        assert gone and moved and consecutive == 0


# the fault's inputs: V = 3, two rule ids past the vocabulary (7 and 9)
OUT_OF_RANGE_IDS = np.array([[1, 7, -1], [0, 2, -1], [9, 1, 0]], dtype=np.int32)
OUT_OF_RANGE_COUNTS = np.array([[5, 4, 0], [1, 3, 0], [6, 2, 1]], dtype=np.int32)
OUT_OF_RANGE_SEEDS = np.array([[0, 2], [2, -1], [1, 0]], dtype=np.int32)


def _out_of_range_pvc(base: str) -> list[str]:
    """A PVC whose npz parses cleanly but carries rule ids >= V (no
    manifest) → the vocabulary."""
    pickles = os.path.join(base, "pickles")
    os.makedirs(pickles)
    vocab = ["track a", "track b", "track c"]
    artifacts.save_rule_tensors(
        artifacts.tensor_artifact_path(os.path.join(pickles, "recommendations.pickle")),
        vocab=vocab, rule_ids=OUT_OF_RANGE_IDS, rule_counts=OUT_OF_RANGE_COUNTS,
        item_counts=np.array([8, 7, 6], dtype=np.int32), n_playlists=10, min_support=0.05)
    artifacts.save_pickle({v: {} for v in vocab}, os.path.join(pickles, "recommendations.pickle"))
    artifacts.save_pickle([{"track_name": v, "count": 1} for v in vocab],
                          os.path.join(pickles, "best_tracks.pickle"))
    artifacts.atomic_write_text(os.path.join(base, "last_execution.txt"), "tok-1")
    return vocab


class TestOutOfRangeIds:
    def test_host_repair_gives_the_references_lookup(self):
        """The reference's scatter sends an id equal to V into its spill
        slot and drops one past it; the port drops them on the host before
        upload, so its unchanged lookup gives equal arrays."""
        confs = (OUT_OF_RANGE_COUNTS / 10).astype(np.float32)
        want_ids, want_confs = ref_recommend_batch(OUT_OF_RANGE_IDS, confs, OUT_OF_RANGE_SEEDS,
                                                   k_best=3)
        _, _, ids, got_confs = engine_mod._host_rule_arrays({
            "vocab": ["a", "b", "c"], "rule_ids": OUT_OF_RANGE_IDS, "rule_confs": confs,
            "known_mask": np.ones(3, dtype=bool)})
        got_ids, got_top = recommend_batch(torch.as_tensor(ids), torch.as_tensor(got_confs),
                                           torch.as_tensor(OUT_OF_RANGE_SEEDS), k_best=3)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(got_top.numpy(), np.asarray(want_confs))

    def test_engine_serves_out_of_range_npz_like_the_reference(self, tmp_path):
        base = str(tmp_path)
        vocab = _out_of_range_pvc(base)
        port, ref = _engines(base, verify_manifest=False)
        assert port.load() and ref.load()
        for seeds in ([vocab[0], vocab[2]], [vocab[2]], [vocab[1], vocab[0]], vocab):
            assert port.recommend(seeds) == ref.recommend(seeds), seeds
        # the engine keeps serving: a later lookup on the same engine works
        assert port.recommend([vocab[0]]) == ref.recommend([vocab[0]])

    def test_shape_mismatch_rolls_back_like_the_reference(self, tmp_path):
        """Confidences that do not match the ids' shape: the reference's
        warm-up refuses them, the port's host check too — both keep the
        last-good bundle."""
        base = str(tmp_path)
        vocab = _out_of_range_pvc(base)
        port, ref = _engines(base, verify_manifest=False)
        assert port.load() and ref.load()
        npz = _paths(base)["npz"]
        artifacts.save_rule_tensors(
            npz, vocab=vocab, rule_ids=np.array([[1, 2], [0, 2], [1, 0]], dtype=np.int32),
            rule_counts=np.array([[5, 4], [1, 3], [6, 2]], dtype=np.int32),
            item_counts=np.array([8, 7, 6], dtype=np.int32), n_playlists=10, min_support=0.05,
            rule_confs64=np.full((3, 3), 0.5))
        artifacts.atomic_write_text(os.path.join(base, "last_execution.txt"), "tok-2")
        for engine in (port, ref):
            good = engine.bundle
            assert engine.load() is False
            assert engine.bundle is good and engine.cache_value == "tok-1"


class _Apps:
    """A port app and a reference app over one PVC, loaded."""

    def __init__(self, base, port_apps, **knobs):
        self.port = port_apps(port_serving_cfg(base, **knobs))
        self.ref = RefApp(ref_serving_cfg(base, **knobs))
        assert self.port.engine.load() and self.ref.engine.load()

    def both(self, fn):
        return [fn(self.port, faults), fn(self.ref, ref_faults)]


class TestReplicaKernelFaults:
    def test_kernel_delay_past_deadline_degrades_not_500(self, pvc, port_apps):
        apps = _Apps(pvc.base_dir, port_apps, request_deadline_ms=80.0)
        seeds = apps.port.engine.bundle.vocab[:2]

        def delayed(app, fmod):
            fmod.inject("replica.kernel", replica=0, delay_s=0.5, times=-1)
            t0 = time.perf_counter()
            status, headers, body = _view(_post(app, seeds))
            elapsed = time.perf_counter() - t0
            fmod.clear()
            time.sleep(0.6)  # let the stalled batch drain
            return status, headers, bool(body["songs"]), elapsed < 0.45, _view(
                _post(app, seeds))[:2]

        port, ref = apps.both(delayed)
        assert port == ref
        assert port[:4] == (200, {"X-KMLS-Degraded": "deadline"}, True, True)
        assert port[4] == (200, {})
        assert apps.port.metrics.degraded_by_reason.get("deadline") == 1

    def test_failing_replica_is_ejected_with_zero_5xx(self, pvc, port_apps):
        """Two replicas on the CPU; replica 1's kernel fails for good after
        request 15 and the artifacts tear after request 30: every request
        answers 200, replica 1 is ejected, the reload fails soft — in both
        packages alike."""
        def scenario(app, fmod):
            vocab = app.engine.bundle.vocab
            statuses = []
            for i in range(60):
                if i == 15:
                    fmod.inject("replica.kernel", replica=1, times=-1)
                if i == 30:
                    paths = _paths(app.cfg.base_dir)
                    faults.truncate_file(paths["rec"], keep_fraction=0.3)
                    faults.truncate_file(paths["npz"], keep_fraction=0.3)
                    _invalidate(app.cfg.base_dir)
                    assert app.engine.load() is False
                statuses.append(_post(app, [vocab[i % len(vocab)], f"u{i}"])[0])
            text = app.handle("GET", "/metrics", None)[2].decode()
            ready = json.loads(app.handle("GET", "/readyz", None)[2])
            return (statuses, app.batcher.ejected_replicas(),
                    "kmls_replica_ejections_total 1" in text,
                    "kmls_reload_failures_total 1" in text, ready["reasons"])

        results = []
        for side in ("port", "ref"):
            base = os.path.join(os.path.dirname(pvc.base_dir), f"copy-{side}")
            shutil.copytree(pvc.base_dir, base)
            knobs = dict(serve_devices=2, request_deadline_ms=2000.0, replica_eject_threshold=2,
                         replica_probe_interval_s=30.0)
            if side == "port":
                app = port_apps(port_serving_cfg(base, **knobs))
                assert app.engine.load() and app.engine.n_replicas == 2
                results.append(scenario(app, faults))
            else:
                app = RefApp(ref_serving_cfg(base, **knobs))
                assert app.engine.load() and app.engine.n_replicas == 2
                results.append(scenario(app, ref_faults))
        assert results[0] == results[1]
        statuses, ejected, ejections, failures, reasons = results[0]
        assert set(statuses) == {200} and ejected == [1] and ejections and failures
        assert reasons == ["reload failing x1 (serving last-good bundle)",
                           "replicas ejected: [1]"]

    def test_env_knobs_arm_the_replica_site(self, pvc, monkeypatch):
        monkeypatch.setenv("KMLS_FAULT_REPLICA_FAIL", "0:2")
        faults.load_env(force=True)
        port, _ = _engines(pvc.base_dir)
        assert port.load()
        seeds = [port.bundle.vocab[0]]
        for _ in range(2):
            with pytest.raises(faults.FaultInjected):
                port.recommend(seeds)
        assert port.recommend(seeds)[1] in ("rules", "empty")
        faults.clear()
        monkeypatch.delenv("KMLS_FAULT_REPLICA_FAIL")
        monkeypatch.setenv("KMLS_FAULT_REPLICA_DELAY_MS", "0:120:1")
        faults.load_env(force=True)
        t0 = time.perf_counter()
        port.recommend(seeds)
        assert time.perf_counter() - t0 >= 0.12


class TestRecoveryMetrics:
    def test_recovery_series_and_readyz_match_the_reference(self, pvc, port_apps):
        apps = _Apps(pvc.base_dir, port_apps)

        def fail_one_reload(app, fmod):
            fmod.inject("engine.load", times=1)
            _invalidate(app.cfg.base_dir)
            app.engine.load()
            status, _, payload = app.handle("GET", "/readyz", None)
            text = app.handle("GET", "/metrics", None)[2].decode()
            series = {}
            for line in text.splitlines():
                name = line.split(" ")[0]
                if name in ("kmls_artifact_quarantines_total", "kmls_reload_failures_total",
                            "kmls_reload_consecutive_failures", "kmls_storage_slow"):
                    series[name] = line.split(" ")[1]
            body = json.loads(payload)
            return status, body["status"], body["reasons"], series

        port, ref = apps.both(fail_one_reload)
        assert port == ref
        assert port[3] == {"kmls_artifact_quarantines_total": "0",
                           "kmls_reload_failures_total": "1",
                           "kmls_reload_consecutive_failures": "1",
                           "kmls_storage_slow": "0"}


@pytest.mark.cuda
def test_cuda_engine_against_the_corrupt_artifact_ladder(pvc, tmp_path):
    """On the card: a flipped npz byte falls back to the pickle with the
    CPU engine's answers; a truncated pickle keeps the last-good bundle
    with the token unconsumed and the backoff armed; an npz with ids >= V
    under verification off publishes, answers like the CPU engine, and the
    CUDA context survives for a later lookup."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    base = pvc.base_dir
    paths = _paths(base)
    faults.flip_byte(paths["npz"])
    card = RecommendEngine(port_serving_cfg(base), device="cuda")
    cpu = RecommendEngine(port_serving_cfg(base), device="cpu")
    assert card.load() and cpu.load()
    for seeds in _seed_sets(card.bundle.vocab):
        assert card.recommend(seeds) == cpu.recommend(seeds)
    token = card.cache_value
    faults.truncate_file(paths["rec"], keep_fraction=0.4)
    _invalidate(base)
    assert card.load() is False and card.cache_value == token
    assert card._backoff_until > time.monotonic()
    oor = str(tmp_path / "oor")
    vocab = _out_of_range_pvc(oor)
    card = RecommendEngine(port_serving_cfg(oor, verify_manifest=False), device="cuda")
    cpu = RecommendEngine(port_serving_cfg(oor, verify_manifest=False), device="cpu")
    assert card.load() and cpu.load()
    for seeds in ([vocab[0], vocab[2]], vocab):
        assert card.recommend(seeds) == cpu.recommend(seeds)
    torch.cuda.synchronize()
    assert card.recommend([vocab[1]]) == cpu.recommend([vocab[1]])
