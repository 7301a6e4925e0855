"""The storage side of the port's chaos suite — twin of
``tests/test_storage_chaos.py``: the path-scoped ``io.*`` fault sites of
``kmlserver_tpu_torch/faults.py`` against the port's durable writer and
reader (``io/artifacts.py``) and its IO-health monitor
(``io/iohealth.py``), with the reference's app beside the port's where
the answer is visible to a client.

- ENOSPC mid-publication: the last-good set keeps its bytes, the token
  does not move, no temp file is left, the job exits resumable, and the
  retry publishes from the intact checkpoints;
- EIO is retried; a torn write leaves its temp file, never the
  destination; a failed fsync aborts and is never retried;
- EIO on the token poll causes no reload; a hung reload read trips the
  read deadline and parks the reload in backoff on last-good;
- sustained slow IO convicts ``storage-slow`` in ``/readyz``;
- reclaim, the preflight that reclaims then publishes or exits 75, and
  the lease heartbeat's self-fence;
- each ``KMLS_FAULT_IO_*`` knob.
"""

import dataclasses
import errno
import json
import os
import time

import pytest

from kmlserver_tpu.io import iohealth as ref_iohealth
from kmlserver_tpu.serving.app import RecommendApp as RefApp
from kmlserver_tpu_torch import faults
from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.io import artifacts, iohealth, registry
from kmlserver_tpu_torch.mining.job import EXIT_RESUMABLE, classify_exception
from kmlserver_tpu_torch.mining.pipeline import run_mining_job
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


def _token_text(cfg) -> str | None:
    path = registry.token_path_for(cfg.base_dir, cfg.data_invalidation_file)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        return fh.read()


def _part_files(directory: str) -> list[str]:
    return [n for n in os.listdir(directory) if n.startswith(".tmp_") and n.endswith(".part")]


class TestEnospcMidPublish:
    def test_last_good_serves_and_token_unconsumed(self, pvc):
        rec_path = os.path.join(pvc.pickles_dir, pvc.recommendations_file)
        with open(rec_path, "rb") as fh:
            good_bytes = fh.read()
        token_before = _token_text(pvc)
        assert token_before is not None
        faults.inject("io.write", kind="enospc", times=1, path="recommendations")
        with pytest.raises(OSError) as excinfo:
            run_mining_job(pvc, device="cpu")
        assert excinfo.value.errno == errno.ENOSPC
        assert classify_exception(excinfo.value) == EXIT_RESUMABLE
        with open(rec_path, "rb") as fh:
            assert fh.read() == good_bytes  # last-good, byte for byte
        assert _token_text(pvc) == token_before
        assert _part_files(pvc.pickles_dir) == []  # ENOSPC unlinks its temp
        assert RecommendEngine(port_serving_cfg(pvc.base_dir), device="cpu").load()
        # the retry publishes from the intact checkpoints
        summary = run_mining_job(pvc, device="cpu")
        assert summary.resumed_phases == ("encode", "mine", "rules")
        assert _token_text(pvc) != token_before

    def test_write_retries_transient_eio_then_succeeds(self, tmp_path):
        target = str(tmp_path / "artifact.pickle")
        faults.inject("io.write", kind="eio", times=1, path="artifact")
        artifacts.save_pickle({"ok": 1}, target)
        assert artifacts.load_pickle(target) == {"ok": 1}
        snap = iohealth.MONITOR.snapshot()
        assert snap["retries"] == 1
        assert snap["errors"].get(("write", errno.EIO)) == 1

    def test_retries_stop_at_the_knob(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KMLS_IO_RETRIES", "1")
        monkeypatch.setenv("KMLS_IO_RETRY_BASE_MS", "1")
        faults.inject("io.write", kind="eio", times=2)
        with pytest.raises(OSError) as excinfo:
            artifacts.save_pickle({"ok": 1}, str(tmp_path / "x.pickle"))
        assert excinfo.value.errno == errno.EIO
        assert iohealth.MONITOR.snapshot()["retries"] == 1

    def test_torn_write_leaves_crash_artifact_not_destination(self, tmp_path):
        target = str(tmp_path / "artifact.bin")
        faults.inject("io.write", torn_at=3, times=1)
        with pytest.raises(faults.TornWrite):
            artifacts._atomic_write_bytes(target, b"0123456789")
        assert not os.path.exists(target)
        (part,) = _part_files(str(tmp_path))
        with open(os.path.join(str(tmp_path), part), "rb") as fh:
            assert fh.read() == b"012"  # exactly torn_at bytes
        assert iohealth.MONITOR.snapshot()["retries"] == 0


class TestTokenPollEio:
    def test_transient_eio_on_token_poll_causes_no_reload_churn(self, pvc):
        engine = RecommendEngine(port_serving_cfg(pvc.base_dir), device="cpu")
        assert engine.load()
        token_before = engine.cache_value
        faults.inject("io.read", kind="eio", times=1, path="last_execution")
        assert engine.is_data_stale() is False  # an EIO poll is not a change
        engine.reload_if_required()
        assert engine.cache_value == token_before
        assert engine.reload_failures == engine.consecutive_reload_failures == 0
        assert engine.finished_loading


class TestSlowReadReload:
    def test_hung_read_parks_reload_in_backoff_with_last_good(self, pvc):
        engine = RecommendEngine(
            port_serving_cfg(pvc.base_dir, io_read_deadline_s=0.2), device="cpu")
        assert engine.load()
        token_before = engine.cache_value
        registry.append_history_and_invalidate(MiningConfig(base_dir=pvc.base_dir), 1, "ds")
        faults.inject("io.read", delay_s=0.8, times=1, path="recommendations")
        t0 = time.monotonic()
        engine.reload_if_required()  # fails at the deadline, not after the stall
        assert time.monotonic() - t0 < 0.7
        assert engine.consecutive_reload_failures == 1
        assert "IoStallError" in engine.last_load_error
        assert engine._backoff_until > time.monotonic()
        assert engine.finished_loading and engine.cache_value == token_before
        engine._backoff_until = 0.0
        faults.clear()
        engine.reload_if_required()
        assert engine.consecutive_reload_failures == 0
        assert engine.cache_value != token_before

    def test_slow_io_conviction_degrades_readyz_like_the_reference(self, pvc):
        """Sustained slow IO convicts storage-slow: /readyz answers 200
        degraded with the reason, /metrics exports the conviction, and
        fast samples clear it — in both packages alike."""
        port = RecommendApp(port_serving_cfg(pvc.base_dir), device="cpu")
        ref = RefApp(ref_serving_cfg(pvc.base_dir))
        try:
            for app in (port, ref):
                assert app.engine.load()
            for monitor in (iohealth.MONITOR, ref_iohealth.MONITOR):
                for _ in range(iohealth.MIN_SAMPLES):
                    monitor.note_latency("write", 1.0)  # 1 s >> 250 ms
                assert monitor.storage_slow()
            views = []
            for app in (port, ref):
                status, _, payload = app.handle("GET", "/readyz", b"")
                text = app.handle("GET", "/metrics", b"")[2].decode()
                body = json.loads(payload)
                views.append((status, body["status"], body["reasons"],
                              "kmls_storage_slow 1" in text,
                              'kmls_io_latency_seconds{op="write"}' in text))
            assert views[0] == views[1] == (200, "degraded", ["storage-slow"], True, True)
            for monitor in (iohealth.MONITOR, ref_iohealth.MONITOR):
                for _ in range(200):
                    monitor.note_latency("write", 0.001)
                assert not monitor.storage_slow()
            assert json.loads(port.handle("GET", "/readyz", b"")[2])["status"] == "ready"
        finally:
            port.close()


class TestDiskFullReclaim:
    def test_reclaim_frees_quarantine_and_orphans_only(self, pvc):
        qdir = os.path.join(pvc.pickles_dir, artifacts.QUARANTINE_DIRNAME)
        os.makedirs(qdir, exist_ok=True)
        with open(os.path.join(qdir, "corpse.pickle"), "wb") as fh:
            fh.write(b"x" * 1024)
        with open(os.path.join(pvc.pickles_dir, ".tmp_dead.part"), "wb") as fh:
            fh.write(b"y" * 512)
        live = os.path.join(pvc.pickles_dir, pvc.recommendations_file)
        live_size = os.path.getsize(live)
        assert artifacts.reclaim_space(pvc.pickles_dir) == 1024 + 512
        assert os.listdir(qdir) == [] and _part_files(pvc.pickles_dir) == []
        assert os.path.getsize(live) == live_size  # the live set untouched

    def test_preflight_reclaims_then_publishes(self, pvc):
        qdir = os.path.join(pvc.pickles_dir, artifacts.QUARANTINE_DIRNAME)
        os.makedirs(qdir, exist_ok=True)
        with open(os.path.join(qdir, "corpse.pickle"), "wb") as fh:
            fh.write(b"x" * 2048)
        assert artifacts.ensure_free_space(pvc.pickles_dir, 1) > 0
        token_before = _token_text(pvc)
        run_mining_job(dataclasses.replace(pvc, disk_min_free_bytes=1 << 20), device="cpu")
        assert _token_text(pvc) != token_before

    def test_exhausted_after_reclaim_exits_resumable(self, pvc):
        with pytest.raises(artifacts.StorageExhaustedError) as excinfo:
            artifacts.ensure_free_space(pvc.pickles_dir, 1 << 60)
        assert classify_exception(excinfo.value) == EXIT_RESUMABLE
        # the pipeline's preflight aborts before any phase or write
        token_before = _token_text(pvc)
        with pytest.raises(artifacts.StorageExhaustedError):
            run_mining_job(dataclasses.replace(pvc, disk_min_free_bytes=1 << 60), device="cpu")
        assert _token_text(pvc) == token_before
        assert not os.path.exists(os.path.join(pvc.checkpoint_path, "encode.ckpt"))


class TestHeartbeatSelfFence:
    def test_stalled_heartbeat_self_fences_sticky(self, tmp_path):
        pickles = str(tmp_path / "pickles")
        os.makedirs(pickles)
        lease = artifacts.PublicationLease.acquire(pickles, ttl_s=0.5, stall_fraction=0.2)
        faults.inject("io.write", delay_s=0.3, times=1, path="publish.lease")
        with pytest.raises(artifacts.LeaseLostError) as excinfo:
            lease.heartbeat()
        assert lease.lost
        assert classify_exception(excinfo.value) == EXIT_RESUMABLE
        with pytest.raises(artifacts.LeaseLostError):
            lease.heartbeat()  # sticky

    def test_fast_heartbeat_does_not_fence(self, tmp_path):
        pickles = str(tmp_path / "pickles")
        os.makedirs(pickles)
        lease = artifacts.PublicationLease.acquire(pickles, ttl_s=0.5, stall_fraction=0.5)
        lease.heartbeat()
        assert not lease.lost
        lease.release()

    def test_stalled_heartbeat_thread_fences_the_job(self, pvc, monkeypatch):
        """The heartbeat thread whose write stalls on the volume mid-run
        self-fences, and the job aborts resumable at its first fence point
        instead of publishing."""
        from kmlserver_tpu_torch.mining import pipeline

        token_before = _token_text(pvc)
        cfg = dataclasses.replace(pvc, lease_ttl_s=0.5, lease_heartbeat_interval_s=0.05,
                                  lease_stall_fraction=0.2)
        real_encode = pipeline._run_encode_phase

        def slow_encode(*args):
            # the next heartbeat write stalls past 0.2 x ttl
            faults.inject("io.write", delay_s=0.3, times=1, path="publish.lease")
            time.sleep(0.6)
            return real_encode(*args)

        monkeypatch.setattr(pipeline, "_run_encode_phase", slow_encode)
        with pytest.raises(artifacts.LeaseLostError) as excinfo:
            run_mining_job(cfg, device="cpu")
        assert classify_exception(excinfo.value) == EXIT_RESUMABLE
        assert _token_text(pvc) == token_before


class TestFsyncFailure:
    def test_fsync_failure_aborts_cleanly_never_retried(self, tmp_path):
        target = str(tmp_path / "artifact.pickle")
        artifacts.save_pickle({"generation": 1}, target)
        faults.inject("io.fsync", times=1)
        with pytest.raises(artifacts.FsyncFailedError):
            artifacts.save_pickle({"generation": 2}, target)
        assert artifacts.load_pickle(target) == {"generation": 1}
        assert _part_files(str(tmp_path)) == []
        assert iohealth.MONITOR.snapshot()["retries"] == 0
        artifacts.save_pickle({"generation": 2}, target)
        assert artifacts.load_pickle(target) == {"generation": 2}


class TestEnvKnobArming:
    """Each KMLS_FAULT_IO_* knob arms its site from the environment."""

    def test_io_write_knob(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KMLS_FAULT_IO_WRITE", "enospc:1:scoped")
        faults.load_env(force=True)
        with pytest.raises(OSError) as excinfo:
            artifacts.atomic_write_text(str(tmp_path / "scoped.txt"), "x")
        assert excinfo.value.errno == errno.ENOSPC
        artifacts.atomic_write_text(str(tmp_path / "other.txt"), "y")  # out of scope

    def test_io_write_torn_knob(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KMLS_FAULT_IO_WRITE", "torn@4:1")
        faults.load_env(force=True)
        with pytest.raises(faults.TornWrite):
            artifacts._atomic_write_bytes(str(tmp_path / "t.bin"), b"abcdefgh")
        (part,) = _part_files(str(tmp_path))
        assert os.path.getsize(os.path.join(str(tmp_path), part)) == 4

    def test_io_write_stall_knob(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KMLS_FAULT_IO_WRITE_STALL_MS", "60:1")
        faults.load_env(force=True)
        t0 = time.monotonic()
        artifacts.atomic_write_text(str(tmp_path / "s.txt"), "x")
        assert time.monotonic() - t0 >= 0.06

    def test_io_read_knob(self, tmp_path, monkeypatch):
        path = str(tmp_path / "r.txt")
        artifacts.atomic_write_text(path, "payload")
        monkeypatch.setenv("KMLS_FAULT_IO_READ", "1")
        faults.load_env(force=True)
        with pytest.raises(OSError) as excinfo:
            artifacts.read_text(path)
        assert excinfo.value.errno == errno.EIO
        assert artifacts.read_text(path) == "payload"  # fault spent

    def test_io_read_stall_knob(self, tmp_path, monkeypatch):
        path = str(tmp_path / "r.txt")
        artifacts.atomic_write_text(path, "payload")
        monkeypatch.setenv("KMLS_FAULT_IO_READ_STALL_MS", "60:1")
        faults.load_env(force=True)
        t0 = time.monotonic()
        assert artifacts.read_text(path) == "payload"
        assert time.monotonic() - t0 >= 0.06

    def test_io_fsync_knob(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KMLS_FAULT_IO_FSYNC", "1")
        faults.load_env(force=True)
        with pytest.raises(artifacts.FsyncFailedError):
            artifacts.atomic_write_text(str(tmp_path / "f.txt"), "x")

    def test_deferred_knobs_parse_like_the_reference(self, monkeypatch):
        """The knobs of sites this package has not wired yet parse as in
        the reference and arm faults nothing fires."""
        from kmlserver_tpu import faults as ref_faults

        knobs = {"KMLS_FAULT_EMBED_CORRUPT": "2", "KMLS_FAULT_DELTA_CORRUPT": "3",
                 "KMLS_FAULT_MESH_PEER_DELAY_MS": "1:25:4",
                 "KMLS_FAULT_FLEET_PEER_DELAY_MS": "2:30"}
        for name, value in knobs.items():
            monkeypatch.setenv(name, value)
        faults.load_env(force=True)
        ref_faults.load_env(force=True)
        assert faults.active() == ref_faults.active()
        assert faults.active() == {("embed.artifact", None): 2, ("delta.apply", None): 3,
                                   ("mesh.peer", 1): 4, ("fleet.peer", 2): -1}


class TestDurableReplace:
    def test_durable_replace_publishes_and_fsyncs(self, tmp_path):
        src, dst = str(tmp_path / "incoming"), str(tmp_path / "published")
        with open(src, "wb") as fh:
            fh.write(b"payload")
        artifacts.durable_replace(src, dst)
        assert not os.path.exists(src)
        with open(dst, "rb") as fh:
            assert fh.read() == b"payload"

    def test_read_deadline_zero_means_no_thread(self, tmp_path):
        path = str(tmp_path / "x.bin")
        artifacts._atomic_write_bytes(path, b"z")
        assert artifacts._read_bytes(path, deadline_s=0) == b"z"
        assert artifacts._read_bytes(path, deadline_s=None) == b"z"
        assert artifacts._read_bytes(path, deadline_s=5.0) == b"z"
