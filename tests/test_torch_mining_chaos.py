"""The batch side of the port's chaos suite — twin of
``tests/test_mining_chaos.py``, held against the JAX package on the same
seeded inputs: with the ``embed`` phase off and on, and with the ``eval``
phase on (its report is part of the publication).

A job killed after each checkpointed phase resumes and publishes the same
bytes as an uninterrupted run, and what it publishes equals the reference
job's publication; a torn checkpoint self-retires, a poison one is
quarantined after two strikes, a stale one (another config, another
dataset, or a store the reference wrote) is retired unread; the lease
fences zombies; the exit-code policy is the reference's, case by case.
"""

import dataclasses
import errno
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from kmlserver_tpu import faults as ref_faults
from kmlserver_tpu.io import artifacts as ref_artifacts
from kmlserver_tpu.mining import checkpoint as ref_ckpt
from kmlserver_tpu.mining.job import classify_exception as ref_classify
from kmlserver_tpu.mining.pipeline import run_mining_job as ref_run_mining_job
from kmlserver_tpu.mining.vocab import DuplicateArtistURIError as RefDuplicateArtistURIError
from kmlserver_tpu_torch import faults
from kmlserver_tpu_torch.io import artifacts
from kmlserver_tpu_torch.mining import als
from kmlserver_tpu_torch.mining import checkpoint as ckpt_mod
from kmlserver_tpu_torch.mining import pipeline
from kmlserver_tpu_torch.mining.job import (
    EXIT_FATAL_CONFIG,
    EXIT_RESUMABLE,
    classify_exception,
)
from kmlserver_tpu_torch.mining.pipeline import run_mining_job
from kmlserver_tpu_torch.mining.vocab import DuplicateArtistURIError
from kmlserver_tpu_torch.parallel.distributed import RankWatchdog

from .torch_chaos_util import (  # noqa: F401  (autouse fixture)
    DATASET,
    clean_chaos_state,
    port_mining_cfg,
    ref_mining_cfg,
    write_dataset,
)

pytestmark = pytest.mark.chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PICKLES = ("recommendations.pickle", "best_tracks.pickle", "artistsMapping.pickle",
           "trackIdsToInfo.pickle")
NPZ = "recommendations.pickle.tensors.npz"


def _pvc(base, seed=0, **overrides):
    write_dataset(str(base), seed=seed)
    return port_mining_cfg(str(base), **overrides)


def _artifact_bytes(cfg) -> dict[str, bytes]:
    out = {}
    for name in PICKLES + (NPZ,):
        with open(os.path.join(cfg.pickles_dir, name), "rb") as fh:
            out[name] = fh.read()
    return out


def _manifest_files(cfg) -> dict:
    manifest = artifacts.load_manifest(cfg.pickles_dir)
    assert manifest is not None
    return manifest["files"]


def _crashed_run(cfg, phase="mine"):
    faults.inject(f"mine.crash.{phase}", times=1)
    with pytest.raises(faults.FaultInjected):
        run_mining_job(cfg, device="cpu")
    faults.clear()
    return cfg


def _assert_publication_equals_reference(pickles_dir, ref_pickles_dir):
    """The fields the pipeline parity tests compare: every pickle loads
    equal, and the npz holds equal arrays."""
    for name in PICKLES:
        assert artifacts.load_pickle(os.path.join(pickles_dir, name)) == (
            ref_artifacts.load_pickle(os.path.join(ref_pickles_dir, name))), name
    with np.load(os.path.join(pickles_dir, NPZ), allow_pickle=True) as a, \
            np.load(os.path.join(ref_pickles_dir, NPZ), allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.fixture(scope="module")
def reference_publication(tmp_path_factory):
    """The reference job's uninterrupted publication of the suite's PVC."""
    base = str(tmp_path_factory.mktemp("ref_pvc"))
    write_dataset(base)
    ref_faults.clear()
    ref_run_mining_job(ref_mining_cfg(base))
    return os.path.join(base, "pickles")


@pytest.fixture(scope="module")
def port_publication(tmp_path_factory):
    """The port's uninterrupted publication of the same PVC → its config."""
    cfg = _pvc(tmp_path_factory.mktemp("port_pvc"))
    faults.clear()
    run_mining_job(cfg, device="cpu")
    return cfg


EMBED_KNOBS = dict(embed_enabled=True, als_rank=8, als_iters=4)


@pytest.fixture(scope="module")
def embed_publication(tmp_path_factory):
    """The port's uninterrupted publication with the embed phase on → its
    bytes (embeddings.npz included) and manifest files; its factors are
    held against the reference job's."""
    cfg = _pvc(tmp_path_factory.mktemp("port_embed_pvc"), **EMBED_KNOBS)
    faults.clear()
    run_mining_job(cfg, device="cpu")
    emb = artifacts.EMBEDDINGS_FILENAME
    with open(os.path.join(cfg.pickles_dir, emb), "rb") as fh:
        blob = fh.read()
    ref_base = str(tmp_path_factory.mktemp("ref_embed_pvc"))
    write_dataset(ref_base)
    ref_faults.clear()
    ref_run_mining_job(ref_mining_cfg(ref_base, **EMBED_KNOBS))
    ours = artifacts.load_embeddings(os.path.join(cfg.pickles_dir, emb))
    theirs = ref_artifacts.load_embeddings(os.path.join(ref_base, "pickles", emb))
    assert ours["vocab"] == theirs["vocab"]
    assert np.abs(ours["item_factors"] - theirs["item_factors"]).max() <= 1e-4
    return {"bytes": {**_artifact_bytes(cfg), emb: blob}, "manifest": _manifest_files(cfg)}


def _publication_with_report(cfg) -> dict[str, bytes]:
    out = _artifact_bytes(cfg)
    for name in (artifacts.EMBEDDINGS_FILENAME, artifacts.QUALITY_REPORT_FILENAME):
        with open(os.path.join(cfg.pickles_dir, name), "rb") as fh:
            out[name] = fh.read()
    return out


@pytest.fixture(scope="module")
def eval_publication(tmp_path_factory):
    """The port's uninterrupted publication with the embed and eval phases
    on → its bytes (the quality report included) and manifest files; its
    report's split and rules are held against the reference job's."""
    import json

    cfg = _pvc(tmp_path_factory.mktemp("port_eval_pvc"), eval_enabled=True, **EMBED_KNOBS)
    faults.clear()
    run_mining_job(cfg, device="cpu")
    ref_base = str(tmp_path_factory.mktemp("ref_eval_pvc"))
    write_dataset(ref_base)
    ref_faults.clear()
    ref_run_mining_job(ref_mining_cfg(ref_base, eval_enabled=True, **EMBED_KNOBS))
    ours = artifacts.load_quality_report(cfg.pickles_dir)
    theirs = ref_artifacts.load_quality_report(os.path.join(ref_base, "pickles"))
    assert json.dumps(ours["split"]) == json.dumps(theirs["split"])
    assert ours["modes"]["rules"] == theirs["modes"]["rules"]
    return {"bytes": _publication_with_report(cfg), "manifest": _manifest_files(cfg)}


class TestResumeEquivalence:
    @pytest.mark.parametrize("crash_phase", ckpt_mod.RUN_PHASES)
    def test_kill_at_phase_then_resume_bit_identical(
        self, tmp_path, crash_phase, port_publication, reference_publication
    ):
        """Kill after each phase's checkpoint in turn: the restart resumes
        from it and publishes the bytes of an uninterrupted run (pickles,
        npz, manifest files), which equal the reference's publication."""
        cfg = _pvc(tmp_path)
        faults.inject(f"mine.crash.{crash_phase}", times=1)
        with pytest.raises(faults.FaultInjected):
            run_mining_job(cfg, device="cpu")
        # nothing published: the artifact set is written after the phases
        assert not os.path.exists(os.path.join(cfg.pickles_dir, cfg.recommendations_file))
        faults.clear()
        summary = run_mining_job(cfg, device="cpu")
        want = ckpt_mod.PHASES[: ckpt_mod.PHASES.index(crash_phase) + 1]
        assert summary.resumed_phases == want
        assert _artifact_bytes(cfg) == _artifact_bytes(port_publication)
        assert _manifest_files(cfg) == _manifest_files(port_publication)
        _assert_publication_equals_reference(cfg.pickles_dir, reference_publication)

    @pytest.mark.parametrize("crash_phase", ckpt_mod.RUN_PHASES)
    def test_resume_skips_the_device_work_it_banked(self, tmp_path, crash_phase, monkeypatch):
        """A job resumed after ``mine`` (or ``rules``) runs no mine at all —
        so no popcount kernel; one resumed after ``encode`` mines once."""
        cfg = _pvc(tmp_path)
        _crashed_run(cfg, crash_phase)
        calls = []
        real_mine = pipeline.mine

        def counting_mine(*args, **kwargs):
            calls.append(1)
            return real_mine(*args, **kwargs)

        monkeypatch.setattr(pipeline, "mine", counting_mine)
        summary = run_mining_job(cfg, device="cpu")
        assert len(calls) == (1 if crash_phase == "encode" else 0)
        assert summary.kernel_launches == 0

    @pytest.mark.parametrize(
        "crash_phase", ckpt_mod.run_phases(port_mining_cfg(".", embed_enabled=True))
    )
    def test_kill_at_phase_with_embed_then_resume_bit_identical(
        self, tmp_path, crash_phase, embed_publication, monkeypatch
    ):
        """With the embed phase on, a kill after each phase (embed included)
        resumes and publishes the uninterrupted run's bytes, embeddings.npz
        included; a resume after ``embed`` trains nothing."""
        cfg = _pvc(tmp_path, **EMBED_KNOBS)
        _crashed_run(cfg, crash_phase)
        trainings = []
        real = als.train_embeddings

        def counting(*args, **kwargs):
            trainings.append(1)
            return real(*args, **kwargs)

        monkeypatch.setattr(als, "train_embeddings", counting)
        summary = run_mining_job(cfg, device="cpu")
        want = ckpt_mod.PHASES[: ckpt_mod.PHASES.index(crash_phase) + 1]
        assert summary.resumed_phases == want
        assert len(trainings) == (0 if crash_phase == "embed" else 1)
        emb = artifacts.EMBEDDINGS_FILENAME
        with open(os.path.join(cfg.pickles_dir, emb), "rb") as fh:
            got = {**_artifact_bytes(cfg), emb: fh.read()}
        assert got == embed_publication["bytes"]
        assert _manifest_files(cfg) == embed_publication["manifest"]

    @pytest.mark.parametrize(
        "crash_phase",
        ckpt_mod.run_phases(port_mining_cfg(".", eval_enabled=True, **EMBED_KNOBS)),
    )
    def test_kill_at_phase_with_eval_then_resume_bit_identical(
        self, tmp_path, crash_phase, eval_publication, monkeypatch
    ):
        """With the embed and eval phases on, a kill after each phase (eval
        included) resumes and publishes the uninterrupted run's bytes, the
        quality report included, under the same manifest sha256s; a resume
        after ``eval`` trains and evaluates nothing."""
        from kmlserver_tpu_torch.quality import eval as eval_mod

        cfg = _pvc(tmp_path, eval_enabled=True, **EMBED_KNOBS)
        _crashed_run(cfg, crash_phase)
        assert not os.path.exists(os.path.join(cfg.pickles_dir, artifacts.QUALITY_REPORT_FILENAME))
        trainings, evals = [], []
        real_train, real_eval = als.train_embeddings, eval_mod.run_eval_phase
        monkeypatch.setattr(als, "train_embeddings",
                            lambda *a, **k: trainings.append(1) or real_train(*a, **k))
        monkeypatch.setattr(eval_mod, "run_eval_phase",
                            lambda *a, **k: evals.append(1) or real_eval(*a, **k))
        summary = run_mining_job(cfg, device="cpu")
        want = ckpt_mod.PHASES[: ckpt_mod.PHASES.index(crash_phase) + 1]
        assert summary.resumed_phases == want
        # eval trains its own embeddings on the train split
        assert len(evals) == (0 if crash_phase == "eval" else 1)
        assert len(trainings) == {"embed": 1, "eval": 0}.get(crash_phase, 2)
        assert _publication_with_report(cfg) == eval_publication["bytes"]
        assert _manifest_files(cfg) == eval_publication["manifest"]

    def test_eval_off_publication_retires_the_report(self, tmp_path, eval_publication):
        """A publication with the eval phase off removes the previous
        generation's report, so its manifest cannot re-bless it; the
        reference does the same."""
        cfg = _pvc(tmp_path, eval_enabled=True, **EMBED_KNOBS)
        run_mining_job(cfg, device="cpu")
        report = os.path.join(cfg.pickles_dir, artifacts.QUALITY_REPORT_FILENAME)
        assert os.path.exists(report)
        assert artifacts.QUALITY_REPORT_FILENAME in _manifest_files(cfg)
        run_mining_job(dataclasses.replace(cfg, eval_enabled=False), device="cpu")
        assert not os.path.exists(report)
        assert artifacts.QUALITY_REPORT_FILENAME not in _manifest_files(cfg)
        assert artifacts.remove_quality_report(cfg.pickles_dir) is False
        ref_base = str(tmp_path / "ref")
        write_dataset(ref_base)
        ref_cfg = ref_mining_cfg(ref_base, eval_enabled=True, **EMBED_KNOBS)
        ref_run_mining_job(ref_cfg)
        assert os.path.exists(os.path.join(ref_base, "pickles", artifacts.QUALITY_REPORT_FILENAME))
        ref_run_mining_job(dataclasses.replace(ref_cfg, eval_enabled=False))
        assert not os.path.exists(
            os.path.join(ref_base, "pickles", artifacts.QUALITY_REPORT_FILENAME))

    def test_checkpoint_payloads_are_host_objects(self, tmp_path):
        """The mine payload is host numpy, not torch tensors: a checkpoint
        written on the card resumes on the CPU and the other way round."""
        cfg = _crashed_run(_pvc(tmp_path), "rules")
        ds = os.path.join(cfg.datasets_dir, DATASET)
        store = ckpt_mod.open_store(cfg, ds, 1, writer=True)
        seen = []

        def walk(obj):
            seen.append(type(obj))
            if dataclasses.is_dataclass(obj):
                for field in dataclasses.fields(obj):
                    walk(getattr(obj, field.name))
            elif isinstance(obj, dict):
                for k, v in obj.items():
                    walk(k)
                    walk(v)
            elif isinstance(obj, (list, tuple)):
                for v in obj[:50]:
                    walk(v)

        for phase in ckpt_mod.RUN_PHASES:
            walk(store.load(phase))
        assert np.ndarray in seen
        assert not [t for t in seen if issubclass(t, torch.Tensor)]

    def test_embed_payload_is_host_objects(self, tmp_path):
        """The embed payload is host numpy too: factors, floats, ints."""
        cfg = _crashed_run(_pvc(tmp_path, **EMBED_KNOBS), "embed")
        store = ckpt_mod.open_store(cfg, os.path.join(cfg.datasets_dir, DATASET), 1, writer=True)
        payload = store.load("embed")
        assert isinstance(payload["item_factors"], np.ndarray)
        assert payload["item_factors"].dtype == np.float32
        assert not [k for k, v in payload.items() if isinstance(v, torch.Tensor)]

    def test_checkpoint_retired_after_publication(self, tmp_path):
        cfg = _pvc(tmp_path)
        run_mining_job(cfg, device="cpu")
        store = ckpt_mod.open_store(cfg, os.path.join(cfg.datasets_dir, DATASET), 1, writer=True)
        assert store.completed == frozenset()  # cleared, nothing to resume
        assert run_mining_job(cfg, device="cpu").resumed_phases == ()


class TestCheckpointHygiene:
    def test_torn_checkpoint_self_retires_to_recompute(self, tmp_path, port_publication):
        cfg = _crashed_run(_pvc(tmp_path))
        faults.flip_byte(os.path.join(cfg.checkpoint_path, "mine.ckpt"))
        summary = run_mining_job(cfg, device="cpu")
        assert "mine" not in summary.resumed_phases  # recomputed
        assert "encode" in summary.resumed_phases  # the untouched phase resumes
        assert _artifact_bytes(cfg) == _artifact_bytes(port_publication)

    def test_fingerprint_mismatch_ignores_checkpoint(self, tmp_path):
        cfg = _crashed_run(_pvc(tmp_path))
        summary = run_mining_job(dataclasses.replace(cfg, min_support=0.2), device="cpu")
        assert summary.resumed_phases == ()

    def test_changed_dataset_ignores_checkpoint(self, tmp_path):
        cfg = _crashed_run(_pvc(tmp_path))
        write_dataset(str(tmp_path), seed=99)  # the same file, new content
        assert run_mining_job(cfg, device="cpu").resumed_phases == ()

    def test_poison_checkpoint_quarantined_after_two_strikes(self, tmp_path):
        """``ckpt.corrupt`` writes truncated bytes WITH a matching digest:
        integrity passes, unpickling fails. Strike one recomputes; strike
        two quarantines the file."""
        cfg = _pvc(tmp_path)
        faults.inject("ckpt.corrupt", times=1)
        faults.inject("mine.crash.encode", times=1)
        with pytest.raises(faults.FaultInjected):
            run_mining_job(cfg, device="cpu")
        faults.clear()
        ckpt_path = os.path.join(cfg.checkpoint_path, "encode.ckpt")
        fingerprint = ckpt_mod.compute_fingerprint(
            cfg, os.path.join(cfg.datasets_dir, DATASET), 1)
        store = ckpt_mod.CheckpointStore(cfg.checkpoint_path, fingerprint, quarantine_after=2)
        assert "encode" in store.completed
        assert store.load("encode") is None  # strike 1: recompute
        assert os.path.exists(ckpt_path)
        store2 = ckpt_mod.CheckpointStore(cfg.checkpoint_path, fingerprint, quarantine_after=2)
        assert store2.load("encode") is None  # strike 2: quarantine
        assert not os.path.exists(ckpt_path)
        qdir = os.path.join(cfg.checkpoint_path, artifacts.QUARANTINE_DIRNAME)
        assert any(n.startswith("encode.ckpt") for n in os.listdir(qdir))
        assert run_mining_job(cfg, device="cpu").token

    def test_fingerprint_sensitivity(self, tmp_path):
        cfg = _pvc(tmp_path)
        ds = os.path.join(cfg.datasets_dir, DATASET)
        base = ckpt_mod.compute_fingerprint(cfg, ds, 1)
        assert base == ckpt_mod.compute_fingerprint(cfg, ds, 1)  # stable
        assert base != ckpt_mod.compute_fingerprint(cfg, ds, 2)  # run index
        assert base != ckpt_mod.compute_fingerprint(
            dataclasses.replace(cfg, min_support=0.2), ds, 1)
        # the count route is deliberately excluded: a card-to-CPU restart
        # resumes
        assert base == ckpt_mod.compute_fingerprint(
            dataclasses.replace(cfg, count_path="bitpack"), ds, 1)

    @pytest.mark.parametrize("overrides", [
        {}, {"min_support": 0.2}, {"k_max_consequents": 8},
        {"confidence_mode": "confidence", "max_itemset_len": 3},
    ])
    def test_identity_is_the_references_plus_the_package(self, tmp_path, overrides):
        """The port's identity dict is the reference's with one key added:
        hashed without it, it gives the reference's fingerprint."""
        import hashlib
        import json

        ds_dir = write_dataset(str(tmp_path))
        ds = os.path.join(ds_dir, DATASET)
        ident = ckpt_mod.fingerprint_identity(port_mining_cfg(str(tmp_path), **overrides), ds, 3)
        assert ident.pop("package") == "kmlserver_tpu_torch"
        blob = json.dumps(ident, sort_keys=True).encode("utf-8")
        assert hashlib.sha256(blob).hexdigest() == ref_ckpt.compute_fingerprint(
            ref_mining_cfg(str(tmp_path), **overrides), ds, 3)
        assert ckpt_mod.compute_fingerprint(
            port_mining_cfg(str(tmp_path), **overrides), ds, 3
        ) != hashlib.sha256(blob).hexdigest()


class TestStoresOfTheOtherPackage:
    def test_reference_store_is_retired_never_unpickled(self, tmp_path, reference_publication):
        """Both packages keep their store in ``<base_dir>/mining_checkpoint``.
        A store the reference wrote (pickles of the JAX package's classes)
        reads as a fingerprint mismatch: the port retires it unread and
        mines afresh — in a process that never imports ``kmlserver_tpu``
        or ``jax`` — and publishes what the reference publishes."""
        base = str(tmp_path)
        write_dataset(base)
        ref_faults.inject("mine.crash.rules", times=1)
        with pytest.raises(ref_faults.FaultInjected):
            ref_run_mining_job(ref_mining_cfg(base))
        ref_faults.clear()
        store = os.path.join(base, "mining_checkpoint")
        assert {"encode.ckpt", "mine.ckpt", "rules.ckpt"} <= set(os.listdir(store))
        code = textwrap.dedent(f"""
            import sys
            from kmlserver_tpu_torch.config import MiningConfig
            from kmlserver_tpu_torch.mining.pipeline import run_mining_job
            cfg = MiningConfig(base_dir={base!r}, datasets_dir={base + '/datasets'!r},
                               min_support=0.1, k_max_consequents=32,
                               top_tracks_save_percentile=0.25, lease_ttl_s=5.0)
            summary = run_mining_job(cfg, device="cpu")
            bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "kmlserver_tpu"))
            print("RESUMED", summary.resumed_phases)
            print("BAD", bad)
        """)
        env = {k: v for k, v in os.environ.items() if not k.startswith("KMLS_")}
        env["PYTHONPATH"] = REPO
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "RESUMED ()" in proc.stdout
        assert "BAD []" in proc.stdout
        assert "fingerprint mismatch" in proc.stdout
        assert not [n for n in os.listdir(store) if n.endswith(".ckpt")]
        _assert_publication_equals_reference(os.path.join(base, "pickles"),
                                             reference_publication)

    def test_port_store_is_retired_by_the_reference(self, tmp_path):
        """And the other way round: the reference never resumes from a
        store the port wrote."""
        base = str(tmp_path)
        cfg = _crashed_run(_pvc(base), "rules")
        assert os.path.exists(os.path.join(cfg.checkpoint_path, "mine.ckpt"))
        assert ref_run_mining_job(ref_mining_cfg(base)).resumed_phases == ()


class TestLeaseFencing:
    def test_live_lease_blocks_second_writer(self, tmp_path):
        d = str(tmp_path)
        lease = artifacts.PublicationLease.acquire(d, ttl_s=30.0)
        with pytest.raises(artifacts.LeaseHeldError):
            artifacts.PublicationLease.acquire(d, ttl_s=30.0)
        lease.release()
        nxt = artifacts.PublicationLease.acquire(d, ttl_s=30.0)
        assert nxt.fencing_token == lease.fencing_token + 1

    def test_lease_expires_after_writer_death(self, tmp_path):
        d = str(tmp_path)
        dead = artifacts.PublicationLease.acquire(d, ttl_s=0.2)
        time.sleep(0.3)  # no heartbeat: the writer is dead
        nxt = artifacts.PublicationLease.acquire(d, ttl_s=30.0)
        assert nxt.fencing_token == dead.fencing_token + 1
        with pytest.raises(artifacts.LeaseLostError):
            dead.check()
        with pytest.raises(artifacts.LeaseLostError):
            dead.heartbeat()  # and cannot resurrect itself
        nxt.check()

    def test_heartbeat_keeps_lease_past_ttl(self, tmp_path):
        d = str(tmp_path)
        lease = artifacts.PublicationLease.acquire(d, ttl_s=0.3, heartbeat_interval_s=0.05)
        lease.start_heartbeat()
        try:
            time.sleep(0.5)  # > ttl: only the heartbeat keeps it alive
            with pytest.raises(artifacts.LeaseHeldError):
                artifacts.PublicationLease.acquire(d, ttl_s=0.3)
        finally:
            lease.stop_heartbeat()

    def test_release_outlives_a_racing_heartbeat(self, tmp_path):
        d = str(tmp_path)
        lease = artifacts.PublicationLease.acquire(d, ttl_s=30.0, heartbeat_interval_s=0.02)
        lease.start_heartbeat()
        time.sleep(0.1)
        lease.release()
        time.sleep(0.2)
        assert artifacts._read_lease(d)["released"] is True
        nxt = artifacts.PublicationLease.acquire(d, ttl_s=30.0)
        assert nxt.fencing_token == lease.fencing_token + 1

    def test_zombie_mining_job_cannot_publish_over_newer_run(self, tmp_path):
        cfg = _crashed_run(_pvc(tmp_path), "rules")
        crashed = artifacts._read_lease(cfg.pickles_dir)
        assert crashed is not None and crashed["released"]
        summary = run_mining_job(cfg, device="cpu")  # released: no TTL wait
        assert summary.fencing_token == crashed["fencing_token"] + 1
        assert artifacts.load_manifest(cfg.pickles_dir)["fencing_token"] == summary.fencing_token
        stale = artifacts.PublicationLease(
            cfg.pickles_dir, crashed["owner"], crashed["fencing_token"], ttl_s=5.0)
        with pytest.raises(artifacts.LeaseLostError):
            stale.check()

    def test_held_lease_aborts_job_as_resumable(self, tmp_path):
        cfg = _pvc(tmp_path)
        holder = artifacts.PublicationLease.acquire(cfg.pickles_dir, ttl_s=30.0)
        with pytest.raises(artifacts.LeaseHeldError) as exc_info:
            run_mining_job(cfg, device="cpu")
        assert classify_exception(exc_info.value) == EXIT_RESUMABLE
        holder.release()
        assert run_mining_job(cfg, device="cpu").token

    def test_zombie_fenced_before_publication(self, tmp_path, monkeypatch):
        """A writer whose lease is taken over mid-run (its heartbeat stale
        past the TTL, a newer writer on disk) aborts at the first fence
        point: nothing of its generation is published."""
        cfg = _pvc(tmp_path, lease_ttl_s=30.0)
        real_publish = pipeline._publish

        def usurped(cfg_, *args):
            lease = args[-1]
            lease.stop_heartbeat()
            newer = artifacts.PublicationLease(cfg_.pickles_dir, "newer", lease.fencing_token + 1,
                                               ttl_s=30.0)
            newer._write()
            return real_publish(cfg_, *args)

        monkeypatch.setattr(pipeline, "_publish", usurped)
        with pytest.raises(artifacts.LeaseLostError) as exc_info:
            run_mining_job(cfg, device="cpu")
        assert classify_exception(exc_info.value) == EXIT_RESUMABLE
        assert not os.path.exists(os.path.join(cfg.pickles_dir, cfg.recommendations_file))
        assert not os.path.exists(os.path.join(cfg.base_dir, cfg.data_invalidation_file))


class TestRankHeartbeatSite:
    def test_dead_peer_aborts_within_bounded_time(self, tmp_path):
        """``rank.heartbeat`` silences rank 1: rank 0's watchdog aborts
        within the timeout instead of waiting on a collective forever."""
        aborts: list[str] = []

        def watchdog(rank, sink):
            return RankWatchdog(str(tmp_path), rank=rank, num_processes=2,
                                heartbeat_interval_s=0.05, timeout_s=0.5,
                                on_abort=sink.append)

        w0, w1 = watchdog(0, aborts), watchdog(1, [])
        w0.start()
        w1.start()
        try:
            time.sleep(0.2)
            assert not aborts  # both alive: no false positive
            faults.inject("rank.heartbeat", replica=1, times=-1)
            deadline = time.monotonic() + 5.0
            while not aborts and time.monotonic() < deadline:
                time.sleep(0.02)
            assert aborts and "rank 1" in aborts[0]
        finally:
            w0.stop()
            w1.stop()

    def test_env_knob_silences_the_rank(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KMLS_FAULT_RANK_DEAD", "1")
        faults.load_env(force=True)
        w1 = RankWatchdog(str(tmp_path), rank=1, num_processes=2,
                          heartbeat_interval_s=0.05, timeout_s=5.0, on_abort=lambda r: None)
        w0 = RankWatchdog(str(tmp_path), rank=0, num_processes=2,
                          heartbeat_interval_s=0.05, timeout_s=5.0, on_abort=lambda r: None)
        assert w1.beat_once() is False and w0.beat_once() is True
        assert not os.path.exists(os.path.join(str(tmp_path), "rank1.hb"))


def _exceptions(pkg_faults, pkg_artifacts, dup):
    return {
        "fault": pkg_faults.FaultInjected("x"),
        "lease_held": pkg_artifacts.LeaseHeldError("x"),
        "lease_lost": pkg_artifacts.LeaseLostError("x"),
        "storage_exhausted": pkg_artifacts.StorageExhaustedError("x"),
        "enospc": OSError(errno.ENOSPC, "disk full"),
        "eio": OSError(errno.EIO, "io"),
        "value": ValueError("x"),
        "file_not_found": FileNotFoundError("x"),
        "duplicate_artist": dup("x"),
        "generic": RuntimeError("x"),
    }


class TestExitCodeContract:
    @pytest.mark.parametrize("case", sorted(_exceptions(faults, artifacts, ValueError)))
    def test_classification_matches_the_reference(self, case):
        port = _exceptions(faults, artifacts, DuplicateArtistURIError)[case]
        ref = _exceptions(ref_faults, ref_artifacts, RefDuplicateArtistURIError)[case]
        assert classify_exception(port) == ref_classify(ref)

    def test_job_module_exit_codes_end_to_end(self, tmp_path):
        """``python -m kmlserver_tpu_torch.mining.job`` as k8s sees it: an
        injected crash after ``mine`` exits 75, the retry resumes and exits
        0 without mining again; a missing dataset dir exits 64."""
        cfg = _pvc(tmp_path)

        def run_job(**extra):
            env = {k: v for k, v in os.environ.items() if not k.startswith("KMLS_")}
            env.update(PYTHONPATH=REPO, BASE_DIR=cfg.base_dir, DATASETS_DIR=cfg.datasets_dir,
                       MIN_SUPPORT="0.1", KMLS_TORCH_DEVICE="cpu", KMLS_COUNT_PATH="bitpack")
            env.update(extra)
            return subprocess.run([sys.executable, "-m", "kmlserver_tpu_torch.mining.job"],
                                  cwd=REPO, env=env, capture_output=True, text=True,
                                  timeout=300)

        proc = run_job(DATASETS_DIR=os.path.join(cfg.base_dir, "nope"))
        assert proc.returncode == EXIT_FATAL_CONFIG, proc.stdout + proc.stderr
        proc = run_job(KMLS_FAULT_MINE_CRASH_PHASE="mine")
        assert proc.returncode == EXIT_RESUMABLE, proc.stdout + proc.stderr
        assert "Job aborted (resumable): exiting 75" in proc.stdout
        proc = run_job()
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "Resumed phase 'mine' from checkpoint" in proc.stdout
        assert "Popcount kernel launches: 0" in proc.stdout


class TestManifestFencingToken:
    def test_manifest_records_fencing_token_and_engine_still_validates(self, tmp_path):
        cfg = _pvc(tmp_path)
        summary = run_mining_job(cfg, device="cpu")
        manifest = artifacts.load_manifest(cfg.pickles_dir)
        assert manifest["fencing_token"] == summary.fencing_token == 1
        files = [cfg.recommendations_file, cfg.best_tracks_file, NPZ]
        assert artifacts.verify_files(cfg.pickles_dir, files, token=summary.token) == []
        # the reference's verifier reads the port's manifest the same way
        assert ref_artifacts.verify_files(cfg.pickles_dir, files, token=summary.token) == []

    def test_lease_disabled_keeps_reference_behavior(self, tmp_path):
        cfg = _pvc(tmp_path, lease_enabled=False)
        summary = run_mining_job(cfg, device="cpu")
        assert summary.fencing_token is None
        assert not os.path.exists(artifacts.lease_path(cfg.pickles_dir))
        assert "fencing_token" not in artifacts.load_manifest(cfg.pickles_dir)
