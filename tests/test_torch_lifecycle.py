"""The delta-chain compactor in the port (``quality/lifecycle.py``), held
against the JAX package's on the same seeded inputs: base ∘ chain ==
compacted snapshot == full re-mine, for the tensors and the answers; the
trigger, the ineligible cases, the re-armed chain after the swap, zero 5xx
through a compaction under load, and the port's compactor folding a chain
the reference published exactly as the reference's own compactor does.
The vocab-sharded layout's cases wait for the port's sharded serving."""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

from kmlserver_tpu.config import MiningConfig as RefMiningConfig
from kmlserver_tpu.data.synthetic import synthetic_baskets
from kmlserver_tpu.io import artifacts as ref_artifacts
from kmlserver_tpu.mining.pipeline import run_mining_job as ref_run_mining_job
from kmlserver_tpu.quality import lifecycle as ref_lifecycle
from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
from kmlserver_tpu_torch.data.csv import TrackTable, write_tracks_csv
from kmlserver_tpu_torch.io import artifacts
from kmlserver_tpu_torch.mining.pipeline import run_mining_job
from kmlserver_tpu_torch.quality import lifecycle
from kmlserver_tpu_torch.serving.app import RecommendApp
from kmlserver_tpu_torch.serving.engine import RecommendEngine

from .torch_chaos_util import SERVE_KNOBS, clean_chaos_state  # noqa: F401  (autouse)

DATASET = "2023_spotify_ds1.csv"


def _baskets_to_csv(path: str, baskets) -> None:
    write_tracks_csv(path, TrackTable(
        pid=baskets.playlist_rows.astype(np.int64),
        track_name=np.asarray([baskets.vocab.names[int(t)] for t in baskets.track_ids],
                              dtype=object),
    ))


def _pvc(root, seed: int = 5) -> tuple[str, str]:
    """A PVC directory holding one synthetic CSV → (base dir, csv path)."""
    os.makedirs(os.path.join(root, "datasets"))
    csv_path = os.path.join(root, "datasets", DATASET)
    _baskets_to_csv(csv_path, synthetic_baskets(150, 100, 3000, seed=seed))
    return str(root), csv_path


def _run(cfg):
    if isinstance(cfg, RefMiningConfig):
        with contextlib.redirect_stdout(io.StringIO()):
            return ref_run_mining_job(cfg)
    return run_mining_job(cfg, device="cpu")


def _grow_chain(csv_path, cfg, n_deltas, rng, first_pid=10_000_000) -> None:
    """Append playlists and publish ``n_deltas`` delta bundles."""
    for i in range(n_deltas):
        lines = [f"{first_pid + i * 1000 + p},Track {int(t):07d}"
                 for p in range(6) for t in (10 + 17 * i + rng.integers(0, 24, size=10))]
        with open(csv_path, "a") as fh:
            fh.write("\n".join(lines) + "\n")
        state = artifacts.read_delta_state(cfg.pickles_dir)
        seq = len(state["entries"]) + 1 if state else 1
        assert _run(cfg).delta_seq == seq


def _port_cfg(base, **knobs) -> MiningConfig:
    return MiningConfig(base_dir=base, datasets_dir=os.path.join(base, "datasets"),
                        **{**dict(min_support=0.05, delta_enabled=True), **knobs})


@pytest.fixture
def chain_pvc(tmp_path, rng):
    """A delta-armed PVC with a two-bundle chain → (cfg, csv path)."""
    base, csv_path = _pvc(tmp_path / "pvc")
    cfg = _port_cfg(base)
    _run(cfg)
    _grow_chain(csv_path, cfg, 2, rng)
    return cfg, csv_path


def _control_remine(tmp_path, csv_path, cfg):
    base2 = tmp_path / "control"
    os.makedirs(base2 / "datasets")
    shutil.copy(csv_path, str(base2 / "datasets" / DATASET))
    cfg2 = dataclasses.replace(cfg, base_dir=str(base2), datasets_dir=str(base2 / "datasets"),
                               delta_enabled=False)
    _run(cfg2)
    return cfg2


def _npz(cfg) -> dict:
    return artifacts.load_rule_tensors(
        artifacts.tensor_artifact_path(os.path.join(cfg.pickles_dir, cfg.recommendations_file)))


def _engine(base, **knobs) -> RecommendEngine:
    engine = RecommendEngine(ServingConfig(base_dir=base, pickle_dir="pickles/",
                                           **{**SERVE_KNOBS, **knobs}), device="cpu")
    assert engine.load()
    return engine


class TestCompaction:
    def test_manifest_file_set_is_the_references(self):
        cfg, ref_cfg = MiningConfig(), RefMiningConfig()
        assert lifecycle.manifest_filenames(cfg) == ref_lifecycle.manifest_filenames(ref_cfg)

    def test_compacted_equals_chain_and_full_remine(self, tmp_path, chain_pvc):
        """base ∘ chain (applied in place) == compacted snapshot == full
        re-mine: tensors, the pickle twin, and answers."""
        cfg, csv_path = chain_pvc
        chained = _engine(cfg.base_dir, delta_enabled=True)
        assert chained.apply_pending_deltas() == 2
        result = lifecycle.compact_delta_chain(cfg)
        assert result.n_folded == 2
        assert artifacts.read_delta_state(cfg.pickles_dir) is None
        control = _control_remine(tmp_path, csv_path, cfg)
        a, b = _npz(cfg), _npz(control)
        assert a["vocab"] == b["vocab"] and a["n_playlists"] == b["n_playlists"]
        for key in ("rule_ids", "rule_counts", "item_counts"):
            assert np.array_equal(a[key], b[key]), key
        rec = cfg.recommendations_file
        assert artifacts.load_pickle(os.path.join(cfg.pickles_dir, rec)) == (
            artifacts.load_pickle(os.path.join(control.pickles_dir, rec)))
        assert artifacts.verify_files(cfg.pickles_dir, lifecycle.manifest_filenames(cfg),
                                      token=result.token) == []
        compacted, full = _engine(cfg.base_dir), _engine(control.base_dir)
        vocab = compacted.bundle.vocab
        seeds = [[vocab[i], vocab[(i + 13) % len(vocab)]] for i in range(0, len(vocab), 9)]
        assert compacted.recommend_many(seeds) == full.recommend_many(seeds)
        assert chained.recommend_many(seeds) == full.recommend_many(seeds)

    def test_compaction_keeps_the_rotation_history(self, chain_pvc):
        cfg, _ = chain_pvc
        history = os.path.join(cfg.base_dir, cfg.dataset_history_file)
        before = open(history).read()
        token_before = artifacts.read_text(os.path.join(cfg.base_dir, "last_execution.txt"))
        result = lifecycle.compact_delta_chain(cfg)
        assert open(history).read() == before
        assert result.token != token_before
        assert artifacts.read_text(os.path.join(cfg.base_dir, "last_execution.txt")) == (
            result.token)

    def test_auto_trigger_and_rearm(self, rng, chain_pvc):
        """The third delta under ``delta_compact_after=3`` folds the chain;
        the base state rolled onto the new token, so the next append is a
        delta on the compacted base."""
        cfg, csv_path = chain_pvc
        cfg3 = dataclasses.replace(cfg, delta_compact_after=3)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            _grow_chain(csv_path, cfg3, 1, rng, first_pid=30_000_000)
        assert "Delta chain compacted: 3 bundles" in log.getvalue()
        assert artifacts.read_delta_state(cfg.pickles_dir) is None
        _grow_chain(csv_path, cfg, 1, rng, first_pid=40_000_000)

    def test_below_threshold_does_not_compact(self, chain_pvc):
        cfg, _ = chain_pvc
        assert lifecycle.maybe_compact(dataclasses.replace(cfg, delta_compact_after=5)) is None
        assert lifecycle.maybe_compact(cfg) is None  # 0 = disabled
        assert artifacts.read_delta_state(cfg.pickles_dir) is not None

    def test_no_chain_is_ineligible(self, tmp_path):
        base, _ = _pvc(tmp_path / "pvc", seed=1)
        cfg = _port_cfg(base)
        _run(cfg)
        with pytest.raises(lifecycle.CompactionIneligible, match="no delta chain"):
            lifecycle.compact_delta_chain(cfg)

    @pytest.mark.parametrize("damage", ["truncate", "wrong_token", "other_npz"])
    def test_a_damaged_chain_compacts_nothing(self, chain_pvc, damage):
        """A torn bundle, a chain of another generation or a chain bound to
        other npz bytes: ineligible, nothing published, the chain stays."""
        cfg, _ = chain_pvc
        state = artifacts.read_delta_state(cfg.pickles_dir)
        if damage == "truncate":
            path = os.path.join(cfg.pickles_dir, state["entries"][0]["file"])
            with open(path, "r+b") as fh:
                fh.truncate(os.path.getsize(path) // 2)
        else:
            token = "1999-01-01 00:00:00.000000" if damage == "wrong_token" else (
                state["base_token"])
            sha = "0" * 64 if damage == "other_npz" else state["base_npz_sha256"]
            artifacts.write_delta_state(cfg.pickles_dir, token, sha, state["entries"])
        token_path = os.path.join(cfg.base_dir, "last_execution.txt")
        token = artifacts.read_text(token_path)
        with pytest.raises(lifecycle.CompactionIneligible):
            lifecycle.compact_delta_chain(cfg)
        assert lifecycle.maybe_compact(dataclasses.replace(cfg, delta_compact_after=1)) is None
        assert artifacts.read_delta_state(cfg.pickles_dir) is not None
        assert artifacts.read_text(token_path) == token

    def test_live_lease_defers_compaction(self, chain_pvc):
        cfg, _ = chain_pvc
        lease = artifacts.PublicationLease.acquire(cfg.pickles_dir, ttl_s=30.0)
        try:
            assert lifecycle.maybe_compact(dataclasses.replace(cfg, delta_compact_after=2)) is None
        finally:
            lease.release()
        assert artifacts.read_delta_state(cfg.pickles_dir) is not None

    def test_folds_a_reference_chain_like_the_reference(self, tmp_path, rng):
        """Two copies of a PVC whose chain the JAX package published: the
        port's compactor and the reference's fold them to equal tensors."""
        base, csv_path = _pvc(tmp_path / "ref")
        ref_cfg = RefMiningConfig(base_dir=base, datasets_dir=os.path.join(base, "datasets"),
                                  min_support=0.05, delta_enabled=True,
                                  native_cpu_pair_counts=False)
        _run(ref_cfg)
        _grow_chain(csv_path, ref_cfg, 2, rng)
        twin = str(tmp_path / "twin")
        shutil.copytree(base, twin)
        ref_twin = dataclasses.replace(ref_cfg, base_dir=twin,
                                       datasets_dir=os.path.join(twin, "datasets"))
        port_result = lifecycle.compact_delta_chain(_port_cfg(base))
        with contextlib.redirect_stdout(io.StringIO()):
            ref_result = ref_lifecycle.compact_delta_chain(ref_twin)
        assert port_result.n_folded == ref_result.n_folded == 2
        a = artifacts.load_rule_tensors(artifacts.tensor_artifact_path(
            os.path.join(base, "pickles", "recommendations.pickle")))
        b = ref_artifacts.load_rule_tensors(ref_artifacts.tensor_artifact_path(
            os.path.join(twin, "pickles", "recommendations.pickle")))
        assert a["vocab"] == b["vocab"]
        for key in ("rule_ids", "rule_counts", "item_counts", "rule_confs"):
            assert np.array_equal(a[key], b[key]), key
        assert artifacts.load_pickle(os.path.join(base, "pickles", "recommendations.pickle")) == (
            ref_artifacts.load_pickle(os.path.join(twin, "pickles", "recommendations.pickle")))

    @pytest.mark.chaos
    def test_selective_invalidation_survives_the_swap(self, rng, chain_pvc):
        """Compaction swaps the base; a delta published after the swap is
        applied in place and invalidates selectively again."""
        cfg, csv_path = chain_pvc
        app = RecommendApp(ServingConfig(base_dir=cfg.base_dir, pickle_dir="pickles/",
                                         delta_enabled=True, **SERVE_KNOBS), device="cpu")
        try:
            assert app.engine.load()
            assert app.engine.apply_pending_deltas() == 2
            lifecycle.compact_delta_chain(cfg)
            assert app.engine.is_data_stale()
            assert app.engine.load()
            assert app.engine.delta_seq == 0 and app.engine.delta_chain_length == 0
            before = app.cache.selective_invalidations
            _grow_chain(csv_path, cfg, 1, rng, first_pid=50_000_000)
            assert app.engine.apply_pending_deltas() == 1
            assert app.cache.selective_invalidations == before + 1
            assert app.engine.delta_chain_length == 1
        finally:
            app.close()

    @pytest.mark.chaos
    def test_zero_5xx_through_mid_replay_compaction(self, chain_pvc):
        """Requests hammer the app while the chain compacts and the poll
        hot-swaps the new base: never a 5xx."""
        cfg, _ = chain_pvc
        app = RecommendApp(ServingConfig(base_dir=cfg.base_dir, pickle_dir="pickles/",
                                         delta_enabled=True, batch_window_ms=0.5,
                                         shed_queue_budget_ms=0.0, **SERVE_KNOBS), device="cpu")
        statuses: list[int] = []
        lock = threading.Lock()
        stop = threading.Event()
        try:
            assert app.engine.load()
            app.engine.apply_pending_deltas()
            vocab = app.engine.bundle.vocab

            def poller():
                while not stop.is_set():
                    app.engine.reload_if_required()
                    time.sleep(0.005)

            def client(worker: int):
                i = 0
                while not stop.is_set():
                    seeds = [vocab[(worker * 31 + i * 7) % len(vocab)]]
                    status, _, _ = app.handle("POST", "/api/recommend/",
                                              json.dumps({"songs": seeds}).encode())
                    with lock:
                        statuses.append(status)
                    i += 1

            threads = [threading.Thread(target=poller, daemon=True)] + [
                threading.Thread(target=client, args=(w,), daemon=True) for w in range(4)]
            for t in threads:
                t.start()
            time.sleep(0.15)
            result = lifecycle.compact_delta_chain(cfg)
            deadline = time.time() + 10.0
            while app.engine.cache_value != result.token and time.time() < deadline:
                time.sleep(0.01)
            time.sleep(0.15)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)
            app.close()
        assert app.engine.cache_value == result.token, "swap never landed"
        assert statuses and all(s < 500 for s in statuses), sorted(set(statuses))
