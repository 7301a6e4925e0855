"""Continuous freshness in the port (``kmlserver_tpu_torch/freshness/``,
the delta route of the mining pipeline, the engine's in-place apply, the
app's selective invalidation and affinity counters), held against the JAX
package on the same seeded inputs.

The contract is the reference's: base ∘ delta chain == a full re-mine of
the final CSV, for the tensors and the served answers. The port's bundles
carry the reference's contents (each package reads the other's), its
emission, application and restricted recount equal the reference's, and
every ineligible run falls back to a full re-mine. One divergence is
pinned on purpose: the reference's suffix reader (pandas) turns a track
named ``007`` into ``7``; the port's reads the appended rows with its
full-path parser, so its chain still equals its full re-mine.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from kmlserver_tpu.config import MiningConfig as RefMiningConfig
from kmlserver_tpu.freshness import delta as ref_delta
from kmlserver_tpu.freshness import ring as ref_ring
from kmlserver_tpu.io import artifacts as ref_artifacts
from kmlserver_tpu.mining.pipeline import run_mining_job as ref_run_mining_job
from kmlserver_tpu.ops.rules import emit_rule_tensors_np as ref_emit_full
from kmlserver_tpu.parallel import support as ref_support
from kmlserver_tpu_torch import faults
from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
from kmlserver_tpu_torch.data.csv import TrackTable, write_tracks_csv
from kmlserver_tpu_torch.freshness import delta as delta_mod
from kmlserver_tpu_torch.freshness.ring import (
    RendezvousRing,
    fleet_multiplier,
    seeds_key,
    simulate_fleet,
)
from kmlserver_tpu_torch.io import artifacts
from kmlserver_tpu_torch.mining import checkpoint as ckpt_mod
from kmlserver_tpu_torch.mining import pipeline as pipeline_mod
from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
from kmlserver_tpu_torch.parallel import support
from kmlserver_tpu_torch.serving.app import RecommendApp
from kmlserver_tpu_torch.serving.engine import RecommendEngine

from .torch_chaos_util import SERVE_KNOBS, clean_chaos_state  # noqa: F401  (autouse)

DATASET = "2023_spotify_ds1.csv"


def run_job(cfg: MiningConfig):
    return pipeline_mod.run_mining_job(cfg, device="cpu")


# ---------------------------------------------------------------------------
# fixtures: an append-only dataset with a delta-armed base generation
# ---------------------------------------------------------------------------


def _write_csv(path, pids, names):
    write_tracks_csv(
        str(path),
        TrackTable(pid=np.asarray(pids, dtype=np.int64), track_name=np.asarray(names, dtype=object)),
    )


def _base_rows(rng, n_playlists=80, n_tracks=30, mean_len=5):
    names = [f"s{i:03d}" for i in range(n_tracks)]
    weights = 1.0 / (1.0 + np.arange(n_tracks) ** 1.2)
    weights /= weights.sum()
    pids, tracks = [], []
    for p in range(n_playlists):
        size = min(max(1, rng.poisson(mean_len)), n_tracks)
        for t in rng.choice(n_tracks, size=size, replace=False, p=weights):
            pids.append(p)
            tracks.append(names[int(t)])
    return pids, tracks


def _append_rows(csv_path, rows):
    """Append ``(pid, name)`` rows as a feed would: raw CSV lines."""
    with open(csv_path, "a") as fh:
        for pid, name in rows:
            fh.write(f"{pid},{name}\n")


def _mining_cfg(base, **knobs) -> MiningConfig:
    return MiningConfig(base_dir=str(base), datasets_dir=os.path.join(str(base), "datasets"),
                        **{**dict(min_support=0.04, delta_enabled=True), **knobs})


def _serving_cfg(base, **knobs) -> ServingConfig:
    return ServingConfig(base_dir=str(base), pickle_dir="pickles/", polling_wait_in_minutes=0.001,
                         **{**SERVE_KNOBS, "delta_enabled": True, **knobs})


@pytest.fixture
def delta_pvc(tmp_path, rng):
    """A PVC with one delta-armed full publication by the port →
    ``(mining cfg, serving cfg, csv path)``. At ``min_support`` 0.04,
    ``min_count`` stays 4 from 80 to 100 playlists, so a small append
    touches exactly the appended names."""
    os.makedirs(tmp_path / "datasets")
    csv_path = str(tmp_path / "datasets" / DATASET)
    _write_csv(csv_path, *_base_rows(rng))
    mining_cfg = _mining_cfg(tmp_path)
    run_job(mining_cfg)
    return mining_cfg, _serving_cfg(tmp_path), csv_path


def _fresh_full_remine(tmp_path, csv_path, mining_cfg, name="full") -> RecommendEngine:
    """A full re-mine of the current CSV in a pristine PVC → its engine."""
    base2 = tmp_path / name
    os.makedirs(base2 / "datasets")
    shutil.copy(csv_path, str(base2 / "datasets" / os.path.basename(csv_path)))
    run_job(dataclasses.replace(mining_cfg, base_dir=str(base2),
                                datasets_dir=str(base2 / "datasets"), delta_enabled=False))
    engine = RecommendEngine(_serving_cfg(base2, delta_enabled=False), device="cpu")
    assert engine.load()
    return engine


def _assert_bundles_identical(a, b):
    assert a.vocab == b.vocab
    assert torch.equal(a.rule_ids, b.rule_ids)
    assert torch.equal(a.rule_confs, b.rule_confs)
    assert np.array_equal(a.known_mask, b.known_mask)


CYCLE_1 = [(3, "s000"), (3, "zz_new"), (81, "s001"), (81, "s002"), (81, "zz_new")]
CYCLE_2 = [(82, "s000"), (82, "s001"), (82, "s003"), (83, "s004"), (83, "zz_new")]
PROBES = (["s000"], ["s001", "s002"], ["zz_new"], ["s003", "s004", "s005"], ["__unknown__"])


# ---------------------------------------------------------------------------
# the port against the reference: bundles, emission, application, recount
# ---------------------------------------------------------------------------


@pytest.fixture
def twin_chain(tmp_path, rng):
    """The same CSV mined delta-armed by both packages, then the same
    append published as a delta by each → ``{"port": (cfg, csv),
    "ref": (cfg, csv)}``."""
    pids, tracks = _base_rows(rng)
    out = {}
    for side in ("port", "ref"):
        base = tmp_path / side
        os.makedirs(base / "datasets")
        csv_path = str(base / "datasets" / DATASET)
        _write_csv(csv_path, pids, tracks)
        if side == "port":
            cfg = _mining_cfg(base)
            run_job(cfg)
        else:
            cfg = RefMiningConfig(base_dir=str(base), datasets_dir=str(base / "datasets"),
                                  min_support=0.04, delta_enabled=True,
                                  native_cpu_pair_counts=False)
            with contextlib.redirect_stdout(io.StringIO()):
                ref_run_mining_job(cfg)
        out[side] = (cfg, csv_path)
    for rows in (CYCLE_1, CYCLE_2):
        for side, (cfg, csv_path) in out.items():
            _append_rows(csv_path, rows)
            if side == "port":
                assert run_job(cfg).delta_seq is not None
            else:
                with contextlib.redirect_stdout(io.StringIO()):
                    assert ref_run_mining_job(cfg).delta_seq is not None
    return out


def _bundle_path(cfg, seq):
    return os.path.join(cfg.pickles_dir, artifacts.delta_bundle_filename(seq))


BUNDLE_CONTENT = ("version", "seq", "n_playlists", "min_count", "vocab", "tombstones")
BUNDLE_ARRAYS = ("changed_rows", "changed_rule_ids", "changed_rule_counts", "changed_item_counts")


class TestAgainstReference:
    @pytest.mark.parametrize("seq", [1, 2])
    def test_bundle_contents_equal_the_references(self, twin_chain, seq):
        """The same appends give bundles of equal contents (the tokens and
        the npz digests they are bound to differ: two generations)."""
        port = artifacts.load_delta_bundle(_bundle_path(twin_chain["port"][0], seq))
        ref = ref_artifacts.load_delta_bundle(_bundle_path(twin_chain["ref"][0], seq))
        for key in BUNDLE_CONTENT:
            assert port[key] == ref[key], key
        for key in BUNDLE_ARRAYS:
            assert np.array_equal(port[key], ref[key]), key
        assert len(port["changed_rows"]) > 0

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_each_package_reads_the_others_bundles(self, twin_chain, writer):
        cfg = twin_chain[writer][0]
        for seq in (1, 2):
            path = _bundle_path(cfg, seq)
            state_entry = artifacts.read_delta_state(cfg.pickles_dir)["entries"][seq - 1]
            a = artifacts.load_delta_bundle(path, expect_sha256=state_entry["sha256"])
            b = ref_artifacts.load_delta_bundle(path, expect_sha256=state_entry["sha256"])
            assert a.keys() == b.keys()
            for key in a:
                assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key
        assert artifacts.read_delta_state(cfg.pickles_dir) == (
            ref_artifacts.read_delta_state(cfg.pickles_dir)
        )

    def test_base_state_rolls_forward_like_the_references(self, twin_chain):
        port = delta_mod.load_base_state(twin_chain["port"][0].pickles_dir)
        ref = ref_delta.load_base_state(twin_chain["ref"][0].pickles_dir)
        for key in ("version", "dataset", "dataset_bytes", "dataset_sha256",
                    "config_fingerprint", "n_playlists", "vocab_names"):
            assert port[key] == ref[key], key
        for key in ("playlist_rows", "track_ids", "pid_values"):
            assert np.array_equal(port[key], ref[key]), key
        for key in ("vocab", "n_playlists", "min_support", "mode", "min_confidence"):
            assert port["published"][key] == ref["published"][key], key
        for key in ("rule_ids", "rule_counts", "item_counts"):
            assert np.array_equal(port["published"][key], ref["published"][key]), key

    def test_apply_delta_to_tensors_equals_the_references(self, twin_chain):
        cfg = twin_chain["port"][0]
        loaded = artifacts.load_rule_tensors(artifacts.tensor_artifact_path(
            os.path.join(cfg.pickles_dir, cfg.recommendations_file)))
        state = {k: loaded[k] for k in ("vocab", "rule_ids", "rule_counts", "item_counts",
                                        "n_playlists", "min_support", "mode", "min_confidence")}
        ref_state = dict(state)
        for seq in (1, 2):
            bundle = artifacts.load_delta_bundle(_bundle_path(cfg, seq))
            state = delta_mod.apply_delta_to_tensors(state, bundle)
            ref_state = ref_delta.apply_delta_to_tensors(ref_state, bundle)
            assert state.keys() == ref_state.keys()
            for key in state:
                assert np.array_equal(np.asarray(state[key]), np.asarray(ref_state[key])), key
            assert delta_mod.touched_names(bundle) == ref_delta.touched_names(bundle)
        got = delta_mod.derive_serving_arrays(state)
        want = ref_delta.derive_serving_arrays(ref_state)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert np.array_equal(a, b)

    def test_apply_rejects_a_structurally_impossible_bundle(self):
        prev = {"vocab": ["a", "b"], "rule_ids": np.array([[1], [0]], np.int32),
                "rule_counts": np.array([[3], [3]], np.int32),
                "item_counts": np.array([5, 4], np.int32), "n_playlists": 10,
                "min_support": 0.1, "mode": "support", "min_confidence": 0.0}
        bundle = {"vocab": ["a", "b", "c"], "changed_rows": np.zeros(0, np.int32),
                  "changed_rule_ids": np.zeros((0, 1), np.int32),
                  "changed_rule_counts": np.zeros((0, 1), np.int32),
                  "changed_item_counts": np.zeros(0, np.int32), "n_playlists": 11,
                  "tombstones": []}
        for fn in (delta_mod.apply_delta_to_tensors, ref_delta.apply_delta_to_tensors):
            with pytest.raises(ValueError, match="no base row"):
                fn(prev, bundle)
        # a consequent that left the vocabulary from an unchanged row
        gone = dict(bundle, vocab=["a"], tombstones=["b"], n_playlists=11)
        for fn in (delta_mod.apply_delta_to_tensors, ref_delta.apply_delta_to_tensors):
            with pytest.raises(ValueError, match="left the vocabulary"):
                fn(prev, gone)

    @pytest.mark.parametrize("seed,k_max,min_count", [(0, 6, 4), (1, 3, 2), (2, 40, 5)])
    def test_emit_rule_rows_equals_the_references_and_the_full_emission(self, seed, k_max,
                                                                        min_count):
        """Selected rows: the port's emission equals the reference's and the
        full emission's same rows (threshold, diagonal, tie order)."""
        rng = np.random.default_rng(seed)
        v = 17
        counts = rng.integers(0, 12, size=(v, v))
        counts = (counts + counts.T).astype(np.int64)
        np.fill_diagonal(counts, rng.integers(1, 15, size=v))
        full_ids, full_counts, _ = ref_emit_full(counts, min_count=min_count, k_max=k_max)
        rows = np.asarray([0, 3, 9, 16], dtype=np.int64)
        got = delta_mod.emit_rule_rows_np(counts[rows], rows, min_count=min_count, k_max=k_max)
        want = ref_delta.emit_rule_rows_np(counts[rows], rows, min_count=min_count, k_max=k_max)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        assert np.array_equal(got[0], full_ids[rows])
        assert np.array_equal(got[1], full_counts[rows])
        assert np.array_equal(got[2], np.diagonal(counts)[rows])
        empty = delta_mod.emit_rule_rows_np(counts[:0], rows[:0], min_count, k_max)
        assert [x.shape for x in empty] == [(0, k_max), (0, k_max), (0,)]

    def test_confidence_filter_equals_the_references(self, rng):
        ids = rng.integers(-1, 9, size=(6, 5)).astype(np.int32)
        counts = rng.integers(0, 9, size=(6, 5)).astype(np.int32)
        items = rng.integers(0, 20, size=6).astype(np.int32)
        for conf in (0.0, 0.25, 0.6):
            got = delta_mod._confidence_filter_rows(ids, counts, items, conf)
            want = ref_delta._confidence_filter_rows(ids, counts, items, conf)
            for a, b in zip(got, want):
                assert np.array_equal(a, b)

    def test_config_fingerprint_equals_the_references(self):
        port = MiningConfig(min_support=0.03, k_max_consequents=64)
        ref = RefMiningConfig(min_support=0.03, k_max_consequents=64)
        assert delta_mod.delta_config_fingerprint(port) == ref_delta.delta_config_fingerprint(ref)


def _baskets(rng, p=60, v=23, density=0.2) -> tuple[Baskets, np.ndarray]:
    x = rng.random((p, v)) < density
    rows, tids = np.nonzero(x)
    names = [f"t{i:03d}" for i in range(v)]
    baskets = Baskets(playlist_rows=rows.astype(np.int32), track_ids=tids.astype(np.int32),
                      n_playlists=p, vocab=Vocab(names, {n: i for i, n in enumerate(names)}))
    full = x.astype(np.int64).T @ x.astype(np.int64)
    return baskets, full


class TestRestrictedRecount:
    @pytest.mark.parametrize("route", ["host", "device", "sparse"])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_rows_equal_the_full_counts_and_the_references(self, route, seed, monkeypatch):
        """Every route's rows equal the same rows of the full ``XᵀX`` and the
        reference's restricted recount. The device route (forced here by a
        zero host threshold) runs on the CPU through ``int8_gram_plain``."""
        rng = np.random.default_rng(seed)
        baskets, full = _baskets(rng)
        row_ids = np.asarray(sorted(rng.choice(baskets.n_tracks, 7, replace=False)), np.int32)
        if route == "device":
            monkeypatch.setattr(support, "HOST_RECOUNT_ELEMS", 0)
        count_path = "sparse" if route == "sparse" else None
        got = support.restricted_pair_counts(baskets, row_ids, count_path=count_path,
                                             device="cpu")
        want = ref_support.restricted_pair_counts(baskets, row_ids, count_path=count_path)
        assert got.dtype == np.int32 and got.shape == (7, baskets.n_tracks)
        assert np.array_equal(got, full[row_ids])
        assert np.array_equal(got, np.asarray(want))
        assert support.LAUNCHES["restricted_recount"] == 0  # no device launch on the CPU

    def test_row_checks_are_the_references(self, rng):
        baskets, _ = _baskets(rng, p=10, v=5)
        for fn in (support.restricted_pair_counts, ref_support.restricted_pair_counts):
            assert fn(baskets, []).shape == (0, 5)
            for bad in ([5], [-1]):
                with pytest.raises(ValueError, match="outside the vocabulary"):
                    fn(baskets, bad)

    def test_device_route_at_odd_shapes(self, rng, monkeypatch):
        """Ragged P, V and R (none a multiple of 8, R below 17): the padded
        operands give the same rows."""
        monkeypatch.setattr(support, "HOST_RECOUNT_ELEMS", 0)
        for p, v, r in ((1, 1, 1), (9, 13, 3), (33, 19, 19)):
            baskets, full = _baskets(rng, p=p, v=v, density=0.5)
            ids = np.arange(r, dtype=np.int32) % v
            got = support.restricted_pair_counts(baskets, ids, device="cpu")
            assert np.array_equal(got, full[ids]), (p, v, r)


# ---------------------------------------------------------------------------
# bit-identity: base ∘ delta chain == full re-mine
# ---------------------------------------------------------------------------


class TestDeltaBitIdentity:
    @pytest.mark.parametrize("count_path", ["auto", "sparse"])
    def test_chain_equals_full_remine(self, tmp_path, delta_pvc, count_path):
        """Two append → delta cycles applied in place leave serving equal to
        a pristine full re-mine, tensors and answers; with ``sparse`` the
        recount takes the event expansion and the full re-mine keeps the
        default dispatch (the identity holds across families)."""
        mining_cfg, serving_cfg, csv_path = delta_pvc
        cfg = dataclasses.replace(mining_cfg, count_path=count_path)
        engine = RecommendEngine(serving_cfg, device="cpu")
        assert engine.load()
        for seq, rows in enumerate((CYCLE_1, CYCLE_2), start=1):
            _append_rows(csv_path, rows)
            assert run_job(cfg).delta_seq == seq
            assert engine.apply_pending_deltas() == 1
            assert engine.delta_seq == seq
        assert engine.delta_applied_total == 2
        full = _fresh_full_remine(tmp_path, csv_path, mining_cfg)
        _assert_bundles_identical(engine.bundle, full.bundle)
        for seeds in PROBES:
            assert engine.recommend(seeds) == full.recommend(seeds)

    def test_delta_with_pruning_and_tombstones(self, tmp_path, rng):
        """The prune active: a track at exactly ``min_count`` leaves the
        vocabulary when appended playlists raise the threshold (a
        tombstone), and the result still equals the full re-mine."""
        os.makedirs(tmp_path / "datasets")
        csv_path = str(tmp_path / "datasets" / DATASET)
        pids, tracks = _base_rows(rng, n_playlists=60, n_tracks=24)
        for p in (0, 1, 2):
            pids.append(p)
            tracks.append("marginal")
        _write_csv(csv_path, pids, tracks)
        mining_cfg = _mining_cfg(tmp_path, min_support=0.05, prune_vocab_threshold=8)
        run_job(mining_cfg)
        engine = RecommendEngine(_serving_cfg(tmp_path), device="cpu")
        assert engine.load()
        assert "marginal" in engine.bundle.vocab
        _append_rows(csv_path, [(100 + i, f"s{i % 6:03d}") for i in range(21)]
                     + [(100 + i, "s006") for i in range(21)])
        assert run_job(mining_cfg).delta_seq == 1
        state = artifacts.read_delta_state(mining_cfg.pickles_dir)
        assert state["entries"][0]["n_tombstones"] >= 1
        assert engine.apply_pending_deltas() == 1
        assert "marginal" not in engine.bundle.vocab
        full = _fresh_full_remine(tmp_path, csv_path, mining_cfg)
        _assert_bundles_identical(engine.bundle, full.bundle)
        assert engine.recommend(["marginal"]) == full.recommend(["marginal"])

    def test_chain_answers_equal_the_references_chain(self, twin_chain):
        """The port's engine over its own chain answers as the reference's
        engine over the reference's chain."""
        from kmlserver_tpu.config import ServingConfig as RefServingConfig
        from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine

        port_cfg = twin_chain["port"][0]
        ref_cfg = twin_chain["ref"][0]
        port = RecommendEngine(_serving_cfg(port_cfg.base_dir), device="cpu")
        ref = RefEngine(RefServingConfig(base_dir=ref_cfg.base_dir, pickle_dir="pickles/",
                                         delta_enabled=True, native_serve=False, **SERVE_KNOBS))
        for engine in (port, ref):
            assert engine.load()
            assert engine.apply_pending_deltas() == 2
        assert port.bundle.vocab == ref.bundle.vocab
        for seeds in PROBES:
            assert port.recommend(seeds) == ref.recommend(seeds)


# ---------------------------------------------------------------------------
# eligibility: the delta route never publishes an approximation
# ---------------------------------------------------------------------------


class TestDeltaEligibility:
    def test_unchanged_dataset_is_a_noop(self, delta_pvc):
        mining_cfg, _, _ = delta_pvc
        s = run_job(mining_cfg)
        assert s.delta_seq is None and s.artifact_paths == {}
        assert artifacts.read_delta_state(mining_cfg.pickles_dir) is None

    def test_rewritten_prefix_falls_back_to_full_mine(self, delta_pvc):
        mining_cfg, _, csv_path = delta_pvc
        with open(csv_path, "r+b") as fh:
            data = fh.read()
            fh.seek(data.index(b",s0") + 1)
            fh.write(b"X")
        s = run_job(mining_cfg)
        assert s.delta_seq is None and "recommendations" in s.artifact_paths
        assert artifacts.read_delta_state(mining_cfg.pickles_dir) is None

    @pytest.mark.parametrize("knob", [{"min_support": 0.1}, {"sample_ratio": 0.5},
                                      {"max_itemset_len": 3}])
    def test_config_changes_fall_back_to_full_mine(self, delta_pvc, knob):
        mining_cfg, _, csv_path = delta_pvc
        _append_rows(csv_path, [(90, "s000"), (90, "s001")])
        with pytest.raises(delta_mod.DeltaIneligible):
            delta_mod.run_delta_job(dataclasses.replace(mining_cfg, **knob), device="cpu")
        s = run_job(dataclasses.replace(mining_cfg, **knob))
        assert s.delta_seq is None and "recommendations" in s.artifact_paths

    def test_chain_cap_forces_full_remine(self, delta_pvc):
        mining_cfg, _, csv_path = delta_pvc
        capped = dataclasses.replace(mining_cfg, delta_max_chain=1)
        _append_rows(csv_path, [(91, "s000"), (91, "s001")])
        assert run_job(capped).delta_seq == 1
        _append_rows(csv_path, [(92, "s002"), (92, "s003")])
        s = run_job(capped)
        assert s.delta_seq is None and "recommendations" in s.artifact_paths
        assert artifacts.read_delta_state(mining_cfg.pickles_dir) is None

    def test_full_publication_retires_chain_and_rearms(self, delta_pvc):
        mining_cfg, _, csv_path = delta_pvc
        _append_rows(csv_path, [(93, "s000"), (93, "s004")])
        assert run_job(mining_cfg).delta_seq == 1
        run_job(dataclasses.replace(mining_cfg, delta_enabled=False))
        assert artifacts.read_delta_state(mining_cfg.pickles_dir) is None
        # the token moved: the base state is stale, the next run full-mines
        _append_rows(csv_path, [(94, "s001"), (94, "s005")])
        assert run_job(mining_cfg).delta_seq is None
        _append_rows(csv_path, [(95, "s002"), (95, "s006")])
        assert run_job(mining_cfg).delta_seq == 1

    def test_delta_job_respects_live_lease(self, delta_pvc):
        mining_cfg, _, csv_path = delta_pvc
        _append_rows(csv_path, [(96, "s000"), (96, "s001")])
        lease = artifacts.PublicationLease.acquire(mining_cfg.pickles_dir, ttl_s=30.0)
        try:
            with pytest.raises(artifacts.LeaseHeldError):
                delta_mod.run_delta_job(mining_cfg, device="cpu")
        finally:
            lease.release()
        assert artifacts.read_delta_state(mining_cfg.pickles_dir) is None

    def test_more_than_one_rank_is_ineligible(self, delta_pvc, monkeypatch):
        from kmlserver_tpu_torch.parallel import mesh as mesh_mod

        mining_cfg, _, csv_path = delta_pvc
        _append_rows(csv_path, [(97, "s000"), (97, "s001")])
        monkeypatch.setattr(mesh_mod, "world_ranks", lambda: [0, 1])
        with pytest.raises(delta_mod.DeltaIneligible, match="multi-host gang"):
            delta_mod.run_delta_job(mining_cfg, device="cpu")

    def test_appended_partial_row_is_ineligible(self, delta_pvc):
        """The base prefix must end at a line boundary: an appender that
        continued the last row rewrote it."""
        mining_cfg, _, csv_path = delta_pvc
        with open(csv_path, "rb+") as fh:
            data = fh.read().rstrip(b"\n")
            fh.seek(0)
            fh.write(data)
            fh.truncate()
        base = delta_mod.load_base_state(mining_cfg.pickles_dir)
        with pytest.raises(delta_mod.DeltaIneligible):
            delta_mod._read_suffix_table(csv_path, base["dataset_bytes"] - 1)
        with pytest.raises(delta_mod.DeltaIneligible, match="header"):
            delta_mod._read_suffix_table(csv_path, 3)

    def test_no_card_raises_before_any_work(self, delta_pvc):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        from kmlserver_tpu_torch.utils.device import DeviceUnavailableError

        mining_cfg, _, csv_path = delta_pvc
        _append_rows(csv_path, [(98, "s000")])
        with pytest.raises(DeviceUnavailableError):
            delta_mod.run_delta_job(mining_cfg)
        assert artifacts.read_delta_state(mining_cfg.pickles_dir) is None


# ---------------------------------------------------------------------------
# the suffix parse: the port's full-path parser, not pandas' inference
# ---------------------------------------------------------------------------


class TestSuffixParse:
    # a suffix whose names are all digit strings: pandas infers integers
    DIGIT_ROWS = [(84, "007"), (85, "0042"), (85, "007"), (86, "007"), (86, "0042"),
                  (87, "007"), (87, "0042"), (88, "0042"), (88, "007")]

    def test_reference_suffix_reader_mangles_digit_names(self, delta_pvc):
        """The reference's delta reader returns ``7`` for ``007``; the
        port's keeps the name verbatim, as both full readers do."""
        mining_cfg, _, csv_path = delta_pvc
        offset = os.path.getsize(csv_path)
        _append_rows(csv_path, self.DIGIT_ROWS)
        _, ref_names = ref_delta._read_suffix_table(csv_path, offset)
        _, port_names = delta_mod._read_suffix_table(csv_path, offset)
        assert "7" in set(ref_names) and "007" not in set(ref_names)
        assert list(port_names) == [name for _, name in self.DIGIT_ROWS]

    def test_digit_names_chain_equals_full_remine(self, tmp_path, delta_pvc):
        mining_cfg, serving_cfg, csv_path = delta_pvc
        engine = RecommendEngine(serving_cfg, device="cpu")
        assert engine.load()
        _append_rows(csv_path, self.DIGIT_ROWS)
        assert run_job(mining_cfg).delta_seq == 1
        assert engine.apply_pending_deltas() == 1
        assert "007" in engine.bundle.vocab and "7" not in engine.bundle.vocab
        full = _fresh_full_remine(tmp_path, csv_path, mining_cfg)
        _assert_bundles_identical(engine.bundle, full.bundle)
        assert engine.recommend(["007"])[0] == ["0042"]
        for seeds in (["007"], ["0042", "s000"], ["7"]):
            assert engine.recommend(seeds) == full.recommend(seeds)

    def test_float_pid_is_refused_like_the_full_path(self, delta_pvc):
        """``5.0`` is no pid to the full path: the delta route is
        ineligible, the full re-mine refuses the CSV (exit 64), and
        nothing is published. The reference's delta reader accepts it."""
        mining_cfg, _, csv_path = delta_pvc
        offset = os.path.getsize(csv_path)
        token = artifacts.read_text(os.path.join(mining_cfg.base_dir, "last_execution.txt"))
        _append_rows(csv_path, [("5.0", "s003")])
        ref_pids, _ = ref_delta._read_suffix_table(csv_path, offset)
        assert list(ref_pids) == [5]
        with pytest.raises(delta_mod.DeltaIneligible, match="pid"):
            delta_mod.run_delta_job(mining_cfg, device="cpu")
        with pytest.raises(ValueError, match="pid"):
            run_job(mining_cfg)
        assert artifacts.read_delta_state(mining_cfg.pickles_dir) is None
        assert artifacts.read_text(
            os.path.join(mining_cfg.base_dir, "last_execution.txt")) == token


# ---------------------------------------------------------------------------
# chaos: a torn, mis-bound or out-of-order bundle — the base keeps serving
# ---------------------------------------------------------------------------


@pytest.mark.chaos
class TestDeltaChaos:
    def _published_then(self, delta_pvc, corrupt):
        """Publish one delta, ``corrupt`` it, then drive the polling path
        → (engine, answer before)."""
        mining_cfg, serving_cfg, csv_path = delta_pvc
        engine = RecommendEngine(serving_cfg, device="cpu")
        assert engine.load()
        before = engine.recommend(["s000", "s001"])
        _append_rows(csv_path, [(97, "s000"), (97, "s001"), (97, "s002")])
        assert run_job(mining_cfg).delta_seq == 1
        corrupt(mining_cfg)
        engine.reload_if_required()
        return engine, before

    def test_torn_delta_rejected_base_keeps_serving(self, delta_pvc):
        engine, before = self._published_then(
            delta_pvc, lambda cfg: faults.flip_byte(_bundle_path(cfg, 1), offset=100))
        assert (engine.delta_seq, engine.delta_rejected_total, engine.delta_applied_total) == (
            0, 1, 0)
        assert "sha256" in (engine.last_delta_error or "")
        assert engine.recommend(["s000", "s001"]) == before
        assert engine._delta_backoff_until > time.monotonic() - 1.0

    def test_wrong_base_delta_is_inert(self, delta_pvc):
        def corrupt(cfg):
            state = artifacts.read_delta_state(cfg.pickles_dir)
            artifacts.write_delta_state(cfg.pickles_dir, "1999-01-01 00:00:00.000000",
                                        state["base_npz_sha256"], state["entries"])

        engine, before = self._published_then(delta_pvc, corrupt)
        assert (engine.delta_seq, engine.delta_applied_total) == (0, 0)
        assert engine.recommend(["s000", "s001"]) == before

    def test_wrong_base_npz_is_rejected(self, delta_pvc):
        """A bundle bound to other npz bytes than the ones serving."""
        def corrupt(cfg):
            bundle = artifacts.load_delta_bundle(_bundle_path(cfg, 1))
            path = _bundle_path(cfg, 1)
            artifacts.save_delta_bundle(
                path, seq=1, base_token=bundle["base_token"], base_npz_sha256="0" * 64,
                n_playlists=bundle["n_playlists"], min_count=bundle["min_count"],
                vocab=bundle["vocab"], changed_rows=bundle["changed_rows"],
                changed_rule_ids=bundle["changed_rule_ids"],
                changed_rule_counts=bundle["changed_rule_counts"],
                changed_item_counts=bundle["changed_item_counts"],
                tombstones=bundle["tombstones"])
            state = artifacts.read_delta_state(cfg.pickles_dir)
            entry = dict(state["entries"][0], sha256=artifacts.file_digest(path)["sha256"])
            artifacts.write_delta_state(cfg.pickles_dir, state["base_token"],
                                        state["base_npz_sha256"], [entry])

        engine, before = self._published_then(delta_pvc, corrupt)
        assert (engine.delta_seq, engine.delta_rejected_total) == (0, 1)
        assert "different base artifact" in engine.last_delta_error
        assert engine.recommend(["s000", "s001"]) == before

    def test_chain_gap_rejected(self, delta_pvc):
        def corrupt(cfg):
            state = artifacts.read_delta_state(cfg.pickles_dir)
            artifacts.write_delta_state(cfg.pickles_dir, state["base_token"],
                                        state["base_npz_sha256"],
                                        [dict(state["entries"][0], seq=2)])

        engine, before = self._published_then(delta_pvc, corrupt)
        assert (engine.delta_seq, engine.delta_rejected_total) == (0, 1)
        assert "chain gap" in engine.last_delta_error
        assert engine.recommend(["s000", "s001"]) == before

    def test_injected_delta_fault_then_recovery(self, delta_pvc, monkeypatch):
        """``KMLS_FAULT_DELTA_CORRUPT=1`` rejects one apply; the next one
        lands the same bundle — a rejection destroys nothing."""
        monkeypatch.setenv("KMLS_FAULT_DELTA_CORRUPT", "1")
        faults.load_env(force=True)
        engine, before = self._published_then(delta_pvc, lambda cfg: None)
        assert (engine.delta_seq, engine.delta_rejected_total) == (0, 1)
        assert "FaultInjected" in engine.last_delta_error
        assert engine.recommend(["s000", "s001"]) == before
        assert engine.apply_pending_deltas() == 1
        assert (engine.delta_seq, engine.delta_applied_total) == (1, 1)

    def test_pickle_only_generation_serves_with_deltas_off(self, delta_pvc):
        """Without the npz's counts there is nothing to patch: the chain is
        left alone and the base serves."""
        mining_cfg, serving_cfg, csv_path = delta_pvc
        engine = RecommendEngine(dataclasses.replace(serving_cfg, prefer_tensor_artifact=False),
                                 device="cpu")
        assert engine.load()
        _append_rows(csv_path, [(97, "s000"), (97, "s001")])
        assert run_job(mining_cfg).delta_seq == 1
        assert engine.apply_pending_deltas() == 0
        assert engine.delta_seq == 0 and engine.delta_rejected_total == 0

    def test_freshness_lag_tracks_applied_generation(self, delta_pvc):
        mining_cfg, serving_cfg, csv_path = delta_pvc
        engine = RecommendEngine(serving_cfg, device="cpu")
        assert engine.load()
        lag0 = engine.freshness_lag_s()
        assert lag0 >= 0.0
        assert engine.artifact_ages()["delta-chain"] == pytest.approx(
            engine.artifact_ages()["rules"], abs=1.0)
        time.sleep(0.05)
        _append_rows(csv_path, [(98, "s000"), (98, "s003")])
        assert run_job(mining_cfg).delta_seq == 1
        assert engine.apply_pending_deltas() == 1
        ages = engine.artifact_ages()
        assert ages["delta-chain"] < ages["rules"]
        assert engine.freshness_lag_s() <= lag0 + 5.0


# ---------------------------------------------------------------------------
# selective against wholesale invalidation
# ---------------------------------------------------------------------------


def _ask(app, seeds):
    status, headers, payload = app.handle("POST", "/api/recommend/",
                                          json.dumps({"songs": seeds}).encode())
    assert status == 200, status
    return json.loads(payload)["songs"], headers


@pytest.mark.chaos
class TestSelectiveInvalidation:
    def test_touched_seed_recomputes_and_hot_key_survives(self, delta_pvc):
        """After a delta touching ``s000`` its answer is recomputed from the
        patched tensors, never the pre-delta entry; an untouched hot key
        keeps its entry (a hit with no recompute) and the epoch stays."""
        mining_cfg, serving_cfg, csv_path = delta_pvc
        app = RecommendApp(dataclasses.replace(serving_cfg, cache_max_entries=256), device="cpu")
        try:
            assert app.engine.load()
            touched, hot = ["s000"], ["s010", "s011"]
            _ask(app, touched)
            _ask(app, hot)
            assert _ask(app, hot)[1].get("X-KMLS-Cache") == "hit"
            epoch = app.engine.bundle_epoch
            _append_rows(csv_path, [(200 + i, "s000") for i in range(6)]
                         + [(200 + i, "s001") for i in range(6)])
            assert run_job(mining_cfg).delta_seq == 1
            bundle = artifacts.load_delta_bundle(_bundle_path(mining_cfg, 1))
            assert "s000" in delta_mod.touched_names(bundle)
            assert not set(hot) & delta_mod.touched_names(bundle)
            assert app.engine.apply_pending_deltas() == 1
            assert app.engine.bundle_epoch == epoch
            assert app.cache.selective_invalidations == 1
            fresh = app.engine.recommend(touched)[0]
            got, headers = _ask(app, touched)
            assert headers.get("X-KMLS-Cache") != "hit" and got == fresh
            hits = app.cache.hits
            assert _ask(app, hot)[1].get("X-KMLS-Cache") == "hit"
            assert app.cache.hits == hits + 1
        finally:
            app.close()

    def test_full_reload_still_invalidates_wholesale(self, delta_pvc):
        mining_cfg, serving_cfg, _ = delta_pvc
        app = RecommendApp(serving_cfg, device="cpu")
        try:
            assert app.engine.load()
            epoch0, key0 = app.engine.bundle_epoch, app._cache_key(["s000"])
            run_job(dataclasses.replace(mining_cfg, delta_enabled=False))
            assert app.engine.load()
            assert app.engine.bundle_epoch == epoch0 + 1
            assert app._cache_key(["s000"]) != key0
        finally:
            app.close()

    def test_blend_bundle_with_moved_playlist_count_bumps_the_epoch(self, tmp_path, rng):
        """Hybrid blend mode: a delta that changes ``n_playlists`` rescales
        every rule confidence, so the apply invalidates wholesale; the
        embedding factors ride over to the patched replicas."""
        os.makedirs(tmp_path / "datasets")
        csv_path = str(tmp_path / "datasets" / DATASET)
        _write_csv(csv_path, *_base_rows(rng))
        mining_cfg = _mining_cfg(tmp_path, embed_enabled=True, als_rank=4, als_iters=2)
        run_job(mining_cfg)
        app = RecommendApp(_serving_cfg(tmp_path, hybrid_mode="blend"), device="cpu")
        try:
            assert app.engine.load() and app.engine.embedding_active
            factors = app.engine.bundle.emb_factors
            epoch = app.engine.bundle_epoch
            _append_rows(csv_path, [(300, "s000"), (300, "s001")])
            assert run_job(mining_cfg).delta_seq == 1
            assert app.engine.apply_pending_deltas() == 1
            assert app.engine.bundle_epoch == epoch + 1
            assert app.cache.selective_invalidations == 0
            assert app.engine.bundle.emb_factors is factors
        finally:
            app.close()


# ---------------------------------------------------------------------------
# the rendezvous ring and the affinity counters
# ---------------------------------------------------------------------------


class TestRendezvousRing:
    def test_owners_equal_the_references(self):
        peers = ["pod-0", "pod-1", "pod-2"]
        port, ref = RendezvousRing(peers), ref_ring.RendezvousRing(peers)
        keys = [f"k{i}" for i in range(300)]
        owners = [port.owner(k) for k in keys]
        assert owners == [ref.owner(k) for k in keys]
        assert set(owners) == set(peers)
        assert [port.ranked(k) for k in keys[:20]] == [ref.ranked(k) for k in keys[:20]]
        assert seeds_key(["b", "a", "a"]) == ref_ring.seeds_key(["a", "b", "a"])
        assert seeds_key(["a"]) != seeds_key(["a", "a"])
        with pytest.raises(ValueError):
            RendezvousRing([" ", ""])

    def test_peer_removal_only_remaps_its_keys(self):
        full, reduced = RendezvousRing(["pod-0", "pod-1", "pod-2"]), RendezvousRing(
            ["pod-0", "pod-2"])
        for i in range(500):
            key = f"key-{i}"
            if full.owner(key) != "pod-1":
                assert reduced.owner(key) == full.owner(key)
            else:
                assert reduced.owner(key) == full.ranked(key)[1]

    def test_fleet_simulation_equals_the_references(self, rng):
        pool = [f"key-{i}" for i in range(64)]
        p = np.arange(1, 65, dtype=np.float64) ** -1.1
        keys = [pool[int(i)] for i in rng.choice(64, 4000, p=p / p.sum())]
        got = fleet_multiplier(keys, n_replicas=3, capacity=16)
        assert got == ref_ring.fleet_multiplier(keys, n_replicas=3, capacity=16)
        assert got["affinity_hit_ratio"] > got["baseline_hit_ratio"]
        for policy in ("affinity", "roundrobin", "random"):
            assert simulate_fleet(keys, 3, 8, policy) == ref_ring.simulate_fleet(keys, 3, 8,
                                                                                policy)
        assert simulate_fleet(["a"] * 10, 3, 8, "affinity") == pytest.approx(0.9)
        with pytest.raises(ValueError):
            simulate_fleet(keys, 3, 8, "bogus")

    @pytest.mark.parametrize("cache_enabled", [True, False])
    def test_app_affinity_counters(self, delta_pvc, cache_enabled):
        _, serving_cfg, _ = delta_pvc
        cfg = dataclasses.replace(serving_cfg, cache_affinity=True, cache_enabled=cache_enabled,
                                  cache_affinity_peers="pod-a,pod-b,pod-c",
                                  cache_affinity_self="pod-a")
        app = RecommendApp(cfg, device="cpu")
        try:
            assert app.engine.load()
            ring = RendezvousRing(["pod-a", "pod-b", "pod-c"])
            seeds = [[f"s{i % 12:03d}"] for i in range(40)]
            for s in seeds:
                _ask(app, s)
            local = sum(ring.owner(seeds_key(s)) == "pod-a" for s in seeds)
            assert (app.affinity_local_total, app.affinity_remote_total) == (local, 40 - local)
            assert 0 < local < 40
        finally:
            app.close()

    def test_unarmed_app_counts_nothing(self, delta_pvc):
        _, serving_cfg, _ = delta_pvc
        app = RecommendApp(serving_cfg, device="cpu")
        try:
            assert app.engine.load()
            _ask(app, ["s000"])
            assert app.ring is None
            assert (app.affinity_local_total, app.affinity_remote_total) == (0, 0)
        finally:
            app.close()


# ---------------------------------------------------------------------------
# exposition, the poll loop, the job telemetry and the checkpoint format
# ---------------------------------------------------------------------------


class TestFreshnessExposition:
    def test_metrics_carry_delta_and_affinity_series(self, delta_pvc):
        mining_cfg, serving_cfg, csv_path = delta_pvc
        app = RecommendApp(serving_cfg, device="cpu")
        try:
            assert app.engine.load()
            _append_rows(csv_path, [(99, "s000"), (99, "s002")])
            assert run_job(mining_cfg).delta_seq == 1
            assert app.engine.apply_pending_deltas() == 1
            text = app.handle("GET", "/metrics", b"")[2].decode()
        finally:
            app.close()
        for line in ("kmls_delta_applied_total 1", "kmls_delta_rejected_total 0",
                     "kmls_delta_seq 1", "kmls_delta_chain_length 1"):
            assert line in text, line
        for name in ("kmls_freshness_lag_seconds", "kmls_cache_selective_invalidations_total",
                     "kmls_cache_invalidated_keys_total", "kmls_cache_affinity_local_total",
                     "kmls_cache_affinity_remote_total", 'artifact="delta-chain"'):
            assert name in text, name

    def test_poll_loop_applies_delta_without_token_rewrite(self, delta_pvc):
        mining_cfg, serving_cfg, csv_path = delta_pvc
        engine = RecommendEngine(serving_cfg, device="cpu")
        assert engine.load()
        epoch0, reloads0 = engine.bundle_epoch, engine.reload_counter
        _append_rows(csv_path, [(101, "s000"), (101, "s005")])
        assert run_job(mining_cfg).delta_seq == 1
        assert not engine.is_data_stale()
        engine.reload_if_required()
        assert (engine.delta_seq, engine.bundle_epoch, engine.reload_counter) == (
            1, epoch0, reloads0)
        assert engine.unwarmed_dispatches == 0

    def test_delta_disabled_server_ignores_the_chain(self, delta_pvc):
        mining_cfg, serving_cfg, csv_path = delta_pvc
        engine = RecommendEngine(dataclasses.replace(serving_cfg, delta_enabled=False),
                                 device="cpu")
        assert engine.load()
        _append_rows(csv_path, [(102, "s000"), (102, "s005")])
        assert run_job(mining_cfg).delta_seq == 1
        engine.reload_if_required()
        assert engine.apply_pending_deltas() == 0 and engine.delta_seq == 0

    def test_job_metrics_record_the_delta_phase(self, delta_pvc):
        from kmlserver_tpu_torch.observability import costmodel

        mining_cfg, _, csv_path = delta_pvc
        _append_rows(csv_path, [(103, "s000"), (103, "s007")])
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            assert run_job(mining_cfg).delta_seq == 1
        assert "Delta phase timings: fingerprint" in log.getvalue()
        prom = open(os.path.join(mining_cfg.pickles_dir, "job_metrics.prom")).read()
        assert 'kmls_job_phase_duration_seconds{phase="delta"}' in prom
        assert 'kmls_job_artifact_bytes{artifact="delta"}' in prom
        assert "kmls_job_success 1" in prom
        flops_line = next(line for line in prom.splitlines()
                          if line.startswith('kmls_job_phase_flops{phase="delta"}'))
        assert float(flops_line.split()[-1]) > 0
        assert costmodel.KERNEL_COST_SPECS["delta_recount"]

    def test_encode_checkpoint_without_pid_values_is_re_encoded(self, tmp_path, rng):
        """An encode payload written before the delta route (no
        ``pid_values``) never crashes a resume: it is retired and the
        phase re-encodes, and the publication equals an uninterrupted
        run's."""
        os.makedirs(tmp_path / "a" / "datasets")
        csv_path = str(tmp_path / "a" / "datasets" / DATASET)
        _write_csv(csv_path, *_base_rows(rng))
        cfg = _mining_cfg(tmp_path / "a", delta_enabled=False)
        faults.inject("mine.crash.encode", times=1)
        with pytest.raises(faults.FaultInjected):
            run_job(cfg)
        store = ckpt_mod.open_store(cfg, csv_path, 1, writer=True)
        payload = store.load("encode")
        assert "pid_values" in payload
        del payload["pid_values"]
        store.save("encode", payload)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            run_job(cfg)
        assert "lacks ['pid_values']" in log.getvalue()
        assert "Resumed phase 'encode'" not in log.getvalue()
        control = _fresh_full_remine(tmp_path, csv_path, cfg, name="control")
        engine = RecommendEngine(_serving_cfg(tmp_path / "a", delta_enabled=False), device="cpu")
        assert engine.load()
        _assert_bundles_identical(engine.bundle, control.bundle)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_card_recount_route_equals_the_full_counts(monkeypatch):
    """The card's route (one-hot built transposed and padded, gathered rows,
    ``torch._int_mm``) at ragged shapes equals the rows of the full count."""
    _cuda()
    monkeypatch.setattr(support, "HOST_RECOUNT_ELEMS", 0)
    rng = np.random.default_rng(3)
    for p, v, r in ((5, 3, 1), (131, 77, 9), (2048, 301, 40)):
        baskets, full = _baskets(rng, p=p, v=v, density=0.3)
        ids = np.sort(rng.choice(v, r, replace=False)).astype(np.int32)
        before = support.LAUNCHES["restricted_recount"]
        got = support.restricted_pair_counts(baskets, ids, device="cuda")
        assert support.LAUNCHES["restricted_recount"] == before + 1
        assert np.array_equal(got, full[ids]), (p, v, r)


@pytest.mark.cuda
def test_card_apply_with_four_batches_in_flight(delta_pvc):
    """Four batches dispatched on the card, a delta applied before any of
    them finishes: each finishes with the answers of the bundle it started
    on, and the batches after the apply give the patched answers."""
    _cuda()
    mining_cfg, serving_cfg, csv_path = delta_pvc
    engine = RecommendEngine(dataclasses.replace(serving_cfg, batch_max_inflight=4),
                             device="cuda")
    cpu = RecommendEngine(serving_cfg, device="cpu")
    assert engine.load() and cpu.load()
    sets = [[f"s{(i * 7 + j) % 30:03d}" for j in range(1 + i % 3)] for i in range(32)]
    batches = [sets[i::4] for i in range(4)]
    want_before = [cpu.recommend_many(b) for b in batches]
    finishes = [engine.recommend_many_async(b) for b in batches]
    _append_rows(csv_path, [(400 + i, "s000") for i in range(8)]
                 + [(400 + i, "s001") for i in range(8)])
    assert run_job(mining_cfg).delta_seq == 1
    assert engine.apply_pending_deltas() == 1 and cpu.apply_pending_deltas() == 1
    assert [f() for f in finishes] == want_before
    assert [engine.recommend_many(b) for b in batches] == [cpu.recommend_many(b)
                                                           for b in batches]
    assert engine.unwarmed_dispatches == 0
