"""The quality loop in the port (``quality/eval.py``, ``quality/sweep.py``,
the checkpointed ``eval`` phase, the report's writer and the staleness
bound), held against the JAX package on the same seeded inputs — the port
of ``tests/test_quality.py``'s ``TestHoldoutSplit``, ``TestEvalReport``,
``TestMeasuredBlendServing`` and ``TestStalenessBound``.

The bars: the split equals the reference's array for array (in any input
order); with the embed phase off, or with both packages' trainers handed
the same dyadic factors, the published report is the reference's byte for
byte; with real training the split, the rules and popularity modes are
equal and the embed / blend / sweep numbers lie within
:data:`TRAINED_TOL` (trained factors differ by ~1e-6 between the packages,
which moves answers only at near-ties).
"""

import dataclasses
import json
import os
import random
import shutil
import time

import numpy as np
import pytest
import torch

from kmlserver_tpu.config import MiningConfig as RefMiningConfig
from kmlserver_tpu.data.synthetic import synthetic_baskets as ref_synthetic_baskets
from kmlserver_tpu.io import artifacts as ref_artifacts
from kmlserver_tpu.mining import als as ref_als
from kmlserver_tpu.mining.pipeline import run_mining_job as ref_run_mining_job
from kmlserver_tpu.quality import eval as ref_eval
from kmlserver_tpu.quality import sweep as ref_sweep
from kmlserver_tpu.serving.app import RecommendApp as RefApp
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu.serving.engine import blend_candidates as ref_blend_candidates
from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
from kmlserver_tpu_torch.io import artifacts
from kmlserver_tpu_torch.mining import als
from kmlserver_tpu_torch.mining import checkpoint as ckpt_mod
from kmlserver_tpu_torch.mining.pipeline import run_mining_job
from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
from kmlserver_tpu_torch.quality import eval as qeval
from kmlserver_tpu_torch.quality import lifecycle, sweep
from kmlserver_tpu_torch.serving import engine as engine_mod
from kmlserver_tpu_torch.serving.app import RecommendApp
from kmlserver_tpu_torch.serving.engine import RecommendEngine

from .test_quality import baskets_to_csv, clustered_baskets
from .torch_chaos_util import clean_chaos_state  # noqa: F401  (autouse)
from .torch_serving_util import port_cfg, ref_cfg

DATASET = "2023_spotify_ds1.csv"
# |Δ| of any embed / blend / sweep number between the packages' reports
# with real training: at most two of the 320 evaluated playlists answering
# differently at a near-tie (one playlist moves a mean by 1/320)
TRAINED_TOL = 2 / 320


def to_port(b) -> Baskets:
    """The reference's baskets as the port's (same arrays, same names)."""
    return Baskets(
        playlist_rows=np.array(b.playlist_rows), track_ids=np.array(b.track_ids),
        n_playlists=b.n_playlists,
        vocab=Vocab(names=list(b.vocab.names), index=dict(b.vocab.index)),
    )


def shuffled(b, rng) -> Baskets:
    perm = rng.permutation(len(b.playlist_rows))
    return Baskets(playlist_rows=b.playlist_rows[perm], track_ids=b.track_ids[perm],
                   n_playlists=b.n_playlists, vocab=b.vocab)


def knobs(**overrides) -> dict:
    """tests/test_quality.py's eval settings."""
    return {**dict(min_support=0.05, embed_enabled=True, als_rank=12, als_iters=6,
                   eval_enabled=True, eval_max_playlists=0), **overrides}


def ref_config(**overrides) -> RefMiningConfig:
    # the reference on its dispatch's route; counts are exact, so the port's
    # native route gives the same report
    return RefMiningConfig(native_cpu_pair_counts=False, **knobs(**overrides))


def port_config(**overrides) -> MiningConfig:
    return MiningConfig(**knobs(**overrides))


def report_bytes(report: dict, tmp_path, package) -> bytes:
    """``report`` through a package's writer → the file's bytes."""
    out = tmp_path / package.__name__
    out.mkdir(parents=True, exist_ok=True)
    with open(package.save_quality_report(str(out), report), "rb") as fh:
        return fh.read()


def dyadic_payload(v: int, rank: int = 8, seed: int = 0) -> dict:
    """A trainer's payload whose factors are multiples of 1/64: every
    similarity is exact in float32, so both packages rank alike."""
    rng = np.random.default_rng(seed)
    factors = (rng.integers(-64, 65, size=(v, rank)) / 64.0).astype(np.float32)
    return {"item_factors": factors, "rank": rank, "iters": 1, "reg": 0.1, "final_loss": 0.0,
            "duration_s": 0.0, "shards": 1, "storage": "dense", "nnz": 0}


# ---------------------------------------------------------------------------
# the held-out split
# ---------------------------------------------------------------------------

SHAPES = {
    # tests/test_quality.py's ds1- and ds2-proportioned shapes
    "ds1-shaped": dict(n_playlists=300, n_tracks=220, target_rows=5200, seed=11),
    "ds2-shaped": dict(n_playlists=225, n_tracks=217, target_rows=2400, seed=12),
}


class TestHoldoutSplit:
    @pytest.mark.parametrize("shape", sorted(SHAPES))
    @pytest.mark.parametrize("order", ["given", "shuffled"])
    @pytest.mark.parametrize("holdout,cap", [(1, 0), (2, 40)])
    def test_split_equals_the_references(self, shape, order, holdout, cap, rng):
        ref_b = ref_synthetic_baskets(**SHAPES[shape])
        port_b = to_port(ref_b)
        if order == "shuffled":
            ref_b = shuffled(ref_b, np.random.default_rng(5))
            port_b = shuffled(port_b, np.random.default_rng(5))
        want = ref_eval.holdout_split(ref_b, n_holdout=holdout, max_playlists=cap)
        got = qeval.holdout_split(port_b, n_holdout=holdout, max_playlists=cap)
        assert got.eval_rows == want.eval_rows
        assert got.seed_names == want.seed_names
        assert got.target_names == want.target_names
        assert got.n_eligible == want.n_eligible
        for field in ("playlist_rows", "track_ids"):
            a, b = getattr(got.train, field), getattr(want.train, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        assert got.train.n_playlists == want.train.n_playlists
        assert got.train.vocab.names == want.train.vocab.names
        if cap:
            assert len(got.eval_rows) == cap < got.n_eligible

    def test_deterministic_across_runs_and_input_order(self, rng):
        baskets = to_port(ref_synthetic_baskets(200, 120, 2400, seed=4))
        a = qeval.holdout_split(baskets)
        b = qeval.holdout_split(baskets)
        assert (a.eval_rows, a.seed_names, a.target_names) == (
            b.eval_rows, b.seed_names, b.target_names)
        c = qeval.holdout_split(shuffled(baskets, rng))
        assert (c.eval_rows, c.target_names) == (a.eval_rows, a.target_names)
        assert np.array_equal(c.train.playlist_rows, a.train.playlist_rows)
        assert np.array_equal(c.train.track_ids, a.train.track_ids)

    @pytest.mark.parametrize("shape", sorted(SHAPES))
    def test_zero_leakage_by_construction(self, shape):
        baskets = to_port(ref_synthetic_baskets(**SHAPES[shape]))
        split = qeval.holdout_split(baskets)
        v = np.int64(baskets.n_tracks)
        all_keys = set((baskets.playlist_rows.astype(np.int64) * v + baskets.track_ids).tolist())
        train_keys = set(
            (split.train.playlist_rows.astype(np.int64) * v + split.train.track_ids).tolist())
        held_keys = {int(row) * int(v) + baskets.vocab.index[name]
                     for row, targets in zip(split.eval_rows, split.target_names)
                     for name in targets}
        assert held_keys and not (train_keys & held_keys)
        assert train_keys | held_keys == all_keys

    def test_min_basket_and_holdout_n(self):
        # playlists of 2, 3 and 5 tracks: leave-1-out needs at least 3
        names = [f"t{i}" for i in range(5)]
        baskets = Baskets(
            playlist_rows=np.asarray([0, 0, 1, 1, 1, 2, 2, 2, 2, 2], dtype=np.int32),
            track_ids=np.asarray([0, 1, 0, 1, 2, 0, 1, 2, 3, 4], dtype=np.int32),
            n_playlists=3, vocab=Vocab(names=names, index={n: i for i, n in enumerate(names)}),
        )
        split = qeval.holdout_split(baskets, n_holdout=1)
        assert split.eval_rows == [1, 2]
        assert all(len(t) == 1 and len(s) >= 2
                   for s, t in zip(split.seed_names, split.target_names))
        split2 = qeval.holdout_split(baskets, n_holdout=2)
        assert split2.eval_rows == [2] and len(split2.target_names[0]) == 2

    def test_pair_digest_and_rank_metrics_are_the_references(self):
        for row, name in [(0, "a"), (17, "Track 0000001"), (10**6, "ünïcode")]:
            assert qeval._pair_digest(row, name) == ref_eval._pair_digest(row, name)
        cases = [(["a", "b", "c"], ["c"], 3), (["a", "b"], ["x", "y"], 10), ([], ["a"], 5),
                 (["b", "a", "c", "d"], ["a", "d", "e"], 2)]
        for answer, targets, k in cases:
            assert qeval._rank_metrics(answer, targets, k) == ref_eval._rank_metrics(
                answer, targets, k)
        best = [f"Track {i:07d}" for i in range(30)]
        for seeds in (["a"], ["b", "c"], []):
            assert qeval._fallback_answer(best, seeds, 10) == ref_eval._fallback_answer(
                best, seeds, 10)
        assert qeval._fallback_answer([], ["a"], 10) == []


# ---------------------------------------------------------------------------
# the eval phase's report
# ---------------------------------------------------------------------------


class TestEvalReport:
    @pytest.mark.parametrize("prune", [False, True], ids=["full-vocab", "pruned-vocab"])
    def test_eval_off_embeddings_report_bytes_equal_the_references(self, tmp_path, prune):
        """Rules and popularity only: the report is the reference's byte for
        byte, also when the train split's mine prunes the vocabulary (rule
        ids index ``result.vocab_names``)."""
        extra = dict(embed_enabled=False, prune_vocab_threshold=32 if prune else 512)
        ref_b = ref_synthetic_baskets(200, 120, 2400, seed=4)
        want = ref_eval.run_eval_phase(ref_config(**extra), ref_b)
        got = qeval.run_eval_phase(port_config(**extra), to_port(ref_b), device="cpu")
        assert got["sweep"] is None and got["modes"]["blend"] == got["modes"]["rules"]
        assert report_bytes(got, tmp_path, artifacts) == report_bytes(want, tmp_path,
                                                                      ref_artifacts)

    def test_shared_factors_report_bytes_equal_the_references(self, tmp_path, monkeypatch):
        """Both trainers return the same dyadic factors: every mode, the
        sweep and the measured weight are the reference's byte for byte."""
        ref_b = clustered_baskets(n_clusters=4, cluster_size=16, per_cluster=20, seed=2)
        payload = dyadic_payload(ref_b.n_tracks)
        calls = []
        for module in (ref_als, als):
            monkeypatch.setattr(module, "train_embeddings",
                                lambda *a, _m=module, **k: calls.append(_m) or payload)
        want = ref_eval.run_eval_phase(ref_config(), ref_b)
        got = qeval.run_eval_phase(port_config(), to_port(ref_b), device="cpu")
        assert calls == [ref_als, als]
        assert got["sweep"] is not None and "embed" in got["modes"]
        assert report_bytes(got, tmp_path, artifacts) == report_bytes(want, tmp_path,
                                                                      ref_artifacts)

    def test_trained_reports_agree_within_tolerance(self):
        """Real training in both packages: split, k, rules and popularity
        equal; embed, blend and every sweep point within TRAINED_TOL."""
        ref_b = clustered_baskets(seed=0)
        want = ref_eval.run_eval_phase(ref_config(), ref_b)
        got = qeval.run_eval_phase(port_config(), to_port(ref_b), device="cpu")
        assert got["split"] == want["split"] and got["k"] == want["k"]
        assert got["split"]["n_eval_playlists"] == 320
        for mode in ("rules", "popularity"):
            assert got["modes"][mode] == want["modes"][mode], mode
        for mode in ("embed", "blend"):
            for field, value in want["modes"][mode].items():
                assert abs(got["modes"][mode][field] - value) <= TRAINED_TOL, (mode, field)
        for field in ("recall_at_k", "mrr"):
            assert np.abs(np.subtract(got["sweep"][field], want["sweep"][field])).max() <= (
                TRAINED_TOL), field
        assert got["sweep"]["weights"] == want["sweep"]["weights"]
        assert abs(got["sweep"]["best_recall_at_k"] - want["sweep"]["best_recall_at_k"]) <= (
            TRAINED_TOL)

    def test_report_deterministic(self, tmp_path):
        baskets = to_port(clustered_baskets(n_clusters=4, cluster_size=16, per_cluster=20,
                                            seed=2))
        cfg = port_config(als_rank=8, als_iters=4, als_sparse="always")
        a = qeval.run_eval_phase(cfg, baskets, device="cpu")
        b = qeval.run_eval_phase(cfg, baskets, device="cpu")
        assert report_bytes(a, tmp_path / "a", artifacts) == report_bytes(b, tmp_path / "b",
                                                                          artifacts)

    def test_measured_blend_beats_both_pure_modes(self):
        report = qeval.run_eval_phase(port_config(), to_port(clustered_baskets(seed=0)),
                                      device="cpu")
        modes, best = report["modes"], report["sweep"]["best_recall_at_k"]
        assert 0.0 < best <= 1.0
        assert best > modes["rules"]["recall_at_k"] and best > modes["embed"]["recall_at_k"]
        assert best > modes["popularity"]["recall_at_k"]
        assert report["measured_blend_weight"] == report["sweep"]["best_weight"]
        assert report["measured_blend_weight"] in sweep.WEIGHT_GRID
        assert report["sweep"]["weights"] == [float(w) for w in sweep.WEIGHT_GRID]

    def test_eval_without_embeddings_degrades_to_rules(self):
        report = qeval.run_eval_phase(
            port_config(embed_enabled=False),
            to_port(clustered_baskets(n_clusters=4, cluster_size=16, per_cluster=20, seed=3)),
            device="cpu")
        assert report["measured_blend_weight"] is None and report["sweep"] is None
        assert "embed" not in report["modes"]
        assert report["modes"]["blend"] == report["modes"]["rules"]

    def test_no_eligible_playlist_gives_the_references_empty_report(self, tmp_path):
        names = ["a", "b"]
        baskets = Baskets(playlist_rows=np.asarray([0, 0, 1], dtype=np.int32),
                          track_ids=np.asarray([0, 1, 0], dtype=np.int32), n_playlists=2,
                          vocab=Vocab(names=names, index={"a": 0, "b": 1}))
        got = qeval.run_eval_phase(port_config(), baskets, device="cpu")
        want = ref_eval.run_eval_phase(ref_config(), baskets)
        assert got["modes"] == {} and report_bytes(got, tmp_path, artifacts) == report_bytes(
            want, tmp_path, ref_artifacts)

    def test_sweep_equals_the_references(self):
        assert sweep.WEIGHT_GRID == ref_sweep.WEIGHT_GRID and len(sweep.WEIGHT_GRID) == 21
        assert sweep.DEFAULT_BLEND_WEIGHT == ref_sweep.DEFAULT_BLEND_WEIGHT
        rng = random.Random(3)
        pool = [f"t{i}" for i in range(30)]
        targets = [rng.sample(pool, 2) for _ in range(40)]
        answers = {(w, e): rng.sample(pool, 10) for w in sweep.WEIGHT_GRID for e in range(40)}

        def compose(w, e):
            return answers[(w, e)]

        assert sweep.sweep_blend_weight(compose, targets, 40, 10) == (
            ref_sweep.sweep_blend_weight(compose, targets, 40, 10))
        # a flat curve: the tie goes to the lowest weight
        flat = sweep.sweep_blend_weight(lambda w, e: pool[:10], targets, 40, 10)
        assert flat["best_weight"] == 0.0

    def test_no_card_raises_before_any_work(self, monkeypatch):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the no-card error cannot show")
        from kmlserver_tpu_torch.utils.device import DeviceUnavailableError

        def no_work(*args, **kwargs):
            raise AssertionError("the eval phase split before finding the card")

        monkeypatch.setattr(qeval, "holdout_split", no_work)
        with pytest.raises(DeviceUnavailableError):
            qeval.run_eval_phase(port_config(), to_port(clustered_baskets(seed=1)))


# ---------------------------------------------------------------------------
# the phase in the pipeline, its knobs and identity
# ---------------------------------------------------------------------------


def _pvc(base, baskets=None) -> str:
    ds_dir = os.path.join(str(base), "datasets")
    os.makedirs(ds_dir, exist_ok=True)
    baskets_to_csv(os.path.join(ds_dir, DATASET), baskets or clustered_baskets())
    return ds_dir


class TestEvalPhase:
    def test_run_phases_and_identity_gain_eval(self, tmp_path):
        assert ckpt_mod.run_phases(MiningConfig(eval_enabled=True)) == (
            "encode", "mine", "rules", "eval")
        assert ckpt_mod.run_phases(MiningConfig(eval_enabled=True, embed_enabled=True)) == (
            "encode", "mine", "rules", "embed", "eval")
        path = tmp_path / DATASET
        path.write_text("pid,track_name\n0,a\n0,b\n1,a\n")
        base = MiningConfig(base_dir=str(tmp_path), datasets_dir=str(tmp_path))
        fingerprints = {ckpt_mod.compute_fingerprint(base, str(path), 1)}
        for field, value in (("eval_enabled", True), ("eval_holdout_n", 2), ("eval_k", 5),
                             ("eval_max_playlists", 0)):
            other = dataclasses.replace(base, **{field: value})
            assert ckpt_mod.fingerprint_identity(other, str(path), 1)[field] == value
            fingerprints.add(ckpt_mod.compute_fingerprint(other, str(path), 1))
        assert len(fingerprints) == 5

    @pytest.mark.parametrize("values", [
        {},
        {"KMLS_EVAL_ENABLED": "1", "KMLS_EVAL_HOLDOUT_N": "2", "KMLS_EVAL_K": "5",
         "KMLS_EVAL_MAX_PLAYLISTS": "0", "KMLS_ARTIFACT_MAX_AGE_S": "3600"},
    ])
    def test_knobs_parse_like_the_reference(self, monkeypatch, values):
        from kmlserver_tpu.config import ServingConfig as RefServingConfig

        for name in ("KMLS_EVAL_ENABLED", "KMLS_EVAL_HOLDOUT_N", "KMLS_EVAL_K",
                     "KMLS_EVAL_MAX_PLAYLISTS", "KMLS_ARTIFACT_MAX_AGE_S"):
            monkeypatch.delenv(name, raising=False)
        for name, value in values.items():
            monkeypatch.setenv(name, value)
        got, want = MiningConfig.from_env(dotenv_path=None), RefMiningConfig.from_env(
            dotenv_path=None)
        for field in ("eval_enabled", "eval_holdout_n", "eval_k", "eval_max_playlists"):
            assert getattr(got, field) == getattr(want, field), field
        assert ServingConfig.from_env(dotenv_path=None).artifact_max_age_s == (
            RefServingConfig.from_env(dotenv_path=None).artifact_max_age_s)

    def test_job_publishes_the_references_report(self, tmp_path):
        """The eval job of each package on one CSV, embed off: the report
        bytes are equal and the manifest of each lists it."""
        paths = {}
        for side in ("port", "ref"):
            base = tmp_path / side
            ds_dir = _pvc(base)
            cfg_kwargs = dict(base_dir=str(base), datasets_dir=ds_dir, embed_enabled=False,
                              eval_enabled=True, eval_max_playlists=256)
            if side == "port":
                run_mining_job(MiningConfig(**cfg_kwargs), device="cpu")
            else:
                ref_run_mining_job(RefMiningConfig(native_cpu_pair_counts=False, **cfg_kwargs))
            pickles = os.path.join(str(base), "pickles")
            paths[side] = os.path.join(pickles, artifacts.QUALITY_REPORT_FILENAME)
            assert artifacts.QUALITY_REPORT_FILENAME in artifacts.load_manifest(pickles)["files"]
        with open(paths["port"], "rb") as a, open(paths["ref"], "rb") as b:
            assert a.read() == b.read()


# ---------------------------------------------------------------------------
# end to end: sweep → report → publication → the served blend weight
# ---------------------------------------------------------------------------


@pytest.fixture
def quality_pvc(tmp_path):
    """A PVC the port's job published with embed and eval on → (mining
    cfg, report)."""
    ds_dir = _pvc(tmp_path)
    cfg = MiningConfig(base_dir=str(tmp_path), datasets_dir=ds_dir, min_support=0.05,
                       embed_enabled=True, als_rank=12, als_iters=6, eval_enabled=True,
                       eval_max_playlists=256)
    run_mining_job(cfg, device="cpu")
    report = artifacts.load_quality_report(cfg.pickles_dir)
    assert report is not None and report["measured_blend_weight"] is not None
    return cfg, report


class TestMeasuredBlendServing:
    def _engine(self, base_dir, **overrides) -> RecommendEngine:
        engine = RecommendEngine(ServingConfig(base_dir=str(base_dir), pickle_dir="pickles/",
                                               **overrides), device="cpu")
        assert engine.load()
        return engine

    def test_measured_weight_served_end_to_end(self, tmp_path, quality_pvc):
        _cfg, report = quality_pvc
        w = report["measured_blend_weight"]
        measured = self._engine(tmp_path, hybrid_blend_measured=True)
        assert measured.measured_blend_weight == w and measured.blend_weight == w
        explicit = self._engine(tmp_path, hybrid_blend_weight=w)
        vocab = measured.bundle.vocab
        seed_sets = [[vocab[i], vocab[(i * 7 + 3) % len(vocab)]] for i in range(0, 60, 3)]
        assert measured.recommend_many(seed_sets) == explicit.recommend_many(seed_sets)
        # the reference's engine reads the port's report to the same weight
        ref = RefEngine(ref_cfg(str(tmp_path), hybrid_blend_measured=True))
        assert ref.load() and ref.blend_weight == w

    def test_explicit_float_wins_over_measured(self, tmp_path, quality_pvc):
        engine = self._engine(tmp_path, hybrid_blend_weight=0.9, hybrid_blend_measured=False)
        assert engine.measured_blend_weight is None and engine.blend_weight == 0.9

    def test_absent_report_fails_safe_to_default(self, tmp_path, quality_pvc):
        cfg, _ = quality_pvc
        assert artifacts.remove_quality_report(cfg.pickles_dir) is True
        engine = self._engine(tmp_path, hybrid_blend_measured=True)
        assert engine.measured_blend_weight is None
        assert engine.blend_weight == engine.cfg.hybrid_blend_weight

    def test_eval_disabled_publication_retires_report(self, tmp_path, quality_pvc):
        cfg, _ = quality_pvc
        run_mining_job(dataclasses.replace(cfg, eval_enabled=False), device="cpu")
        assert artifacts.load_quality_report(cfg.pickles_dir) is None
        assert artifacts.QUALITY_REPORT_FILENAME not in artifacts.load_manifest(
            cfg.pickles_dir)["files"]

    def test_malformed_report_fails_safe(self, tmp_path, quality_pvc):
        cfg, _ = quality_pvc
        artifacts.save_quality_report(cfg.pickles_dir,
                                      {"version": 1, "measured_blend_weight": "nope"})
        assert self._engine(tmp_path, hybrid_blend_measured=True).measured_blend_weight is None

    def test_blend_candidates_is_the_one_merge(self):
        """The harness ranks through the engine's merge, whose tie order
        (score desc, name asc) and endpoints are the reference's."""
        assert qeval.blend_candidates is engine_mod.blend_candidates
        cases = [([("b", 0.4), ("a", 0.4)], [("c", 0.4), ("a", 0.2)], 0.0, 3),
                 ([("b", 0.4), ("a", 0.4)], [("c", 0.4), ("a", 0.2)], 1.0, 3),
                 ([("x", 0.5)], [("y", 0.5)], 0.5, 2),
                 ([("p", 0.9), ("q", 0.1)], [("q", 0.8), ("r", 0.7)], 0.35, 2)]
        for rules, emb, w, k in cases:
            assert engine_mod.blend_candidates(rules, emb, w, k) == ref_blend_candidates(
                rules, emb, w, k)
        assert engine_mod.blend_candidates([("x", 0.5)], [("y", 0.5)], 0.5, 2) == ["x", "y"]

    def test_delta_and_compaction_keep_the_report(self, tmp_path):
        """A delta publication and a chain compaction leave the published
        report and its manifest entry as they were, as in the reference."""
        ds_dir = _pvc(tmp_path, clustered_baskets(n_clusters=4, cluster_size=16,
                                                  per_cluster=20, seed=5))
        cfg = MiningConfig(base_dir=str(tmp_path), datasets_dir=ds_dir, min_support=0.05,
                           embed_enabled=True, als_rank=8, als_iters=4, eval_enabled=True,
                           delta_enabled=True)
        run_mining_job(cfg, device="cpu")
        path = os.path.join(cfg.pickles_dir, artifacts.QUALITY_REPORT_FILENAME)
        with open(path, "rb") as fh:
            published = fh.read()
        digest = artifacts.load_manifest(cfg.pickles_dir)["files"][
            artifacts.QUALITY_REPORT_FILENAME]
        with open(os.path.join(ds_dir, DATASET), "a") as fh:
            fh.write("".join(f"{900 + p},Track {t:07d}\n" for p in range(3) for t in (1, 2, 3)))
        assert run_mining_job(cfg, device="cpu").delta_seq == 1
        assert lifecycle.compact_delta_chain(cfg).n_folded == 1
        with open(path, "rb") as fh:
            assert fh.read() == published
        manifest = artifacts.load_manifest(cfg.pickles_dir)
        assert manifest["files"][artifacts.QUALITY_REPORT_FILENAME] == digest
        assert artifacts.verify_files(cfg.pickles_dir, [artifacts.QUALITY_REPORT_FILENAME]) == []


# ---------------------------------------------------------------------------
# the staleness bound
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serving_pvc(tmp_path_factory):
    base = tmp_path_factory.mktemp("quality_serving")
    ds_dir = _pvc(base, clustered_baskets(n_clusters=4, cluster_size=16, per_cluster=20,
                                          seed=7))
    run_mining_job(MiningConfig(base_dir=str(base), datasets_dir=ds_dir, min_support=0.05),
                   device="cpu")
    return str(base)


class TestStalenessBound:
    def _app(self, base, **overrides) -> RecommendApp:
        app = RecommendApp(port_cfg(base, **overrides), device="cpu")
        assert app.engine.load()
        return app

    def test_stale_artifact_degrades_readyz_and_sets_gauge(self, serving_pvc):
        app = self._app(serving_pvc, artifact_max_age_s=1e-6)
        try:
            time.sleep(0.01)  # every artifact is now older than the bound
            assert any("artifacts stale" in r and "rules" in r for r in app.degraded_reasons())
            status, _h, body = app.handle("GET", "/readyz", None)
            payload = json.loads(body)
            assert status == 200 and payload["status"] == "degraded"
            assert any("stale" in r for r in payload["reasons"])
            _s, _h, text = app.handle("GET", "/metrics", None)
            for name in payload["artifact_age_seconds"]:
                assert f'kmls_artifact_stale{{artifact="{name}"}} 1' in text.decode(), name
        finally:
            app.close()

    def test_disabled_bound_stays_observational(self, serving_pvc):
        app = self._app(serving_pvc)  # artifact_max_age_s = 0, the default
        try:
            assert not any("stale" in r for r in app.degraded_reasons())
            _s, _h, text = app.handle("GET", "/metrics", None)
            assert 'kmls_artifact_stale{artifact="rules"} 0' in text.decode()
            _s, _h, body = app.handle("GET", "/readyz", None)
            assert json.loads(body)["status"] == "ready"
        finally:
            app.close()

    @pytest.mark.parametrize("bound", [0.0, 30.0, 1e-6])
    def test_reasons_and_flags_equal_the_references(self, serving_pvc, monkeypatch, bound):
        """One age snapshot: both apps name the same stale artifacts in the
        same words and render the same kmls_artifact_stale lines."""
        ages = {"rules": 45.25, "popularity": 12.0, "delta-chain": 45.25, "embeddings": 31.5}
        port = self._app(serving_pvc, artifact_max_age_s=bound)
        ref = RefApp(ref_cfg(serving_pvc, artifact_max_age_s=bound))
        try:
            assert ref.engine.load()
            for app in (port, ref):
                monkeypatch.setattr(app, "_artifact_ages", lambda: dict(ages))
            assert port.degraded_reasons() == ref.degraded_reasons()
            assert port._artifact_stale_flags(ages) == ref._artifact_stale_flags(ages)

            def stale_lines(app):
                _s, _h, text = app.handle("GET", "/metrics", None)
                return [ln for ln in text.decode().splitlines() if "kmls_artifact_stale" in ln]

            assert stale_lines(port) == stale_lines(ref)
            assert len(stale_lines(port)) == len(ages) + 1
        finally:
            port.close()


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------


def test_two_ranks_publish_the_one_rank_report(tmp_path):
    """The eval job on two gloo ranks of the CPU: every rank evaluates (its
    mine enters the all-reduce), rank 0 publishes, and the report's bytes
    are the one-rank job's."""
    from .test_torch_parallel import run_gloo_ranks
    from .test_torch_sharded_job import _JOB_RANK

    baskets = clustered_baskets(n_clusters=4, cluster_size=16, per_cluster=20, seed=6)
    env = dict(KMLS_EVAL_ENABLED="1", KMLS_EMBED_ENABLED="1", KMLS_ALS_RANK="8",
               KMLS_ALS_ITERS="4", KMLS_COUNT_PATH="bitpack")
    reports = {}
    for side in ("one", "two"):
        base = tmp_path / side
        ds_dir = _pvc(base, baskets)
        if side == "one":
            cfg = MiningConfig(base_dir=str(base), datasets_dir=ds_dir, embed_enabled=True,
                               als_rank=8, als_iters=4, eval_enabled=True, count_path="bitpack")
            run_mining_job(cfg, device="cpu")
        else:
            logs = run_gloo_ranks(2, _JOB_RANK, [], env=dict(
                KMLS_TORCH_DEVICE="cpu", BASE_DIR=str(base), DATASETS_DIR=ds_dir,
                KMLS_RANK_HEARTBEAT_S="0.5", **env))
            for log in logs:
                assert "Eval split:" in log and "sharded-bitpack-torch" in log, log
            assert "Rank 1: not the writer" in logs[1]
        with open(base / "pickles" / artifacts.QUALITY_REPORT_FILENAME, "rb") as fh:
            reports[side] = fh.read()
    assert reports["two"] == reports["one"]
    shutil.rmtree(tmp_path / "two" / "mining_checkpoint", ignore_errors=True)
