"""The embed phase's publication and hybrid rule ∪ embedding serving in
the port, held against the JAX package on the CPU — twin of the
reference's ``tests/test_embedding.py`` (pipeline publication, hybrid
serving, chaos) plus the parity bar of the two engines.

Parity bar (the two engines on one PVC): on a reference-published PVC
whose factors are dyadic (multiples of 1/64, so every similarity is exact
in fp32 in either package) every answer and source of the port's engine
equals the reference engine's, in the modes ``rules``, ``embed`` and
``blend``. On a PVC with trained factors, published by either package and
served by the other, the answers are equal except where two candidate
scores lie within 1e-6 of each other and decide the answer (a near-tie
the packages' sums may order either way); each difference must be one.
Both packages run their device paths (``native_serve=False``; the native
host lookup has its own tests, ``test_torch_native.py``).
"""

import dataclasses
import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from kmlserver_tpu.config import ServingConfig as RefServingConfig
from kmlserver_tpu.io import artifacts as ref_artifacts
from kmlserver_tpu.mining.pipeline import run_mining_job as ref_run_mining_job
from kmlserver_tpu.quality.lifecycle import manifest_filenames as ref_manifest_filenames
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu.serving.engine import blend_candidates as ref_blend_candidates
from kmlserver_tpu_torch import faults
from kmlserver_tpu_torch.config import ServingConfig
from kmlserver_tpu_torch.io import artifacts
from kmlserver_tpu_torch.mining.pipeline import run_mining_job
from kmlserver_tpu_torch.observability.costmodel import phase_cost
from kmlserver_tpu_torch.ops.embed import embed_topk
from kmlserver_tpu_torch.ops.serve import recommend_batch
from kmlserver_tpu_torch.serving.app import RecommendApp
from kmlserver_tpu_torch.serving.engine import RecommendEngine, blend_candidates

from .torch_chaos_util import (  # noqa: F401  (autouse fixture)
    clean_chaos_state,
    port_mining_cfg,
    port_serving_cfg,
    ref_mining_cfg,
    ref_serving_cfg,
    write_dataset,
)

NEAR_TIE = 1e-6
EMBED_KNOBS = dict(min_support=0.15, embed_enabled=True, als_rank=8, als_iters=4)


def mine_port(base: str, **knobs) -> object:
    """A 60-playlist PVC mined by the port on the CPU, with the embed phase
    (a good share of the tracks stays below min_support: the cold start)."""
    if not os.path.exists(os.path.join(base, "datasets")):
        write_dataset(base, seed=0, n_playlists=60, n_tracks=24)
    cfg = port_mining_cfg(base, **{**EMBED_KNOBS, **knobs})
    run_mining_job(cfg, device="cpu")
    return cfg


def mine_ref(base: str, **knobs) -> object:
    if not os.path.exists(os.path.join(base, "datasets")):
        write_dataset(base, seed=0, n_playlists=60, n_tracks=24)
    cfg = ref_mining_cfg(base, **{**EMBED_KNOBS, **knobs})
    ref_run_mining_job(cfg)
    return cfg


def port_engine(base: str, **knobs) -> RecommendEngine:
    engine = RecommendEngine(port_serving_cfg(base, **knobs), device="cpu")
    assert engine.load()
    return engine


def ref_engine(base: str, **knobs) -> RefEngine:
    engine = RefEngine(ref_serving_cfg(base, **knobs))
    assert engine.load()
    return engine


def port_app(base: str, **knobs) -> RecommendApp:
    app = RecommendApp(port_serving_cfg(base, **knobs), device="cpu")
    assert app.engine.load()
    return app


def cold_and_hot(engine) -> tuple[str, str]:
    """→ (a seed with no rule row but an embedding row, a rule-known seed)."""
    bundle = engine.bundle
    known = {bundle.vocab[i] for i in range(len(bundle.vocab)) if bundle.known_mask[i]}
    cold = [n for n in bundle.emb_vocab if n not in known]
    assert cold, "the PVC must leave some tracks below min_support"
    return cold[0], sorted(known)[0]


def seed_sets(engine) -> list[list[str]]:
    """Hot, cold, mixed, repeated, unknown and over-long seed sets."""
    bundle = engine.bundle
    names = list(bundle.emb_vocab)
    known = [n for n, k in zip(bundle.vocab, bundle.known_mask) if k]
    cold = [n for n in names if n not in set(known)]
    rng = np.random.default_rng(4)
    sets = [[n] for n in names] + [known[:2], cold[:2], [known[0], cold[0]],
                                   [cold[1], cold[1]], ["nope"], ["nope", cold[0]], names]
    sets += [list(rng.choice(names, 3, replace=False)) for _ in range(30)]
    return sets


def answers(engine, sets) -> list:
    out = []
    for i in range(0, len(sets), 8):
        out += [(list(s), src) for s, src in engine.recommend_many_async(sets[i:i + 8])()]
    return out


def dyadic_pvc(base: str) -> str:
    """A reference-published PVC whose embeddings.npz holds dyadic factors
    (duplicate rows included), re-manifested by the reference's writer."""
    cfg = mine_ref(base)
    pickles = cfg.pickles_dir
    loaded = ref_artifacts.load_embeddings(artifacts.embeddings_artifact_path(pickles))
    rng = np.random.default_rng(7)
    v = len(loaded["vocab"])
    f = (rng.integers(-16, 17, (v, 8)) / 64.0).astype(np.float32)
    f[1::4] = f[0::4][: len(f[1::4])]
    ref_artifacts.save_embeddings(artifacts.embeddings_artifact_path(pickles),
                                  vocab=loaded["vocab"], item_factors=f, rank=8, iters=4, reg=0.1)
    token = ref_artifacts.load_manifest(pickles)["token"]
    ref_artifacts.write_manifest(pickles, ref_manifest_filenames(cfg), token=token)
    return base


def decisive_near_tie(engine: RecommendEngine, seeds: list[str]) -> bool:
    """The port engine's answer for ``seeds`` rests on two candidate scores
    within NEAR_TIE: the embedding top-(k+1) or the blended union."""
    bundle = engine.bundle
    k, cap = engine.cfg.k_best_tracks, engine.cfg.max_seed_tracks
    emb = [bundle.emb_index[s] for s in seeds if s in (bundle.emb_index or {})][:cap]
    if bundle.emb_factors is None or not emb:
        return False
    ids, sims = embed_topk(bundle.emb_factors, torch.tensor([emb], dtype=torch.int32),
                           k_best=k + 1)
    live = sims[0][ids[0] >= 0].tolist()
    if any(a - b <= NEAR_TIE for a, b in zip(live, live[1:])):
        return True
    rule = [bundle.index[s] for s in seeds
            if s in bundle.index and bundle.known_mask[bundle.index[s]]][:cap]
    if not rule or engine.cfg.hybrid_mode != "blend":
        return False
    r_ids, r_confs = recommend_batch(bundle.rule_ids, bundle.rule_confs,
                                     torch.tensor([rule], dtype=torch.int32), k_best=k)
    w = engine.blend_weight
    scores: dict = {}
    for i, c in zip(r_ids[0].tolist(), r_confs[0].tolist()):
        if i >= 0:
            scores[bundle.vocab[i]] = (1.0 - w) * c
    for i, s in zip(ids[0][:k].tolist(), sims[0][:k].tolist()):
        if i >= 0:
            scores[bundle.emb_vocab[i]] = scores.get(bundle.emb_vocab[i], 0.0) + w * s
    ranked = sorted(scores.values(), reverse=True)[: k + 1]
    return any(a - b <= NEAR_TIE for a, b in zip(ranked, ranked[1:]))


@pytest.fixture(scope="module")
def port_pvc(tmp_path_factory) -> str:
    base = str(tmp_path_factory.mktemp("port_embed_pvc"))
    mine_port(base)
    return base


@pytest.fixture(scope="module")
def ref_pvc(tmp_path_factory) -> str:
    base = str(tmp_path_factory.mktemp("ref_embed_pvc"))
    mine_ref(base)
    return base


@pytest.fixture(scope="module")
def dyadic(tmp_path_factory) -> str:
    return dyadic_pvc(str(tmp_path_factory.mktemp("dyadic_pvc")))


def copy_pvc(src: str, dst) -> str:
    dst = str(dst / "pvc")
    shutil.copytree(src, dst)
    return dst


class TestPipelinePublication:
    def test_embed_phase_publishes_manifested_artifact(self, tmp_path):
        cfg = port_mining_cfg(str(tmp_path), **EMBED_KNOBS)
        write_dataset(str(tmp_path), seed=0, n_playlists=60, n_tracks=24)
        summary = run_mining_job(cfg, device="cpu")
        assert summary.als_train_s is not None and summary.als_train_s > 0
        emb_path = summary.artifact_paths["embeddings"]
        assert os.path.basename(emb_path) == artifacts.EMBEDDINGS_FILENAME
        entry = artifacts.load_manifest(cfg.pickles_dir)["files"][artifacts.EMBEDDINGS_FILENAME]
        assert entry == artifacts.file_digest(emb_path)
        assert artifacts.load_embeddings(emb_path)["rank"] == cfg.als_rank

    def test_port_job_matches_the_reference_job(self, port_pvc, ref_pvc):
        """Same CSV, same knobs: the same rule artifacts, the embedding
        vocabulary, and factors within the parity bar."""
        ours = artifacts.load_embeddings(artifacts.embeddings_artifact_path(
            os.path.join(port_pvc, "pickles")))
        theirs = ref_artifacts.load_embeddings(artifacts.embeddings_artifact_path(
            os.path.join(ref_pvc, "pickles")))
        assert ours["vocab"] == theirs["vocab"]
        assert (ours["rank"], ours["iters"], ours["reg"]) == (theirs["rank"], theirs["iters"],
                                                              theirs["reg"])
        assert np.abs(ours["item_factors"] - theirs["item_factors"]).max() <= 1e-4
        for name in ("recommendations.pickle", "best_tracks.pickle"):
            assert artifacts.load_pickle(os.path.join(port_pvc, "pickles", name)) == (
                ref_artifacts.load_pickle(os.path.join(ref_pvc, "pickles", name)))
        manifest = artifacts.load_manifest(os.path.join(port_pvc, "pickles"))
        ref_manifest = ref_artifacts.load_manifest(os.path.join(ref_pvc, "pickles"))
        assert set(manifest["files"]) == set(ref_manifest["files"])

    def test_disabled_run_retires_stale_embeddings(self, tmp_path):
        cfg = mine_port(str(tmp_path))
        emb_path = artifacts.embeddings_artifact_path(cfg.pickles_dir)
        assert os.path.exists(emb_path)
        summary = run_mining_job(dataclasses.replace(cfg, embed_enabled=False), device="cpu")
        assert summary.als_train_s is None
        assert not os.path.exists(emb_path)
        assert artifacts.EMBEDDINGS_FILENAME not in artifacts.load_manifest(cfg.pickles_dir)["files"]

    def test_hbm_guard_publishes_rules_only_generation(self, tmp_path, capsys):
        cfg = mine_port(str(tmp_path), hbm_budget_bytes=16)
        out = capsys.readouterr().out
        assert "ALS embed phase skipped:" in out
        assert not os.path.exists(artifacts.embeddings_artifact_path(cfg.pickles_dir))
        engine = port_engine(str(tmp_path))
        assert not engine.embedding_active and not engine.embedding_degraded

    @pytest.mark.parametrize("mode,budget,storage", [
        ("always", 12 * (1 << 30), "sparse"),
        ("never", 12 * (1 << 30), "dense"),
        ("never", 200_000, None),
        ("auto", 200_000, "sparse"),
        ("always", 100_000, None),
        ("sparsely", 12 * (1 << 30), "dense"),
    ])
    def test_als_sparse_knob_matches_the_reference_job(self, tmp_path, mode, budget, storage,
                                                       caplog):
        """At 400 playlists x 300 tracks (dense ≈ 645 kB, sparse ≈ 126 kB of
        planned device bytes) the job's storage — read from its embed cost
        attribution — and its published artifact set equal the reference
        job's at each setting; a typo resolves to auto with a warning."""
        knobs = dict(als_sparse=mode, hbm_budget_bytes=budget)
        for side in ("port", "ref"):
            write_dataset(str(tmp_path / side), seed=1, n_playlists=400, n_tracks=300)
        with caplog.at_level(logging.WARNING):
            cfg = mine_port(str(tmp_path / "port"), **knobs)
        ref_cfg = mine_ref(str(tmp_path / "ref"), **knobs)
        assert ("is not one of" in caplog.text) == (mode == "sparsely")

        def prom(pickles):
            with open(os.path.join(pickles, "job_metrics.prom")) as fh:
                return {k: float(v) for k, _, v in (
                    line.rpartition(" ") for line in fh if line.strip() and line[0] != "#")}

        ours, theirs = prom(cfg.pickles_dir), prom(ref_cfg.pickles_dir)
        key = 'kmls_job_phase_flops{phase="embed"}'
        emb = os.path.exists(artifacts.embeddings_artifact_path(cfg.pickles_dir))
        assert emb == (storage is not None) == os.path.exists(
            artifacts.embeddings_artifact_path(ref_cfg.pickles_dir))
        if storage is None:
            assert ours.get(key) is None and theirs.get(key) is None
            return
        v = len(artifacts.load_embeddings(
            artifacts.embeddings_artifact_path(cfg.pickles_dir))["vocab"])
        dense, _ = phase_cost("als_sweep", p=400, v=v, r=8, iters=4)
        assert (ours[key] == dense) == (storage == "dense")
        if storage == "dense":
            assert ours[key] == theirs[key]
        else:
            # the port counts a segment sum of the 0/1 matrix as one add per
            # event and column (costmodel's als_sweep_sparse), the reference
            # a multiply-add: the same job, its nnz read from the reference's
            # 4 · (4·nnz·r + 2·r²·(p + v) + 2·r³)
            nnz = (theirs[key] / 4 - 2 * 64 * (400 + v) - 2 * 512) / (4 * 8)
            assert nnz == int(nnz) > 0
            sparse, _ = phase_cost("als_sweep_sparse", nnz=nnz, p=400, v=v, r=8, iters=4)
            assert ours[key] == sparse

    def test_crash_after_embed_resumes_bit_identical(self, tmp_path, port_pvc):
        cfg = port_mining_cfg(str(tmp_path), **EMBED_KNOBS)
        write_dataset(str(tmp_path), seed=0, n_playlists=60, n_tracks=24)
        faults.inject("mine.crash.embed", times=1)
        with pytest.raises(faults.FaultInjected):
            run_mining_job(cfg, device="cpu")
        faults.clear()
        summary = run_mining_job(cfg, device="cpu")
        assert summary.resumed_phases == ("encode", "mine", "rules", "embed")
        manifest = artifacts.load_manifest(cfg.pickles_dir)["files"]
        want = artifacts.load_manifest(os.path.join(port_pvc, "pickles"))["files"]
        assert manifest[artifacts.EMBEDDINGS_FILENAME] == want[artifacts.EMBEDDINGS_FILENAME]
        assert manifest == want


class TestHybridServing:
    def test_cold_start_seed_answers_from_embeddings(self, port_pvc):
        engine = port_engine(port_pvc)
        cold, _hot = cold_and_hot(engine)
        songs, source = engine.recommend([cold])
        assert source == "embed" and songs and cold not in songs

    def test_hot_seed_blends_and_zero_compiles(self, port_pvc):
        app = port_app(port_pvc)
        try:
            _cold, hot = cold_and_hot(app.engine)
            songs, source = app.engine.recommend([hot])
            assert source == "hybrid" and songs
            body = json.dumps({"songs": [hot]}).encode()
            status, headers, payload = app.handle("POST", "/api/recommend/", body)
            assert status == 200 and json.loads(payload)["songs"] == songs
            assert "X-KMLS-Cache" not in headers
            status, headers, payload = app.handle("POST", "/api/recommend/", body)
            assert status == 200 and headers.get("X-KMLS-Cache") == "hit"
            assert "X-KMLS-Degraded" not in headers
            assert app.engine.unwarmed_dispatches == 0
        finally:
            app.close()

    def test_mode_rules_reproduces_legacy_answers(self, port_pvc, tmp_path):
        """``rules`` on a PVC with embeddings answers what the engine answers
        on the same PVC without them."""
        rules = port_engine(port_pvc, hybrid_mode="rules")
        assert not rules.embedding_active
        legacy_pvc = copy_pvc(port_pvc, tmp_path)
        os.unlink(artifacts.embeddings_artifact_path(os.path.join(legacy_pvc, "pickles")))
        legacy = port_engine(legacy_pvc, verify_manifest=False)
        sets = seed_sets(port_engine(port_pvc))
        assert answers(rules, sets) == answers(legacy, sets)
        assert {src for _, src in answers(rules, sets)} <= {"rules", "fallback", "empty"}

    def test_mode_embed_serves_embedding_topk(self, port_pvc):
        engine = port_engine(port_pvc, hybrid_mode="embed")
        _cold, hot = cold_and_hot(engine)
        songs, source = engine.recommend([hot])
        assert source == "embed" and songs

    @pytest.mark.parametrize("value", [None, "", "rules", "embed", "blend", "BLEND", " Embed ",
                                       "rule", "hybrid"])
    def test_hybrid_mode_env_parses_like_the_reference(self, monkeypatch, value, caplog):
        monkeypatch.delenv("KMLS_HYBRID_MODE", raising=False)
        if value is not None:
            monkeypatch.setenv("KMLS_HYBRID_MODE", value)
        with caplog.at_level(logging.WARNING):
            got = ServingConfig.from_env(dotenv_path=None).hybrid_mode
        assert got == RefServingConfig.from_env(dotenv_path=None).hybrid_mode
        assert ("serving rules-only" in caplog.text) == (value in ("rule", "hybrid"))

    @pytest.mark.parametrize("value", [None, "", "0.25", "1", "measured", " MEASURED ", "abc"])
    def test_blend_weight_env_parses_like_the_reference(self, monkeypatch, value):
        monkeypatch.delenv("KMLS_HYBRID_BLEND_WEIGHT", raising=False)
        if value is not None:
            monkeypatch.setenv("KMLS_HYBRID_BLEND_WEIGHT", value)
        got = ServingConfig.from_env(dotenv_path=None)
        want = RefServingConfig.from_env(dotenv_path=None)
        assert (got.hybrid_blend_weight, got.hybrid_blend_measured) == (
            want.hybrid_blend_weight, want.hybrid_blend_measured)

    def test_blend_weight_bounds(self, port_pvc):
        """w = 1 ranks like embed-only."""
        _cold, hot = cold_and_hot(port_engine(port_pvc))
        w1 = port_engine(port_pvc, hybrid_blend_weight=1.0)
        embed_only = port_engine(port_pvc, hybrid_mode="embed")
        assert w1.recommend([hot])[0] == embed_only.recommend([hot])[0]

    @pytest.mark.parametrize("seed", range(5))
    def test_blend_candidates_is_the_references(self, seed):
        rng = np.random.default_rng(seed)
        names = [f"n{i}" for i in range(12)]
        rule = [(str(n), float(c)) for n, c in zip(rng.choice(names, 6, replace=False),
                                                   rng.integers(0, 4, 6) / 4)]
        emb = [(str(n), float(c)) for n, c in zip(rng.choice(names, 6, replace=False),
                                                  rng.integers(-4, 5, 6) / 4)]
        for w in (-0.5, 0.0, 0.3, 0.5, 1.0, 2.0):
            for k in (1, 5, 20):
                assert blend_candidates(rule, emb, w, k) == ref_blend_candidates(rule, emb, w, k)

    def test_identity_across_replicas(self, port_pvc):
        engine = port_engine(port_pvc, serve_devices=2)
        assert engine.n_replicas >= 2
        cold, hot = cold_and_hot(engine)
        for seeds in ([hot], [cold], [hot, cold]):
            got = {tuple(r) for replica in range(engine.n_replicas)
                   for r, _src in engine.recommend_many_async([seeds], replica=replica)()}
            assert len(got) == 1, f"replicas disagree on {seeds}"
        assert engine.unwarmed_dispatches == 0

    def test_identity_across_cache_epochs(self, tmp_path):
        cfg = mine_port(str(tmp_path))
        app = port_app(str(tmp_path))
        try:
            cold, hot = cold_and_hot(app.engine)
            before = {s: app.recommend_direct([s])[0] for s in (hot, cold)}
            epoch = app.engine.bundle_epoch
            run_mining_job(cfg, device="cpu")
            assert app.engine.load()
            assert app.engine.bundle_epoch == epoch + 1
            for seed, songs in before.items():
                recs, _source, cached = app.recommend_direct([seed])
                assert not cached and recs == songs
        finally:
            app.close()

    @pytest.mark.parametrize("report,want", [
        ({"measured_blend_weight": 0.25}, 0.25), ({"measured_blend_weight": 1.5}, 0.5),
        ({"other": 1}, 0.5), (None, 0.5),
    ])
    def test_measured_blend_weight(self, port_pvc, tmp_path, report, want):
        """``measured`` serves the published optimum; no usable report
        serves the configured weight, like the reference's engine."""
        pvc = copy_pvc(port_pvc, tmp_path)
        if report is not None:
            ref_artifacts.save_quality_report(os.path.join(pvc, "pickles"), report)
        engine = port_engine(pvc, hybrid_blend_measured=True)
        ref = ref_engine(pvc, hybrid_blend_measured=True)
        assert engine.blend_weight == ref.blend_weight == want
        _cold, hot = cold_and_hot(engine)
        assert engine.recommend([hot])[0] == port_engine(pvc, hybrid_blend_weight=want).recommend(
            [hot])[0]

    def test_metrics_and_sources(self, port_pvc):
        app = port_app(port_pvc)
        try:
            cold, hot = cold_and_hot(app.engine)
            for seeds in ([cold], [hot], ["nope"]):
                status, _h, _p = app.handle("POST", "/api/recommend/",
                                            json.dumps({"songs": seeds}).encode())
                assert status == 200
            _s, _h, body = app.handle("GET", "/metrics", None)
            text = body.decode()
            for line in ("kmls_embedding_active 1", "kmls_embedding_load_failures_total 0",
                         "kmls_hybrid_blend_weight 0.5",
                         'kmls_requests_by_source{source="embed"} 1',
                         'kmls_requests_by_source{source="hybrid"} 1',
                         'kmls_requests_by_source{source="fallback"} 1',
                         'kmls_compiles_total{kernel="embed_topk"} 0'):
                assert line in text.splitlines(), line
            assert 'kmls_kernel_device_seconds{kernel="embed_topk"}' in text
            assert 'kmls_model_tensor_bytes{artifact="embeddings"}' in text
            status, _h, body = app.handle("GET", "/readyz", None)
            assert status == 200 and "embeddings" in json.loads(body)["artifact_age_seconds"]
        finally:
            app.close()


class TestReferenceParity:
    @pytest.mark.parametrize("mode,weight", [("rules", 0.5), ("embed", 0.5), ("blend", 0.5),
                                             ("blend", 0.0), ("blend", 0.3), ("blend", 1.0)])
    def test_dyadic_pvc_every_answer_and_source_equal(self, dyadic, mode, weight):
        knobs = dict(hybrid_mode=mode, hybrid_blend_weight=weight)
        ours, theirs = port_engine(dyadic, **knobs), ref_engine(dyadic, **knobs)
        assert ours.embedding_active == theirs.embedding_active == (mode != "rules")
        sets = seed_sets(port_engine(dyadic))
        got = answers(ours, sets)
        want = [(list(s), src) for s, src in theirs.recommend_many(sets)]
        assert got == want
        assert [ours.recommend(s) for s in sets[:20]] == [theirs.recommend(s) for s in sets[:20]]
        sources = {src for _, src in got}
        assert sources >= ({"rules"} if mode == "rules" else {"embed"})

    @pytest.mark.parametrize("publisher", ["reference", "port"])
    @pytest.mark.parametrize("mode", ["rules", "embed", "blend"])
    def test_trained_pvc_equal_except_near_ties(self, port_pvc, ref_pvc, publisher, mode):
        """Either package's publication, served by both engines."""
        pvc = ref_pvc if publisher == "reference" else port_pvc
        ours, theirs = port_engine(pvc, hybrid_mode=mode), ref_engine(pvc, hybrid_mode=mode)
        sets = seed_sets(port_engine(pvc))
        got = answers(ours, sets)
        want = [(list(s), src) for s, src in theirs.recommend_many(sets)]
        ties = 0
        for seeds, a, b in zip(sets, got, want):
            assert a[1] == b[1], seeds
            if a[0] != b[0]:
                assert decisive_near_tie(ours, seeds), f"{seeds}: {a} != {b} without a near-tie"
                ties += 1
        assert ties <= len(sets) // 10


@pytest.mark.chaos
class TestEmbeddingChaos:
    """A bad embeddings.npz costs answer quality (rules only), never the
    reload and never a 5xx — in both packages alike."""

    def _request(self, app, seeds):
        return app.handle("POST", "/api/recommend/", json.dumps({"songs": seeds}).encode())

    def test_torn_artifact_degrades_to_rules_only(self, port_pvc, tmp_path):
        pvc = copy_pvc(port_pvc, tmp_path)
        faults.truncate_file(artifacts.embeddings_artifact_path(os.path.join(pvc, "pickles")),
                             keep_fraction=0.5)
        app = port_app(pvc, verify_manifest=False)
        ref = ref_engine(pvc, verify_manifest=False)
        try:
            engine = app.engine
            assert not engine.embedding_active and engine.embedding_degraded
            assert engine.embedding_load_failures == 1 == ref.embedding_load_failures
            bundle = engine.bundle
            known = {bundle.vocab[i] for i in range(len(bundle.vocab)) if bundle.known_mask[i]}
            hot = sorted(known)[0]
            cold = next(n for n in bundle.vocab if n not in known)
            status, headers, _ = self._request(app, [hot])
            assert status == 200 and "X-KMLS-Degraded" not in headers
            status, _h, payload = self._request(app, [cold])
            assert status == 200
            assert json.loads(payload)["songs"] == ref.recommend([cold])[0]
            status, _h, body = app.handle("GET", "/readyz", None)
            assert status == 200
            assert "embedding artifact unusable" in str(json.loads(body))
            _s, _h, metrics = app.handle("GET", "/metrics", None)
            assert "kmls_embedding_load_failures_total 1" in metrics.decode().splitlines()
        finally:
            app.close()

    def test_fault_knob_arms_rules_only_degradation(self, tmp_path, monkeypatch):
        cfg = mine_port(str(tmp_path))
        monkeypatch.setenv("KMLS_FAULT_EMBED_CORRUPT", "1")
        faults.load_env(force=True)
        engine = port_engine(str(tmp_path))
        assert not engine.embedding_active and engine.embedding_load_failures == 1
        run_mining_job(cfg, device="cpu")
        assert engine.load()
        assert engine.embedding_active and not engine.embedding_degraded

    def test_checksum_mismatch_skips_embeddings_not_reload(self, port_pvc, tmp_path):
        pvc = copy_pvc(port_pvc, tmp_path)
        faults.flip_byte(artifacts.embeddings_artifact_path(os.path.join(pvc, "pickles")))
        engine = port_engine(pvc)
        ref = ref_engine(pvc)
        assert engine.finished_loading and not engine.embedding_active
        assert engine.embedding_degraded and ref.embedding_degraded
        assert "fails its manifest checksum" in engine.last_embedding_error

    def test_vanished_artifact_mid_load_is_absent_not_degraded(self, port_pvc, monkeypatch):
        def vanish(path, **kwargs):
            raise FileNotFoundError(path)

        monkeypatch.setattr(artifacts, "load_embeddings", vanish)
        engine = port_engine(port_pvc)
        assert engine.finished_loading and not engine.embedding_active
        assert not engine.embedding_degraded and engine.embedding_load_failures == 0

    def test_all_unknown_seeds_skip_the_embed_dispatch(self, port_pvc):
        engine = port_engine(port_pvc)
        assert engine.embedding_active
        assert engine._dispatch_embed(engine.bundle, [["definitely-not-a-track"]], 1, 1) is None
        assert engine.recommend(["definitely-not-a-track"])[1] == "fallback"

    def test_absent_artifact_is_not_degraded(self, tmp_path):
        mine_port(str(tmp_path), embed_enabled=False)
        app = port_app(str(tmp_path))
        try:
            assert not app.engine.embedding_active
            assert app.engine.embedding_load_failures == 0 and not app.engine.embedding_degraded
            status, _h, body = app.handle("GET", "/readyz", None)
            assert status == 200 and json.loads(body)["status"] == "ready"
        finally:
            app.close()


@pytest.mark.cuda
def test_card_engine_matches_the_cpu_engine(port_pvc):
    """On the card: every hybrid answer equals the CPU engine's, except at
    near-ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    cpu = port_engine(port_pvc)
    card = RecommendEngine(port_serving_cfg(port_pvc), device="cuda")
    assert card.load() and card.embedding_active
    sets = seed_sets(cpu)
    for seeds, a, b in zip(sets, answers(card, sets), answers(cpu, sets)):
        assert a[1] == b[1]
        assert a[0] == b[0] or decisive_near_tie(cpu, seeds)
