"""The embedding lookup (``kmlserver_tpu_torch/ops/embed.py``), the
embedding artifact (``io/artifacts.py``) and the model objects
(``models/``), held against the JAX package on the CPU.

Parity bar for ``embed_topk``: on dyadic factors (entries that are
multiples of 1/64, so every dot product is exact in fp32 whatever the
summation order) with duplicate rows that force ties, the port's ids and
similarities equal the reference's exactly, tie order included (lowest
index first, as ``jax.lax.top_k``). On trained factors the similarities
agree within 1e-6 and the ids are equal except where two similarities lie
within 1e-6 of each other (a near-tie the two packages' sums may order
either way); the tests count those and check each is one. The artifact is
byte-compatible both ways: each package loads what the other saved, and
the same inputs save to the same bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmlserver_tpu.config import MiningConfig as RefMiningConfig
from kmlserver_tpu.io import artifacts as ref_artifacts
from kmlserver_tpu.mining import als as ref_als
from kmlserver_tpu.mining.miner import mine as ref_mine
from kmlserver_tpu.mining.vocab import build_baskets as ref_build_baskets
from kmlserver_tpu.models import EmbeddingModel as RefEmbeddingModel
from kmlserver_tpu.models import RuleModel as RefRuleModel
from kmlserver_tpu.ops.embed import embed_topk as ref_embed_topk
from kmlserver_tpu_torch import faults
from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.io import artifacts
from kmlserver_tpu_torch.mining import als
from kmlserver_tpu_torch.mining.vocab import build_baskets
from kmlserver_tpu_torch.models import EmbeddingModel, RuleModel
from kmlserver_tpu_torch.ops.embed import embed_topk

from .oracle import random_baskets
from .test_ops import table_from_baskets
from .test_torch_als import both_baskets, zipf_lists

SIM_TOL = 1e-6
NEAR_TIE = 1e-6


def dyadic_factors(seed: int, v: int, rank: int, dups: int) -> np.ndarray:
    """Factors on the 1/64 grid, with ``dups`` rows copied over others so
    equal similarities are common."""
    rng = np.random.default_rng(seed)
    f = (rng.integers(-16, 17, (v, rank)) / 64.0).astype(np.float32)
    for _ in range(dups):
        a, b = rng.integers(0, v, 2)
        f[b] = f[a]
    return f


def random_seeds(seed: int, b: int, length: int, v: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    seeds = rng.integers(-1, v, (b, length)).astype(np.int32)
    seeds[0] = -1  # a row with no valid seed
    if b > 1:
        seeds[1, 1:] = seeds[1, 0]  # one seed repeated
    return seeds


def ours(factors, seeds, k):
    ids, sims = embed_topk(torch.from_numpy(factors), torch.from_numpy(seeds), k_best=k)
    return ids.numpy(), sims.numpy()


def reference(factors, seeds, k):
    ids, sims = ref_embed_topk(jnp.asarray(factors), jnp.asarray(seeds), k_best=k)
    return np.asarray(ids), np.asarray(sims)


class TestEmbedTopk:
    @pytest.mark.parametrize("seed,b,length,v,rank,k", [
        (0, 1, 1, 5, 2, 3), (1, 4, 3, 50, 4, 10), (2, 8, 8, 300, 8, 10),
        (3, 32, 8, 2171 // 8, 32, 10), (4, 2, 4, 7, 3, 12), (5, 16, 1, 1000, 16, 25),
        (6, 5, 128, 200, 8, 10), (7, 3, 2, 1, 4, 10),
    ])
    def test_dyadic_factors_match_exactly_tie_order_included(self, seed, b, length, v, rank, k):
        f = dyadic_factors(seed, v, rank, dups=max(v // 4, 1))
        seeds = random_seeds(seed, b, length, v)
        got, want = ours(f, seeds, k), reference(f, seeds, k)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert got[0].dtype == np.int32 and got[1].dtype == np.float32

    @pytest.mark.parametrize("seed", range(6))
    def test_trained_factors_agree_except_at_near_ties(self, seed):
        bk, ref_bk = both_baskets(zipf_lists(seed, 200, 120))
        f = ref_als.train_embeddings(ref_bk, RefMiningConfig(als_rank=16, als_iters=6))[
            "item_factors"]
        seeds = random_seeds(seed, 16, 4, bk.n_tracks)
        (gi, gs), (wi, ws) = ours(f, seeds, 10), reference(f, seeds, 10)
        assert np.abs(gs - ws).max() <= SIM_TOL
        _, wide = reference(f, seeds, 11)
        for r in range(len(seeds)):
            if not np.array_equal(gi[r], wi[r]):
                gaps = -np.diff(wide[r])
                assert (gaps <= NEAR_TIE).any(), f"row {r} differs without a near-tie"

    def test_seeds_never_come_back_and_empty_rows_are_padding(self):
        f = dyadic_factors(9, 40, 4, dups=10)
        seeds = random_seeds(9, 6, 3, 40)
        ids, sims = ours(f, seeds, 40)
        for r, row in enumerate(seeds):
            assert not set(ids[r]) & {int(s) for s in row if s >= 0}
        assert (ids[0] == -1).all() and (sims[0] == 0).all()

    def test_tf32_is_off(self):
        """The products stay full fp32 (the default this module relies on)."""
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"


def _factors(v=6, rank=3):
    return np.eye(v, rank, dtype=np.float32) + 0.25


class TestArtifact:
    def test_round_trip(self, tmp_path, tiny_baskets):
        bk, _ = both_baskets(tiny_baskets)
        res = als.train_embeddings(bk, MiningConfig(als_rank=4, als_iters=4), device="cpu")
        path = str(tmp_path / "embeddings.npz")
        artifacts.save_embeddings(path, vocab=bk.vocab.names, item_factors=res["item_factors"],
                                  rank=4, iters=4, reg=0.1, final_loss=res["final_loss"])
        loaded = artifacts.load_embeddings(path)
        assert loaded["vocab"] == bk.vocab.names
        assert np.array_equal(loaded["item_factors"], res["item_factors"])
        assert (loaded["rank"], loaded["iters"], loaded["reg"]) == (4, 4, 0.1)

    @pytest.mark.parametrize("final_loss", [None, 12.5])
    def test_same_bytes_as_the_reference_and_loads_both_ways(self, tmp_path, final_loss):
        names = [f"n{i}" for i in range(6)]
        kw = dict(vocab=names, item_factors=_factors(), rank=3, iters=2, reg=0.1,
                  final_loss=final_loss)
        ours_path, ref_path = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
        artifacts.save_embeddings(ours_path, **kw)
        ref_artifacts.save_embeddings(ref_path, **kw)
        with open(ours_path, "rb") as a, open(ref_path, "rb") as b:
            assert a.read() == b.read()
        for loaded in (artifacts.load_embeddings(ref_path), ref_artifacts.load_embeddings(ours_path)):
            assert loaded["vocab"] == names
            assert np.array_equal(loaded["item_factors"], _factors())

    def test_save_rejects_shape_mismatch(self, tmp_path):
        with pytest.raises(ValueError):
            artifacts.save_embeddings(str(tmp_path / "e.npz"), vocab=["a", "b"],
                                      item_factors=np.zeros((3, 2), np.float32),
                                      rank=2, iters=1, reg=0.1)

    @pytest.mark.parametrize("factors,match", [
        (np.full((2, 2), np.nan, np.float32), "non-finite"),
        (np.zeros((2, 0), np.float32), "rank-0"),
    ])
    def test_load_rejects_bad_factors(self, tmp_path, factors, match):
        path = str(tmp_path / "e.npz")
        np.savez_compressed(path, version=np.int64(1), vocab=np.asarray(["a", "b"], dtype=object),
                            item_factors=factors)
        with pytest.raises(ValueError, match=match):
            artifacts.load_embeddings(path)

    @pytest.mark.parametrize("arrays,match", [
        ({"vocab": np.asarray(["a"], dtype=object)}, "not an embedding artifact"),
        ({"version": np.int64(2), "vocab": np.asarray(["a"], dtype=object),
          "item_factors": np.ones((1, 2), np.float32)}, "version 2"),
        ({"version": np.int64(1), "vocab": np.asarray(["a", "b", "c"], dtype=object),
          "item_factors": np.ones((2, 2), np.float32)}, "does not match"),
    ])
    def test_load_rejects_other_structures(self, tmp_path, arrays, match):
        path = str(tmp_path / "e.npz")
        np.savez_compressed(path, **arrays)
        with pytest.raises(ValueError, match=match):
            artifacts.load_embeddings(path)

    def test_load_rejects_torn_file(self, tmp_path):
        path = str(tmp_path / "e.npz")
        artifacts.save_embeddings(path, vocab=["a", "b"], item_factors=np.eye(2, dtype=np.float32),
                                  rank=2, iters=1, reg=0.1)
        faults.truncate_file(path, keep_fraction=0.4)
        with pytest.raises(Exception):
            artifacts.load_embeddings(path)

    def test_remove_embeddings(self, tmp_path):
        artifacts.save_embeddings(artifacts.embeddings_artifact_path(str(tmp_path)), vocab=["a"],
                                  item_factors=np.ones((1, 1), np.float32), rank=1, iters=1, reg=0.1)
        assert artifacts.remove_embeddings(str(tmp_path)) is True
        assert artifacts.remove_embeddings(str(tmp_path)) is False

    def test_quality_report_reader(self, tmp_path):
        assert artifacts.load_quality_report(str(tmp_path)) is None
        ref_artifacts.save_quality_report(str(tmp_path), {"measured_blend_weight": 0.25})
        assert artifacts.load_quality_report(str(tmp_path)) == (
            ref_artifacts.load_quality_report(str(tmp_path)))
        (tmp_path / artifacts.QUALITY_REPORT_FILENAME).write_text("[1, 2]")
        assert artifacts.load_quality_report(str(tmp_path)) is None


class TestEmbeddingModel:
    def test_fit_recommend_excludes_seeds(self, tiny_baskets):
        bk, _ = both_baskets(tiny_baskets)
        model = EmbeddingModel.fit(bk, MiningConfig(als_rank=4, als_iters=8), device="cpu")
        recs = model.recommend([["t0"]], k_best=3)[0]
        assert recs and "t0" not in recs

    def test_load_matches_fit(self, tmp_path, tiny_baskets):
        bk, _ = both_baskets(tiny_baskets)
        cfg = MiningConfig(als_rank=4, als_iters=8)
        res = als.train_embeddings(bk, cfg, device="cpu")
        path = str(tmp_path / "embeddings.npz")
        artifacts.save_embeddings(path, vocab=bk.vocab.names, item_factors=res["item_factors"],
                                  rank=4, iters=8, reg=0.1)
        fit = EmbeddingModel.fit(bk, cfg, device="cpu")
        loaded = EmbeddingModel.load(path, device="cpu")
        seeds = [["t0", "t2"], ["t3"]]
        assert fit.recommend(seeds) == loaded.recommend(seeds)

    def test_unknown_seeds_give_empty(self, tiny_baskets):
        bk, _ = both_baskets(tiny_baskets)
        model = EmbeddingModel.fit(bk, MiningConfig(als_rank=4, als_iters=4), device="cpu")
        assert model.recommend([["nope"]], k_best=3) == [[]]

    def test_fit_refuses_a_skipped_training(self, tiny_baskets):
        bk, _ = both_baskets(tiny_baskets)
        with pytest.raises(ValueError, match="skipped"):
            EmbeddingModel.fit(bk, MiningConfig(hbm_budget_bytes=16), device="cpu")

    @pytest.mark.parametrize("k", [1, 3, 10])
    def test_reference_artifact_gives_the_references_answers(self, tmp_path, k):
        """The reference's artifact of dyadic factors: the port's model and
        the reference's answer alike, tie order included."""
        names = [f"s{i:03d}" for i in range(40)]
        path = str(tmp_path / "embeddings.npz")
        ref_artifacts.save_embeddings(path, vocab=names, item_factors=dyadic_factors(3, 40, 4, 12),
                                      rank=4, iters=1, reg=0.1)
        port, ref = EmbeddingModel.load(path, device="cpu"), RefEmbeddingModel.load(path)
        seed_sets = [[names[0]], [names[3], names[9]], ["unknown"], names[10:17], []]
        assert port.recommend(seed_sets, k_best=k) == ref.recommend(seed_sets, k_best=k)
        assert np.array_equal(port.encode_seeds(seed_sets), ref.encode_seeds(seed_sets))

    def test_entry_points_default_to_cuda(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the no-card error cannot show")
        from kmlserver_tpu_torch.utils.device import DeviceUnavailableError

        path = str(tmp_path / "e.npz")
        artifacts.save_embeddings(path, vocab=["a"], item_factors=np.ones((1, 1), np.float32),
                                  rank=1, iters=1, reg=0.1)
        with pytest.raises(DeviceUnavailableError):
            EmbeddingModel.load(path)


class TestRuleModel:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_fit_load_recommend_match_the_reference(self, tmp_path, seed):
        rng = np.random.default_rng(seed)
        table = table_from_baskets(random_baskets(rng, n_playlists=50, n_tracks=16, mean_len=5))
        cfg_kw = dict(min_support=0.08, k_max_consequents=32)
        port = RuleModel.fit(build_baskets(table), MiningConfig(**cfg_kw), device="cpu")
        ref_result = ref_mine(ref_build_baskets(table),
                              RefMiningConfig(native_cpu_pair_counts=False, **cfg_kw))
        ref = RefRuleModel._from_tensors(ref_result.vocab_names, ref_result.tensors.rule_ids,
                                         ref_result.tensors.rule_confs, ref_result.tensors.mode)
        assert port.vocab == ref.vocab and port.mode == ref.mode
        seed_sets = [[v] for v in port.vocab[:6]] + [port.vocab[:3], ["nope"]]
        assert port.recommend(seed_sets, k_best=5) == ref.recommend(seed_sets, k_best=5)
        t = ref_result.tensors
        path = str(tmp_path / "m.npz")
        ref_artifacts.save_rule_tensors(
            path, vocab=ref_result.vocab_names, rule_ids=t.rule_ids,
            rule_counts=t.rule_counts, item_counts=t.item_counts,
            n_playlists=ref_result.n_playlists, min_support=cfg_kw["min_support"])
        loaded = RuleModel.load(path, device="cpu")
        assert loaded.recommend(seed_sets, k_best=5) == ref.recommend(seed_sets, k_best=5)

    def test_encode_seeds_drops_unknown_and_pads(self):
        model = RuleModel(vocab=["a", "b"], index={"a": 0, "b": 1},
                          rule_ids=None, rule_confs=None, mode="support")
        out = model.encode_seeds([["a", "zz", "b"], ["zz"]])
        assert out.tolist() == [[0, 1], [-1, -1]]


@pytest.mark.cuda
def test_embed_topk_on_the_card_matches_the_cpu():
    """On the card: dyadic factors give the CPU's ids and sims exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    f = dyadic_factors(11, 5000, 32, dups=1000)
    seeds = random_seeds(11, 32, 8, 5000)
    ids, sims = embed_topk(torch.from_numpy(f).cuda(), torch.from_numpy(seeds).cuda(), k_best=10)
    want = ours(f, seeds, 10)
    assert np.array_equal(ids.cpu().numpy(), want[0])
    assert np.array_equal(sims.cpu().numpy(), want[1])

