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
from kmlserver_tpu_torch.ops import embed as embed_ops
from kmlserver_tpu_torch.ops.embed import embed_topk, embed_topk_plain

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


class TestWrapper:
    """The entry point's checks and routes, on the CPU."""

    @pytest.mark.parametrize("seed,b,length,v,rank,k", [
        (0, 4, 3, 50, 4, 10), (1, 8, 8, 300, 8, 10), (2, 3, 2, 1, 4, 10),
    ])
    def test_cpu_tensors_take_the_plain_version(self, seed, b, length, v, rank, k):
        f = dyadic_factors(seed, v, rank, dups=max(v // 4, 1))
        seeds = random_seeds(seed, b, length, v)
        before = dict(embed_ops.LAUNCHES)
        got = ours(f, seeds, k)
        ids, sims = embed_topk_plain(torch.from_numpy(f), torch.from_numpy(seeds), k_best=k)
        assert np.array_equal(got[0], ids.numpy()) and np.array_equal(got[1], sims.numpy())
        want = reference(f, seeds, k)
        assert np.array_equal(ids.numpy(), want[0]) and np.array_equal(sims.numpy(), want[1])
        assert embed_ops.LAUNCHES == before

    @pytest.mark.parametrize("k,route", [
        (1, "fused"), (10, "fused"), (embed_ops.TOPK_CAPACITY, "fused"),
        (embed_ops.TOPK_CAPACITY + 1, "sort"), (10 * embed_ops.TOPK_CAPACITY, "sort"),
    ])
    def test_the_route_follows_k(self, k, route):
        assert embed_ops.topk_route(k) == route

    def test_the_capacity_is_at_least_64(self):
        assert embed_ops.TOPK_CAPACITY >= 64

    @pytest.mark.parametrize("what", ["float64 factors", "int64 seeds"])
    def test_raises_on_other_dtypes(self, what):
        f = torch.from_numpy(dyadic_factors(3, 20, 4, dups=2))
        seeds = torch.zeros((2, 3), dtype=torch.int32)
        if what == "float64 factors":
            f = f.double()
        else:
            seeds = seeds.long()
        with pytest.raises(TypeError):
            embed_topk(f, seeds, k_best=5)

    @pytest.mark.parametrize("what", ["factors", "seeds"])
    def test_raises_on_non_contiguous_input(self, what):
        f = torch.from_numpy(dyadic_factors(4, 20, 4, dups=2))
        seeds = torch.zeros((3, 2), dtype=torch.int32)
        if what == "factors":
            f = f.t().contiguous().t()
        else:
            seeds = seeds.t().contiguous().t()
        assert not (f.is_contiguous() and seeds.is_contiguous())
        with pytest.raises(ValueError, match="contiguous"):
            embed_topk(f, seeds, k_best=5)

    def test_raises_on_seeds_on_another_device(self):
        f = torch.from_numpy(dyadic_factors(5, 20, 4, dups=2))
        with pytest.raises(ValueError, match="seeds on"):
            embed_topk(f, torch.zeros((2, 3), dtype=torch.int32, device="meta"), k_best=5)

    @pytest.mark.parametrize("shape", [(5,), (2, 3, 4)])
    def test_raises_on_other_ranks_of_tensor(self, shape):
        f = torch.from_numpy(dyadic_factors(6, 20, 4, dups=2))
        with pytest.raises(ValueError):
            embed_topk(f, torch.zeros(shape, dtype=torch.int32), k_best=5)


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



# ---------------------------------------------------------------------------
# the kernel on the card, against the plain version on the same card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda")


def card_factors(seed: int, v: int, rank: int) -> np.ndarray:
    """Dyadic factors (every product and sum exact in fp32, in any order)
    with a quarter of the rows copied over others: equal scores are
    common, so the ids must agree tie order included."""
    rng = np.random.default_rng(seed)
    f = (rng.integers(-16, 17, (v, rank)) / 64.0).astype(np.float32)
    n = max(v // 4, 1)
    f[rng.integers(0, v, n)] = f[rng.integers(0, v, n)]
    return f


def card_seeds(seed: int, b: int, length: int, v: int) -> np.ndarray:
    """Three quarters of the slots padding, as a serving batch has; the last
    row all -1, the one before it one seed repeated, row 0 holding the
    first and the last item."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, v, (b, length)).astype(np.int32)
    seeds[rng.random((b, length)) < 0.75] = -1
    seeds[0, 0] = 0
    if length > 1:
        seeds[0, -1] = v - 1
    if b > 1:
        seeds[-1] = -1
    if b > 2:
        seeds[-2] = seeds[-2, 0] if seeds[-2, 0] >= 0 else 7 % v
    return seeds


def both_on_card(f: np.ndarray, seeds: np.ndarray, k: int, factors=None):
    """(kernel ids, kernel sims, plain ids, plain sims) on the card."""
    fd = torch.from_numpy(f).cuda() if factors is None else factors
    sd = torch.from_numpy(seeds).cuda()
    got = embed_topk(fd, sd, k_best=k)
    want = embed_topk_plain(fd, sd, k_best=k)
    torch.cuda.synchronize()
    out = [t.cpu().numpy() for t in (*got, *want)]
    assert out[0].dtype == np.int32 and out[1].dtype == np.float32
    assert out[0].shape == out[1].shape == (seeds.shape[0], k)
    return out


def assert_exact(out):
    gi, gs, wi, ws = out
    assert np.array_equal(gi, wi)
    assert np.array_equal(gs, ws)


@pytest.mark.cuda
class TestKernelOnTheCard:
    @pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32, 64])
    @pytest.mark.parametrize("length", [1, 8, 32, 128])
    def test_the_engines_grid_matches_the_plain_version_exactly(self, card, b, length):
        f = card_factors(b * 1000 + length, 2171, 32)
        assert_exact(both_on_card(f, card_seeds(b + length, b, length, 2171), 10))

    @pytest.mark.parametrize("v", [2171, 1 << 20, 1_000_003])
    @pytest.mark.parametrize("k", [1, 10, embed_ops.TOPK_CAPACITY, embed_ops.TOPK_CAPACITY + 1])
    def test_sizes_and_routes_match_the_plain_version_exactly(self, card, v, k):
        f = card_factors(v % 9973 + k, v, 32)
        before = dict(embed_ops.LAUNCHES)
        assert_exact(both_on_card(f, card_seeds(k, 8, 128, v), k))
        sort = int(embed_ops.topk_route(k) == "sort")
        assert embed_ops.LAUNCHES["embed_topk"] == before["embed_topk"] + 1
        assert embed_ops.LAUNCHES["embed_topk_sort_route"] == (
            before["embed_topk_sort_route"] + sort)

    @pytest.mark.parametrize("v,k", [(1, 10), (50, 100), (100, 300), (129, 128)])
    def test_k_above_the_valid_scores_pads(self, card, v, k):
        f = card_factors(v, v, 32)
        out = both_on_card(f, card_seeds(v, 6, 8, v), k)
        assert_exact(out)
        assert (out[0][-1] == -1).all() and (out[1][-1] == 0).all()  # the all -1 row

    @pytest.mark.parametrize("rank", [1, 3, 5, 16, 31, 48, 64, 100, 128])
    def test_other_ranks(self, card, rank):
        f = card_factors(rank, 3001, rank)
        assert_exact(both_on_card(f, card_seeds(rank, 8, 32, 3001), 10))

    def test_misaligned_factors_take_the_narrow_loads(self, card):
        f = card_factors(21, 5000, 32)
        flat = torch.empty(f.size + 1, dtype=torch.float32, device="cuda")
        factors = flat[1:].view(5000, 32)
        factors.copy_(torch.from_numpy(f))
        assert factors.is_contiguous() and factors.data_ptr() % 16 != 0
        assert_exact(both_on_card(f, card_seeds(21, 8, 32, 5000), 10, factors=factors))

    def test_every_score_tied(self, card):
        """All items share one row: every score ties, lowest index first."""
        f = np.tile(card_factors(22, 1, 32), (70_000, 1))
        out = both_on_card(f, card_seeds(22, 4, 8, 70_000), embed_ops.TOPK_CAPACITY)
        assert_exact(out)

    @pytest.mark.parametrize("seed", range(4))
    def test_unit_factors_agree_within_the_tolerance(self, card, seed):
        rng = np.random.default_rng(seed)
        f = rng.standard_normal((200_000, 32)).astype(np.float32)
        f /= np.linalg.norm(f, axis=1, keepdims=True)
        seeds = card_seeds(seed, 16, 32, len(f))
        gi, gs, wi, ws = both_on_card(f, seeds, 10)
        assert np.abs(gs - ws).max() <= embed_ops.SIM_TOL
        _, _, _, wide = both_on_card(f, seeds, 11)
        for r in range(len(seeds)):
            if not np.array_equal(gi[r], wi[r]):
                assert (-np.diff(wide[r]) <= NEAR_TIE).any(), f"row {r} differs without a near-tie"

    def test_the_plain_version_is_the_cpus(self, card):
        f = card_factors(23, 3001, 32)
        seeds = card_seeds(23, 8, 32, 3001)
        gi, gs, _, _ = both_on_card(f, seeds, 10)
        ci, cs = ours(f, seeds, 10)
        assert np.array_equal(gi, ci) and np.array_equal(gs, cs)

    def test_a_rank_above_the_kernels_raises(self, card):
        f = torch.zeros((10, embed_ops.MAX_RANK + 1), dtype=torch.float32, device="cuda")
        with pytest.raises(ValueError, match="rank"):
            embed_topk(f, torch.zeros((1, 1), dtype=torch.int32, device="cuda"), k_best=3)

    def test_a_kernel_plan(self, card):
        plan = embed_ops.kernel_plan(1 << 20, 32)
        assert plan["padded_rank"] == 32 and plan["capacity"] == embed_ops.TOPK_CAPACITY
        assert 1 <= plan["lists"] <= 1024 and plan["tile"] % 128 == 0
