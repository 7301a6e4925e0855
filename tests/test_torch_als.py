"""The port's ALS trainer (``kmlserver_tpu_torch/mining/als.py``) and its
deterministic segment sum (``ops/segsum.py``), held against the JAX
package's ``mining/als.py`` on the CPU.

Mirrors the reference's ``tests/test_embedding.py::TestTrainer`` and adds
the parity bar: the port's plain run against the JAX ``train_embeddings``
(``JAX_PLATFORMS=cpu``) on the same baskets and seed, dense and sparse —
normalized factors within 1e-4, final loss within 1e-5 relative (the two
packages sum the products and reductions in other orders, and every sweep
carries the difference on through its solve). The storage decision, the
skip messages, the byte formulas and the knob validation are the
reference's exactly. The default-config checkpoint fingerprint is pinned
to the string the package gave before the embed fields became real
config fields. The segment-sum kernel itself runs only on the card
(``cuda`` marker); on the CPU its plain version is held against numpy's
sequential ``np.add.at``, bit for bit.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from kmlserver_tpu.config import MiningConfig as RefMiningConfig
from kmlserver_tpu.mining import als as ref_als
from kmlserver_tpu.mining.vocab import Baskets as RefBaskets
from kmlserver_tpu.mining.vocab import Vocab as RefVocab
from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.mining import als
from kmlserver_tpu_torch.mining import checkpoint as ckpt_mod
from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
from kmlserver_tpu_torch.ops import segsum
from kmlserver_tpu_torch.parallel import collectives
from kmlserver_tpu_torch.parallel.mesh import RankMesh

FACTOR_TOL = 1e-4
LOSS_RTOL = 1e-5

# one gloo rank of the sharded-layout case: trains on a 1x2 mesh
_SHARDED_RANK = r"""
import os, sys

import numpy as np

rank, world, port, work = sys.argv[1:5]
os.environ.update(KMLS_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", KMLS_NUM_PROCESSES=world,
                  KMLS_PROCESS_ID=rank)
from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.mining import als
from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
from kmlserver_tpu_torch.parallel.distributed import maybe_initialize, shutdown
from kmlserver_tpu_torch.parallel.mesh import make_mesh

assert maybe_initialize(device="cpu", timeout_s=120)
case = np.load(os.path.join(work, "in.npz"))
names = [str(n) for n in case["names"]]
bk = Baskets(playlist_rows=case["rows"], track_ids=case["ids"], n_playlists=int(case["p"]),
             vocab=Vocab(names=names, index={n: i for i, n in enumerate(names)}))
cfg = MiningConfig(als_rank=4, als_iters=2, model_layout="sharded")
res = als.train_embeddings(bk, cfg, mesh=make_mesh("1x2"), device="cpu")
np.savez(os.path.join(work, f"rank{rank}.npz"), factors=res["item_factors"],
         shards=res["shards"], loss=res["final_loss"])
shutdown()
"""


def _pairs(lists: list[list[str]]):
    names = sorted({t for basket in lists for t in basket})
    index = {n: i for i, n in enumerate(names)}
    rows, ids = [], []
    for p, basket in enumerate(lists):
        for t in sorted(set(basket)):
            rows.append(p)
            ids.append(index[t])
    return names, np.asarray(rows, np.int32), np.asarray(ids, np.int32), len(lists)


def both_baskets(lists: list[list[str]]) -> tuple[Baskets, RefBaskets]:
    """The same transaction DB as the port's and the reference's Baskets."""
    names, rows, ids, p = _pairs(lists)
    index = {n: i for i, n in enumerate(names)}
    return (
        Baskets(playlist_rows=rows, track_ids=ids, n_playlists=p,
                vocab=Vocab(names=names, index=index)),
        RefBaskets(playlist_rows=rows, track_ids=ids, n_playlists=p,
                   vocab=RefVocab(names=names, index=index)),
    )


def zipf_lists(seed: int, n_playlists: int, n_tracks: int, mean_len: int = 8) -> list:
    """Skewed baskets whose long tail holds tracks with identical columns."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_playlists):
        picks = rng.zipf(1.3, mean_len)
        out.append([f"t{int(t) - 1:04d}" for t in picks if t <= n_tracks] or ["t0000"])
    return out


def train(bk, **knobs):
    return als.train_embeddings(bk, MiningConfig(**knobs), device="cpu")


class TestTrainer:
    def test_deterministic_and_normalized(self, tiny_baskets):
        bk, _ = both_baskets(tiny_baskets)
        a = train(bk, als_rank=4, als_iters=6, als_reg=0.05)
        b = train(bk, als_rank=4, als_iters=6, als_reg=0.05)
        assert np.array_equal(a["item_factors"], b["item_factors"])
        assert a["item_factors"].shape == (bk.n_tracks, 4)
        assert a["item_factors"].dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(a["item_factors"], axis=1), 1.0, atol=1e-5)

    def test_cooccurrence_shapes_similarity(self, tiny_baskets):
        """(t0, t1) co-occur in 3 of 5 playlists, (t0, t3) in 1."""
        bk, _ = both_baskets(tiny_baskets)
        f = train(bk, als_rank=4, als_iters=10, als_reg=0.05)["item_factors"]
        idx = bk.vocab.index
        sim = f @ f.T
        assert sim[idx["t0"], idx["t1"]] > sim[idx["t0"], idx["t3"]]

    def test_hyperparameters_change_factors(self, tiny_baskets):
        bk, _ = both_baskets(tiny_baskets)
        a = train(bk, als_rank=4, als_iters=4)
        b = train(bk, als_rank=4, als_iters=8)
        assert not np.array_equal(a["item_factors"], b["item_factors"])

    def test_normalize_factors_guards_zero_rows(self):
        out = als.normalize_factors(np.zeros((2, 3), dtype=np.float32))
        assert np.isfinite(out).all()
        rows = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
        assert np.array_equal(als.normalize_factors(rows), ref_als.normalize_factors(rows))

    def test_hbm_guard_skips_training_deterministically(self, tiny_baskets):
        bk, ref_bk = both_baskets(tiny_baskets)
        res = train(bk, als_rank=4, als_iters=2, hbm_budget_bytes=16)
        want = ref_als.train_embeddings(
            ref_bk, RefMiningConfig(als_rank=4, als_iters=2, hbm_budget_bytes=16))
        assert res["item_factors"] is None
        assert "exceeds hbm_budget_bytes" in res["skipped"]
        assert res == want

    def test_payload_is_host_objects(self, tiny_baskets):
        bk, _ = both_baskets(tiny_baskets)
        res = train(bk, als_rank=4, als_iters=2)
        assert isinstance(res["item_factors"], np.ndarray)
        assert not [k for k, v in res.items() if isinstance(v, torch.Tensor)]
        assert isinstance(res["final_loss"], float)


PARITY_CASES = [
    # (seed, playlists, tracks, rank, iters, reg)
    (0, 40, 30, 8, 4, 0.1),
    (1, 120, 80, 16, 8, 0.1),
    (2, 300, 150, 32, 8, 0.1),
    (3, 200, 64, 7, 5, 0.5),
    (4, 60, 200, 4, 3, 0.01),
]


class TestParityWithReference:
    @pytest.mark.parametrize("storage", ["never", "always"])
    @pytest.mark.parametrize("seed,p,v,rank,iters,reg", PARITY_CASES)
    def test_factors_and_loss_match_the_reference(self, storage, seed, p, v, rank, iters, reg):
        """Port plain run vs JAX ``train_embeddings``, same baskets and seed:
        normalized factors within 1e-4, final loss within 1e-5 relative."""
        bk, ref_bk = both_baskets(zipf_lists(seed, p, v))
        knobs = dict(als_rank=rank, als_iters=iters, als_reg=reg, als_sparse=storage)
        got = train(bk, **knobs)
        want = ref_als.train_embeddings(ref_bk, RefMiningConfig(**knobs))
        assert got["storage"] == want["storage"] == ("sparse" if storage == "always" else "dense")
        assert got["nnz"] == want["nnz"] and got["rank"] == want["rank"]
        assert np.abs(got["item_factors"] - want["item_factors"]).max() <= FACTOR_TOL
        assert abs(got["final_loss"] - want["final_loss"]) <= LOSS_RTOL * abs(want["final_loss"])

    @pytest.mark.parametrize("seed", [0, 1])
    def test_same_host_init_as_the_reference(self, seed, monkeypatch):
        """Both packages start from the same factors: the reference's host
        draw (users, then items), its float64 quotient rounded to float32."""
        bk, ref_bk = both_baskets(zipf_lists(seed, 50, 40))
        seen = {}
        real = als._train_dense

        def spy(baskets, user_init, item_init, *rest):
            seen["user"], seen["item"] = user_init, item_init
            return real(baskets, user_init, item_init, *rest)

        monkeypatch.setattr(als, "_train_dense", spy)
        als.train_embeddings(bk, MiningConfig(als_rank=8, als_iters=1), seed=seed, device="cpu")
        rng = np.random.default_rng(seed)
        user = np.asarray(rng.standard_normal((bk.n_playlists, 8)).astype(np.float32)
                          / np.sqrt(8), dtype=np.float32)
        item = np.asarray(rng.standard_normal((bk.n_tracks, 8)).astype(np.float32)
                          / np.sqrt(8), dtype=np.float32)
        assert np.array_equal(seen["user"], user) and np.array_equal(seen["item"], item)
        assert seen["user"].dtype == np.float32


class TestStorageDecision:
    @pytest.mark.parametrize("mode", ["auto", "always", "never", "Always ", "sparse-please", ""])
    @pytest.mark.parametrize("budget", [16, 9000, 40_000, 12 * (1 << 30)])
    def test_decision_and_skip_message_match_the_reference(self, mode, budget):
        bk, ref_bk = both_baskets(zipf_lists(5, 30, 20))
        knobs = dict(als_rank=4, als_iters=2, als_sparse=mode, hbm_budget_bytes=budget)
        got = train(bk, **knobs)
        want = ref_als.train_embeddings(ref_bk, RefMiningConfig(**knobs))
        assert got["storage"] == want["storage"]
        assert got.get("skipped") == want.get("skipped")

    @pytest.mark.parametrize("nnz,p,v,rank", [
        (0, 1, 1, 1), (1, 1, 1, 32), (255, 10, 10, 8), (257, 10, 10, 8),
        (70_000, 5_000, 3_000, 32), (50_000_000, 1_000_000, 1_000_000, 32),
    ])
    def test_byte_formulas_match_the_reference(self, nnz, p, v, rank):
        assert als._als_chunk(nnz) == ref_als._als_chunk(nnz)
        assert als.sparse_als_bytes(nnz, p, v, rank) == ref_als.sparse_als_bytes(nnz, p, v, rank)

    @pytest.mark.parametrize("value,want", [
        ("auto", "auto"), ("always", "always"), ("never", "never"), (" NEVER ", "never"),
        (None, "auto"), ("", "auto"), ("sometimes", "auto"),
    ])
    def test_knob_validation(self, value, want, caplog):
        with caplog.at_level(logging.WARNING):
            assert als.resolve_als_sparse(value) == want == ref_als.resolve_als_sparse(value)
        assert ("is not one of" in caplog.text) == (value == "sometimes")

    @pytest.mark.parametrize("budget,storage", [(1_000_000, "sparse"), (100_000, "none"),
                                                (12 * (1 << 30), "dense")])
    def test_auto_goes_sparse_where_dense_busts_the_budget(self, budget, storage):
        """2,000 playlists x 1,000 tracks: dense ≈ 10 MB, sparse ≈ 0.8 MB of
        planned bytes; the reference decides and trains alike."""
        bk, ref_bk = both_baskets(zipf_lists(8, 2000, 1000))
        knobs = dict(als_rank=8, als_iters=2, hbm_budget_bytes=budget)
        got = train(bk, **knobs)
        want = ref_als.train_embeddings(ref_bk, RefMiningConfig(**knobs))
        assert got["storage"] == want["storage"] == storage
        if storage != "none":
            assert np.abs(got["item_factors"] - want["item_factors"]).max() <= FACTOR_TOL

    def test_scale_shape_picks_sparse(self):
        """At phase 5's scale shape dense is ≈ 5·10¹² B, over the 12 GiB
        budget, and sparse ≈ 0.92 GB fits: ``auto`` trains sparse."""
        p = v = 1_000_000
        nnz, rank = 50_000_000, 32
        budget = MiningConfig().hbm_budget_bytes
        assert 5 * p * v + 8 * rank * (p + v) > budget
        assert als.sparse_als_bytes(nnz, p, v, rank) <= budget < 5 * p * v

    def test_sharded_layout_trains_on_two_gloo_ranks(self, tiny_baskets, tmp_path):
        """Where the reference shards the item axis, two gloo ranks of the
        CPU train the vocab-sharded sweep: ``shards == 2``, the same factors
        on both ranks, within the reference's layout bar of one device's."""
        from .test_torch_parallel import run_gloo_ranks

        bk, _ = both_baskets(tiny_baskets)
        np.savez(tmp_path / "in.npz", rows=bk.playlist_rows, ids=bk.track_ids,
                 p=bk.n_playlists, names=np.asarray(bk.vocab.names))
        run_gloo_ranks(2, _SHARDED_RANK, [str(tmp_path)], env=dict(OMP_NUM_THREADS="1"))
        plain = train(bk, als_rank=4, als_iters=2)
        got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
        assert [int(g["shards"]) for g in got] == [2, 2]
        np.testing.assert_array_equal(got[0]["factors"], got[1]["factors"])
        np.testing.assert_allclose(got[0]["factors"], plain["item_factors"],
                                   rtol=2e-4, atol=2e-5)
        assert float(got[0]["loss"]) == pytest.approx(plain["final_loss"], rel=1e-4)

    @pytest.mark.parametrize("chunk_elems", [1, 7 * 13, 64 * 13 + 5])
    def test_sharded_loss_over_row_chunks(self, chunk_elems, monkeypatch):
        """The sharded loss builds each block's residual in row chunks: the
        same value as the whole residual's (up to float order), the same
        bits from one call to the next, and the reference's loss."""
        rng = np.random.default_rng(5)
        p, v, r, tp = 90, 26, 4, 2
        x = (rng.random((p, v)) < 0.2).astype(np.float32)
        user = rng.standard_normal((p, r)).astype(np.float32)
        items = rng.standard_normal((v, r)).astype(np.float32)
        reg = torch.tensor(0.1)
        blocks = [torch.from_numpy(x[:, t * 13:(t + 1) * 13]) for t in range(tp)]
        item_blocks = [torch.from_numpy(items[t * 13:(t + 1) * 13]) for t in range(tp)]
        user_f = torch.from_numpy(user)

        def loss():
            return als._sharded_loss(blocks, user_f, item_blocks, reg,
                                     collectives.add_in_order)

        whole = loss()
        monkeypatch.setattr(als, "_LOSS_CHUNK_ELEMS", chunk_elems)
        chunked = loss()
        assert chunked == loss()
        assert chunked == pytest.approx(whole, rel=1e-6)
        want = float(ref_als._als_loss(x, user, items, 0.1))
        assert chunked == pytest.approx(want, rel=1e-5)

    @pytest.mark.parametrize("layout,budget,want", [
        ("replicated", 1, 1), ("sharded", 1 << 40, 2), ("auto", 1 << 40, 1), ("auto", 1, 2),
    ])
    def test_shard_count_matches_the_reference_rule(self, layout, budget, want):
        mesh = RankMesh(grid=((0, 1),))
        cfg = MiningConfig(model_layout=layout, hbm_budget_bytes=budget)
        assert als._als_shards(cfg, mesh, 100, 100, 8) == want
        assert als._als_shards(cfg, None, 100, 100, 8) == 1


class TestSegsumPlain:
    @pytest.mark.parametrize("rank", [1, 7, 32, 64])
    @pytest.mark.parametrize("n_out,n_in,nnz", [(1, 1, 0), (5, 9, 40), (300, 200, 20_000)])
    def test_plain_is_the_sequential_sum(self, rank, n_out, n_in, nnz):
        """``index_add_`` on the CPU adds in event order: bit-equal to numpy's
        unbuffered ``np.add.at``, also with magnitudes that make order show."""
        rng = np.random.default_rng(rank + nnz)
        seg = rng.integers(0, n_out, nnz)
        gidx = rng.integers(0, n_in, nnz)
        mat = (rng.standard_normal((n_in, rank))
               * 10.0 ** rng.integers(-6, 6, (n_in, 1))).astype(np.float32)
        want = np.zeros((n_out, rank), np.float32)
        np.add.at(want, seg, mat[gidx])
        got = segsum.segment_sum_plain(torch.from_numpy(mat), torch.from_numpy(seg),
                                       torch.from_numpy(gidx), n_out)
        assert np.array_equal(got.numpy(), want)

    @pytest.mark.parametrize("rank", [1, 7, 32, 64])
    def test_csr_order_gives_the_same_bits(self, rank, monkeypatch):
        """The wrapper's CSR (a stable sort) keeps each row's events in their
        original order: the same bits as the original order, chunked or not,
        with empty rows zero."""
        monkeypatch.setattr(segsum, "PLAIN_CHUNK", 97)
        rng = np.random.default_rng(rank)
        n_out, n_in, nnz = 60, 40, 5_000
        seg = rng.integers(0, n_out, nnz)
        seg[seg == 7] = 8  # an empty row
        seg[: nnz // 4] = 3  # a heavy one
        gidx = rng.integers(0, n_in, nnz)
        mat = (rng.standard_normal((n_in, rank))
               * 10.0 ** rng.integers(-5, 5, (n_in, 1))).astype(np.float32)
        want = np.zeros((n_out, rank), np.float32)
        np.add.at(want, seg, mat[gidx])
        csr = segsum.build_csr(torch.from_numpy(seg), torch.from_numpy(gidx), n_out, n_in)
        assert csr.n_out == n_out and csr.nnz == nnz and csr.gidx.dtype == torch.int32
        got = segsum.segment_sum(torch.from_numpy(mat), csr)
        assert np.array_equal(got.numpy(), want)
        assert not got[7].any()
        assert torch.equal(csr.segments(), torch.from_numpy(np.sort(seg, kind="stable")))

    def test_matches_the_references_accumulate(self):
        """The reference's chunked XLA scatter-add over the padded stream,
        against the port's segment sum of the same events."""
        import jax.numpy as jnp

        rng = np.random.default_rng(9)
        n_out, n_in, nnz, rank = 50, 30, 3_000, 8
        seg = rng.integers(0, n_out, nnz).astype(np.int32)
        gidx = rng.integers(0, n_in, nnz).astype(np.int32)
        mat = rng.standard_normal((n_in, rank)).astype(np.float32)
        chunk = ref_als._als_chunk(nnz)
        pad = (-nnz) % chunk
        want = ref_als._sparse_accumulate(
            jnp.asarray(np.concatenate([seg, np.full(pad, n_out, np.int32)])),
            jnp.asarray(np.concatenate([gidx, np.full(pad, n_in, np.int32)])),
            jnp.asarray(mat), n_out, chunk)
        csr = segsum.build_csr(torch.from_numpy(seg), torch.from_numpy(gidx), n_out, n_in)
        got = segsum.segment_sum(torch.from_numpy(mat), csr).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("seg,gidx", [([0, 3], [0, 0]), ([0, -1], [0, 0]),
                                          ([0, 1], [0, 5]), ([0, 1], [-2, 0])])
    def test_build_csr_refuses_ids_out_of_range(self, seg, gidx):
        with pytest.raises(ValueError, match="outside"):
            segsum.build_csr(torch.tensor(seg), torch.tensor(gidx), 3, 5)

    def test_wrapper_checks_its_inputs(self):
        csr = segsum.build_csr(torch.tensor([0, 1]), torch.tensor([1, 0]), 2, 2)
        with pytest.raises(ValueError, match="must be"):
            segsum.segment_sum(torch.zeros(3, 4), csr)
        with pytest.raises(TypeError, match="float32"):
            segsum.segment_sum(torch.zeros(2, 4, dtype=torch.float64), csr)
        assert segsum.LAUNCHES == {"segsum": segsum.LAUNCHES["segsum"]}


DEFAULT_FINGERPRINT = "e09ccf3f7dd779155209d09ce3978b8eeceabc0fbf13e68b07f3497d568c27b6"


class TestCheckpointIdentity:
    def _dataset(self, tmp_path) -> str:
        path = tmp_path / "2023_spotify_ds1.csv"
        path.write_text("pid,track_name\n0,a\n0,b\n1,a\n")
        return str(path)

    def test_default_config_fingerprint_is_pinned(self, tmp_path):
        """The embed and ALS fields joined the config at the reference's
        defaults: the identity at the default config is the string the
        package gave before, so existing checkpoints stay valid."""
        cfg = MiningConfig(base_dir=str(tmp_path), datasets_dir=str(tmp_path))
        assert ckpt_mod.compute_fingerprint(cfg, self._dataset(tmp_path), 1) == DEFAULT_FINGERPRINT

    @pytest.mark.parametrize("field,value", [
        ("embed_enabled", True), ("als_rank", 16), ("als_iters", 4), ("als_reg", 0.5),
        ("als_sparse", "always"),
    ])
    def test_embed_fields_change_the_identity(self, tmp_path, field, value):
        cfg = MiningConfig(base_dir=str(tmp_path), datasets_dir=str(tmp_path))
        path = self._dataset(tmp_path)
        other = dataclasses.replace(cfg, **{field: value})
        assert ckpt_mod.fingerprint_identity(other, path, 1)[field] == value
        assert ckpt_mod.compute_fingerprint(other, path, 1) != DEFAULT_FINGERPRINT

    def test_run_phases_gain_embed_when_enabled(self):
        assert ckpt_mod.run_phases(MiningConfig()) == ("encode", "mine", "rules")
        assert ckpt_mod.run_phases(MiningConfig(embed_enabled=True)) == (
            "encode", "mine", "rules", "embed")


class TestConfigKnobs:
    ENV = ("KMLS_EMBED_ENABLED", "KMLS_ALS_RANK", "KMLS_ALS_ITERS", "KMLS_ALS_REG",
           "KMLS_ALS_SPARSE")

    @pytest.mark.parametrize("values", [
        {}, {"KMLS_EMBED_ENABLED": "1", "KMLS_ALS_RANK": "16", "KMLS_ALS_ITERS": "3",
             "KMLS_ALS_REG": "0.25", "KMLS_ALS_SPARSE": "always"},
        {"KMLS_EMBED_ENABLED": "yes", "KMLS_ALS_SPARSE": "typo"},
    ])
    def test_mining_knobs_parse_like_the_reference(self, monkeypatch, values):
        for name in self.ENV:
            monkeypatch.delenv(name, raising=False)
        for name, value in values.items():
            monkeypatch.setenv(name, value)
        ref = RefMiningConfig.from_env(dotenv_path=None)
        got = MiningConfig.from_env(dotenv_path=None)
        for field in ("embed_enabled", "als_rank", "als_iters", "als_reg", "als_sparse"):
            assert getattr(got, field) == getattr(ref, field), field


@pytest.mark.cuda
class TestSegsumKernel:
    """On the card: the CUDA kernel against its plain version, bit for bit."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (runs on the GPU machine)")

    @pytest.mark.parametrize("rank", [1, 7, 32, 64])
    @pytest.mark.parametrize("n_out,n_in,nnz", [(1, 1, 0), (50, 40, 3_000), (2_000, 900, 300_000)])
    def test_kernel_matches_plain_bit_for_bit(self, rank, n_out, n_in, nnz):
        rng = np.random.default_rng(rank * 7 + nnz)
        seg = rng.integers(0, n_out, nnz)
        seg[: nnz // 3] = 0  # a heavy row
        if n_out > 4:
            seg[seg == 2] = 3  # an empty row
        gidx = rng.integers(0, n_in, nnz)
        mat = (rng.standard_normal((n_in, rank))
               * 10.0 ** rng.integers(-4, 4, (n_in, 1))).astype(np.float32)
        want = segsum.segment_sum_plain(torch.from_numpy(mat), torch.from_numpy(seg),
                                        torch.from_numpy(gidx), n_out)
        csr = segsum.build_csr(torch.from_numpy(seg).cuda(), torch.from_numpy(gidx).cuda(),
                               n_out, n_in)
        before = segsum.LAUNCHES["segsum"]
        a = segsum.segment_sum(torch.from_numpy(mat).cuda(), csr)
        b = segsum.segment_sum(torch.from_numpy(mat).cuda(), csr)
        torch.cuda.synchronize()
        assert segsum.LAUNCHES["segsum"] == before + 2
        assert torch.equal(a.cpu(), want) and torch.equal(a, b)

    def test_sparse_training_is_bit_identical_run_to_run(self):
        bk, _ = both_baskets(zipf_lists(3, 400, 300))
        cfg = MiningConfig(als_sparse="always", als_rank=32, als_iters=4)
        a = als.train_embeddings(bk, cfg, device="cuda")
        b = als.train_embeddings(bk, cfg, device="cuda")
        cpu = als.train_embeddings(bk, cfg, device="cpu")
        assert np.array_equal(a["item_factors"], b["item_factors"])
        assert np.abs(a["item_factors"] - cpu["item_factors"]).max() <= FACTOR_TOL
