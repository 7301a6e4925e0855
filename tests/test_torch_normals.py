"""The ALS init's standard normals on the card (``kmlserver_tpu_torch/ops/
normals.py``, ``ops/csrc/normals.cu``) against numpy's own draw.

On the CPU: the plain versions — numpy's raw PCG64 stream through the
ziggurat over the module's tables, the chain walked whole or chunk by chunk
between barriers as the kernels walk it — equal
``default_rng(seed).standard_normal`` bit for bit; a window too short for
the chain's longest attempt declines; the kernel source's constants are the
module's; the training's init falls back to the host draw where the card's
declines or differs; the loss gathered in groups of chunks equals the
float64 loss, and so does the training's loss over the playlist CSR
(``Σ_r u_r·(X F)_r``), which gives the gather form's bits where every sum
is exact and one more segment sum a training. On the card (``cuda``
marker): ``init_rows`` equals the host draw bit for bit, at config 4's size
too, in two launches; a sparse training's loss repeats bit for bit with
``2·iters + 1`` segsum launches.
"""

import hashlib
import base64
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.mining import als
from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
from kmlserver_tpu_torch.ops import normals, segsum

# the ALS tests' bar on a final loss (``tests/test_torch_als.py``)
LOSS_RTOL = 1e-5
SEEDS = [0, 7, 3141592653, 2**33 + 5]
CU = Path(normals.__file__).resolve().parent / "csrc" / "normals.cu"


def _host_init(seed, p, v, rank):
    rng = np.random.default_rng(seed)
    user, item = np.empty((p, rank), np.float32), np.empty((v, rank), np.float32)
    als._draw_init(rng, user)
    als._draw_init(rng, item)
    return user, item


def test_tables_are_numpys():
    raw = base64.b64decode("".join(normals._TABLES_B64))
    assert hashlib.sha256(raw).hexdigest() == (
        "e3811c133c6e61093d15d9a7c4dc37d055d79937a0084872fdde0905da48cd1c")
    ki, wi, fi = normals.tables()
    assert ki.dtype == np.uint64 and wi.shape == fi.shape == ki.shape == (256,)
    assert int(ki[0]) == 0x000EF33D8025EF6A and int(ki[1]) == 0 and fi[0] == 1.0
    assert wi[0] == 8.68362706080130616677e-16
    assert (np.diff(fi) < 0).all() and int(ki.max()) < 1 << 52


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_chain_is_numpys_draw(seed):
    want = np.random.default_rng(seed).standard_normal(200_000)
    assert np.array_equal(normals.standard_normal_plain(seed, 200_000), want)


@pytest.mark.parametrize("chunk", [1, 7, 64, normals.CHUNK])
@pytest.mark.parametrize("seed", SEEDS[1:3])
def test_chunked_walk_is_numpys_draw(seed, chunk):
    n = 30_000
    got = normals.standard_normal_plain(seed, n, chunk=chunk)
    assert np.array_equal(got, np.random.default_rng(seed).standard_normal(n))


def test_a_window_shorter_than_a_tail_declines():
    # a tail reads at least 3 raws: with a window of 2 a walk cannot trust it
    with pytest.raises(ValueError, match="longer than the window"):
        normals.standard_normal_plain(5, 200_000, chunk=64, window=2)


def test_barrier_is_never_jumped_over():
    raws = np.random.PCG64(3).random_raw(60_000)
    used, _, _ = normals.attempts_plain(raws, 50_000)
    chain = set(normals.chain_plain(used, 50_000).tolist())
    for lo in range(0, 49_000, 97):
        s = normals.barrier_plain(used, lo, normals.WINDOW)
        assert s >= lo and s in chain


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_pcg64_step_is_numpys(seed):
    state, inc = normals.pcg64_start(seed)
    want = [int(x) for x in np.random.PCG64(seed).random_raw(16)]
    assert normals.pcg64_raw_plain(state, inc, 16) == want


def test_kernel_constants_are_the_modules():
    src = CU.read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([-0-9a-fA-Fx.p+]+?)(?:ULL)?;", src).group(1)

    assert (int(const("kMultHi"), 16) << 64) | int(const("kMultLo"), 16) == normals.MULT
    assert float.fromhex(const("kNegNorInvR")) == normals.NEG_NOR_INV_R
    assert normals.NOR_R == 3.6541528853610087963519472518
    assert normals.NEG_NOR_INV_R == -0.27366123732975827203338247596


@pytest.mark.parametrize("rank", [1, 8, 32])
def test_round_rows_is_the_inits(rank):
    values = np.random.default_rng(rank).standard_normal((50, rank))
    want = (values.astype(np.float32) / np.sqrt(rank)).astype(np.float32)
    assert np.array_equal(normals.round_rows(values, rank), want)
    assert normals.divides_in_float64(rank) is (np.lib.NumpyVersion(np.__version__) >= "2.0.0")


def _fake_card(monkeypatch, corrupt):
    def init_rows(seed, rows, rank, device):
        if corrupt is None:
            return None
        user, item = _host_init(seed, rows[0], rows[1], rank)
        user[0, 0] += corrupt
        return torch.from_numpy(user), torch.from_numpy(item)

    monkeypatch.setattr(normals, "init_rows", init_rows)


@pytest.mark.parametrize("corrupt", [None, 1.0])
def test_card_init_falls_back_to_the_host_draw(monkeypatch, caplog, corrupt):
    _fake_card(monkeypatch, corrupt)
    user, item = als._card_init(21, 100, 30, 8, torch.device("cpu"))
    want_user, want_item = _host_init(21, 100, 30, 8)
    assert np.array_equal(user.numpy(), want_user) and np.array_equal(item.numpy(), want_item)
    assert ("differs from numpy's draw" in caplog.text) == (corrupt is not None)


def test_card_init_keeps_a_draw_that_agrees(monkeypatch):
    _fake_card(monkeypatch, 0.0)
    user, item = als._card_init(21, 100, 30, 8, torch.device("cpu"))
    want_user, want_item = _host_init(21, 100, 30, 8)
    assert np.array_equal(user.numpy(), want_user) and np.array_equal(item.numpy(), want_item)


@pytest.mark.parametrize("group", [1, 3, 64])
def test_grouped_loss_is_the_float64_loss(monkeypatch, group):
    monkeypatch.setattr(als, "_SPARSE_CHUNK", 256)  # 256-event chunks at this size
    monkeypatch.setattr(als, "_LOSS_GROUP_CHUNKS", group)
    g = np.random.default_rng(4)
    p, v, r = 300, 120, 8
    pairs = np.unique(g.integers(0, p * v, 5_000))
    rows, cols = torch.as_tensor(pairs // v), torch.as_tensor(pairs % v)
    user = torch.as_tensor(g.standard_normal((p, r)), dtype=torch.float32)
    item = torch.as_tensor(g.standard_normal((v, r)), dtype=torch.float32)
    reg = torch.tensor(0.1)
    got = float(als._sparse_als_loss(rows, cols, user, item, reg))
    x = torch.zeros((p, v), dtype=torch.float64)
    x[rows, cols] = 1.0
    u64, f64 = user.double(), item.double()
    want = float(((x - u64 @ f64.T) ** 2).sum() + 0.1 * ((u64 ** 2).sum() + (f64 ** 2).sum()))
    assert abs(got - want) <= 1e-5 * abs(want)


# (playlists, tracks, rank, event density): one playlist empty and one with
# every track in each; an empty matrix; more playlists than one chunk of the
# cross term's row sums (65,536)
LOSS_SHAPES = [(300, 120, 8, 0.1), (700, 3_000, 32, 0.01), (20, 10, 4, 0.0),
               (70_001, 50, 3, 0.05)]


def _loss_case(shape, seed: int, dyadic: bool = False):
    """Shuffled distinct events and float32 factors (multiples of 1/8 in
    [-1, 1] where ``dyadic``: every sum of the loss's cross term exact)."""
    p, v, r, density = shape
    g = np.random.default_rng(seed)
    x = g.random((p, v)) < density
    if density:
        x[min(3, p - 1)] = True  # a heavy playlist
        x[1] = False  # an empty one
    rows, cols = np.nonzero(x)
    order = g.permutation(rows.shape[0])
    rows, cols = torch.as_tensor(rows[order]), torch.as_tensor(cols[order])
    if dyadic:
        user, item = (torch.as_tensor(g.integers(-8, 9, (n, r)) / 8, dtype=torch.float32)
                      for n in (p, v))
    else:
        user, item = (torch.as_tensor(g.standard_normal((n, r)), dtype=torch.float32)
                      for n in (p, v))
    return rows, cols, user, item


def _loss64(rows, cols, user, item, reg: float) -> float:
    x = torch.zeros((user.shape[0], item.shape[0]), dtype=torch.float64)
    x[rows, cols] = 1.0
    u64, f64 = user.double(), item.double()
    return float(((x - u64 @ f64.T) ** 2).sum() + reg * ((u64 ** 2).sum() + (f64 ** 2).sum()))


@pytest.mark.parametrize("shape", LOSS_SHAPES)
def test_row_loss_is_the_float64_loss(shape):
    """The cross term as ``Σ_r u_r·(X F)_r`` over the playlist CSR."""
    p, v = shape[:2]
    rows, cols, user, item = _loss_case(shape, 11)
    by_user = segsum.build_csr(rows, cols, p, v)
    got = float(als._sparse_als_loss_rows(by_user, user, item, torch.tensor(0.1)))
    want = _loss64(rows, cols, user, item, 0.1)
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("shape", LOSS_SHAPES)
def test_row_loss_is_the_gather_forms(shape):
    """On factors whose every sum is exact, the two orders of the cross
    term give the same bits."""
    p, v = shape[:2]
    rows, cols, user, item = _loss_case(shape, 12, dyadic=True)
    reg = torch.tensor(0.1)
    by_user = segsum.build_csr(rows, cols, p, v)
    got = als._sparse_als_loss_rows(by_user, user, item, reg)
    want = als._sparse_als_loss(rows, cols, user, item, reg)
    assert torch.equal(got, want)


def _gather_form(by_user, user_f, item_f, reg):
    return als._sparse_als_loss(by_user.segments(), by_user.gidx.long(), user_f, item_f, reg)


def _skewed_baskets(seed: int = 5, p: int = 400, v: int = 300) -> Baskets:
    rows, cols, _, _ = _loss_case((p, v, 1, 0.03), seed)
    names = [f"t{i}" for i in range(v)]
    return Baskets(playlist_rows=rows.numpy().astype(np.int32),
                   track_ids=cols.numpy().astype(np.int32), n_playlists=p,
                   vocab=Vocab(names=names, index={n: i for i, n in enumerate(names)}))


def test_training_takes_the_row_loss(monkeypatch):
    """A sparse training calls the segment sum 2·iters + 1 times (the
    loss's ``X F`` the last); its factors are a gather-form training's bit
    for bit, its loss within the ALS tests' bar of that one's."""
    cfg = MiningConfig(als_sparse="always", als_rank=8, als_iters=3)
    calls = []
    segment_sum = als.segment_sum
    monkeypatch.setattr(als, "segment_sum",
                        lambda mat, csr: calls.append(csr.n_out) or segment_sum(mat, csr))
    got = als.train_embeddings(_skewed_baskets(), cfg, seed=9, device="cpu")
    assert got["storage"] == "sparse" and len(calls) == 2 * cfg.als_iters + 1
    assert calls[-1] == 400  # the playlist CSR
    monkeypatch.setattr(als, "_sparse_als_loss_rows", _gather_form)
    want = als.train_embeddings(_skewed_baskets(), cfg, seed=9, device="cpu")
    assert np.array_equal(got["item_factors"].view(np.int32), want["item_factors"].view(np.int32))
    assert abs(got["final_loss"] - want["final_loss"]) <= LOSS_RTOL * abs(want["final_loss"])


@pytest.mark.parametrize("rank", [1, 5, 8, 13, 32, 64, 100, 128])
def test_rows_normalized_in_torch_ops_are_numpys(rank):
    g = np.random.default_rng(rank)
    x = (g.standard_normal((3_000, rank)) * g.uniform(0.01, 100, (3_000, 1))).astype(np.float32)
    x[7] = 0.0  # a zero row keeps a zero vector
    got = als._normalize_rows(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), als.normalize_factors(x).view(np.int32))


def test_fetch_off_the_card_normalizes_on_the_host():
    x = np.random.default_rng(2).standard_normal((500, 32)).astype(np.float32)
    got = als._fetch_normalized(torch.from_numpy(x))
    assert np.array_equal(got.view(np.int32), als.normalize_factors(x).view(np.int32))


def test_cpu_training_draws_the_init_on_the_host(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the card's draw on a CPU training")

    monkeypatch.setattr(normals, "init_rows", refuse)
    out = als.train_embeddings(_tiny_baskets(), MiningConfig(als_sparse="always", als_rank=4, als_iters=2),
                               seed=3, device="cpu")
    assert out["storage"] == "sparse"


# ---- on the card -----------------------------------------------------------

CARD_SHAPES = [(1, 1, 1), (3, 2, 5), (1_000, 300, 32), (70_001, 4_099, 32), (200_000, 50_000, 8)]


def _tiny_baskets():
    names = [f"t{i}" for i in range(40)]
    return Baskets(playlist_rows=np.repeat(np.arange(50), 2).astype(np.int32),
                   track_ids=(np.arange(100) % 40).astype(np.int32), n_playlists=50,
                   vocab=Vocab(names=names, index={n: i for i, n in enumerate(names)}))


@pytest.mark.cuda
class TestOnTheCard:
    """The kernels' draw against the host's, bit for bit."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (runs on the GPU machine)")

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("shape", CARD_SHAPES)
    def test_card_draw_is_the_host_draw(self, seed, shape):
        p, v, rank = shape
        launches = normals.LAUNCHES["normals"]
        got = normals.init_rows(seed, (p, v), rank, torch.device("cuda"))
        assert got is not None
        assert normals.LAUNCHES["normals"] - launches == 2
        want_user, want_item = _host_init(seed, p, v, rank)
        assert np.array_equal(got[0].cpu().numpy().view(np.int32), want_user.view(np.int32))
        assert np.array_equal(got[1].cpu().numpy().view(np.int32), want_item.view(np.int32))

    def test_card_draw_at_config4(self):
        p, v, rank, seed = 10_000_000, 1_000_000, 32, 2_654_435_761
        got = normals.init_rows(seed, (p, v), rank, torch.device("cuda"))
        assert got is not None
        want_user, want_item = _host_init(seed, p, v, rank)
        for g, w in zip(got, (want_user, want_item)):
            assert torch.equal(g.cpu().view(torch.int32), torch.from_numpy(w).view(torch.int32))

    @pytest.mark.parametrize("rank", [4, 32, 100])
    def test_card_normalizes_as_numpy(self, rank, caplog):
        g = np.random.default_rng(rank)
        x = (g.standard_normal((100_003, rank)) * g.uniform(0.01, 100, (100_003, 1))).astype(
            np.float32)
        x[11] = 0.0
        got = als._fetch_normalized(torch.from_numpy(x).cuda())
        assert np.array_equal(got.view(np.int32), als.normalize_factors(x).view(np.int32))
        assert "differ from numpy's" not in caplog.text

    def test_card_training_draws_on_the_card(self):
        cfg = MiningConfig(als_sparse="always", als_rank=4, als_iters=2)
        launches = normals.LAUNCHES["normals"]
        keep = {}
        card = als.train_embeddings(_tiny_baskets(), cfg, seed=3, device="cuda", keep=keep)
        assert normals.LAUNCHES["normals"] - launches == 2
        want_user, want_item = _host_init(3, 50, 40, 4)
        assert np.array_equal(keep["user_init"].cpu().numpy(), want_user)
        assert np.array_equal(keep["item_init"].cpu().numpy(), want_item)
        assert card["storage"] == "sparse"


@pytest.mark.cuda
class TestLossOnTheCard:
    """The row-form loss on the card: one more segsum launch, the same bits
    run to run, the gather form's factors and (within the bar) its loss."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (runs on the GPU machine)")

    def test_card_training_loss_repeats_bit_for_bit(self, monkeypatch):
        cfg = MiningConfig(als_sparse="always", als_rank=32, als_iters=4)
        bk = _skewed_baskets(p=3_000, v=2_000)
        outs, keep = [], {}
        for k in (keep, None):
            launches = segsum.LAUNCHES["segsum"]
            outs.append(als.train_embeddings(bk, cfg, seed=9, device="cuda", keep=k))
            assert segsum.LAUNCHES["segsum"] - launches == 2 * cfg.als_iters + 1
        a, b = outs
        assert a["storage"] == "sparse" and a["final_loss"] == b["final_loss"]
        assert np.array_equal(a["item_factors"], b["item_factors"])
        by_user = keep["by_user"]
        want = _loss64(by_user.segments().cpu(), by_user.gidx.long().cpu(),
                       keep["user_out"].cpu(), keep["item_out"].cpu(), cfg.als_reg)
        assert abs(a["final_loss"] - want) <= 1e-5 * abs(want)
        monkeypatch.setattr(als, "_sparse_als_loss_rows", _gather_form)
        gather = als.train_embeddings(bk, cfg, seed=9, device="cuda")
        assert np.array_equal(a["item_factors"], gather["item_factors"])
        assert abs(a["final_loss"] - gather["final_loss"]) <= LOSS_RTOL * abs(gather["final_loss"])
