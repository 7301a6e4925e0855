"""The embed phase over the device-born catalog
(``kmlserver_tpu_torch/mining/als.train_embeddings`` on event tensors,
``keep=``), and the checks of the benchmark's embed cell
(``kmls_bench/cells/embed.py``), on the CPU at a small size.

- events given as tensors train exactly as the same events given as host
  arrays; ``keep=`` holds what it promises and leaves the payload as it
  is; the port's training equals the plain reference's
  (``kmls_bench/reference/embed.als_plain``: ``index_add_`` over the
  events in their order) within :data:`FACTOR_TOL` (the same additions in
  the same order: equal in practice) and its loss within :data:`LOSS_RTOL`
  (the port sums the loss's cross term in float32 chunks, the reference in
  float64);
- the init drawn block by block equals the reference's whole draw, and
  the reference's float64 training is near its float32 one;
- each check of the cell reads at its limit on a sound rotation and past
  it on a perturbed event, a perturbed factor bit and a Gramian rounded to
  TF32; a training that drops its state between sweeps, runs one sweep of
  three or draws another init fails the float64 training check alone;
- the cell's per-layer readers on a hand-built trace: what each reads from
  the program's spans and kernels, and nothing where the program opened no
  span.
"""

import copy
import itertools

import numpy as np
import pytest
import torch

from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.data import device_synthetic as ds
from kmlserver_tpu_torch.mining import als
from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
from kmlserver_tpu_torch.ops.support import min_count_for

from .bench_modules import load

run, cell, ref, trace, roofline = load("kmls_bench.run", "kmls_bench.cells.embed",
                                       "kmls_bench.reference.embed", "kmls_bench.trace",
                                       "kmls_bench.roofline")

FACTOR_TOL = 1e-6
LOSS_RTOL = 1e-5
TRAIN_RTOL = 1e-5  # float32 against float64 after three sweeps at this size
P, V, ROWS, MIN_SUPPORT = 4_000, 400, 40_000, 0.05
KEPT = ("by_user", "by_item", "user_in", "item_in", "g_item", "g_user", "rhs_users",
        "rhs_items", "user_out", "item_out", "user_init", "item_init")


def _vocab(v):
    names = [f"t{i}" for i in range(v)]
    return Vocab(names=names, index={n: i for i, n in enumerate(names)})


def _baskets(seed=3):
    rows, tracks = ds.device_synthetic_events(P, V, ROWS, min_count_for(MIN_SUPPORT, P),
                                              seed=seed, device="cpu")
    return Baskets(playlist_rows=rows, track_ids=tracks, n_playlists=P, vocab=_vocab(V))


def _cfg(**kw):
    return MiningConfig(als_sparse="always", als_rank=8, als_iters=3, als_reg=0.1, **kw)


@pytest.mark.parametrize("seed", [0, 5])
def test_tensor_events_train_as_host_arrays(seed):
    bk = _baskets()
    host = Baskets(playlist_rows=bk.playlist_rows.numpy(), track_ids=bk.track_ids.numpy(),
                   n_playlists=P, vocab=bk.vocab)
    a = als.train_embeddings(bk, _cfg(), seed=seed, device="cpu")
    b = als.train_embeddings(host, _cfg(), seed=seed, device="cpu")
    assert a["storage"] == b["storage"] == "sparse"
    assert np.array_equal(a["item_factors"], b["item_factors"])
    assert a["final_loss"] == b["final_loss"] and a["nnz"] == b["nnz"]


def test_keep_holds_the_last_sweep_and_leaves_the_payload():
    bk = _baskets()
    keep = {}
    a = als.train_embeddings(bk, _cfg(), seed=1, device="cpu", keep=keep)
    b = als.train_embeddings(bk, _cfg(), seed=1, device="cpu")
    assert set(keep) == set(KEPT)
    assert np.array_equal(a["item_factors"], b["item_factors"]) and a["final_loss"] == b["final_loss"]
    assert a.keys() == b.keys()
    assert np.array_equal(a["item_factors"], als.normalize_factors(keep["item_out"].numpy()))
    user0, item0 = ref.init32(1, P, keep["item_out"].shape[0], 8)
    assert np.array_equal(keep["user_init"].numpy(), user0)
    assert np.array_equal(keep["item_init"].numpy(), item0)
    reg = torch.tensor(0.1, dtype=torch.float32)
    eye = als._eye_reg(8, reg)
    assert torch.equal(keep["g_item"], keep["item_in"].T @ keep["item_in"] + eye)
    assert torch.equal(keep["g_user"], keep["user_out"].T @ keep["user_out"] + eye)
    # one more sweep from the kept inputs gives the kept outputs
    again = {}
    user, item = als._sparse_als_sweep(keep["by_user"], keep["by_item"], keep["user_in"],
                                       keep["item_in"], reg, again)
    assert torch.equal(user, keep["user_out"]) and torch.equal(item, keep["item_out"])
    assert torch.equal(again["rhs_users"], keep["rhs_users"])
    assert keep["by_item"].longest == P  # a track at q = 1


def test_dense_route_keeps_nothing():
    keep = {}
    out = als.train_embeddings(_baskets(), MiningConfig(als_sparse="never", als_rank=4,
                                                        als_iters=2), device="cpu", keep=keep)
    assert out["storage"] == "dense" and keep == {}


@pytest.mark.parametrize("seed", [0, 9])
def test_training_matches_the_plain_reference(seed):
    bk = _baskets()
    keep = {}
    out = als.train_embeddings(bk, _cfg(), seed=seed, device="cpu", keep=keep)
    plain = ref.als_plain((bk.playlist_rows, bk.track_ids), P, V, 8, 3, 0.1, seed)
    assert float((keep["item_out"] - plain["item"]).abs().max()) <= FACTOR_TOL
    assert float((keep["user_out"] - plain["user"]).abs().max()) <= FACTOR_TOL
    assert abs(out["final_loss"] - plain["loss"]) <= LOSS_RTOL * abs(plain["loss"])


@pytest.fixture(scope="module")
def spec():
    s = copy.deepcopy(run.load_cell("config4_embed.train"))
    s["config"]["deployment"].update(playlists=P, tracks=V, rows=ROWS, min_support=MIN_SUPPORT)
    s["config"]["als"].update(rank=8, iters=3, hbm_budget_bytes=5_000_000)
    return s


def _kept(spec, seed):
    gen_seed, als_seed = cell.seeds(seed, 0)
    keep = {}
    baskets, payload = cell.rotation(torch.device("cpu"), spec["config"], _vocab(V), gen_seed,
                                     als_seed, keep)
    return {"gen_seed": gen_seed, "als_seed": als_seed, "baskets": baskets, "payload": payload,
            "keep": keep}


def _checks(spec, seed, kept):
    return cell.check(spec["config"], spec["traffic"], seed, kept, torch.device("cpu"))


def _failed(checks):
    return {n for n, (v, lim) in checks.items() if not v <= lim}


@pytest.mark.parametrize("seed", [2**31 + 99, 12345])
def test_sound_rotation_passes_every_check(spec, seed):
    kept = _kept(spec, seed)
    assert kept["payload"]["storage"] == "sparse"
    checks = _checks(spec, seed, kept)
    assert list(checks) == ["event_entries_differ", "segsum_bits_differ", "gram_rel_gap",
                            "solve_residual", "loss_rel_gap", "init_bits_differ",
                            "train_rel_gap", "payload_bits_differ", "repeat_bits_differ"]
    assert _failed(checks) == set(), checks


def _perturbed_event(kept):
    rows = kept["baskets"].playlist_rows.clone()
    rows[0] = (rows[0] + 1) % P  # track 0, always compared
    kept["baskets"].playlist_rows = rows


def _perturbed_factor_bit(kept):
    kept["payload"]["item_factors"].view(np.int32)[3, 1] ^= 1 << 12


def _perturbed_init_bit(kept):
    kept["keep"]["item_init"].view(torch.int32)[5, 2] ^= 1


def _tf32_gramian(kept):
    g = kept["keep"]["g_user"]
    g.view(torch.int32).bitwise_and_(~((1 << 13) - 1))  # TF32 keeps 10 mantissa bits


@pytest.mark.parametrize("fault,fails", [
    (_perturbed_event, "event_entries_differ"),
    (_perturbed_factor_bit, "repeat_bits_differ"),
    (_perturbed_factor_bit, "payload_bits_differ"),
    (_tf32_gramian, "gram_rel_gap"),
    (_perturbed_init_bit, "init_bits_differ"),
])
def test_a_fault_fails_its_check(spec, fault, fails):
    seed = 777
    kept = _kept(spec, seed)
    fault(kept)
    assert fails in _failed(_checks(spec, seed, kept))


def _sweeps_drop_their_state(monkeypatch):
    """Every sweep starts from the init's item factors."""
    sweep, init = als._sparse_als_sweep, {}

    def from_the_init(by_user, by_item, user_f, item_f, reg, keep=None):
        item_f = init.setdefault(id(by_item), item_f)
        return sweep(by_user, by_item, user_f, item_f, reg, keep)

    monkeypatch.setattr(als, "_sparse_als_sweep", from_the_init)


def _one_sweep_of_three(monkeypatch):
    """Only the last sweep of a training runs; the others hand their
    inputs on."""
    sweep, calls = als._sparse_als_sweep, itertools.count()

    def last_only(by_user, by_item, user_f, item_f, reg, keep=None):
        if next(calls) % 3 != 2:
            return user_f, item_f
        return sweep(by_user, by_item, user_f, item_f, reg, keep)

    monkeypatch.setattr(als, "_sparse_als_sweep", last_only)


def _another_init(monkeypatch):
    """The init drawn one normal further down the seed's stream."""
    draw = als._draw_init

    def shifted(rng, out):
        rng.standard_normal()
        draw(rng, out)

    monkeypatch.setattr(als, "_draw_init", shifted)


@pytest.mark.parametrize("plant", [_sweeps_drop_their_state, _one_sweep_of_three, _another_init])
def test_a_wrong_training_fails_the_training_check_alone(spec, monkeypatch, plant):
    """A training whose last sweep is sound but whose state, sweep count
    or init is wrong passes every check of the last sweep, the payload and
    the repeat (the fault is deterministic), and fails ``train_rel_gap``
    (a wrong init fails ``init_bits_differ`` too)."""
    seed = 4242
    plant(monkeypatch)
    kept = _kept(spec, seed)
    fails = {"train_rel_gap"} | ({"init_bits_differ"} if plant is _another_init else set())
    assert _failed(_checks(spec, seed, kept)) == fails


@pytest.mark.parametrize("block", [1, 7, 1 << 15])
def test_init_blocks_draw_the_reference_init(monkeypatch, block):
    monkeypatch.setattr(als, "_INIT_BLOCK_ROWS", block)
    user, item = ref.init32(11, 300, 50, 8)
    rng = np.random.default_rng(11)
    got_user, got_item = torch.empty((300, 8)), np.empty((50, 8), np.float32)
    als._draw_init(rng, got_user)
    als._draw_init(rng, got_item)
    assert np.array_equal(got_user.numpy(), user) and np.array_equal(got_item, item)


@pytest.mark.parametrize("seed", [0, 9])
def test_float64_training_is_near_the_float32_one(seed):
    bk = _baskets()
    plain = ref.als_plain((bk.playlist_rows, bk.track_ids), P, V, 8, 3, 0.1, seed)
    want = ref.train64(bk.playlist_rows, bk.track_ids, P, V, 8, 3, 0.1, seed)
    assert want["user"].dtype == torch.float64
    for side in ("user", "item"):
        assert ref.rel_gap64(plain[side], want[side]) <= TRAIN_RTOL


def test_check_tracks_and_users_cover_the_edges():
    t = cell.check_tracks(70, 400, 32, 5)
    assert {0, 1, 2, 69, 70, 399} <= set(t) and len(t) == 32 and t == sorted(t)
    u = cell.check_users(P, 64, 5)
    assert {0, P - 1} <= set(u) and len(u) == 64


H100 = "NVIDIA H100 80GB HBM3"
READERS = ("segsum_roofline", "als_init_s", "csr_s", "als_loss_s", "bitset_events_roofline",
           "tail_events_roofline", "normals_roofline")


def _x(name, cat, ts, dur, tid=1, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if args:
        e["args"] = args
    return e


def _kernel(name, corr, ts, kernel_ts, kernel_dur):
    return [_x("cudaLaunchKernel", "cuda_runtime", ts, 2, correlation=corr),
            _x(name, "kernel", kernel_ts, kernel_dur, tid=7, correlation=corr)]


def _embed_trace(with_program: bool = True):
    """A 10 s window holding one rotation: its generation and a training
    of one sweep (microseconds)."""
    ev = [_x("kmls_bench:window", "user_annotation", 0, 10_000_000)]
    if with_program:
        ev += [
            _x("kmls:gen.events:tracks=1000:events=5000", "cpu_op", 100, 9_000),
            _x("kmls:gen.tail:tracks=900", "cpu_op", 200, 1_000),
            _x("kmls:gen.compact:rows=100:words=400", "cpu_op", 1_300, 1_000),
            _x("kmls:gen.compact:rows=100:words=400:events=4000", "cpu_op", 2_400, 1_000),
            _x("kmls:gen.tail:tracks=900:events=1000", "cpu_op", 3_500, 1_000),
            _x("kmls:als.train:storage=sparse:nnz=5000:p=800:v=1000:r=32:iters=1", "cpu_op",
               10_000, 5_000_000),
            _x("kmls:als.init:values=57600", "cpu_op", 10_100, 3_000_000),
            _x("kmls:als.csr", "cpu_op", 3_010_200, 400_000),
            _x("kmls:als.sweep:i=0", "cpu_op", 3_410_300, 300_000),
            _x("kmls:als.users:rows=800:n_in=1000:events=5000:longest=20:r=32", "cpu_op",
               3_410_400, 100_000),
            _x("kmls:als.items:rows=1000:n_in=800:events=5000:longest=800:r=32", "cpu_op",
               3_510_500, 100_000),
            _x("kmls:als.loss", "cpu_op", 3_710_400, 1_200_000),
            _x("kmls:als.fetch", "cpu_op", 4_910_500, 50_000),
        ]
    ev += _kernel("(anonymous namespace)::tail_events_count(double const*)", 1, 300, 400, 50)
    ev += _kernel("(anonymous namespace)::bitset_events_count(unsigned int const*)", 2, 1_400,
                  1_500, 30)
    ev += _kernel("void at::native::cumsum(long)", 3, 1_500, 1_600, 10)
    ev += _kernel("(anonymous namespace)::bitset_events_write(unsigned int const*)", 4, 2_500,
                  2_600, 70)
    ev += _kernel("(anonymous namespace)::tail_events_write(double const*)", 5, 3_600, 3_700,
                  150)
    ev += _kernel("(anonymous namespace)::normals_count((anonymous namespace)::Stream)", 9,
                  10_200, 10_300, 40)
    ev += _kernel("(anonymous namespace)::normals_write((anonymous namespace)::Stream)", 10,
                  10_400, 10_500, 60)
    ev += _kernel("gemm_f32", 6, 3_410_500, 3_411_000, 100)
    ev += _kernel("void (anonymous namespace)::segsum_kernel<true>(float const*)", 7,
                  3_410_600, 3_411_200, 20)
    ev += _kernel("void (anonymous namespace)::segsum_kernel<true>(float const*)", 8,
                  3_510_600, 3_511_000, 80)
    return trace.Trace(ev)


def test_readers_read_the_programs_spans():
    ctx = {"trace": _embed_trace(), "device_kind": H100}
    got = {m: run.reader(m)(ctx) for m in READERS}
    assert got["als_init_s"] == pytest.approx(3.0)
    assert got["csr_s"] == pytest.approx(0.4)
    assert got["als_loss_s"] == pytest.approx(1.2)
    users = roofline.least_seconds("segsum", H100, n_in=1000, n_out=800, nnz=5000, r=32,
                                   longest=20)
    items = roofline.least_seconds("segsum", H100, n_in=800, n_out=1000, nnz=5000, r=32,
                                   longest=800)
    assert got["segsum_roofline"] == pytest.approx(100 * (users + items) / 100e-6)
    head = roofline.least_seconds("bitset_events", H100, rows=100, words=400, events=4000)
    assert got["bitset_events_roofline"] == pytest.approx(100 * head / 100e-6)
    tail = roofline.least_seconds("tail_events", H100, tracks=900, events=1000)
    assert got["tail_events_roofline"] == pytest.approx(100 * tail / 200e-6)
    init = roofline.least_seconds("normals", H100, values=57_600)
    assert got["normals_roofline"] == pytest.approx(100 * init / 100e-6)


def test_readers_read_nothing_without_the_programs_spans():
    ctx = {"trace": _embed_trace(with_program=False), "device_kind": H100}
    assert {m: run.reader(m)(ctx) for m in READERS} == dict.fromkeys(READERS)
    assert run.reader("idle_share.embed")(ctx) is not None
    assert all(run.reader(m)({"trace": None, "device_kind": H100}) is None for m in READERS)


def test_segsum_roofline_takes_the_longest_row_chain():
    ops, nbytes, key = roofline.count("segsum", n_in=10_000_000, n_out=1_000_000,
                                      nnz=466_000_000, r=32, longest=10_000_000)
    assert key == "int32_lane_ops_per_s"
    chain_s = 10_000_000 * 4 / 1.98e9  # 4 cycles an add at the lane rate's clock
    assert ops / 3.345e13 == pytest.approx(chain_s, rel=1e-3)
    assert nbytes == 4.0 * 10_000_000 * 32 + 8.0 * 1_000_001 + 4.0 * 466_000_000 + 4.0 * 1_000_000 * 32
