"""The port's native host libraries against the JAX package's: the CSV
reader (``data/native.py``) and ``read_tracks`` on every case of
``tests/test_native.py``, the POPCNT pair counter, bit-packer and top-k
(``ops/cpu_popcount.py``), the serve lookup (``serving/native_serve.py``)
against the reference's and the port's ``recommend_batch``, a CPU mine
through the native counter, a CPU engine serving through the native
lookup, the replay CLI's in-process target, the ABI refusal and the
``KMLS_NATIVE=0`` kill switch. Inputs are seeded with numpy; every
comparison is exact. The reference's libraries build through its own
Makefile, as ``tests/test_native.py`` builds them; the port's through
``utils/nativelib.py`` (g++)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kmlserver_tpu.config import MiningConfig as RefMiningConfig
from kmlserver_tpu.config import ServingConfig as RefServingConfig
from kmlserver_tpu.data import native as ref_native
from kmlserver_tpu.data.csv import read_tracks as ref_read_tracks
from kmlserver_tpu.data.csv import write_tracks_csv as ref_write_tracks_csv
from kmlserver_tpu.data.synthetic import synthetic_table
from kmlserver_tpu.mining import miner as ref_miner
from kmlserver_tpu.ops import cpu_popcount as ref_cpu
from kmlserver_tpu.serving import native_serve as ref_serve
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu_torch import faults
from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.data import native
from kmlserver_tpu_torch.data.csv import read_tracks
from kmlserver_tpu_torch.mining import miner
from kmlserver_tpu_torch.ops import cpu_popcount, rules
from kmlserver_tpu_torch.ops.serve import recommend_batch
from kmlserver_tpu_torch.serving import native_serve
from kmlserver_tpu_torch.serving.engine import RecommendEngine
from kmlserver_tpu_torch.utils import nativelib

from .test_torch_dispatch import _assert_same
from .torch_serving_util import KNOBS, mine_pvc, port_cfg, seed_sets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not (native.available() and ref_native.ensure_built()),
    reason="no C++ toolchain to build the native libraries",
)

# tests/test_native.py's files, one case each
CSV_CASES = {
    "rfc4180": 'pid,track_name,artist_name\n1,"Hello, World","A ""quoted"" artist"\n'
               "2,Simple,Nome çedilha\n" '1,"Multi\nline title",Artist2\n',
    "missing_pid": "a,b\n1,2\n",
    "too_many_fields": "pid,track_name,artist_name\n1,a,b,X,Y,Z\n2,c,d\n",
    "too_few_fields": "pid,track_name,artist_name\n1,a,b\n2,c\n",
    "invalid_pid": "pid,track_name\nabc,x\n7,y\n",
    "float_pid": "pid,track_name\n1.5,x\n2,y\n",
    "integral_float_pid": "pid,track_name\n1.0,x\n2,y\n",
    "exponent_pid": "pid,track_name\n2e3,x\n2,y\n",
    "pid_past_int64": "pid,track_name\n9223372036854775808,x\n",
    "trailing_empty_at_eof": "pid,track_name,artist_name\n1,a,b\n2,c,",
    "trailing_empty_newline": "pid,track_name,artist_name\n1,a,b\n2,c,\n",
    "trailing_comma": "pid,track_name,artist_name\n1,a,b,\n",
    "empty_cells": "pid,track_name,artist_name\n1,,z\n2,y,\n",
    "header_only": "pid,track_name\n",
    "skip_column": "pid,track_name,duration_ms\n1,a,111\n2,b,222\n",
    "crlf_and_blank_lines": "pid,track_name\r\n1,a\r\n\r\n2,b\r\n\n",
}


def _write_case(tmp_path, name: str) -> str:
    path = tmp_path / f"{name}.csv"
    path.write_text(CSV_CASES[name])
    return str(path)


def _synthetic_csv(tmp_path, seed: int = 11) -> str:
    path = str(tmp_path / "ds.csv")
    ref_write_tracks_csv(
        path, synthetic_table(n_playlists=50, n_tracks=40, target_rows=600, seed=seed)
    )
    return path


def _native_outcome(read, path: str, skip: tuple):
    try:
        t = read(path, skip_columns=skip)
    except ValueError as exc:
        return "error", str(exc)
    return "ok", t.pids.tolist(), {
        name: (c.codes.tolist(), list(c.vocab)) for name, c in t.columns.items()
    }


@pytest.mark.parametrize("name", list(CSV_CASES) + ["synthetic"])
def test_native_reader_matches_reference(name, tmp_path):
    path = _synthetic_csv(tmp_path) if name == "synthetic" else _write_case(tmp_path, name)
    skip = ("duration_ms",) if name == "skip_column" else ()
    got = _native_outcome(native.read_csv_native, path, skip)
    want = _native_outcome(ref_native.read_csv_native, path, skip)
    assert got == want


def _table_view(read, path: str, sample_ratio: float = 1.0):
    try:
        t = read(path, sample_ratio)
    except ValueError:
        return "error"
    return [
        None if getattr(t, f) is None else np.asarray(getattr(t, f)).tolist()
        for f in ("pid", "track_name", "track_uri", "artist_name", "artist_uri", "album_name")
    ]


@pytest.mark.parametrize("name", list(CSV_CASES) + ["synthetic"])
def test_read_tracks_matches_reference(name, tmp_path):
    path = _synthetic_csv(tmp_path) if name == "synthetic" else _write_case(tmp_path, name)
    before = dict(native.LOADS)
    got = _table_view(read_tracks, path)
    want = _table_view(ref_read_tracks, path)
    native_refused = _native_outcome(native.read_csv_native, path, ())[0] == "error"
    if name == "too_few_fields":
        # the one divergence of the fallbacks: the reference's pandas pads a
        # short row with "", the port's stdlib parser refuses it, as both
        # native readers do
        assert got == "error" and want != "error"
        return
    assert got == want
    if got != "error":
        reader = "stdlib" if native_refused else "native"
        assert native.LOADS[reader] == before[reader] + 1


@pytest.mark.parametrize("ratio", [0.37, 0.5, 0.001])
def test_read_tracks_sample_ratio_is_the_references_head_slice(ratio, tmp_path):
    path = _synthetic_csv(tmp_path, seed=12)
    got = _table_view(read_tracks, path, ratio)
    assert got == _table_view(ref_read_tracks, path, ratio)
    assert len(got[0]) == max(1, int(len(_table_view(read_tracks, path)[0]) * ratio))


def test_kill_switch_is_live_after_the_first_load(tmp_path, monkeypatch):
    path = _synthetic_csv(tmp_path)
    assert native.available() and cpu_popcount.available() and native_serve.available()
    via_native = _table_view(read_tracks, path)
    monkeypatch.setenv("KMLS_NATIVE", "0")
    assert not native.available()
    assert not cpu_popcount.available() and not native_serve.available()
    stdlib = native.LOADS["stdlib"]
    assert _table_view(read_tracks, path) == via_native
    assert native.LOADS["stdlib"] == stdlib + 1
    with pytest.raises(RuntimeError):
        cpu_popcount.pair_counts([0], [0], n_playlists=1, n_tracks=1)
    monkeypatch.delenv("KMLS_NATIVE")
    assert native.available()


class _FakeLib:
    """A library whose version functions report ``version`` (or, with
    None, that predates versioning)."""

    def __init__(self, version):
        self.version = version

    def __getattr__(self, name):
        if self.version is None or not name.endswith("abi_version"):
            raise AttributeError(name)
        fn = lambda: self.version  # noqa: E731
        return fn


@pytest.mark.parametrize("module,good", [(native, 2), (cpu_popcount, 4), (native_serve, 1)])
def test_a_library_of_another_abi_is_refused(module, good):
    assert module._ABI_VERSION == good
    for version in (good - 1, good + 1):
        with pytest.raises(OSError, match="ABI"):
            module._bind(_FakeLib(version))
    if module is native:
        with pytest.raises(OSError, match="predates"):
            module._bind(_FakeLib(None))


def test_a_refused_library_is_not_rebuilt(monkeypatch):
    builds = []
    real_build = nativelib.build

    def counting_build(source):
        builds.append(source)
        return real_build(source)

    monkeypatch.setattr(nativelib, "build", counting_build)

    def refuse(lib):
        raise OSError("refused for the test")

    lib = nativelib.NativeLib("kmls_serve", refuse)
    assert lib.load() is None and lib.error == "refused for the test"
    assert lib.load() is None and not lib.available()
    assert builds == ["kmls_serve"]
    assert nativelib.library_path("kmls_serve").parent == nativelib.BUILD_DIR


# ---- the counter, the bit-packer and the top-k ----


def _pairs(seed: int, n_playlists: int, n_tracks: int, mean_len: int):
    rng = np.random.default_rng(seed)
    rows, ids = [], []
    for p in range(n_playlists):
        k = int(min(n_tracks, rng.poisson(mean_len)))
        picks = rng.choice(n_tracks, size=k, replace=False)
        rows += [p] * k
        ids += picks.tolist()
    return np.asarray(rows, dtype=np.int64), np.asarray(ids, dtype=np.int32)


def _dense_counts(rows, ids, n_playlists, n_tracks):
    x = np.zeros((n_playlists, n_tracks), dtype=np.int64)
    x[rows, ids] = 1
    return (x.T @ x).astype(np.int32)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("method", ["auto", "bitset", "sparse"])
@pytest.mark.parametrize("shape", [(300, 120, 9), (130, 700, 3), (70, 33, 30)])
def test_pair_counts_match_the_references(method, threads, shape):
    n_playlists, n_tracks, mean_len = shape
    rows, ids = _pairs(sum(shape), n_playlists, n_tracks, mean_len)
    kw = dict(n_playlists=n_playlists, n_tracks=n_tracks, n_threads=threads, method=method)
    got = cpu_popcount.pair_counts(rows, ids, **kw)
    np.testing.assert_array_equal(got, ref_cpu.pair_counts(rows, ids, **kw))
    np.testing.assert_array_equal(got, _dense_counts(rows, ids, n_playlists, n_tracks))
    assert cpu_popcount.choose_method(rows, n_playlists=n_playlists, n_tracks=n_tracks) == \
        ref_cpu.choose_method(rows, n_playlists=n_playlists, n_tracks=n_tracks)


@pytest.mark.parametrize("method", ["bitset", "sparse"])
def test_pair_method_env_pins_the_counter(method, monkeypatch):
    rows, ids = _pairs(3, 200, 90, 8)
    monkeypatch.setenv("KMLS_NATIVE_PAIR_METHOD", method)
    monkeypatch.setenv("KMLS_NATIVE_THREADS", "2")
    assert cpu_popcount._effective_threads() == ref_cpu._effective_threads() == 2
    before = dict(cpu_popcount.CALLS)
    got = cpu_popcount.pair_counts(rows, ids, n_playlists=200, n_tracks=90)
    assert cpu_popcount.CALLS[method] == before[method] + 1
    np.testing.assert_array_equal(got, _dense_counts(rows, ids, 200, 90))
    with pytest.raises(ValueError, match="method"):
        cpu_popcount.pair_counts(rows, ids, n_playlists=200, n_tracks=90, method="dense")


@pytest.mark.parametrize("shape", [(1, 1), (63, 5), (64, 9), (65, 40), (700, 130)])
def test_bitpack_rows_matches_the_reference(shape):
    n_playlists, n_tracks = shape
    rows, ids = _pairs(n_playlists, n_playlists, n_tracks, max(1, n_tracks // 3))
    kw = dict(n_playlists=n_playlists, n_tracks=n_tracks)
    got = cpu_popcount.bitpack_rows(rows, ids, **kw)
    want = ref_cpu.bitpack_rows(rows, ids, **kw)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="track_ids"):
        cpu_popcount.bitpack_rows(rows, ids + n_tracks, **kw)


@pytest.mark.parametrize("k_max", [1, 7, 64, 500])
@pytest.mark.parametrize("min_count", [1, 3, 12])
def test_emit_topk_matches_the_reference_and_the_numpy_twin(k_max, min_count):
    rows, ids = _pairs(5, 400, 150, 10)
    counts = cpu_popcount.pair_counts(rows, ids, n_playlists=400, n_tracks=150)
    got = cpu_popcount.emit_topk(counts, min_count, k_max=k_max)
    want = ref_cpu.emit_topk(counts, min_count, k_max=k_max)
    twin = rules.emit_rule_tensors_np(counts, min_count, k_max=k_max)
    for a, b, c in zip(got, want, twin):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# ---- the serve lookup ----


def _rule_tensors(seed: int, v: int, k: int):
    """Rows emitted as the miner writes them (descending, then -1), with
    confidences from a short list so that ties are common."""
    rng = np.random.default_rng(seed)
    ids = np.full((v, k), -1, dtype=np.int32)
    confs = np.zeros((v, k), dtype=np.float32)
    levels = np.asarray([0.9, 0.5, 0.5, 0.25, 0.125], dtype=np.float32)
    for r in range(v):
        n = int(rng.integers(0, min(k, v - 1) + 1))
        ids[r, :n] = rng.choice([c for c in range(v) if c != r], size=n, replace=False)
        confs[r, :n] = np.sort(rng.choice(levels, size=n))[::-1]
    return ids, confs


def _seeds(seed: int, b: int, l: int, v: int):
    rng = np.random.default_rng(seed)
    seeds = np.full((b, l), -1, dtype=np.int32)
    for r in range(b):
        n = int(rng.integers(0, l + 1))
        seeds[r, :n] = rng.choice(v, size=n, replace=False)
    return seeds


@pytest.mark.parametrize("k_best", [1, 5, 40, 200])
@pytest.mark.parametrize("b,l", [(1, 1), (3, 8), (32, 5)])
def test_serve_topk_matches_the_reference_and_recommend_batch(b, l, k_best):
    v, k = 60, 12
    ids, confs = _rule_tensors(b * 100 + l, v, k)
    seeds = _seeds(k_best, b, l, v)
    got_ids, got_confs = native_serve.serve_topk(ids, confs, seeds, k_best)
    ref_ids, ref_confs = ref_serve.serve_topk(ids, confs, seeds, k_best)
    plain_ids, plain_confs = recommend_batch(
        torch.from_numpy(ids), torch.from_numpy(confs), torch.from_numpy(seeds), k_best=k_best
    )
    np.testing.assert_array_equal(got_ids, ref_ids)
    np.testing.assert_array_equal(got_confs, ref_confs)
    np.testing.assert_array_equal(got_ids, plain_ids.numpy())
    np.testing.assert_array_equal(got_confs, plain_confs.numpy())


def test_tied_confidences_rank_the_lowest_id_first():
    ids = np.asarray([[7, 3, 5, -1], [2, 9, -1, -1]], dtype=np.int32)
    confs = np.asarray([[0.5, 0.5, 0.5, 0], [0.5, 0.5, 0, 0]], dtype=np.float32)
    seeds = np.asarray([[0, 1]], dtype=np.int32)
    ids = np.concatenate([ids, np.full((8, 4), -1, dtype=np.int32)])
    confs = np.concatenate([confs, np.zeros((8, 4), dtype=np.float32)])
    got, _ = native_serve.serve_topk(ids, confs, seeds, 4)
    assert got.tolist() == [[2, 3, 5, 7]]
    plain, _ = recommend_batch(torch.from_numpy(ids), torch.from_numpy(confs),
                               torch.from_numpy(seeds), k_best=4)
    assert plain.tolist() == got.tolist()


def test_host_rule_rows_close_a_hole_without_changing_an_answer():
    ids, confs = _rule_tensors(9, 50, 10)
    holed = ids.copy()
    holed[ids[:, 1] >= 0, 0] = -1  # an id dropped at the head of each row
    seeds = _seeds(4, 16, 6, 50)
    host_ids, host_confs = native_serve.host_rule_rows(holed, confs)
    got = native_serve.serve_topk(host_ids, host_confs, seeds, 12)
    want = recommend_batch(torch.from_numpy(holed), torch.from_numpy(confs),
                           torch.from_numpy(seeds), k_best=12)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    same_ids, _ = native_serve.host_rule_rows(ids, confs)
    assert np.shares_memory(same_ids, ids)  # emission's layout is kept as is


# ---- the miner's native route ----


@pytest.fixture(scope="module")
def baskets():
    from kmlserver_tpu.mining.vocab import build_baskets as ref_build_baskets
    from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab

    table = synthetic_table(n_playlists=300, n_tracks=800, target_rows=6000, seed=5)
    ref = ref_build_baskets(table)
    names = list(ref.vocab.names)
    port = Baskets(
        playlist_rows=ref.playlist_rows.copy(), track_ids=ref.track_ids.copy(),
        n_playlists=ref.n_playlists,
        vocab=Vocab(names=names, index={n: i for i, n in enumerate(names)}),
    )
    return ref, port


NATIVE_SETTINGS = {
    "auto": ({}, "native-cpu"),
    "dense": (dict(count_path="dense"), "native-cpu"),
    "bitpack": (dict(count_path="bitpack"), "bitpack-torch"),
    "sparse": (dict(count_path="sparse"), "sparse-hybrid"),
    "sparse_long": (dict(count_path="sparse", sparse_long_basket=24), "sparse-hybrid"),
    "conf_len2": (dict(confidence_mode="confidence", min_confidence=0.1), "native-cpu"),
    "census3": (dict(max_itemset_len=3), "dense"),
    "low_support": (dict(min_support=0.01, k_max_consequents=8), "native-cpu"),
}


@pytest.mark.parametrize("name", list(NATIVE_SETTINGS))
def test_cpu_mine_through_the_native_counter_matches_the_reference(name, baskets, capsys):
    knobs, route = NATIVE_SETTINGS[name]
    ref_b, port_b = baskets
    calls = dict(cpu_popcount.CALLS)
    ref = ref_miner.mine(ref_b, RefMiningConfig(**knobs))
    capsys.readouterr()
    port = miner.mine(port_b, MiningConfig(**knobs), device="cpu")
    out = capsys.readouterr().out
    assert port.count_path == route
    _assert_same(ref, port)
    assert "NOTE: the reference counts" not in out
    if route == "native-cpu":
        assert port.phase_timings.keys() >= {"native_pair_counts", "rule_emission"}
        assert sum(cpu_popcount.CALLS[m] for m in ("bitset", "sparse")) > sum(
            calls[m] for m in ("bitset", "sparse"))
        assert cpu_popcount.CALLS["emit_topk"] > calls["emit_topk"]


def test_the_knob_turns_the_native_counter_off(baskets):
    _, port_b = baskets
    on = miner.mine(port_b, MiningConfig(), device="cpu")
    off = miner.mine(port_b, MiningConfig(native_cpu_pair_counts=False), device="cpu")
    assert (on.count_path, off.count_path) == ("native-cpu", "dense-fused")
    for key in ("rule_ids", "rule_counts", "rule_confs", "item_counts"):
        np.testing.assert_array_equal(getattr(on.tensors, key), getattr(off.tensors, key))


# ---- the engine's native lookup and the replay CLI ----


@pytest.fixture(scope="module")
def pvc(tmp_path_factory):
    return mine_pvc(tmp_path_factory.mktemp("torch_native"))


def _answers(engine, sets):
    out = []
    for lo in range(0, len(sets), 8):
        out += engine.recommend_many(sets[lo:lo + 8])
    return out


def _loaded(engine):
    assert engine.load()
    return engine


def test_cpu_engine_answers_alike_with_native_serve_on_and_off(pvc):
    sets = seed_sets(pvc, 300, seed=7)
    on = _loaded(RecommendEngine(port_cfg(pvc, native_serve=True), device="cpu"))
    off = _loaded(RecommendEngine(port_cfg(pvc), device="cpu"))
    ref = _loaded(RefEngine(RefServingConfig(base_dir=pvc, polling_wait_in_minutes=5.0, **KNOBS)))
    assert on.bundle.host_rule_ids is not None and off.bundle.host_rule_ids is None
    assert ref.bundle.host_rule_ids is not None  # the reference's native lookup too
    calls = native_serve.CALLS["serve_topk"]
    got = _answers(on, sets)
    assert native_serve.CALLS["serve_topk"] == calls + (len(sets) + 7) // 8
    assert got == _answers(off, sets)
    assert got == [tuple(a) for a in _answers(ref, sets)]
    assert [on.recommend(s) for s in sets[:40]] == [tuple(ref.recommend(s)) for s in sets[:40]]
    assert on.unwarmed_dispatches == 0 and not on.bundle.warmed_shapes
    stats = on.cost_model.kernel_stats()
    assert stats["serve_native"]["dispatches"] > 0 and "serve_rules" not in stats


def test_native_engine_keeps_one_replica_and_the_kernel_fault_site(pvc):
    engine = _loaded(RecommendEngine(port_cfg(pvc, native_serve=True, serve_devices=2),
                                     device="cpu"))
    assert engine.n_replicas == 1
    sets = seed_sets(pvc, 4, seed=1)
    faults.inject("replica.kernel", replica=0)
    try:
        finish = engine.recommend_many_async(sets)
        with pytest.raises(faults.FaultInjected):
            finish()
    finally:
        faults.clear()
    assert engine.recommend_many(sets) == _loaded(
        RecommendEngine(port_cfg(pvc), device="cpu")).recommend_many(sets)


def test_replay_cli_in_process_target(pvc):
    env = dict(os.environ, PYTHONPATH=REPO, BASE_DIR=pvc, KMLS_TORCH_DEVICE="cpu",
               KMLS_MAX_SEED_TRACKS="8", KMLS_BATCH_MAX_SIZE="8")
    proc = subprocess.run(
        [sys.executable, "-m", "kmlserver_tpu_torch.serving.replay", "--qps", "400",
         "--requests", "200", "--zipf-s", "1.1", "--batch-max-size", "8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["n_requests"] == 200 and summary["n_errors"] == 0
    assert sum(summary["by_source"].values()) == 200
    assert set(summary["by_source"]) <= {"rules", "fallback", "empty"}
    assert summary["by_source"].get("rules", 0) > 0
    assert 0 < summary["cache_hit_ratio"] < 1  # a Zipf mix repeats seed sets
    assert len(summary["per_device_dispatch"]) == 1 and summary["per_device_dispatch"][0] > 0
    empty = subprocess.run(
        [sys.executable, "-m", "kmlserver_tpu_torch.serving.replay", "--requests", "5"],
        cwd=REPO, env=dict(env, BASE_DIR=os.path.join(pvc, "nothing-here")),
        capture_output=True, text=True, timeout=240,
    )
    assert empty.returncode == 1 and "artifacts not found" in empty.stdout
