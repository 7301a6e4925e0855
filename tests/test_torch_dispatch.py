"""The port's count dispatch and whole mines, held against the JAX package.

``mining/dispatch.py::plan_count_path``, ``bitpack_wanted`` and
``bitpack_plan_bytes`` decide over a grid of overrides, thresholds, table
cells, budgets and backends (``cpu``, ``gpu``, ``tpu``) exactly as the
reference does. Then ``mine`` runs on the CPU at every setting that
``chip_smoke.py``'s phase 7 runs on the card (plus the capacity-overflow
paths), beside the reference's ``mine``, the native counter off on both
sides (``test_torch_native.py`` holds its route): route, dispatch source,
rule tensors, ``rule_confs64``,
census and merge flag must be equal. Last, the job end to end in
confidence mode with ``max_itemset_len=3``.
"""

import contextlib
import io
import json
import os
import pickle
import shutil
import types

import jax
import numpy as np
import pytest

from kmlserver_tpu.config import MiningConfig as RefMiningConfig
from kmlserver_tpu.data.csv import write_tracks_csv as ref_write_tracks_csv
from kmlserver_tpu.data.synthetic import synthetic_baskets as ref_synthetic_baskets
from kmlserver_tpu.data.synthetic import synthetic_table
from kmlserver_tpu.mining import dispatch as ref_dispatch
from kmlserver_tpu.mining import miner as ref_miner
from kmlserver_tpu.mining.pipeline import run_mining_job as ref_run_mining_job
from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.mining import dispatch, miner
from kmlserver_tpu_torch.mining.pipeline import run_mining_job
from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
from kmlserver_tpu_torch.utils.device import backend_name

GIB = 1 << 30


def _rows(n_playlists, nnz, seed, long_every=0):
    """Sorted playlist rows of ``nnz`` memberships (only the rows matter
    to the plan: it measures basket lengths). ``long_every``: every such
    playlist gets a basket long enough for the long-basket guard."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, n_playlists, size=nnz)).astype(np.int32)
    if long_every:
        extra = np.repeat(np.arange(0, n_playlists, long_every, dtype=np.int32), 300)
        rows = np.sort(np.concatenate([rows, extra]))
    return rows


# (n_playlists, n_tracks, nnz, long_every): density and element bands that
# hit the cpu table's sparse, dense and bitpack cells and miss it
SHAPES = {
    "d1e0": (4000, 1000, 2000, 0),  # cpu cell: sparse
    "d1e0_long": (4000, 1000, 2000, 500),  # sparse cell, long baskets
    "d3e0": (4000, 1000, 100_000, 0),  # cpu cell: dense
    "d3e1": (20000, 2000, 1_000_000, 0),  # cpu cell: bitpack
    "d4e0": (2000, 500, 200_000, 0),  # no cell: heuristic
    "d1e3": (100_000, 20_000, 2_000_000, 0),  # no cell, above 2^26 elements
}

_ROWS_CACHE: dict = {}


def _shape(name):
    if name not in _ROWS_CACHE:
        p, v, nnz, long_every = SHAPES[name]
        rows = _rows(p, nnz, seed=len(name), long_every=long_every)
        _ROWS_CACHE[name] = (p, v, len(rows), types.SimpleNamespace(playlist_rows=rows))
    return _ROWS_CACHE[name]


def _plans(shape, backend, capsys, **cfg):
    p, v, nnz, baskets = _shape(shape)
    # both decide from the same evidence: the port's packaged table (it banks
    # cells the reference's copy lacks), unless the test names another
    ref_cfg = cfg
    if "dispatch_table" not in cfg and not os.environ.get("KMLS_DISPATCH_TABLE"):
        ref_cfg = dict(cfg, dispatch_table=dispatch.builtin_table_path())
    out = []
    for mod, config, knobs in ((ref_dispatch, RefMiningConfig, ref_cfg),
                               (dispatch, MiningConfig, cfg)):
        plan = mod.plan_count_path(
            config(**knobs), p, v, nnz, backend=backend, baskets=baskets
        )
        out.append((_plan_tuple(plan), capsys.readouterr().out))
    return out


def _plan_tuple(plan):
    return (plan.path, plan.source, plan.density, plan.elems, plan.cell, plan.pair_events)


PLAN_CONFIGS = [
    {},
    dict(count_path="dense"),
    dict(count_path="bitpack"),
    dict(count_path="sparse"),
    dict(count_path=" Sparse "),
    dict(count_path="auto"),
    dict(count_path="bitpak"),  # a misspelling: fails safe to auto
    dict(bitpack_threshold_elems=1),
    dict(bitpack_threshold_elems=None),
    dict(bitpack_threshold_elems=10**12),
    dict(bitpack_threshold_elems="never"),
    dict(hbm_budget_bytes=GIB),  # the sparse rescue where it fits
    dict(hbm_budget_bytes=64 << 20),
    dict(hbm_budget_bytes=1000),  # nothing fits
    dict(sparse_long_basket=64),
    dict(count_path="dense", sparse_long_basket=2),
]


@pytest.mark.parametrize("backend", ["cpu", "gpu", "tpu"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("cfg", PLAN_CONFIGS, ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()) or "default")
def test_plan_count_path_matches_reference(shape, backend, cfg, capsys):
    """Path, source, density, elements, cell and pair events — and the
    NOTE/WARNING lines the plan prints — equal the reference's."""
    (ref_plan, ref_out), (plan, out) = _plans(shape, backend, capsys, **cfg)
    assert plan == ref_plan
    assert out == ref_out


def test_plan_grid_reaches_every_family_and_source(capsys):
    """The grid above is not vacuous: it hits every path and source."""
    seen = set()
    for shape in SHAPES:
        for backend in ("cpu", "gpu", "tpu"):
            for cfg in PLAN_CONFIGS:
                (_, _), (plan, _) = _plans(shape, backend, capsys, **cfg)
                seen.add((plan[0], plan[1]))
    for want in [
        ("sparse", "table"), ("dense", "table"), ("bitpack", "table"),
        ("dense", "heuristic"), ("bitpack", "heuristic"), ("sparse", "heuristic"),
        ("dense", "override"), ("bitpack", "override"), ("sparse", "override"),
        ("dense", "threshold"), ("bitpack", "threshold"),
    ]:
        assert want in seen, want


def test_misspelled_override_warns_and_keeps_auto(caplog):
    p, v, nnz, baskets = _shape("d4e0")
    with caplog.at_level("WARNING"):
        plan = dispatch.plan_count_path(
            MiningConfig(count_path="bitpak"), p, v, nnz, backend="gpu", baskets=baskets
        )
    assert plan.source == "heuristic"
    assert "fail-safe" in caplog.text


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_table_from_env_or_config_matches_reference(tmp_path, backend, monkeypatch, capsys):
    """An explicit table (config field, then env) is read, a gpu cell
    included; an unreadable one falls back to the heuristic."""
    table = dispatch.table_from_records(
        [{"density": 0.2, "elems": 10**6, "rows": 1000, "dense_s": 2.0,
          "bitpack_s": 1.0, "shape": "2000x500"}],
        backend, measured_on="test", banked_at=1.0,
    )
    assert table == ref_dispatch.table_from_records(
        [{"density": 0.2, "elems": 10**6, "rows": 1000, "dense_s": 2.0,
          "bitpack_s": 1.0, "shape": "2000x500"}],
        backend, measured_on="test", banked_at=1.0,
    )
    path = tmp_path / "table.json"
    dispatch.save_table(str(path), table)
    assert json.loads(path.read_text())["backends"][backend]["cells"]["d4:e0"]["path"] == "bitpack"
    (ref_plan, _), (plan, _) = _plans("d4e0", backend, capsys, dispatch_table=str(path))
    assert plan == ref_plan and plan[:2] == ("bitpack", "table")
    monkeypatch.setenv("KMLS_DISPATCH_TABLE", str(path))
    (ref_plan, _), (plan, _) = _plans("d4e0", backend, capsys)
    assert plan == ref_plan and plan[:2] == ("bitpack", "table")
    monkeypatch.setenv("KMLS_DISPATCH_TABLE", str(tmp_path / "missing.json"))
    (ref_plan, _), (plan, _) = _plans("d4e0", backend, capsys)
    assert plan == ref_plan and plan[1] == "heuristic"


def test_packaged_table_is_the_reference_copy():
    """The reference's cells, byte for byte, plus the ``gpu`` cells the
    density sweep banked on the H100 (``mining/sweep.py``)."""
    port, ref = dispatch.load_table(), ref_dispatch.load_table()
    assert sorted(ref["backends"]) == ["cpu"]
    assert sorted(port["backends"]) == ["cpu", "gpu"]
    assert json.dumps(port["backends"]["cpu"], indent=1, sort_keys=True) == \
        json.dumps(ref["backends"]["cpu"], indent=1, sort_keys=True)
    assert {k: v for k, v in port.items() if k not in ("backends", "banked_at")} == \
        {k: v for k, v in ref.items() if k not in ("backends", "banked_at")}
    gpu = port["backends"]["gpu"]
    assert gpu["measured_on"].endswith("/NVIDIA H100 80GB HBM3")
    assert gpu["cells"] and all(c["identical"] for c in gpu["cells"].values())
    assert all(c["path"] in dispatch.PATHS for c in gpu["cells"].values())


@pytest.mark.parametrize("density,elems", [
    (0.0, 0), (0.0001, 1 << 22), (0.00011, (1 << 22) + 1), (0.03, 1 << 26),
    (0.05, 1 << 30), (0.5, 1 << 31),
])
def test_table_cell_matches_reference(density, elems):
    assert dispatch.table_cell(density, elems) == ref_dispatch.table_cell(density, elems)


@pytest.mark.parametrize("args", [
    (1000, None, GIB, 0, 256, "cpu"), (1000, 10**6, GIB, 0, 256, "cpu"),
    (1000, 10**8, GIB, 0, 256, "cpu"), (1000, 10**6, GIB, 5, 256, "cpu"),
    (1000, 10**6, GIB, 0, 256, "gpu"), (20_000, 10**6, GIB, 0, 256, "gpu"),
])
def test_sparse_feasible_matches_reference(args):
    assert dispatch.sparse_feasible(*args) == ref_dispatch.sparse_feasible(*args)


WANTED = [
    (2246, 424, "auto", 12 * GIB, 1, 0), (2246, 424, 1, 12 * GIB, 1, 0),
    (2246, 424, None, 12 * GIB, 1, 0), (2246, 424, "none", 12 * GIB, 1, 0),
    (2246, 424, 10**9, 12 * GIB, 1, 0), (100_000, 2000, "auto", 12 * GIB, 1, 0),
    (1_000_000, 8124, "auto", 12 * GIB, 1, 50_000_000),
    (1_000_000, 8124, "auto", 12 * GIB, 2, 50_000_000),
    (1_000_000, 8124, "auto", 4 * GIB, 1, 50_000_000),  # dense does not fit
    (1_000_000, 100_000, "auto", 4 * GIB, 1, 10**8),  # neither fits: WARNING
]


@pytest.mark.parametrize("backend", [None, "cpu", "gpu", "tpu"])
@pytest.mark.parametrize("p,v,threshold,budget,n_devices,n_rows", WANTED)
def test_bitpack_wanted_matches_reference(p, v, threshold, budget, n_devices, n_rows, backend, capsys):
    kw = dict(hbm_budget_bytes=budget, n_devices=n_devices, n_rows=n_rows, backend=backend)
    want = ref_miner.bitpack_wanted(p, v, threshold, **kw)
    ref_out = capsys.readouterr().out
    assert miner.bitpack_wanted(p, v, threshold, **kw) == want
    assert capsys.readouterr().out == ref_out


def test_bitpack_wanted_rejects_unknown_words():
    for fn in (miner.bitpack_wanted, ref_miner.bitpack_wanted):
        with pytest.raises(ValueError, match="bitpack threshold"):
            fn(10, 10, "sometimes")


@pytest.mark.parametrize("tiles", [None, ("16", "64", "128"), ("8", "24", "5")])
@pytest.mark.parametrize("p,v,n_devices,n_rows", [
    (2246, 424, 1, 0), (2246, 1084, 1, 100_000), (1_000_000, 8124, 2, 50_000_000),
    (1, 1, 1, 0),
])
def test_bitpack_plan_bytes_matches_reference(p, v, n_devices, n_rows, tiles, monkeypatch):
    """The footprint uses the port's own padded_shape / word_chunk, pinned
    equal to the reference's under the tile knobs too."""
    if tiles:
        for key, value in zip(("TILE_I", "TILE_J", "WORD_CHUNK"), tiles):
            monkeypatch.setenv(f"KMLS_POPCOUNT_{key}", value)
    kw = dict(n_devices=n_devices, n_rows=n_rows)
    assert miner.bitpack_plan_bytes(p, v, **kw) == ref_miner.bitpack_plan_bytes(p, v, **kw)


def test_backend_name():
    assert backend_name("cpu") == "cpu"
    assert backend_name("cuda") == "gpu"
    assert backend_name("cuda:1") == "gpu"
    with pytest.raises(ValueError):
        backend_name("meta")


def test_config_reads_the_dispatch_knobs(monkeypatch):
    from kmlserver_tpu.config import MiningConfig as Ref

    env = {
        "KMLS_MAX_ITEMSET_LEN": "4", "KMLS_BITPACK_THRESHOLD_ELEMS": "12345",
        "KMLS_HBM_BUDGET_BYTES": "999", "KMLS_COUNT_PATH": "sparse",
        "KMLS_DISPATCH_TABLE": "/x/t.json", "KMLS_SPARSE_LONG_BASKET": "64",
    }
    fields = ("max_itemset_len", "bitpack_threshold_elems", "hbm_budget_bytes",
              "count_path", "dispatch_table", "sparse_long_basket")
    for key in env:
        monkeypatch.delenv(key, raising=False)
    port, ref = MiningConfig.from_env(None), Ref.from_env(None)
    assert [getattr(port, f) for f in fields] == [getattr(ref, f) for f in fields]
    for word in ("auto", "none", "never", " NEVER ", "77"):
        monkeypatch.setenv("KMLS_BITPACK_THRESHOLD_ELEMS", word)
        assert (MiningConfig.from_env(None).bitpack_threshold_elems
                == Ref.from_env(None).bitpack_threshold_elems)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    port, ref = MiningConfig.from_env(None), Ref.from_env(None)
    assert [getattr(port, f) for f in fields] == [getattr(ref, f) for f in fields]


# ---------------------------------------------------------------- whole mines


@pytest.fixture(scope="module")
def data():
    """One small synthetic (a vocabulary above the prune threshold), as the
    reference's baskets and the port's."""
    ref = ref_synthetic_baskets(n_playlists=400, n_tracks=600, target_rows=8000, seed=11)
    names = list(ref.vocab.names)
    port = Baskets(
        playlist_rows=ref.playlist_rows.copy(), track_ids=ref.track_ids.copy(),
        n_playlists=ref.n_playlists,
        vocab=Vocab(names=names, index={n: i for i, n in enumerate(names)}),
    )
    return ref, port


# phase 7's list on the card, plus the overrides the census forces
SETTINGS = {
    "auto": {},
    "dense": dict(count_path="dense"),
    "bitpack": dict(count_path="bitpack"),
    "sparse": dict(count_path="sparse"),
    "sparse_long": dict(count_path="sparse", sparse_long_basket=24),
    "conf3": dict(confidence_mode="confidence", max_itemset_len=3, min_support=0.05),
    "conf4": dict(confidence_mode="confidence", max_itemset_len=4, min_support=0.05),
    "conf4_low": dict(confidence_mode="confidence", max_itemset_len=4, min_support=0.02),
    "census3": dict(max_itemset_len=3),
    "census4": dict(max_itemset_len=4, min_support=0.02),
    "conf5": dict(confidence_mode="confidence", max_itemset_len=5),
    "conf3_sparse": dict(confidence_mode="confidence", max_itemset_len=3, count_path="sparse"),
    "conf3_threshold": dict(confidence_mode="confidence", max_itemset_len=3,
                            bitpack_threshold_elems=1),
    # dense does not fit: the bit-packed route stays, the merge is skipped
    "conf3_no_fit": dict(confidence_mode="confidence", max_itemset_len=3,
                         count_path="bitpack", hbm_budget_bytes=1000),
    "conf_len2": dict(confidence_mode="confidence", min_confidence=0.1),
}


def _mine_both(data, capsys, **cfg):
    ref_b, port_b = data
    ref = ref_miner.mine(ref_b, RefMiningConfig(native_cpu_pair_counts=False, **cfg))
    ref_out = capsys.readouterr().out
    # the native counter off on both sides (test_torch_native.py has its route)
    port = miner.mine(port_b, MiningConfig(native_cpu_pair_counts=False, **cfg), device="cpu")
    out = capsys.readouterr().out
    return ref, ref_out, port, out


def _warnings(text):
    return [line for line in text.splitlines() if line.startswith("WARNING")]


def _assert_same(ref, port):
    assert port.count_path == ref.count_path.replace("bitpack-mxu", "bitpack-torch")
    assert port.count_path_source == ref.count_path_source
    assert port.itemset_census == ref.itemset_census
    assert port.triple_merge_applied == ref.triple_merge_applied
    assert port.sparse_events == ref.sparse_events
    assert port.vocab_names == ref.vocab_names
    assert (port.n_playlists, port.n_tracks, port.pruned_vocab) == (
        ref.n_playlists, ref.n_tracks, ref.pruned_vocab)
    pt, rt = port.tensors, ref.tensors
    for key in ("rule_ids", "rule_counts", "rule_confs", "item_counts", "row_valid_counts"):
        got, want = getattr(pt, key), np.asarray(getattr(rt, key))
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert (pt.rule_confs64 is None) == (rt.rule_confs64 is None)
    if rt.rule_confs64 is not None:
        np.testing.assert_array_equal(pt.rule_confs64, rt.rule_confs64)
    for key in ("min_count", "mode", "min_confidence", "n_frequent_items",
                "n_songs_missing", "overflow_rows", "n_playlists", "min_support"):
        assert getattr(pt, key) == getattr(rt, key), key


@pytest.mark.parametrize("name", list(SETTINGS))
def test_mine_matches_reference(name, data, capsys):
    ref, ref_out, port, out = _mine_both(data, capsys, **SETTINGS[name])
    _assert_same(ref, port)
    assert _warnings(out) == _warnings(ref_out)


def test_settings_cover_every_route_and_outcome(data, capsys):
    """The settings above are not vacuous on this data."""
    seen = {}
    for name, cfg in SETTINGS.items():
        _, _, port, _ = _mine_both(data, capsys, **cfg)
        seen[name] = port
    assert seen["auto"].count_path == "dense-fused"
    assert seen["dense"].count_path == "dense-fused"
    assert seen["bitpack"].count_path == "bitpack-torch"
    assert seen["sparse"].count_path == "sparse-hybrid"
    assert seen["conf3"].count_path == "dense" and seen["conf3"].triple_merge_applied
    assert seen["conf4"].itemset_census[4] >= 0  # the quad merge ran
    assert seen["conf3_sparse"].count_path_source == "census-override"
    assert seen["conf3_threshold"].count_path_source == "census-override"
    assert seen["conf3_no_fit"].triple_merge_applied is False
    assert seen["conf3_no_fit"].itemset_census[3] == -1
    assert seen["conf3"].tensors.rule_confs64 is not None
    # the long-basket guard split some baskets out of the pair expansion
    lengths = np.bincount(data[1].playlist_rows)
    assert (lengths > 24).any() and (lengths <= 24).any()


@pytest.mark.parametrize("pair_cap,triple_cap", [(8, None), (None, 4)])
def test_mine_capacity_overflow_matches_reference(pair_cap, triple_cap, data, capsys, monkeypatch):
    """Frequent pairs (triples) over capacity: the triple (quad) merge is
    skipped with the reference's WARNING and the census says -1."""
    if pair_cap:
        monkeypatch.setattr(miner, "PAIR_CAPACITY", pair_cap)
        monkeypatch.setattr(ref_miner.compute_triple_extension, "__defaults__", (pair_cap,))
    if triple_cap:
        monkeypatch.setattr(miner, "TRIPLE_CAPACITY", triple_cap)
        monkeypatch.setattr(ref_miner.compute_quad_extension, "__defaults__", (triple_cap,))
    for cfg in (SETTINGS["conf4_low"], SETTINGS["census4"]):
        ref, ref_out, port, out = _mine_both(data, capsys, **cfg)
        _assert_same(ref, port)
        assert _warnings(out) == _warnings(ref_out)
        assert -1 in port.itemset_census.values()
        if pair_cap and cfg is SETTINGS["conf4_low"]:
            assert port.triple_merge_applied is False
            assert "(frequent pairs exceed capacity)" in out
        if triple_cap and cfg is SETTINGS["conf4_low"]:
            assert "quad-rule merge skipped" in out


@pytest.mark.parametrize("name", ["auto", "sparse", "conf3", "census4", "conf_len2"])
def test_mine_on_a_rank_mesh_matches_reference(name, data, capsys):
    """A one-rank mesh here, the reference's 2x1 device mesh there: the
    port takes the sharded route the reference takes (the bit-packed one
    named with its ``-torch`` suffix), with the same tensors; with
    max_itemset_len >= 3 neither has a one-hot, so both report the census
    and skip the merge the same way."""
    from kmlserver_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from kmlserver_tpu_torch.parallel.mesh import make_mesh

    ref_b, port_b = data
    cfg = SETTINGS[name]
    ref = ref_miner.mine(ref_b, RefMiningConfig(native_cpu_pair_counts=False, **cfg),
                         mesh=ref_make_mesh("2x1", devices=jax.devices()[:2]))
    ref_out = capsys.readouterr().out
    port = miner.mine(port_b, MiningConfig(**cfg), device="cpu", mesh=make_mesh("auto"))
    out = capsys.readouterr().out
    if ref.count_path == "sharded-bitpack":
        ref.count_path = "sharded-bitpack-torch"
    _assert_same(ref, port)
    assert _warnings(out) == _warnings(ref_out)
    if cfg.get("max_itemset_len", 2) >= 3:
        assert port.itemset_census[3] == -1
    if name == "conf3":
        assert port.triple_merge_applied is False
        assert "(one-hot matrix not materialized on the sharded/bit-packed path)" in out


@pytest.mark.parametrize("max_len", [2, 3])
def test_mine_nothing_frequent_in_a_large_vocab(max_len, capsys):
    ref_b = ref_synthetic_baskets(n_playlists=200, n_tracks=5000, target_rows=2000, seed=2)
    names = list(ref_b.vocab.names)
    port_b = Baskets(ref_b.playlist_rows, ref_b.track_ids, ref_b.n_playlists,
                     Vocab(names=names, index={n: i for i, n in enumerate(names)}))
    cfg = dict(min_support=0.9, max_itemset_len=max_len)
    ref, _, port, _ = _mine_both((ref_b, port_b), capsys, **cfg)
    assert port.count_path == ref.count_path == "pruned-empty"
    assert port.itemset_census == ref.itemset_census
    assert port.tensors.rule_ids.shape == ref.tensors.rule_ids.shape


def test_mine_on_ds2_reproduces_the_reference_census(capsys):
    """The ds2-shaped baskets (seed 7) at the reference's confserve
    settings: the census the reference prints, and the same tensors."""
    from kmlserver_tpu_torch.data.synthetic import DS2_SHAPE, synthetic_baskets

    port_b = synthetic_baskets(**DS2_SHAPE, seed=7)
    ref_b = ref_synthetic_baskets(**DS2_SHAPE, seed=7)
    cfg = dict(confidence_mode="confidence", max_itemset_len=3, min_support=0.05)
    ref, _, port, _ = _mine_both((ref_b, port_b), capsys, **cfg)
    _assert_same(ref, port)
    assert port.itemset_census == {1: 424, 2: 12623, 3: 150547}
    assert port.count_path == "dense" and port.triple_merge_applied


# ---------------------------------------------------------------- the job


def test_job_confidence_len3_matches_reference(tmp_path):
    csv_name = "2023_spotify_ds_synth.csv"
    csv_path = str(tmp_path / csv_name)
    ref_write_tracks_csv(
        csv_path, synthetic_table(n_playlists=300, n_tracks=800, target_rows=6000, seed=5)
    )
    kw = dict(confidence_mode="confidence", max_itemset_len=3)
    logs = []
    for side in ("ref", "port"):
        base = tmp_path / side
        os.makedirs(base / "datasets")
        shutil.copy(csv_path, base / "datasets" / csv_name)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if side == "ref":
                ref_run_mining_job(RefMiningConfig(
                    base_dir=str(base), datasets_dir=str(base / "datasets"),
                    native_cpu_pair_counts=False, **kw))
            else:
                summary = run_mining_job(MiningConfig(
                    base_dir=str(base), datasets_dir=str(base / "datasets"), **kw),
                    device="cpu")
        logs.append(out.getvalue())
    census = [[line for line in log.splitlines() if line.startswith("Frequent itemsets")]
              for log in logs]
    assert census[0] and census[0] == census[1]
    paths = [[line for line in log.splitlines() if line.startswith("Pair-count path")]
             for log in logs]
    assert paths[0] and paths[0] == paths[1]
    assert summary.count_path == paths[0][0].split(": ")[1]
    npz = "pickles/recommendations.pickle.tensors.npz"
    a = np.load(tmp_path / "ref" / npz, allow_pickle=True)
    b = np.load(tmp_path / "port" / npz, allow_pickle=True)
    assert a.files == b.files and "rule_confs64" in a.files
    for key in a.files:
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    pickles = "pickles/recommendations.pickle"
    with open(tmp_path / "ref" / pickles, "rb") as fh_a, open(tmp_path / "port" / pickles, "rb") as fh_b:
        assert pickle.load(fh_a) == pickle.load(fh_b)
