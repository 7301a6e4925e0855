"""The vocab-sharded mining of the port (``parallel/support.py``'s dense
sharded counts, the slab emission and the sparse-sharded route, the
vocab-sharded ALS of ``mining/als.py``) held against the JAX package's.

The port runs on real ranks: one gloo group of 2 processes and one of 4 on
the CPU (``run_gloo_ranks``), each rank on the meshes ``1x2`` / ``2x1`` or
``1x4`` / ``2x2`` / ``4x1`` in turn, for every schedule (``gspmd``,
``allgather``, ``ring``). The reference runs the same functions in process
on meshes of the same shape over the virtual CPU devices. The baskets come
from a numpy seed and cover the padding cases: V no multiple of ``tp``
(nor of ``8·tp``), P no multiple of ``dp``, and a vocabulary smaller than
``k_max``. Counts and rule tensors are integers: every comparison of them
is exact, on every rank. The sharded ALS is held to the reference's own
bar (``tests/test_shard_layout.py:391-411``): factors within
``rtol=2e-4, atol=2e-5`` of the dense training, the loss within
``rel=1e-4``, bit-identical from one run to the next and to its plain
version in one process. A sharded job killed after ``mine`` resumes to the
uninterrupted run's bytes. The delta recount over the ranks
(``restricted_pair_counts`` with a mesh) equals the reference's mesh
recount, the one-rank recount and its plain version, on every rank.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import time

import jax
import numpy as np
import pytest
import torch

from kmlserver_tpu.config import MiningConfig as RefMiningConfig
from kmlserver_tpu.data.csv import write_tracks_csv
from kmlserver_tpu.data.synthetic import synthetic_table
from kmlserver_tpu.mining import als as ref_als
from kmlserver_tpu.mining import miner as ref_miner
from kmlserver_tpu.mining.vocab import build_baskets as ref_build_baskets
from kmlserver_tpu.parallel import support as ref_support
from kmlserver_tpu.parallel.mesh import make_mesh as ref_make_mesh
from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.io import artifacts
from kmlserver_tpu_torch.mining import als, miner
from kmlserver_tpu_torch.mining.pipeline import run_mining_job
from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
from kmlserver_tpu_torch.ops.support import min_count_for
from kmlserver_tpu_torch.parallel import support
from kmlserver_tpu_torch.parallel.mesh import make_mesh

from .test_torch_parallel import RANK_TIMEOUT_S, _start_ranks, run_gloo_ranks
from .test_torch_sharded_job import _JOB_RANK

IMPLS = ("gspmd", "allgather", "ring")
MESHES = {2: ("1x2", "2x1"), 4: ("1x4", "2x2", "4x1")}
# name → (synthetic_table kwargs, min_support, k_max, long-basket threshold)
DATA = {
    "300x220": (dict(n_playlists=300, n_tracks=220, target_rows=5400, seed=9), 0.01, 24, 12),
    "41x13": (dict(n_playlists=41, n_tracks=13, target_rows=160, seed=3), 0.05, 256, 4),
}
# the mines on the ranks: (name, MiningConfig knobs)
MINES = (
    ("vocab-auto", dict(model_layout="sharded")),
    ("vocab-ring", dict(model_layout="sharded", count_path="dense", sharded_impl="ring")),
    ("vocab-allgather", dict(model_layout="sharded", count_path="dense",
                             sharded_impl="allgather")),
    ("sparse-sharded", dict(model_layout="sharded", count_path="sparse")),
    ("dense-replicated", dict(count_path="dense")),
    ("staged-len3", dict(model_layout="sharded", count_path="dense", max_itemset_len=3,
                         sharded_impl="ring")),
)
ALS_KNOBS = dict(embed_enabled=True, als_rank=8, als_iters=4)
AUTO_KNOBS = dict(embed_enabled=True, als_rank=4, als_iters=2, model_layout="auto")
ALS_DATA = dict(n_playlists=90, n_tracks=45, target_rows=1400, seed=7)
RULE_FIELDS = ("rule_ids", "rule_counts", "rule_confs", "item_counts", "row_valid_counts")
# one intra-op thread per rank: the ranks' products are tiny, and a group of
# four at the machine's width would crowd the suite's other workers
RANK_ENV = dict(OMP_NUM_THREADS="1")

_WORKER = r"""
import contextlib, io, json, os, sys

import numpy as np

rank, world, port, indir, outdir = sys.argv[1:6]
os.environ.update(
    KMLS_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", KMLS_NUM_PROCESSES=world,
    KMLS_PROCESS_ID=rank,
)
from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.mining import als, miner
from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
from kmlserver_tpu_torch.parallel import support
from kmlserver_tpu_torch.parallel.distributed import maybe_initialize, shutdown
from kmlserver_tpu_torch.parallel.mesh import make_mesh

assert maybe_initialize(device="cpu", timeout_s=120)
spec = json.load(open(os.path.join(indir, "spec.json")))


def baskets(name):
    case = np.load(os.path.join(indir, f"{name}.npz"))
    names = [str(i) for i in range(int(case["n_tracks"]))]
    return Baskets(playlist_rows=case["playlist_rows"], track_ids=case["track_ids"],
                   n_playlists=int(case["n_playlists"]),
                   vocab=Vocab(names=names, index={n: i for i, n in enumerate(names)}))


for shape in spec["meshes"]:
    grid = make_mesh(shape)
    for name, (min_count, k_max, long) in spec["data"].items():
        b = baskets(name)
        out = {}
        for impl in spec["impls"]:
            out[f"counts_{impl}"] = support.sharded_pair_counts(b, grid, impl, device="cpu").numpy()
            emitted = support.sharded_rule_tensors(b, grid, min_count, k_max, impl, device="cpu")
            for key, arr in zip(("ids", "counts", "valid", "items"), emitted):
                out[f"rules_{impl}_{key}"] = arr
        emitted = support.sparse_sharded_rule_tensors(
            b, grid, min_count, k_max, long_basket_threshold=long, device="cpu")
        for key, arr in zip(("ids", "counts", "valid", "items"), emitted):
            out[f"sparse_{key}"] = arr
        rows = np.asarray(spec["recount_rows"][name], dtype=np.int32)
        out["recount"] = support.restricted_pair_counts(b, rows, device="cpu", mesh=grid)
        logs = {}
        for label, knobs in spec["mines"]:
            knobs = dict(knobs, min_support=spec["support"][name], k_max_consequents=k_max,
                         prune_vocab_threshold=10_000)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                result = miner.mine(b, MiningConfig(**knobs), device="cpu", mesh=grid)
            logs[label] = [result.count_path, buf.getvalue()]
            for field in spec["rule_fields"]:
                out[f"mine_{label}_{field}"] = getattr(result.tensors, field)
        np.savez(os.path.join(outdir, f"{shape}.{name}.rank{rank}.npz"), **out)
        with open(os.path.join(outdir, f"{shape}.{name}.rank{rank}.json"), "w") as fh:
            json.dump(logs, fh)
    if grid.shape["tp"] > 1:
        b = baskets("als")
        cfg = MiningConfig(model_layout="sharded", **spec["als"])
        runs = [als.train_embeddings(b, cfg, mesh=grid, device="cpu") for _ in range(2)]
        # a budget between the per-shard slab and one device's: auto shards
        budget = (4 if grid.shape["tp"] == 2 else 3) * b.n_playlists * b.n_tracks
        auto = als.train_embeddings(b, MiningConfig(**spec["auto"], hbm_budget_bytes=budget),
                                    mesh=grid, device="cpu")
        np.savez(os.path.join(outdir, f"{shape}.als.rank{rank}.npz"),
                 one=runs[0]["item_factors"], two=runs[1]["item_factors"],
                 auto=auto["item_factors"],
                 meta=np.array([runs[0]["shards"], runs[0]["final_loss"], auto["shards"]]))
shutdown()
print(f"RANK {rank} DONE", flush=True)
"""


def _both(table_kwargs: dict):
    """The same synthetic baskets as the reference's and the port's."""
    ref_b = ref_build_baskets(synthetic_table(**table_kwargs))
    names = list(ref_b.vocab.names)
    port_b = Baskets(ref_b.playlist_rows, ref_b.track_ids, ref_b.n_playlists,
                     Vocab(names=names, index={n: i for i, n in enumerate(names)}))
    return ref_b, port_b


def _save(path, b: Baskets) -> None:
    np.savez(path, playlist_rows=b.playlist_rows, track_ids=b.track_ids,
             n_playlists=b.n_playlists, n_tracks=b.n_tracks)


@pytest.fixture(scope="module")
def data():
    return {name: _both(kw) for name, (kw, *_rest) in DATA.items()} | {"als": _both(ALS_DATA)}


def _recount_rows(v: int) -> list[int]:
    """Delta-recount rows: unsorted, one repeated, both vocabulary ends."""
    return [v - 1, 0, 5 % v, 5 % v, (v * 2) // 3, 1 % v]


def _min_count(name, data) -> int:
    return min_count_for(DATA[name][1], data[name][1].n_playlists)


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """{(mesh, data name): [per-rank npz dict]}, {(mesh, data): [per-rank
    mine logs]} and {mesh: [per-rank ALS npz]} from one gloo group per
    world size."""
    root = tmp_path_factory.mktemp("shard_layout")
    spec = {
        "impls": IMPLS, "rule_fields": RULE_FIELDS, "als": ALS_KNOBS, "auto": AUTO_KNOBS,
        "data": {name: (_min_count(name, data), k, long)
                 for name, (_, _, k, long) in DATA.items()},
        "support": {name: sup for name, (_, sup, _, _) in DATA.items()},
        "mines": MINES,
        "recount_rows": {name: _recount_rows(data[name][1].n_tracks) for name in DATA},
    }
    arrays, logs, trained = {}, {}, {}
    for world, meshes in MESHES.items():
        indir, outdir = root / f"in{world}", root / f"out{world}"
        indir.mkdir()
        outdir.mkdir()
        for name, (_, port_b) in data.items():
            _save(indir / f"{name}.npz", port_b)
        (indir / "spec.json").write_text(json.dumps(dict(spec, meshes=meshes)))
        outs = run_gloo_ranks(world, _WORKER, [str(indir), str(outdir)], env=RANK_ENV)
        assert all(f"RANK {r} DONE" in out for r, out in enumerate(outs)), outs
        for shape in meshes:
            for name in DATA:
                stem = f"{shape}.{name}.rank"
                arrays[shape, name] = [dict(np.load(outdir / f"{stem}{r}.npz"))
                                       for r in range(world)]
                logs[shape, name] = [json.loads((outdir / f"{stem}{r}.json").read_text())
                                     for r in range(world)]
            if not shape.endswith("x1"):
                trained[shape] = [dict(np.load(outdir / f"{shape}.als.rank{r}.npz"))
                                  for r in range(world)]
    return arrays, logs, trained


def _ref_mesh(shape: str):
    dp, tp = (int(n) for n in shape.split("x"))
    return ref_make_mesh((dp, tp), devices=jax.devices()[:dp * tp])


ALL_MESHES = [m for meshes in MESHES.values() for m in meshes]
CASES = [(m, name) for m in ALL_MESHES for name in DATA]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape,name", CASES)
def test_sharded_pair_counts_equal_the_reference(shape, name, impl, ranks, data):
    """Every schedule on every mesh: the counts on every rank equal the
    reference's sharded counts on a mesh of that shape, and the plain
    version in one process."""
    arrays, _, _ = ranks
    ref_b, port_b = data[name]
    want = np.asarray(ref_support.sharded_pair_counts(ref_b, _ref_mesh(shape), impl=impl))
    dp, tp = (int(n) for n in shape.split("x"))
    plain = support.sharded_pair_counts_plain(port_b, dp, tp).numpy()
    v = port_b.n_tracks
    np.testing.assert_array_equal(plain[:v, :v], want)
    assert not plain[v:].any() and not plain[:, v:].any()
    for rank, got in enumerate(arrays[shape, name]):
        np.testing.assert_array_equal(got[f"counts_{impl}"], want, err_msg=f"rank {rank}")


@pytest.mark.parametrize("shape,name", CASES)
def test_restricted_recount_over_ranks_equals_the_reference(shape, name, ranks, data):
    """The delta recount with a mesh: on every rank, the reference's mesh
    recount of the same rows (``_restricted_counts_fn``), the one-rank
    recount and the plain version in one process — at any size (no host
    shortcut under a mesh)."""
    arrays, _, _ = ranks
    ref_b, port_b = data[name]
    rows = np.asarray(_recount_rows(port_b.n_tracks), dtype=np.int32)
    want = np.asarray(ref_support.restricted_pair_counts(ref_b, rows, mesh=_ref_mesh(shape)))
    np.testing.assert_array_equal(support.restricted_pair_counts(port_b, rows, device="cpu"), want)
    dp, tp = (int(n) for n in shape.split("x"))
    np.testing.assert_array_equal(
        support.restricted_counts_sharded_plain(port_b, rows, dp, tp), want)
    for rank, got in enumerate(arrays[shape, name]):
        np.testing.assert_array_equal(got["recount"], want, err_msg=f"rank {rank}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape,name", CASES)
def test_sharded_rule_tensors_equal_the_reference(shape, name, impl, ranks, data):
    """The vocab-sharded emission on every rank: the reference's
    ``sharded_rule_tensors`` on the same mesh shape, bit for bit, and the
    plain emission over the plain counts' blocks."""
    arrays, _, _ = ranks
    ref_b, port_b = data[name]
    min_count, k_max = _min_count(name, data), DATA[name][2]
    want = ref_support.sharded_rule_tensors(ref_b, _ref_mesh(shape), min_count, k_max,
                                            impl=impl)
    dp, tp = (int(n) for n in shape.split("x"))
    plain = support.emit_slabs_plain(support.sharded_pair_counts_plain(port_b, dp, tp), tp,
                                     port_b.n_tracks, min_count, k_max)
    for key, w, p in zip(("ids", "counts", "valid", "items"), want, plain):
        np.testing.assert_array_equal(p, w, err_msg=key)
        for rank, got in enumerate(arrays[shape, name]):
            np.testing.assert_array_equal(got[f"rules_{impl}_{key}"], w,
                                          err_msg=f"rank {rank} {key}")
    if name == "41x13":
        assert port_b.n_tracks < k_max and (want[0] >= 0).sum() > 0


@pytest.mark.parametrize("shape,name", CASES)
def test_sparse_sharded_rule_tensors_equal_the_reference(shape, name, ranks, data):
    """The sparse count fed to the same emission, with a long-basket
    threshold that sends baskets through the long block."""
    arrays, _, _ = ranks
    ref_b, port_b = data[name]
    min_count, k_max, long = _min_count(name, data), DATA[name][2], DATA[name][3]
    assert np.bincount(port_b.playlist_rows).max() > long
    want = ref_support.sparse_sharded_rule_tensors(ref_b, _ref_mesh(shape), min_count, k_max,
                                                   long_basket_threshold=long)
    for key, w in zip(("ids", "counts", "valid", "items"), want):
        for rank, got in enumerate(arrays[shape, name]):
            np.testing.assert_array_equal(got[f"sparse_{key}"], w, err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("label", [label for label, _ in MINES])
@pytest.mark.parametrize("shape,name", CASES)
def test_mine_routes_and_tensors_equal_the_reference(shape, name, label, ranks, data, capsys,
                                                     monkeypatch):
    """``mine`` on the ranks names the reference's route for the same
    settings on the same mesh shape, prints no ``NOTE:``, and its tensors
    equal the reference's on every rank. Each rank is a process, so the
    reference runs as over processes too: it then keeps an ``Nx1`` mesh
    under the sharded layout instead of rewriting it to ``1xN``
    (``kmlserver_tpu/parallel/layout.py:120-125``), as the port does."""
    arrays, logs, _ = ranks
    ref_b, _ = data[name]
    knobs = dict(dict(MINES)[label], min_support=DATA[name][1],
                 k_max_consequents=DATA[name][2], prune_vocab_threshold=10_000)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    ref = ref_miner.mine(ref_b, RefMiningConfig(native_cpu_pair_counts=False, **knobs),
                         mesh=_ref_mesh(shape))
    capsys.readouterr()
    for rank, (path, out) in enumerate(log[label] for log in logs[shape, name]):
        assert path == ref.count_path, (rank, path, ref.count_path)
        assert "NOTE:" not in out, out
        for field in RULE_FIELDS:
            np.testing.assert_array_equal(arrays[shape, name][rank][f"mine_{label}_{field}"],
                                          getattr(ref.tensors, field),
                                          err_msg=f"rank {rank} {field}")
    if label.startswith("vocab") and shape.startswith("1x"):
        assert path.startswith("sharded-vocab-")
    if label == "sparse-sharded" and not shape.endswith("x1"):
        assert path == "sparse-sharded"
    if label == "dense-replicated":
        assert path == "sharded-dense-gspmd"


@pytest.mark.parametrize("shape", [m for m in ALL_MESHES if not m.endswith("x1")])
def test_sharded_als_meets_the_reference_bar(shape, ranks, data):
    """The vocab-sharded ALS on the ranks: ``shards == tp``, the same
    factors on every rank, bit-identical across two runs and to the plain
    version in one process, within the reference's bar of the dense
    training (the port's and the reference's) and of the reference's
    sharded training on the same mesh shape."""
    _, _, trained = ranks
    ref_b, port_b = data["als"]
    tp = int(shape.split("x")[1])
    cfg = MiningConfig(**ALS_KNOBS)
    dense = als.train_embeddings(port_b, cfg, device="cpu")
    ref_dense = ref_als.train_embeddings(ref_b, RefMiningConfig(**ALS_KNOBS))
    ref_sharded = ref_als.train_embeddings(
        ref_b, RefMiningConfig(model_layout="sharded", **ALS_KNOBS), mesh=_ref_mesh(shape))
    rng = np.random.default_rng(0)
    user_init = (rng.standard_normal((port_b.n_playlists, 8)).astype(np.float32)
                 / np.sqrt(8)).astype(np.float32)
    item_init = (rng.standard_normal((port_b.n_tracks, 8)).astype(np.float32)
                 / np.sqrt(8)).astype(np.float32)
    plain_raw, plain_loss = als.train_sharded_plain(
        port_b, user_init, item_init, torch.tensor(0.1, dtype=torch.float32), 4, tp)
    plain = als.normalize_factors(plain_raw)
    first = trained[shape][0]
    shards, loss, auto_shards = first["meta"]
    assert shards == tp and auto_shards == tp
    assert loss == pytest.approx(plain_loss, rel=1e-6)
    for rank, got in enumerate(trained[shape]):
        np.testing.assert_array_equal(got["one"], first["one"], err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["two"], got["one"], err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["auto"], first["auto"], err_msg=f"rank {rank}")
    np.testing.assert_array_equal(first["one"], plain)
    # auto trains, sharded, what one device's guard would skip
    auto_dense = als.train_embeddings(port_b, MiningConfig(**dict(AUTO_KNOBS, model_layout=
                                                                  "replicated")), device="cpu")
    np.testing.assert_allclose(first["auto"], auto_dense["item_factors"], rtol=2e-4, atol=2e-5)
    for want in (dense, ref_dense, ref_sharded):
        np.testing.assert_allclose(first["one"], want["item_factors"], rtol=2e-4, atol=2e-5)
        assert loss == pytest.approx(want["final_loss"], rel=1e-4)


def test_auto_layout_trains_what_one_device_would_skip(data):
    """The budget sits between the one-device slab and the per-shard one:
    alone the guard skips (as the reference's does), the sharded decision
    trains."""
    ref_b, port_b = data["als"]
    p, v = port_b.n_playlists, port_b.n_tracks
    knobs = dict(model_layout="auto", hbm_budget_bytes=3 * p * v, als_rank=4, als_iters=2)
    alone = als.train_embeddings(port_b, MiningConfig(**knobs), device="cpu")
    ref_alone = ref_als.train_embeddings(ref_b, RefMiningConfig(**knobs))
    assert alone["item_factors"] is None and ref_alone["item_factors"] is None
    assert alone["skipped"] == ref_alone["skipped"]
    mesh = make_mesh("1x1")
    assert als._als_shards(MiningConfig(**knobs), mesh, p, v, 4) == 1
    grid = dataclasses.replace(mesh, grid=((0, 1, 2, 3),))
    assert als._als_shards(MiningConfig(**knobs), grid, p, v, 4) == 4


@pytest.mark.parametrize("value,error", [
    ("gspmd", None), ("allgather", None), ("ring", None), ("bogus", ValueError), ("", ValueError),
])
def test_sharded_impl_knob_parses_and_fails_where_the_reference_does(value, error, data,
                                                                    monkeypatch):
    """``KMLS_SHARDED_IMPL`` reaches the config as the reference reads it,
    stays out of the checkpoint fingerprint, and an unknown schedule raises
    the reference's ``ValueError`` when the count starts."""
    from kmlserver_tpu.config import MiningConfig as RefConfig
    from kmlserver_tpu_torch.mining import checkpoint as ckpt_mod

    monkeypatch.setenv("KMLS_SHARDED_IMPL", value)
    cfg = MiningConfig.from_env()
    assert cfg.sharded_impl == RefConfig.from_env().sharded_impl == value
    assert "sharded_impl" not in ckpt_mod._FINGERPRINT_FIELDS
    ref_b, port_b = data["41x13"]
    if error is None:
        got = support.sharded_pair_counts(port_b, make_mesh("1x1"), value, device="cpu")
        assert got.shape == (port_b.n_tracks,) * 2
        return
    with pytest.raises(error) as want:
        ref_support.sharded_pair_counts(ref_b, _ref_mesh("1x2"), impl=value)
    with pytest.raises(error) as got:
        miner.mine(port_b, MiningConfig(count_path="dense", sharded_impl=value), device="cpu",
                   mesh=make_mesh("1x1"))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- the sharded job

JOB_ENV = dict(KMLS_MESH_SHAPE="hybrid", KMLS_MODEL_LAYOUT="sharded",
               KMLS_K_MAX_CONSEQUENTS="32", KMLS_EMBED_ENABLED="1", KMLS_ALS_RANK="8",
               KMLS_ALS_ITERS="3", KMLS_CKPT_ENABLED="1", KMLS_COUNT_PATH="dense",
               MIN_SUPPORT="0.05")
PUBLISHED = ("recommendations.pickle", "recommendations.pickle.tensors.npz",
             "embeddings.npz")


def _job_pvc(base, csv_src: str) -> str:
    ds_dir = os.path.join(base, "datasets")
    os.makedirs(ds_dir)
    shutil.copy(csv_src, os.path.join(ds_dir, "2023_spotify_ds_synth.csv"))
    return ds_dir


def _ranks_job(base, ds_dir, want_exit: int = 0, **extra) -> list[str]:
    env = dict(KMLS_TORCH_DEVICE="cpu", BASE_DIR=str(base), DATASETS_DIR=ds_dir,
               KMLS_RANK_HEARTBEAT_S="0.5", **RANK_ENV, **JOB_ENV, **extra)
    if want_exit == 0:
        return run_gloo_ranks(2, _JOB_RANK, [], env=env)
    procs = _start_ranks(2, _JOB_RANK, [], env)
    outs = []
    try:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    assert [p.returncode for p in procs] == [want_exit] * 2, outs
    return outs


def _published(base) -> dict[str, bytes]:
    out = {}
    for name in PUBLISHED:
        with open(os.path.join(base, "pickles", name), "rb") as fh:
            out[name] = fh.read()
    return out


@pytest.fixture(scope="module")
def sharded_jobs(tmp_path_factory):
    """Two ranks of the job with the manifest's sharded knobs: once
    uninterrupted, once killed after ``mine`` and resumed; and the same
    knobs on one process."""
    root = tmp_path_factory.mktemp("sharded_jobs")
    csv_src = str(root / "ds.csv")
    write_tracks_csv(csv_src, synthetic_table(n_playlists=200, n_tracks=300,
                                              target_rows=3000, seed=11))
    whole, killed, one = root / "whole", root / "killed", root / "one"
    logs = {"whole": _ranks_job(whole, _job_pvc(whole, csv_src))}
    ds_dir = _job_pvc(killed, csv_src)
    logs["crash"] = _ranks_job(killed, ds_dir, want_exit=75,
                               KMLS_FAULT_MINE_CRASH_PHASE="mine")
    logs["resume"] = _ranks_job(killed, ds_dir)
    run_mining_job(dataclasses.replace(
        MiningConfig.from_env(), base_dir=str(one), datasets_dir=_job_pvc(one, csv_src),
        model_layout="sharded", k_max_consequents=32, embed_enabled=True, als_rank=8,
        als_iters=3, min_support=0.05, count_path="dense"), device="cpu")
    return whole, killed, one, logs


def test_sharded_job_takes_the_vocab_route_on_both_ranks(sharded_jobs):
    _, _, _, logs = sharded_jobs
    for rank, log in enumerate(logs["whole"]):
        assert "Pair-count path: sharded-vocab-gspmd" in log, log
        assert "NOTE:" not in log, log
        assert "ALS embeddings trained" in log, log
    assert "Rank 1: not the writer" in logs["whole"][1]
    for log in logs["resume"]:
        assert "Resumed phase 'mine' from checkpoint" in log, log


def test_sharded_job_rules_equal_the_one_process_job(sharded_jobs):
    """Every pickle, the npz twin member by member and the manifest's
    entries for the rule files: the one-process job's. The embeddings are
    within the reference's bar of the one-process dense training."""
    whole, _, one, _ = sharded_jobs
    pickles = sorted(n for n in os.listdir(one / "pickles") if n.endswith(".pickle"))
    assert PUBLISHED[0] in pickles
    for name in pickles:
        assert artifacts.load_pickle(str(whole / "pickles" / name)) == artifacts.load_pickle(
            str(one / "pickles" / name)), name
    npz = [np.load(p / "pickles" / PUBLISHED[1], allow_pickle=True) for p in (whole, one)]
    assert npz[0].files == npz[1].files
    for k in npz[0].files:
        assert npz[0][k].dtype == npz[1][k].dtype and np.array_equal(npz[0][k], npz[1][k]), k
    files = [artifacts.load_manifest(str(p / "pickles"))["files"] for p in (whole, one)]
    for name in pickles + [PUBLISHED[1]]:
        assert files[0][name] == files[1][name], name
    emb = [np.load(p / "pickles" / PUBLISHED[2], allow_pickle=True) for p in (whole, one)]
    assert list(emb[0]["vocab"]) == list(emb[1]["vocab"])
    np.testing.assert_allclose(emb[0]["item_factors"], emb[1]["item_factors"],
                               rtol=2e-4, atol=2e-5)


def test_sharded_job_resumed_after_mine_publishes_the_same_bytes(sharded_jobs):
    whole, killed, _, _ = sharded_jobs
    assert _published(killed) == _published(whole)
    files = [artifacts.load_manifest(str(p / "pickles"))["files"] for p in (whole, killed)]
    assert files[0] == files[1]
