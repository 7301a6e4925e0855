"""The port's multi-rank layer (kmlserver_tpu_torch/parallel/, mining/job.py)
against the JAX package's.

Pure logic — mesh shapes, the env triple, mesh strings, the layout knob,
the exit-code contract, the dead-rank watchdog, the slab packer — runs in
process. The dp-sharded count runs in real processes: a gloo group of 2
ranks (and one of 4) on the CPU, spawned once per group for the module on
a free port through the env triple, every process under a timeout so a
hung collective fails the test instead of the suite. One more pair of
ranks shows the watchdog's exit 76 ending a rank blocked inside a gloo
all-reduce that its peer never joins. The JAX side runs
``sharded_bitpack_pair_counts(impl="vpu", interpret=True)`` on ``2x1`` /
``4x1`` meshes of the virtual CPU devices, as tests/test_parallel.py
does. Counts are integers: every comparison is exact.
"""

import errno
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from kmlserver_tpu.mining import job as ref_job
from kmlserver_tpu.mining.vocab import DuplicateArtistURIError as RefDuplicateArtistURIError
from kmlserver_tpu.mining.vocab import build_baskets
from kmlserver_tpu.ops import popcount as ref_pc
from kmlserver_tpu.parallel import distributed as ref_dist
from kmlserver_tpu.parallel import layout as ref_layout
from kmlserver_tpu.parallel import mesh as ref_mesh
from kmlserver_tpu.parallel.support import (
    sharded_bitpack_pair_counts as ref_sharded_bitpack_pair_counts,
)
from kmlserver_tpu_torch.mining import job
from kmlserver_tpu_torch.mining.vocab import DuplicateArtistURIError
from kmlserver_tpu_torch.ops import popcount as pc
from kmlserver_tpu_torch.parallel import collectives, distributed, layout, mesh, support
from kmlserver_tpu_torch.parallel.distributed import RankWatchdog
from kmlserver_tpu_torch.utils.device import DeviceUnavailableError

from .oracle import random_baskets
from .test_ops import table_from_baskets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 180


def _outcome(fn):
    """A call's value, or the type of the exception it raised."""
    try:
        return fn()
    except Exception as exc:  # the outcome IS the exception type
        return type(exc).__name__


# ---------------------------------------------------------------- meshes


@pytest.mark.parametrize(
    "shape", ["4x2", "2x1", "1x1", "8X1", "4", "4x2x1", "ax1", "", "0x3"]
)
def test_parse_mesh_shape_matches_reference(shape):
    assert _outcome(lambda: mesh.parse_mesh_shape(shape)) == _outcome(
        lambda: ref_mesh.parse_mesh_shape(shape)
    )


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("shape", ["auto", "1x1", "2x1", "1x2", "2x2", "3x5", (1, 1), (2, 2)])
def test_make_mesh_matches_reference(shape, n):
    """Same (dp, tp) shape, or the same error, over n ranks as over n devices."""

    def port():
        m = mesh.make_mesh(shape, ranks=list(range(n)))
        return m.shape, m.ranks()

    def ref():
        m = ref_mesh.make_mesh(shape, devices=jax.devices()[:n])
        return dict(m.shape), [d.id for d in m.devices.flatten()]

    assert _outcome(port) == _outcome(ref)


def test_single_process_mesh_and_flatten():
    m = mesh.make_mesh("auto")
    assert m.shape == {"dp": 1, "tp": 1} and m.ranks() == [0] and m.group is None
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        mesh.make_mesh("2x1")
    grid = mesh.make_mesh("2x2", ranks=[0, 1, 2, 3])
    assert grid.flattened().shape == {"dp": 4, "tp": 1}
    assert grid.flattened().ranks() == [0, 1, 2, 3]


@pytest.mark.parametrize(
    "env",
    [
        {},
        {"KMLS_COORDINATOR_ADDRESS": "10.0.0.1:1234", "KMLS_NUM_PROCESSES": "4",
         "KMLS_PROCESS_ID": "3"},
        {"KMLS_COORDINATOR_ADDRESS": "h:1", "KMLS_NUM_PROCESSES": "3",
         "JOB_COMPLETION_INDEX": "2"},
        {"KMLS_COORDINATOR_ADDRESS": "h:1", "KMLS_NUM_PROCESSES": "3",
         "KMLS_PROCESS_ID": "1", "JOB_COMPLETION_INDEX": "2"},
        {"KMLS_COORDINATOR_ADDRESS": "h:1"},
        {"KMLS_COORDINATOR_ADDRESS": "h:1", "KMLS_NUM_PROCESSES": "2",
         "KMLS_PROCESS_ID": "2"},
        {"KMLS_COORDINATOR_ADDRESS": "h:1", "JOB_COMPLETION_INDEX": "1"},
    ],
)
def test_distributed_env_matches_reference(env, monkeypatch):
    for var in ("KMLS_COORDINATOR_ADDRESS", "KMLS_NUM_PROCESSES",
                "KMLS_PROCESS_ID", "JOB_COMPLETION_INDEX"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    got = _outcome(distributed.distributed_env)
    assert got == _outcome(ref_dist.distributed_env)
    if env.get("KMLS_PROCESS_ID") == "2":
        assert got == "ValueError"


@pytest.mark.parametrize(
    "shape,want",
    [
        ("", None),
        ("1x1", None),
        ("auto", None),  # one process drives one card: nothing to shard over
        ("hybrid", {"dp": 1, "tp": 1}),
        ("hybrid:tp1", {"dp": 1, "tp": 1}),
        ("hybrid:tp3", "ValueError"),  # tp must divide the per-host count
        ("hybrid:tpx", "ValueError"),
        ("hybridz", "ValueError"),
        ("2x1", "ValueError"),
        ("nonsense", "ValueError"),
    ],
)
def test_resolve_mesh_single_process(shape, want):
    got = _outcome(lambda: distributed.resolve_mesh(shape))
    assert (got.shape if isinstance(got, mesh.RankMesh) else got) == want
    if shape in ("", "1x1", "hybrid:tpx", "hybridz", "nonsense", "hybrid:tp3"):
        # strings whose outcome does not depend on the device count
        ref = _outcome(lambda: ref_dist.resolve_mesh(shape))
        assert (ref if ref is None or isinstance(ref, str) else "mesh") == (
            got if got is None or isinstance(got, str) else "mesh"
        )


@pytest.mark.parametrize(
    "hosts,tp,want",
    [
        (("a", "a", "b", "b"), None, ((0, 1), (2, 3))),
        (("a", "b", "a", "b"), None, ((0, 2), (1, 3))),
        (("a", "a", "a", "a"), 2, ((0, 1), (2, 3))),
        (("a", "b", "c", "d"), None, ((0,), (1,), (2,), (3,))),
        (("a", "a", "b", "b"), 4, "ValueError"),
    ],
)
def test_hybrid_mesh_keeps_tp_within_a_host(hosts, tp, want, monkeypatch):
    monkeypatch.setattr(distributed, "hostnames", lambda: hosts)
    got = _outcome(lambda: distributed.make_hybrid_mesh(tp=tp, ranks=[0, 1, 2, 3]).grid)
    assert got == want


@pytest.mark.parametrize(
    "device,peers,want",
    [
        ("cpu", [("a", 0), ("a", 0)], "gloo"),
        ("cuda", [("a", 1), ("a", 1)], "gloo"),  # two ranks share cuda:0
        ("cuda", [("a", 2), ("a", 2)], "nccl"),
        ("cuda", [("a", 1), ("b", 1)], "nccl"),  # one card per host
        ("cuda", [("a", 2), ("a", 2), ("a", 2)], "gloo"),  # ranks 0 and 2 share
        ("cuda", [("a", 8)] * 4, "nccl"),
    ],
)
def test_backend_rule(device, peers, want):
    assert distributed.choose_backend(device, peers) == want


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize(
    "word", ["replicated", "sharded", "auto", " SHARDED ", "Auto", "typo", "", None]
)
def test_validate_layout_matches_reference(word):
    assert layout.validate_layout(word) == ref_layout.validate_layout(word)


@pytest.mark.parametrize("word", ["replicated", "sharded", "auto", "typo"])
@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("tensor_bytes,budget", [(10, 100), (1000, 100), (1000, 0)])
def test_resolve_layout_matches_reference(word, n, tensor_bytes, budget):
    assert layout.resolve_layout(word, tensor_bytes, budget, n) == (
        ref_layout.resolve_layout(word, tensor_bytes, budget, n)
    )


@pytest.mark.parametrize("word", ["replicated", "sharded", "auto"])
@pytest.mark.parametrize("shape", ["2x1", "1x2", "2x2"])
def test_wants_sharded_mining_matches_reference(word, shape):
    class Cfg:
        model_layout = word

    n = 4 if shape == "2x2" else 2
    port = mesh.make_mesh(shape, ranks=list(range(n)))
    ref = ref_mesh.make_mesh(shape, devices=jax.devices()[:n])
    assert layout.wants_sharded_mining(Cfg, port) == ref_layout.wants_sharded_mining(Cfg, ref)
    assert layout.mining_mesh(Cfg, port) is port
    assert not layout.wants_sharded_mining(Cfg, None)


# ---------------------------------------------------------------- exit codes


@pytest.mark.parametrize(
    "make",
    [
        lambda dup: ValueError("x"),
        lambda dup: FileNotFoundError("x"),
        lambda dup: dup("x"),
        lambda dup: OSError(errno.ENOSPC, "No space left on device"),
        lambda dup: OSError(errno.EIO, "Input/output error"),
        lambda dup: RuntimeError("x"),
    ],
    ids=["ValueError", "FileNotFoundError", "DuplicateArtistURIError", "ENOSPC",
         "EIO", "RuntimeError"],
)
def test_classify_exception_matches_reference(make):
    got = job.classify_exception(make(DuplicateArtistURIError))
    assert got == ref_job.classify_exception(make(RefDuplicateArtistURIError))
    assert (job.EXIT_OK, job.EXIT_FATAL_CONFIG, job.EXIT_RESUMABLE, job.EXIT_RANK_DEAD) == (
        ref_job.EXIT_OK, ref_job.EXIT_FATAL_CONFIG, ref_job.EXIT_RESUMABLE,
        ref_job.EXIT_RANK_DEAD,
    )
    assert job.classify_exception(DeviceUnavailableError("no card")) == job.EXIT_FATAL_CONFIG


# ---------------------------------------------------------------- watchdog


def _watchdog(directory, rank, num=2, timeout_s=0.5, collective_timeout_s=None, aborts=None):
    return RankWatchdog(
        str(directory), rank=rank, num_processes=num, heartbeat_interval_s=0.05,
        timeout_s=timeout_s, collective_timeout_s=collective_timeout_s,
        on_abort=(aborts.append if aborts is not None else None),
    )


def _wait_for(aborts, seconds=5.0):
    deadline = time.monotonic() + seconds
    while not aborts and time.monotonic() < deadline:
        time.sleep(0.02)


def test_watchdog_stale_peer_aborts(tmp_path):
    """A peer that beat once and then went silent is aged out."""
    aborts: list[str] = []
    w0 = _watchdog(tmp_path, 0, aborts=aborts)
    w0.start()
    try:
        (tmp_path / "rank1.hb").write_text(repr(time.time()))
        time.sleep(0.2)
        assert not aborts  # fresh: no false positive
        _wait_for(aborts)
        assert aborts and "rank 1" in aborts[0] and "stale" in aborts[0]
    finally:
        w0.stop()


def test_watchdog_live_peers_never_abort(tmp_path):
    aborts: list[str] = []
    w0 = _watchdog(tmp_path, 0, aborts=aborts)
    w1 = _watchdog(tmp_path, 1, aborts=aborts)
    w0.start()
    w1.start()
    try:
        time.sleep(1.0)  # twice the staleness timeout
        assert not aborts
    finally:
        w0.stop()
        w1.stop()


def test_watchdog_guard_past_deadline_aborts(tmp_path):
    aborts: list[str] = []
    w0 = _watchdog(tmp_path, 0, num=1, timeout_s=0.3, collective_timeout_s=0.3, aborts=aborts)
    w0.start()
    try:
        with w0.guard("mine"):
            _wait_for(aborts)
        assert aborts and "'mine'" in aborts[0]
    finally:
        w0.stop()


def test_watchdog_long_guard_outlives_staleness_timeout(tmp_path):
    aborts: list[str] = []
    w0 = _watchdog(tmp_path, 0, num=1, timeout_s=0.1, collective_timeout_s=30.0, aborts=aborts)
    w0.start()
    try:
        with w0.guard("mine"):
            time.sleep(0.5)
        assert not aborts
    finally:
        w0.stop()
    assert _watchdog(tmp_path, 0, timeout_s=0.5).collective_timeout_s == pytest.approx(3.0)


def test_watchdog_predecessor_file_gets_startup_grace(tmp_path):
    (tmp_path / "rank1.hb").write_text(repr(time.time() - 3600.0))
    aborts: list[str] = []
    w0 = _watchdog(tmp_path, 0, timeout_s=0.5, aborts=aborts)
    w0.start()
    try:
        time.sleep(0.25)  # past the first poll, inside the timeout
        assert not aborts
        _wait_for(aborts)  # the peer never boots: dead after the full timeout
        assert aborts and "rank 1" in aborts[0]
    finally:
        w0.stop()


def test_watchdog_stop_unlinks_own_file(tmp_path):
    w0 = _watchdog(tmp_path, 0)
    w0.start()
    assert (tmp_path / "rank0.hb").exists()
    w0.stop()
    assert not (tmp_path / "rank0.hb").exists()


# rank 1 stays alive and beating but never joins the all-reduce: rank 0's
# main thread blocks inside gloo until its guard's deadline passes
_HUNG_PEER = r"""
import os, sys, time

rank, world, port, beats = sys.argv[1:5]
os.environ.update(
    KMLS_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", KMLS_NUM_PROCESSES=world,
    KMLS_PROCESS_ID=rank,
)
import torch
import torch.distributed as dist
from kmlserver_tpu_torch.parallel.distributed import RankWatchdog, maybe_initialize

assert maybe_initialize(device="cpu", timeout_s=120)
w = RankWatchdog(beats, rank=int(rank), num_processes=int(world), heartbeat_interval_s=0.1,
                 timeout_s=60.0, collective_timeout_s=2.0)
w.start()
if rank == "1":
    time.sleep(120)
with w.guard("mine"):
    dist.all_reduce(torch.ones(4))
print("the all-reduce returned", flush=True)
"""


def test_watchdog_exits_76_from_a_blocked_collective(tmp_path):
    procs = _start_ranks(2, _HUNG_PEER, [str(tmp_path)])
    try:
        out = procs[0].communicate(timeout=RANK_TIMEOUT_S)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    assert procs[0].returncode == job.EXIT_RANK_DEAD, out
    assert "RANK WATCHDOG ABORT (rank 0): collective section 'mine' exceeded" in out
    assert "the all-reduce returned" not in out


# ---------------------------------------------------------------- slab packer


def _baskets(p, v, seed=None):
    rng = np.random.default_rng(p * 1000 + v if seed is None else seed)
    return build_baskets(
        table_from_baskets(random_baskets(rng, n_playlists=p, n_tracks=v, mean_len=6))
    )


@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("n_playlists", [257, 1000])
@pytest.mark.parametrize("word_chunk", [None, 8])
def test_slabs_concatenate_to_the_whole_bitset(dp, n_playlists, word_chunk, monkeypatch):
    if word_chunk is not None:
        monkeypatch.setenv("KMLS_POPCOUNT_WORD_CHUNK", str(word_chunk))
    b = _baskets(n_playlists, 90)
    v_pad, w_total = support.sharded_padded_shape(b.n_tracks, b.n_playlists, dp)
    assert w_total % (dp * pc.word_chunk()) == 0
    kw = dict(n_playlists=b.n_playlists, n_tracks=b.n_tracks, v_pad=v_pad)
    slabs = [
        pc.bitpack_slab_by_track(
            b.playlist_rows, b.track_ids, w_total=w_total, dp=dp, rank=r, device="cpu", **kw
        )
        for r in range(dp)
    ]
    assert all(s.shape == (v_pad, w_total // dp) and s.dtype == torch.int32 for s in slabs)
    whole = pc.bitpack_by_track(b.playlist_rows, b.track_ids, w_pad=w_total, device="cpu", **kw)
    np.testing.assert_array_equal(torch.cat(slabs, dim=1).numpy(), whole.numpy())
    ref = np.asarray(ref_pc.bitpack_by_track(b.playlist_rows, b.track_ids, w_pad=w_total, **kw))
    np.testing.assert_array_equal(whole.numpy(), ref.view(np.int32))
    if word_chunk == 8 and dp > 1:
        assert all(int(s.count_nonzero()) > 0 for s in slabs[:2])  # data in several slabs


def test_slab_packer_refuses_a_bad_split():
    b = _baskets(40, 17)
    kw = dict(n_playlists=b.n_playlists, n_tracks=b.n_tracks, v_pad=128, device="cpu")
    with pytest.raises(ValueError, match="equal slabs"):
        pc.bitpack_slab_by_track(b.playlist_rows, b.track_ids, w_total=6, dp=4, rank=0, **kw)
    with pytest.raises(ValueError, match="outside"):
        pc.bitpack_slab_by_track(b.playlist_rows, b.track_ids, w_total=8, dp=4, rank=4, **kw)
    with pytest.raises(ValueError, match="too small"):
        pc.bitpack_slab_by_track(b.playlist_rows, b.track_ids, w_total=1, dp=1, rank=0, **kw)


def test_sharded_routes_need_a_dp_only_mesh():
    b = _baskets(40, 17)
    grid = mesh.make_mesh("1x2", ranks=[0, 1])
    for fn in (
        lambda: support.sharded_bitpack_pair_counts(b, grid, device="cpu"),
        lambda: support.counts_from_sharded_bitset(torch.zeros((128, 512), dtype=torch.int32), grid),
    ):
        with pytest.raises(ValueError, match="dp-only"):
            fn()


def test_one_rank_mesh_without_a_runtime():
    """A single process with a 1x1 mesh counts its one slab alone; a wider
    mesh without the runtime is refused rather than silently partial."""
    b = _baskets(90, 33)
    got = support.sharded_bitpack_pair_counts(b, mesh.make_mesh("auto"), device="cpu")
    want = pc.popcount_pair_counts(
        b.playlist_rows, b.track_ids, n_playlists=b.n_playlists, n_tracks=b.n_tracks,
        device="cpu",
    )
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(RuntimeError, match="distributed runtime"):
        collectives.all_reduce_sum_(torch.zeros(2, 2),
                                    mesh.make_mesh("2x1", ranks=[0, 1]).axis("dp"))


# ---------------------------------------------------------------- B4 on gloo ranks

_WORKER = r"""
import os, sys

import numpy as np

rank, world, port, indir, outdir = sys.argv[1:6]
os.environ.update(
    KMLS_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", KMLS_NUM_PROCESSES=world,
    KMLS_PROCESS_ID=rank,
)
from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
from kmlserver_tpu_torch.parallel import support
from kmlserver_tpu_torch.parallel.distributed import maybe_initialize, shutdown
from kmlserver_tpu_torch.parallel.mesh import make_mesh

assert maybe_initialize(device="cpu", timeout_s=120)
grid = make_mesh("auto")
assert grid.shape == {"dp": int(world), "tp": 1}
for name in sorted(os.listdir(indir)):
    case = np.load(os.path.join(indir, name))
    env = {k: str(case[k]) for k in case.files if k.startswith("KMLS_")}
    os.environ.update(env)
    names = [str(i) for i in range(int(case["n_tracks"]))]
    b = Baskets(
        playlist_rows=case["playlist_rows"], track_ids=case["track_ids"],
        n_playlists=int(case["n_playlists"]),
        vocab=Vocab(names=names, index={n: i for i, n in enumerate(names)}),
    )
    full = support.sharded_bitpack_pair_counts(b, grid, device="cpu")
    slab = support.pack_rank_slab(b, grid, "cpu")
    padded = support.counts_from_sharded_bitset(slab.clone(), grid)
    np.savez(
        os.path.join(outdir, f"{name[:-4]}.rank{rank}.npz"),
        full=full.numpy(), padded=padded.numpy(), slab=slab.numpy(),
    )
    for k in env:
        del os.environ[k]
shutdown()
print(f"RANK {rank} DONE", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(world: int, script: str, args: list[str], env: dict | None = None):
    """``world`` processes of ``script``, argv ``rank world port *args``."""
    port = _free_port()
    full_env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    return [
        subprocess.Popen(
            [sys.executable, "-c", script, str(r), str(world), str(port), *args],
            cwd=REPO, env=full_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(world)
    ]


def run_gloo_ranks(world: int, script: str, args: list[str], env: dict | None = None):
    """Run ``world`` ranks of ``script`` on a free port; every process has
    RANK_TIMEOUT_S, and one rank that fails or hangs kills the group."""
    procs = _start_ranks(world, script, args, env)
    outs = []
    try:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


# (world, n_playlists, n_tracks, env): small word chunks put data in
# several slabs; the row/swar case takes its kernel options from the env
CASES = {
    "2r-40x17": (2, 40, 17, {}),
    "2r-90x33-wk1": (2, 90, 33, {"KMLS_POPCOUNT_WORD_CHUNK": "1"}),
    "2r-257x129-wk2": (2, 257, 129, {"KMLS_POPCOUNT_WORD_CHUNK": "2"}),
    "2r-257x129-row-swar": (2, 257, 129, {"KMLS_POPCOUNT_VARIANT": "row", "KMLS_POPCOUNT_SWAR": "1"}),
    "2r-257x129-wk2-row-swar": (
        2, 257, 129,
        {"KMLS_POPCOUNT_WORD_CHUNK": "2", "KMLS_POPCOUNT_VARIANT": "row", "KMLS_POPCOUNT_SWAR": "1"},
    ),
    "4r-257x129-wk1": (4, 257, 129, {"KMLS_POPCOUNT_WORD_CHUNK": "1"}),
    "4r-90x33": (4, 90, 33, {}),
}


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """{case: (baskets, [per-rank npz])} — one gloo group per world size."""
    root = tmp_path_factory.mktemp("gloo_ranks")
    results = {}
    for world in (2, 4):
        indir, outdir = root / f"in{world}", root / f"out{world}"
        indir.mkdir()
        outdir.mkdir()
        for name, (w, p, v, env) in CASES.items():
            if w != world:
                continue
            b = _baskets(p, v)
            np.savez(
                indir / f"{name}.npz", playlist_rows=b.playlist_rows, track_ids=b.track_ids,
                n_playlists=b.n_playlists, n_tracks=b.n_tracks, **env,
            )
            results[name] = b
        outs = run_gloo_ranks(world, _WORKER, [str(indir), str(outdir)])
        assert all("backend gloo (ranks on the CPU)" in out for out in outs), outs
        for name in results:
            if CASES[name][0] == world:
                results[name] = (results[name], [
                    dict(np.load(outdir / f"{name}.rank{r}.npz")) for r in range(world)
                ])
    return results


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_counts_match_jax_on_every_rank(name, rank_results, monkeypatch):
    world, _, _, env = CASES[name]
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    b, per_rank = rank_results[name]
    v = b.n_tracks
    want = np.asarray(ref_sharded_bitpack_pair_counts(
        b, ref_mesh.make_mesh(f"{world}x1", devices=jax.devices()[:world]),
        impl="vpu", interpret=True,
    ))
    slabs = [torch.from_numpy(r["slab"]) for r in per_rank]
    plain = support.sharded_counts_plain(slabs).numpy()
    for rank, got in enumerate(per_rank):
        np.testing.assert_array_equal(got["full"], want, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["padded"], plain, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["padded"][:v, :v], want, err_msg=f"rank {rank}")
    v_pad, w_total = support.sharded_padded_shape(b.n_tracks, b.n_playlists, world)
    whole = pc.bitpack_by_track(
        b.playlist_rows, b.track_ids, n_playlists=b.n_playlists, n_tracks=v,
        v_pad=v_pad, w_pad=w_total, device="cpu",
    )
    np.testing.assert_array_equal(torch.cat(slabs, dim=1).numpy(), whole.numpy())
