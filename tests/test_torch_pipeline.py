"""The port's slice as a whole: mine → publish → serve, held against the
JAX package on the same CSVs.

The reference ``run_mining_job`` and the port's (on the CPU) run over the
same CSV into two temporary PVCs: a synthetic table at a few hundred
playlists (its vocabulary is large enough for the Apriori prune) and the
repo's sample dataset. Neither side is forced onto a count route: both
dispatch the same way (the reference with its native counter, which the
port lacks, turned off), and counts are integers, so the published rules
must be equal.
Then both engines serve both PVCs crosswise, and the port's HTTP server
answers from its PVC. Everything is exact.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from kmlserver_tpu.config import MiningConfig as RefMiningConfig
from kmlserver_tpu.config import ServingConfig as RefServingConfig
from kmlserver_tpu.data.csv import read_tracks as ref_read_tracks
from kmlserver_tpu.data.csv import write_tracks_csv as ref_write_tracks_csv
from kmlserver_tpu.data.synthetic import synthetic_table
from kmlserver_tpu.io import artifacts as ref_artifacts
from kmlserver_tpu.mining.pipeline import run_mining_job as ref_run_mining_job
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
from kmlserver_tpu_torch.data.csv import read_tracks
from kmlserver_tpu_torch.io import artifacts
from kmlserver_tpu_torch.mining.pipeline import run_mining_job
from kmlserver_tpu_torch.serving.engine import RecommendEngine, bundle_from_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE_CSV = os.path.join(REPO, "datasets", "2023_spotify_ds_sample.csv")
DATASETS = ("synthetic", "sample")
MAX_SEEDS = 8  # small, so the over-the-cap cut is exercised cheaply


@pytest.fixture(scope="module")
def pvcs(tmp_path_factory):
    """{name: (csv, reference PVC, port PVC)} — each job run once."""
    root = tmp_path_factory.mktemp("torch_pipeline")
    synth_csv = str(root / "2023_spotify_ds_synth.csv")
    ref_write_tracks_csv(
        synth_csv,
        synthetic_table(n_playlists=300, n_tracks=800, target_rows=6000, seed=5),
    )
    out = {}
    for name, csv_path in (("synthetic", synth_csv), ("sample", SAMPLE_CSV)):
        bases = []
        for side in ("ref", "port"):
            base = root / name / side
            os.makedirs(base / "datasets")
            shutil.copy(csv_path, base / "datasets" / os.path.basename(csv_path))
            bases.append(str(base))
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            # both at their defaults: on the CPU the native counter
            ref_run_mining_job(
                RefMiningConfig(base_dir=bases[0], datasets_dir=bases[0] + "/datasets")
            )
        ref_path = log.getvalue().split("Pair-count path: ", 1)[1].split()[0]
        summary = run_mining_job(
            MiningConfig(base_dir=bases[1], datasets_dir=bases[1] + "/datasets"),
            device="cpu",
        )
        # the same route by the same dispatch; the bit-packed route's name
        # carries the port's suffix
        assert summary.count_path == ref_path.replace("bitpack-mxu", "bitpack-torch")
        out[name] = (csv_path, bases[0], bases[1])
    return out


def _pickles(base):
    return os.path.join(base, "pickles")


@pytest.mark.parametrize("name", DATASETS)
def test_read_tracks_matches_reference(name, pvcs):
    csv_path = pvcs[name][0]
    for ratio in (1.0, 0.37):
        got, want = read_tracks(csv_path, ratio), ref_read_tracks(csv_path, ratio)
        assert got.pid.dtype == np.int64
        np.testing.assert_array_equal(got.pid, want.pid)
        for col in ("track_name", "track_uri", "artist_name", "artist_uri", "album_name"):
            a, b = getattr(got, col), getattr(want, col)
            assert (a is None) == (b is None), col
            if a is not None:
                assert [str(x) for x in a] == [str(x) for x in b], col
        assert (got.n_playlists, got.n_tracks) == (want.n_playlists, want.n_tracks)


def test_read_tracks_edge_cases(tmp_path):
    path = tmp_path / "edge.csv"
    path.write_text(
        'pid,track_name,duration_ms,album_name\n'
        '7,"Hello, ""World""",1000,\n'
        ' 3,"multi\nline",5,Alb\n'
        '\n'
        '+2,plain,9,Alb\n',
        encoding="utf-8",
    )
    for reader in (read_tracks, ref_read_tracks):
        t = reader(str(path))
        assert t.pid.tolist() == [7, 3, 2]
        assert list(t.track_name) == ['Hello, "World"', "multi\nline", "plain"]
        assert list(t.album_name) == ["", "Alb", "Alb"]
        assert t.track_uri is None
    for bad in ("1.0", "x1", "", "99999999999999999999"):
        path.write_text(f"pid,track_name\n{bad},a\n", encoding="utf-8")
        with pytest.raises(ValueError, match="pid"):
            read_tracks(str(path))
        with pytest.raises(ValueError, match="pid"):
            ref_read_tracks(str(path))


@pytest.mark.parametrize("name", DATASETS)
def test_published_pickles_equal(name, pvcs):
    _, ref_base, port_base = pvcs[name]
    ref_names = sorted(f for f in os.listdir(_pickles(ref_base)) if f.endswith(".pickle"))
    port_names = sorted(f for f in os.listdir(_pickles(port_base)) if f.endswith(".pickle"))
    assert port_names == ref_names
    assert "recommendations.pickle" in ref_names and "best_tracks.pickle" in ref_names
    for f in ref_names:
        assert artifacts.load_pickle(os.path.join(_pickles(port_base), f)) == (
            ref_artifacts.load_pickle(os.path.join(_pickles(ref_base), f))
        ), f


@pytest.mark.parametrize("name", DATASETS)
def test_tensor_artifact_equal(name, pvcs):
    _, ref_base, port_base = pvcs[name]
    f = "recommendations.pickle.tensors.npz"
    with np.load(os.path.join(_pickles(ref_base), f), allow_pickle=True) as a, np.load(
        os.path.join(_pickles(port_base), f), allow_pickle=True
    ) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # each package's loader reads the other's artifact identically
    for path in (ref_base, port_base):
        p = os.path.join(_pickles(path), f)
        mine, theirs = artifacts.load_rule_tensors(p), ref_artifacts.load_rule_tensors(p)
        for k in ("rule_ids", "rule_counts", "rule_confs", "item_counts"):
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
        assert mine["vocab"] == theirs["vocab"]


@pytest.mark.parametrize("name", DATASETS)
def test_manifest_and_token(name, pvcs):
    _, ref_base, port_base = pvcs[name]
    got = artifacts.load_manifest(_pickles(port_base))
    want = ref_artifacts.load_manifest(_pickles(ref_base))
    assert sorted(got["files"]) == sorted(want["files"])
    token = artifacts.read_text(os.path.join(port_base, "last_execution.txt"))
    assert got["token"] == token and len(token.rsplit(".", 1)[1]) == 6
    for fname, entry in got["files"].items():
        assert entry == artifacts.file_digest(os.path.join(_pickles(port_base), fname))
    history = artifacts.read_text(os.path.join(port_base, "dataset_history.csv"))
    assert history.splitlines()[0] == "time,dataset_index,dataset_file"
    assert history.splitlines()[1].startswith(f"{token},1,")


def _seed_sets(base):
    """~50 seed sets: known, unknown, mixed, over the seed cap, seeds whose
    rule rows are empty, duplicates."""
    loaded = artifacts.load_rule_tensors(
        os.path.join(_pickles(base), "recommendations.pickle.tensors.npz")
    )
    rules = artifacts.load_pickle(os.path.join(_pickles(base), "recommendations.pickle"))
    keys = sorted(rules)
    empty = [k for k in keys if not rules[k]]
    unknown = [n for n in loaded["vocab"] if n not in rules][:5] + ["No Such Track"]
    rng = np.random.default_rng(0)
    sets = [[k] for k in keys[:12]]
    sets += [list(rng.choice(keys, size=int(n), replace=False)) for n in (2, 3, 5, 8, 9, 20)]
    sets += [list(rng.choice(keys, size=4, replace=True)) for _ in range(6)]
    sets += [[u] for u in unknown[:4]] + [unknown]
    sets += [[unknown[0], keys[-1]], [keys[0], unknown[-1], keys[1]]]
    sets += [keys[: MAX_SEEDS + 5], keys[-(MAX_SEEDS * 3):], keys[::-1][: MAX_SEEDS + 1]]
    if empty:
        sets += [[e] for e in empty[:4]] + [empty[:2] + keys[:1], empty[:3]]
    sets += [[keys[3], keys[3]], [keys[2]] * 12]
    while len(sets) < 50:
        sets.append(list(rng.choice(keys, size=3, replace=False)))
    return [[str(s) for s in seeds] for seeds in sets]


@pytest.mark.parametrize("name", DATASETS)
def test_engines_serve_crosswise(name, pvcs):
    """Reference and port engines, each over both PVCs: identical
    (songs, source) for every seed set; the port's batched path equals its
    per-request path."""
    _, ref_base, port_base = pvcs[name]
    seed_sets = _seed_sets(port_base)
    answers = {}
    for label, base in (("ref-pvc", ref_base), ("port-pvc", port_base)):
        ref = RefEngine(RefServingConfig(base_dir=base, max_seed_tracks=MAX_SEEDS))
        port = RecommendEngine(
            ServingConfig(base_dir=base, max_seed_tracks=MAX_SEEDS), device="cpu"
        )
        assert ref.load() and port.load()
        assert port.cache_value == ref.cache_value
        answers[("ref", label)] = [ref.recommend(s) for s in seed_sets]
        answers[("port", label)] = [port.recommend(s) for s in seed_sets]
        assert port.recommend_many(seed_sets) == answers[("port", label)]
    first = answers[("ref", "ref-pvc")]
    sources = {src for _, src in first}
    assert {"rules", "fallback"} <= sources
    for key, got in answers.items():
        assert got == first, key


def test_pickle_only_pvc_and_bundle_from_arrays(pvcs):
    """A PVC without the npz twin serves from the pickle; a bundle carried
    from the reference loader's arrays answers like the engine."""
    _, ref_base, port_base = pvcs["synthetic"]
    seed_sets = _seed_sets(ref_base)
    engine = RecommendEngine(
        ServingConfig(base_dir=ref_base, max_seed_tracks=MAX_SEEDS), device="cpu"
    )
    assert engine.load()
    want = [engine.recommend(s) for s in seed_sets]
    ref_loaded = ref_artifacts.load_rule_tensors(
        os.path.join(_pickles(ref_base), "recommendations.pickle.tensors.npz")
    )
    engine.bundle = bundle_from_arrays(ref_loaded, token=engine.cache_value, device="cpu")
    engine.replicas = [engine.bundle]
    assert [engine.recommend(s) for s in seed_sets] == want
    pickle_only = RecommendEngine(
        ServingConfig(base_dir=ref_base, max_seed_tracks=MAX_SEEDS,
                      prefer_tensor_artifact=False),
        device="cpu",
    )
    assert pickle_only.load()
    ref_pickle_only = RefEngine(RefServingConfig(
        base_dir=ref_base, max_seed_tracks=MAX_SEEDS, prefer_tensor_artifact=False
    ))
    assert ref_pickle_only.load()
    assert [pickle_only.recommend(s) for s in seed_sets] == [
        ref_pickle_only.recommend(s) for s in seed_sets
    ]


def test_engine_hot_swaps_on_token(pvcs, tmp_path):
    """Staleness is the token: a rewritten last_execution.txt reloads, an
    unchanged one does not; a missing PVC fails soft."""
    _, _, port_base = pvcs["sample"]
    base = str(tmp_path / "pvc")
    shutil.copytree(port_base, base)
    engine = RecommendEngine(ServingConfig(base_dir=base), device="cpu")
    assert engine.is_data_stale()
    engine.reload_if_required()
    assert engine.finished_loading and engine.reload_counter == 1
    assert not engine.is_data_stale()
    engine.reload_if_required()
    assert engine.reload_counter == 1
    artifacts.atomic_write_text(os.path.join(base, "last_execution.txt"), "2099-01-01 00:00:00.000001")
    assert engine.is_data_stale()
    engine.reload_if_required()
    assert engine.reload_counter == 2 and engine.cache_value == "2099-01-01 00:00:00.000001"
    empty = RecommendEngine(ServingConfig(base_dir=str(tmp_path / "none")), device="cpu")
    assert not empty.load()
    assert empty.recommend(["x"]) == ([], "fallback")


def _post(url, payload):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_http_server_answers_like_the_engine(pvcs):
    _, _, port_base = pvcs["synthetic"]
    env = dict(os.environ, PYTHONPATH=REPO, BASE_DIR=port_base, KMLS_PORT="0",
               KMLS_TORCH_DEVICE="cpu", KMLS_MAX_SEED_TRACKS=str(MAX_SEEDS))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kmlserver_tpu_torch.serving.server"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    port, lines = [], []

    def pump():
        for line in proc.stdout:
            lines.append(line)
            if "serving on" in line and not port:
                port.append(int(line.split("serving on", 1)[1].split()[0].rsplit(":", 1)[1]))

    threading.Thread(target=pump, daemon=True).start()
    try:
        deadline = time.monotonic() + 90
        while not port and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.05)
        assert port, "".join(lines)
        base = f"http://127.0.0.1:{port[0]}"
        ready = False
        while not ready and time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(base + "/readyz", timeout=5) as resp:
                    ready = resp.status == 200
            except urllib.error.HTTPError as exc:
                assert exc.code == 503
                time.sleep(0.05)
        assert ready
        engine = RecommendEngine(
            ServingConfig(base_dir=port_base, max_seed_tracks=MAX_SEEDS), device="cpu"
        )
        assert engine.load()
        for seeds in _seed_sets(port_base)[::6]:
            status, body = _post(base + "/api/recommend/", {"songs": seeds})
            assert status == 200
            assert body == {"songs": engine.recommend(seeds)[0],
                            "model_date": engine.cache_value, "version": "V1.1"}
        assert _post(base + "/api/recommend", {"songs": []}) == (
            400, {"detail": "Request with no songs"})
        for bad in (b"{oops", b'{"songs": "a"}', b'{"songs": [1]}', b"[]"):
            status, body = _post(base + "/api/recommend/", bad)
            assert status == 422, bad
    finally:
        proc.terminate()
        proc.wait(timeout=30)
