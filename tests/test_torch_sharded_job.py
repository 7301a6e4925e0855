"""The multi-rank mining job as a whole, held against the JAX package.

Two ranks of ``python -m kmlserver_tpu_torch.mining.job`` (on the CPU, over
gloo, bootstrapped by the env triple) mine one synthetic CSV on one shared
temporary PVC; the reference ``run_mining_job`` mines the same CSV in
process on a ``2x1`` mesh of virtual CPU devices; both are pinned to the
bit-packed family, so both take the ``sharded-bitpack`` route. Only rank 0 may publish, the published pickles
and rule tensors must equal the reference's exactly, and the port's engine
must answer from both PVCs exactly as the reference engine does.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from kmlserver_tpu.config import MiningConfig as RefMiningConfig
from kmlserver_tpu.config import ServingConfig as RefServingConfig
from kmlserver_tpu.data.csv import write_tracks_csv
from kmlserver_tpu.data.synthetic import synthetic_table
from kmlserver_tpu.io import artifacts as ref_artifacts
from kmlserver_tpu.mining.pipeline import run_mining_job as ref_run_mining_job
from kmlserver_tpu.parallel.mesh import make_mesh as ref_make_mesh
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu_torch.config import ServingConfig
from kmlserver_tpu_torch.io import artifacts
from kmlserver_tpu_torch.serving.engine import RecommendEngine

from .test_torch_parallel import REPO, run_gloo_ranks

CSV_NAME = "2023_spotify_ds_synth.csv"

# each rank runs the job's entry point as the container would
_JOB_RANK = r"""
import os, runpy, sys

rank, world, port = sys.argv[1:4]
os.environ.update(
    KMLS_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", KMLS_NUM_PROCESSES=world,
    KMLS_PROCESS_ID=rank,
)
runpy.run_module("kmlserver_tpu_torch.mining.job", run_name="__main__")
"""


@pytest.fixture(scope="module")
def pvcs(tmp_path_factory):
    """(port PVC, reference PVC, [rank logs], reference log)."""
    root = tmp_path_factory.mktemp("sharded_job")
    csv_path = str(root / CSV_NAME)
    write_tracks_csv(
        csv_path, synthetic_table(n_playlists=300, n_tracks=800, target_rows=6000, seed=5)
    )
    bases = []
    for side in ("port", "ref"):
        os.makedirs(root / side / "datasets")
        shutil.copy(csv_path, root / side / "datasets" / CSV_NAME)
        bases.append(str(root / side))
    port_base, ref_base = bases
    logs = run_gloo_ranks(
        2, _JOB_RANK, [],
        # the ranks pin the bit-packed family, as the reference run below
        # does with its threshold
        env=dict(KMLS_TORCH_DEVICE="cpu", KMLS_COUNT_PATH="bitpack", BASE_DIR=port_base,
                 DATASETS_DIR=os.path.join(port_base, "datasets"),
                 KMLS_RANK_HEARTBEAT_S="0.5"),
    )
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref_run_mining_job(
            RefMiningConfig(base_dir=ref_base, datasets_dir=os.path.join(ref_base, "datasets"),
                            bitpack_threshold_elems=1),
            mesh=ref_make_mesh("2x1", devices=jax.devices()[:2]),
        )
    return port_base, ref_base, logs, out.getvalue()


def _pickles(base):
    return os.path.join(base, "pickles")


def test_both_ranks_take_the_sharded_route(pvcs):
    _, _, logs, ref_log = pvcs
    assert "Pair-count path: sharded-bitpack\n" in ref_log
    for rank, log in enumerate(logs):
        assert f"Distributed runtime: rank {rank}/2 on cpu, backend gloo" in log, log
        assert "Pair-count path: sharded-bitpack-torch" in log, log
        assert "all_reduce" in log and "Popcount kernel launches: 0" in log, log


def test_only_rank_zero_publishes(pvcs):
    port_base, _, logs, _ = pvcs
    assert "not the writer" not in logs[0] and "Saved " in logs[0]
    assert "Rank 1: not the writer; rank 0 publishes" in logs[1]
    assert "Saved " not in logs[1]
    history = artifacts.read_text(os.path.join(port_base, "dataset_history.csv"))
    assert len(history.splitlines()) == 2  # the header and one run
    token = artifacts.read_text(os.path.join(port_base, "last_execution.txt"))
    assert history.splitlines()[1].startswith(f"{token},1,")
    assert artifacts.load_manifest(_pickles(port_base))["token"] == token
    # the watchdog ran on both ranks and left no heartbeat behind
    beats = os.path.join(port_base, "mining_checkpoint", "heartbeats")
    assert os.path.isdir(beats) and not os.listdir(beats)


def test_published_pickles_equal_reference(pvcs):
    port_base, ref_base, _, _ = pvcs
    names = sorted(f for f in os.listdir(_pickles(ref_base)) if f.endswith(".pickle"))
    assert names == sorted(f for f in os.listdir(_pickles(port_base)) if f.endswith(".pickle"))
    assert "recommendations.pickle" in names
    for f in names:
        assert artifacts.load_pickle(os.path.join(_pickles(port_base), f)) == (
            ref_artifacts.load_pickle(os.path.join(_pickles(ref_base), f))
        ), f


def test_rule_tensors_equal_reference(pvcs):
    port_base, ref_base, _, _ = pvcs
    f = "recommendations.pickle.tensors.npz"
    with np.load(os.path.join(_pickles(ref_base), f), allow_pickle=True) as a, np.load(
        os.path.join(_pickles(port_base), f), allow_pickle=True
    ) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert int((b["rule_ids"] >= 0).sum()) > 0


def test_engines_answer_alike_on_both_pvcs(pvcs):
    port_base, ref_base, _, _ = pvcs
    rules = artifacts.load_pickle(os.path.join(_pickles(port_base), "recommendations.pickle"))
    keys = sorted(rules)
    rng = np.random.default_rng(0)
    seed_sets = [[k] for k in keys[:8]]
    seed_sets += [[str(s) for s in rng.choice(keys, size=n, replace=False)] for n in (2, 3, 5, 9)]
    seed_sets += [["No Such Track"], ["No Such Track", keys[-1]], keys[:20], [keys[3]] * 3]
    while len(seed_sets) < 20:
        seed_sets.append([str(s) for s in rng.choice(keys, size=3, replace=False)])
    answers = []
    for base in (port_base, ref_base):
        ref = RefEngine(RefServingConfig(base_dir=base))
        port = RecommendEngine(ServingConfig(base_dir=base), device="cpu")
        assert ref.load() and port.load()
        answers += [[ref.recommend(s) for s in seed_sets], [port.recommend(s) for s in seed_sets]]
    assert {src for _, src in answers[0]} >= {"rules", "fallback"}
    for got in answers[1:]:
        assert got == answers[0]


@pytest.mark.parametrize("module", ["kmlserver_tpu_torch.mining.job", "kmlserver_tpu.mining.job"])
def test_rank_beyond_the_world_exits_64(module, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, BASE_DIR=str(tmp_path), KMLS_TORCH_DEVICE="cpu",
               KMLS_COORDINATOR_ADDRESS="127.0.0.1:1", KMLS_NUM_PROCESSES="2",
               KMLS_PROCESS_ID="2")
    proc = subprocess.run([sys.executable, "-m", module], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 64, proc.stdout + proc.stderr
    assert "process_id 2 >= num_processes 2" in proc.stderr
