"""The support and density sweeps (``kmlserver_tpu_torch/mining/sweep.py``)
against the JAX package's: ``run_sweep`` records and the results CSV equal
the reference's but for the durations (with the native counter and
without), the same sweep over two gloo ranks equals the one-process sweep,
the CLI writes the reference's CSV, ``run_density_sweep`` measures the
reference's points, and ``table_from_records`` banks them as the
reference's does, leaving the packaged ``cpu`` cells byte for byte."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from kmlserver_tpu.config import MiningConfig as RefMiningConfig
from kmlserver_tpu.data.csv import write_tracks_csv
from kmlserver_tpu.data.synthetic import synthetic_table
from kmlserver_tpu.mining import dispatch as ref_dispatch
from kmlserver_tpu.mining import sweep as ref_sweep
from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.mining import dispatch, sweep

from .test_torch_parallel import REPO, run_gloo_ranks

CSV_NAME = "2023_spotify_ds_synth.csv"
SUPPORTS = np.arange(0.03, 0.2, 0.0025)  # the reference grid
KNOBS = dict(k_max_consequents=32)


@pytest.fixture(scope="module")
def pvc(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_sweep")
    os.makedirs(base / "datasets")
    write_tracks_csv(
        str(base / "datasets" / CSV_NAME),
        synthetic_table(n_playlists=300, n_tracks=800, target_rows=6000, seed=5),
    )
    return str(base)


def _without_durations(records):
    return [{k: v for k, v in r.items() if k != "duration_s"} for r in records]


def _csv_without_durations(path):
    with open(path) as fh:
        return [line.rsplit(",", 1)[0] for line in fh.read().splitlines()]


def _dataset(base):
    return os.path.join(base, "datasets", CSV_NAME)


@pytest.mark.parametrize("native", [True, False])
def test_run_sweep_records_and_csv_equal_the_references(native, pvc, tmp_path, capsys):
    port_cfg = MiningConfig(base_dir=str(tmp_path / "port"), native_cpu_pair_counts=native,
                            **KNOBS)
    ref_cfg = RefMiningConfig(base_dir=str(tmp_path / "ref"), native_cpu_pair_counts=native,
                              **KNOBS)
    for cfg in (port_cfg, ref_cfg):
        os.makedirs(cfg.base_dir)
    got = sweep.run_sweep(port_cfg, SUPPORTS, dataset=_dataset(pvc), device="cpu")
    want = ref_sweep.run_sweep(ref_cfg, SUPPORTS, dataset=_dataset(pvc))
    assert len(got) == len(SUPPORTS) == 68
    assert _without_durations(got) == _without_durations(want)
    assert all(r["duration_s"] >= 0 for r in got)
    assert len({r["missing_songs"] for r in got}) > 3  # the grid is not vacuous
    path = sweep.write_results_csv(port_cfg, got)
    ref_path = ref_sweep.write_results_csv(ref_cfg, want)
    assert os.path.basename(path) == os.path.basename(ref_path) == sweep.RESULTS_FILE
    assert _csv_without_durations(path) == _csv_without_durations(ref_path)
    assert "pair counts once" in capsys.readouterr().out


# each rank sweeps the PVC's dataset on the job's mesh contract
_SWEEP_RANK = r"""
import json, os, sys

rank, world, port, base, out, threshold = sys.argv[1:7]
os.environ.update(
    KMLS_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", KMLS_NUM_PROCESSES=world,
    KMLS_PROCESS_ID=rank,
)
import numpy as np
from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.mining.sweep import run_sweep
from kmlserver_tpu_torch.parallel.distributed import maybe_initialize, resolve_mesh, shutdown

assert maybe_initialize(device="cpu")
mesh = resolve_mesh("auto", distributed=True)
cfg = MiningConfig(base_dir=base, k_max_consequents=32,
                   bitpack_threshold_elems=int(threshold) if threshold != "auto" else "auto")
records = run_sweep(cfg, np.arange(0.03, 0.2, 0.0025),
                    dataset=os.path.join(base, "datasets", "2023_spotify_ds_synth.csv"),
                    mesh=mesh, device="cpu")
with open(f"{out}.rank{rank}.json", "w") as fh:
    json.dump(records, fh)
shutdown()
"""


@pytest.mark.parametrize("threshold", ["auto", "1"])
def test_run_sweep_over_two_gloo_ranks_equals_one_process(threshold, pvc, tmp_path):
    out = str(tmp_path / "records")
    run_gloo_ranks(2, _SWEEP_RANK, [pvc, out, threshold])
    alone = sweep.run_sweep(
        MiningConfig(base_dir=pvc, **KNOBS), SUPPORTS, dataset=_dataset(pvc), device="cpu"
    )
    for rank in range(2):
        with open(f"{out}.rank{rank}.json") as fh:
            assert _without_durations(json.load(fh)) == _without_durations(alone)


def test_sweep_cli_writes_the_references_csv(pvc, tmp_path):
    port_base, ref_base = str(tmp_path / "port"), str(tmp_path / "ref")
    for base in (port_base, ref_base):
        shutil.copytree(os.path.join(pvc, "datasets"), os.path.join(base, "datasets"))
    env = dict(os.environ, PYTHONPATH=REPO, BASE_DIR=port_base, KMLS_TORCH_DEVICE="cpu",
               DATASETS_DIR=os.path.join(port_base, "datasets"), KMLS_K_MAX_CONSEQUENTS="32",
               KMLS_SWEEP_START="0.05", KMLS_SWEEP_STOP="0.1", KMLS_SWEEP_STEP="0.01")
    env.pop("KMLS_COORDINATOR_ADDRESS", None)
    proc = subprocess.run([sys.executable, "-m", "kmlserver_tpu_torch.mining.sweep"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "wrote 5 sweep points" in proc.stdout
    with contextlib.redirect_stdout(io.StringIO()):
        ref_cfg = RefMiningConfig(base_dir=ref_base, k_max_consequents=32,
                                  datasets_dir=os.path.join(ref_base, "datasets"))
        ref_path = ref_sweep.write_results_csv(
            ref_cfg, ref_sweep.run_sweep(ref_cfg, np.arange(0.05, 0.1, 0.01)))
    assert _csv_without_durations(os.path.join(port_base, sweep.RESULTS_FILE)) == \
        _csv_without_durations(ref_path)


GRID = dict(densities=(0.05, 0.01), shapes=((400, 100), (1200, 300)))


@pytest.fixture(scope="module")
def density_records():
    with contextlib.redirect_stdout(io.StringIO()):
        got = sweep.run_density_sweep(**GRID, device="cpu")
        want = ref_sweep.run_density_sweep(**GRID)
    return got, want


def test_density_sweep_measures_the_references_points(density_records):
    got, want = density_records
    assert len(got) == len(want) == 4
    keys = ("shape", "rows", "elems", "identical")
    assert [{k: r[k] for k in keys} for r in got] == [{k: r[k] for k in keys} for r in want]
    assert all(r["identical"] for r in got)
    for r in got:
        assert r["density"] == pytest.approx(r["rows"] / r["elems"])
        assert all(r[f"{p}_s"] > 0 for p in dispatch.PATHS)
        assert r["winner"] == min(dispatch.PATHS, key=lambda p: r[f"{p}_s"])


def test_density_sweep_guards_leave_a_family_unmeasured():
    with contextlib.redirect_stdout(io.StringIO()):
        got = sweep.run_density_sweep(densities=(0.05,), shapes=((400, 100),), device="cpu",
                                      dense_max_elems=1000, sparse_max_events=10)
    assert got[0]["dense_s"] is None and got[0]["sparse_s"] is None
    assert got[0]["winner"] == "bitpack" and got[0]["identical"]


def test_table_from_records_merges_as_the_references(density_records):
    got, _ = density_records
    base = dispatch.load_table()
    args = dict(measured_on="host/NVIDIA H100 80GB HBM3", banked_at=1.5)
    port = dispatch.table_from_records(got, "gpu", base=base, **args)
    ref = ref_dispatch.table_from_records(got, "gpu", base=base, **args)
    assert port == ref
    assert port["backends"]["cpu"] == base["backends"]["cpu"]
    assert port["backends"]["gpu"]["measured_on"] == args["measured_on"]
    again = dispatch.table_from_records(got[:1], "gpu", base=port, measured_on="x", banked_at=2)
    assert again == ref_dispatch.table_from_records(got[:1], "gpu", base=port, measured_on="x",
                                                    banked_at=2)


def test_banking_gpu_cells_keeps_the_cpu_cells_byte_for_byte(density_records, tmp_path):
    got, _ = density_records
    base = dispatch.load_table()
    out = str(tmp_path / "table.json")
    dispatch.save_table(out, dispatch.table_from_records(
        got, "gpu", base=base, measured_on="host/card", banked_at=2.5))
    with open(out) as fh:
        written = json.load(fh)
    assert set(written["backends"]) == set(base["backends"]) | {"gpu"}
    for backend in base["backends"]:
        if backend != "gpu":
            assert json.dumps(written["backends"][backend], indent=1, sort_keys=True) == \
                json.dumps(base["backends"][backend], indent=1, sort_keys=True)


def test_bank_density_table_banks_under_the_devices_backend(density_records, tmp_path):
    import torch

    got, _ = density_records
    out = str(tmp_path / "table.json")
    table = sweep.bank_density_table(got, torch.device("cpu"), out)
    with open(out) as fh:
        assert json.load(fh) == table
    entry = table["backends"]["cpu"]
    assert entry["measured_on"].endswith("/cpu")
    newest = {dispatch.table_cell(r["density"], r["elems"]): r for r in got}  # newest wins
    for cell, r in newest.items():
        assert entry["cells"][cell]["path"] == r["winner"]
        assert entry["cells"][cell]["shape"] == r["shape"]
