"""The port stands alone: importing every module of ``kmlserver_tpu_torch``
(and ``chip_smoke.py``) loads neither ``jax`` nor any module of the JAX
package, and its entry points run on ``cuda`` unless told otherwise —
raising when no card is present."""

import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest

import kmlserver_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, **env) -> subprocess.CompletedProcess:
    full_env = dict(os.environ, PYTHONPATH=REPO, **env)
    full_env.pop("KMLS_TORCH_DEVICE", None)
    full_env.update(env)
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        cwd=REPO, env=full_env, capture_output=True, text=True, timeout=300,
    )


def test_every_module_imports_without_jax_or_the_reference():
    names = [
        m.name for m in pkgutil.walk_packages(
            kmlserver_tpu_torch.__path__, prefix="kmlserver_tpu_torch."
        )
    ]
    for name in ("ops.popcount", "faults", "io.iohealth", "io.artifacts", "mining.checkpoint",
                 "observability.trace", "observability.runtime", "observability.slo",
                 "observability.costmodel", "observability.jobmetrics",
                 "observability.tracejoin", "utils.profiling", "ops.embed", "ops.segsum",
                 "mining.als", "models", "models.embedding_model", "models.rule_model",
                 "freshness", "freshness.delta", "freshness.ring", "quality",
                 "quality.lifecycle", "parallel.collectives", "serving.mesh",
                 "serving.forecast", "utils.nativelib", "data.native", "ops.cpu_popcount",
                 "serving.native_serve", "mining.sweep", "ops.threefry", "ops.bernoulli",
                 "data.device_synthetic", "mining.config4", "analysis", "analysis.core",
                 "analysis.callgraph", "analysis.registries", "analysis.exitcodes",
                 "analysis.atomicwrite", "analysis.hotpath", "analysis.locking",
                 "analysis.lockown", "analysis.loopblock", "analysis.envread",
                 "analysis.metricsreg", "analysis.costspec", "analysis.__main__"):
        assert f"kmlserver_tpu_torch.{name}" in names, name
    proc = _run(
        f"""
        import importlib, sys
        for name in {names!r} + ["chip_smoke"]:
            importlib.import_module(name)
        bad = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith("jax.") or m == "kmlserver_tpu"
            or m.startswith("kmlserver_tpu.")
        )
        print("BAD", bad)
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot show")
    from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
    from kmlserver_tpu_torch.mining.pipeline import run_mining_job
    from kmlserver_tpu_torch.ops.popcount import popcount_pair_counts
    from kmlserver_tpu_torch.serving.engine import RecommendEngine
    from kmlserver_tpu_torch.utils.device import DeviceUnavailableError

    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        RecommendEngine(ServingConfig(base_dir=str(tmp_path)))
    with pytest.raises(DeviceUnavailableError):
        popcount_pair_counts([0], [0], n_playlists=1, n_tracks=1)
    from kmlserver_tpu_torch.data.device_synthetic import device_synthetic_bitset

    with pytest.raises(DeviceUnavailableError):
        device_synthetic_bitset(64, 32, 500, 2)
    os.makedirs(tmp_path / "datasets")
    (tmp_path / "datasets" / "2023_spotify_ds1.csv").write_text("pid,track_name\n0,a\n")
    with pytest.raises(DeviceUnavailableError):
        run_mining_job(MiningConfig(base_dir=str(tmp_path),
                                    datasets_dir=str(tmp_path / "datasets")))


def test_job_entry_point_exits_64_without_cuda_and_runs_on_cpu(tmp_path):
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card exit cannot show")
    os.makedirs(tmp_path / "datasets")
    shutil.copy(os.path.join(REPO, "datasets", "2023_spotify_ds_sample.csv"),
                tmp_path / "datasets")
    env = dict(BASE_DIR=str(tmp_path), DATASETS_DIR=str(tmp_path / "datasets"))
    code = "from kmlserver_tpu_torch.mining.job import main; raise SystemExit(main())"
    no_card = _run(code, **env)
    assert no_card.returncode == 64, no_card.stdout + no_card.stderr
    assert "CUDA is not available" in no_card.stderr
    assert not (tmp_path / "last_execution.txt").exists()
    # pinned to the bit-packed family: on the CPU it runs the kernel's
    # plain version, so no launch is counted
    on_cpu = _run(code, KMLS_TORCH_DEVICE="cpu", KMLS_COUNT_PATH="bitpack", **env)
    assert on_cpu.returncode == 0, on_cpu.stdout + on_cpu.stderr
    assert "Pair-count path: bitpack-torch" in on_cpu.stdout
    assert "Popcount kernel launches: 0" in on_cpu.stdout
    assert (tmp_path / "last_execution.txt").exists()


def test_chip_smoke_refuses_without_cuda_or_the_repo(tmp_path):
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_native_libraries_build_from_the_ports_sources_without_make(tmp_path):
    """The port's three native libraries build with g++ from
    ``kmlserver_tpu_torch/native/`` into ``build/kmls_torch_native/``: no
    port module runs ``make`` or loads a library under the repository's
    ``native/`` (the JAX package's)."""
    (tmp_path / "ds.csv").write_text("pid,track_name\n1,a\n1,b\n2,a\n")
    proc = _run(
        f"""
        import os, subprocess
        commands = []
        real_run, real_popen = subprocess.run, subprocess.Popen.__init__

        def run(cmd, *a, **k):
            commands.append(list(cmd))
            return real_run(cmd, *a, **k)

        def popen(self, cmd, *a, **k):
            commands.append(list(cmd) if not isinstance(cmd, str) else [cmd])
            return real_popen(self, cmd, *a, **k)

        subprocess.run, subprocess.Popen.__init__ = run, popen
        import numpy as np
        from kmlserver_tpu_torch.data import native
        from kmlserver_tpu_torch.data.csv import read_tracks
        from kmlserver_tpu_torch.ops import cpu_popcount
        from kmlserver_tpu_torch.serving import native_serve
        from kmlserver_tpu_torch.utils import nativelib

        table = read_tracks({str(tmp_path / "ds.csv")!r})
        assert native.LOADS == {{"native": 1, "stdlib": 0}}, native.LOADS
        counts = cpu_popcount.pair_counts(np.array([0, 0, 1]), np.array([0, 1, 0]),
                                          n_playlists=2, n_tracks=2)
        assert counts.tolist() == [[2, 1], [1, 1]]
        assert native_serve.available()
        for lib in (native._loader, cpu_popcount._loader, native_serve._LIB):
            assert lib._lib is not None, lib.error
            print("LIB", lib._lib._name)
        print("SRC", nativelib.SOURCE_DIR)
        for cmd in commands:
            print("CMD", os.path.basename(cmd[0]))
        with open("/proc/self/maps") as fh:
            for line in fh:
                if "libkmls" in line:
                    print("MAP", line.split()[-1])
        """
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    build_dir = os.path.join(REPO, "build", "kmls_torch_native") + os.sep
    libs = [line[4:] for line in lines if line.startswith("LIB ")]
    maps = {line[4:] for line in lines if line.startswith("MAP ")}
    assert len(libs) == 3 and all(p.startswith(build_dir) for p in libs), libs
    assert maps and all(p.startswith(build_dir) for p in maps), maps
    assert not any(p.startswith(os.path.join(REPO, "native") + os.sep) for p in maps)
    assert f"SRC {os.path.join(REPO, 'kmlserver_tpu_torch', 'native')}" in lines
    assert {line[4:] for line in lines if line.startswith("CMD ")} <= {"g++", "c++"}
