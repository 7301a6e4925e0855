"""No run loads JAX or the JAX package; a run without a card prints no
result."""

import json
import os
import subprocess
import sys
from pathlib import Path

from kmls_bench.isolation import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_whole_top_level_names_are_compared():
    assert forbidden_modules(["kmlserver_tpu_torch", "kmlserver_tpu_torch.ops", "numpy"]) == []
    assert forbidden_modules(["kmlserver_tpu.ops.serve", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "kmlserver_tpu"]
    assert forbidden_modules(["jaxtyping", "kmlserver_tpu_other"]) == []


def test_what_a_run_imports_loads_no_jax():
    code = (
        "import sys\n"
        "import kmls_bench.run, kmls_bench.cells.mine, kmls_bench.cells.serve, kmls_bench.control\n"
        "import kmls_bench.serve_child, kmls_bench.publication, kmls_bench.trace\n"
        "import kmlserver_tpu_torch.serving.server, kmlserver_tpu_torch.serving.engine\n"
        "import kmlserver_tpu_torch.data.device_synthetic, kmlserver_tpu_torch.ops.rules\n"
        "import kmlserver_tpu_torch.ops.popcount, kmlserver_tpu_torch.io.artifacts\n"
        "from kmls_bench.isolation import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result_is_printed():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "kmls_bench.run", "--workload", "config4_job.mine", "--seed",
         "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_names_files_under_its_paths():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["kmls_bench"]
    for cfg in bench["configs"]:
        assert (ROOT / cfg["file"]).is_file()
    for cell in bench["workloads"]:
        assert (ROOT / "kmls_bench" / "traffic" / f"{cell['traffic']}.json").is_file()
    for m in bench["per_layer"]:
        assert (ROOT / "kmls_bench" / "metrics" / f"{m['name']}.py").is_file()
