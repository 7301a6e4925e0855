"""Run one cell of the benchmark once and print its result line.

    python3 -m kmls_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root. The cell, its configuration, its traffic mix
and its metrics come from ``BENCHMARK.json``; the configuration's
``driver`` names the module of :mod:`kmls_bench.cells` that runs it.
Standard output's last line is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
traced its per-layer ones), ``device``, traced ``breakdown``, and last
``checks``, each number the check compared beside its limit (also the
last lines of standard error). Without a card, with fewer cards than the
cell asks for, or when the run loaded JAX or the JAX package, it prints
no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load_cell(name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix and metric entries."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}

    def reports(m: dict) -> bool:
        return name in m["workloads"] if "workloads" in m else m["moves"] in reported

    layer = [m for m in bench["per_layer"] if reports(m)]
    return {
        "cell": cell,
        "config": json.loads((HERE / "configs" / f"{cell['config']}.json").read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "end_to_end": e2e, "per_layer": layer,
    }


def reader(metric: str):
    """The per-layer reader ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"kmls_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(spec: dict, *, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, **extra) -> dict:
    """Drive the cell → its result line (a dict, ``checks`` last)."""
    driver = importlib.import_module(f"kmls_bench.cells.{spec['config']['driver']}")
    out = driver.run(config=spec["config"], traffic=spec["traffic"], seed=seed, seconds=seconds,
                     trace=trace, device=device, t_start=t_start, **extra)
    checks = out["checks"]
    correct = out["attempted"] > 0 and all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        metrics, ctx = {}, out["layer"]
        for m in spec["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        tr = ctx["trace"]
        result["device"] = {**out["device"], "busy_s": tr.busy_s, "window_s": tr.window_s}
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        result["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                             for m in spec["end_to_end"]}
        result["device"] = out["device"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    result["_notes"] = out.get("notes", {})
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m kmls_bench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = load_cell(args.workload)
    import torch

    from kmls_bench.isolation import forbidden_modules

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark drives the port alone",
              file=sys.stderr)
        return 3
    notes = result.pop("_notes")
    from kmls_bench.cells import power_limit

    print(f"card: {power_limit()}; notes: {json.dumps(notes)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
