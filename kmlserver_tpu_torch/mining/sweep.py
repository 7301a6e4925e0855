"""Support and density sweeps — counterpart of
``kmlserver_tpu/mining/sweep.py``.

**Support sweep** (:func:`run_sweep`): the reference's ``experiment_supports``
loop (machine-learning/main.py:450-473): min_support over
``arange(0.03, 0.2, 0.0025)``, recording (missing songs, frequent items,
duration) per point into ``fp_growth_experiment_results.csv``. The pair
counts do not depend on min_support, so they are counted ONCE — on the
route the miner takes for this device (the native counter when the caller
asks for the CPU, else ``pair_count_fn``: the int8 product or the popcount
kernel, over a rank mesh when one is given) — and only the emission
re-runs per point.

**Density sweep** (:func:`run_density_sweep`): each count family timed on
synthetic baskets across a (density, shape) grid, the counts checked
bit-identical per point; the records fill the measured dispatch table
(``mining/dispatch.table_from_records``). Each family is timed as the
port's miner runs it on the device: the int8 one-hot product
(``ops/support.py``), the bit-packed count (the popcount kernel on a card,
its plain version on the CPU), and the sparse count
(``ops/sparse.sparse_pair_counts_device`` on a card, the reference's host
route on the CPU). The reference times its host route for ``sparse`` on
every backend; the table must measure what the dispatcher would run.

Run: ``python -m kmlserver_tpu_torch.mining.sweep`` (env: BASE_DIR /
DATASETS_DIR as the job, plus KMLS_SWEEP_START/STOP/STEP) and
``python -m kmlserver_tpu_torch.mining.sweep density [out.json]``; both on
``KMLS_TORCH_DEVICE`` (default ``cuda``).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..config import BASE_INDEX, MiningConfig, torch_device_from_env
from ..data.csv import read_tracks
from ..io import registry
from ..io.artifacts import atomic_write_text
from ..ops import rules as rules_mod
from ..ops.support import min_count_for
from ..utils.device import backend_name, resolve_device
from ..utils.profiling import PhaseTimer
from .miner import native_cpu_eligible, native_pair_counts, pair_count_fn, prune_infrequent
from .vocab import build_baskets

RESULTS_FILE = "fp_growth_experiment_results.csv"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sweep(
    cfg: MiningConfig,
    supports: np.ndarray,
    dataset: str | None = None,
    mesh=None,
    device: str | torch.device = "cuda",
) -> list[dict]:
    """→ one record per support point:
    ``{min_support, missing_songs, frequent_items, duration_s}``.

    With ``mesh`` (every rank calls this with the same data), the count
    runs on the mesh through the miner's ``pair_count_fn`` (the dense
    sharded count, or the bit-packed slabs all-reduced); each rank then
    emits from the whole counts it holds."""
    dev = resolve_device(device)
    if dataset is None:
        datasets = registry.get_dataset_list(cfg)
        index = registry.get_next_run_index(cfg, datasets)
        dataset = datasets[index - BASE_INDEX]
    table = read_tracks(dataset, cfg.sample_ratio)
    baskets = build_baskets(table)
    n_total = baskets.n_tracks

    # resolved before the timer: may build the native library
    use_native = native_cpu_eligible(cfg, dev, mesh)

    t0 = time.perf_counter()
    # pruning must use the SMALLEST support of the sweep to stay exact for
    # every point
    mined = baskets
    if baskets.n_tracks > cfg.prune_vocab_threshold:
        mined, _ = prune_infrequent(
            baskets, min_count_for(float(supports.min()), baskets.n_playlists)
        )
    if use_native:
        counts = native_pair_counts(mined)
        emit = rules_mod.mine_rules_from_counts_np
    else:
        counts, _, _ = pair_count_fn(
            mined, dev, PhaseTimer(dev), mesh,
            bitpack_threshold_elems=cfg.bitpack_threshold_elems,
            hbm_budget_bytes=cfg.hbm_budget_bytes,
            sharded_impl=cfg.sharded_impl,
        )
        _sync(dev)
        emit = rules_mod.mine_rules_from_counts
    count_s = time.perf_counter() - t0
    print(f"pair counts once: {count_s:.3f}s (shared across the sweep)")

    records = []
    for s in supports:
        t0 = time.perf_counter()
        tensors = emit(
            counts,
            n_playlists=mined.n_playlists,
            min_support=float(s),
            k_max=cfg.k_max_consequents,
            mode=cfg.confidence_mode,
            min_confidence=cfg.min_confidence,
            n_total_songs=n_total,
        )
        duration = time.perf_counter() - t0
        records.append(
            {
                # full precision: rounding here would move min_count_for at
                # exact-threshold points (rounded only for the CSV)
                "min_support": float(s),
                "missing_songs": tensors.n_songs_missing,
                "frequent_items": tensors.n_frequent_items,
                "duration_s": round(duration, 6),
            }
        )
        print(
            f"min_support {s:.4f}: missing {tensors.n_songs_missing}, "
            f"emission {duration * 1e3:.1f}ms"
        )
    return records


DENSITY_GRID = (0.05, 0.01, 0.002, 0.0005, 0.00005)
DENSITY_SHAPES = ((4000, 1000), (20000, 2000), (80000, 2500))
# best of this many for a banked table: on a card most points take well
# under a millisecond, where one sample's noise can flip a cell's winner
BANK_REPEAT = 5


def run_density_sweep(
    densities=DENSITY_GRID,
    shapes=DENSITY_SHAPES,
    *,
    seed: int = 123,
    max_elems: int | None = None,
    max_rows: int = 4_000_000,
    dense_max_elems: int = 1 << 25,
    sparse_max_events: int = 150_000_000,
    repeat: int = 1,
    device: str | torch.device = "cuda",
) -> list[dict]:
    """Time the three count families on synthetic baskets across the
    (density, shape) grid, check their counts bit-identical per point, and
    record each family's seconds. One record per measured point:

    ``{density, elems, shape, rows, dense_s, bitpack_s, sparse_s,
    identical, winner}``

    The reference's grid and guards: a family whose guard excludes a
    point is ``None`` there (the table then cannot pick it for the cell).
    Every family runs once before it is timed (the kernel build, the
    allocator's first blocks); a time is the best of ``repeat``, from the
    call to its counts on the device, synchronized — the copy of the
    counts to the host for the comparison is outside it."""
    from ..data.synthetic import synthetic_baskets
    from ..ops import encode, popcount, sparse
    from ..ops import support as support_ops

    dev = resolve_device(device)
    records = []
    for n_playlists, n_tracks in shapes:
        elems = n_playlists * n_tracks
        if max_elems is not None and elems > max_elems:
            continue
        for density in densities:
            target = int(density * elems)
            if target < 16 or target > max_rows:
                continue
            baskets = synthetic_baskets(
                n_playlists=n_playlists, n_tracks=n_tracks,
                target_rows=target, seed=seed,
            )
            prows, tids = baskets.playlist_rows, baskets.track_ids
            rows = len(prows)
            shape = dict(n_playlists=n_playlists, n_tracks=n_tracks)

            def best_of(fn):
                fn()  # warm
                best = out = None
                for _ in range(max(repeat, 1)):
                    _sync(dev)
                    t0 = time.perf_counter()
                    out = fn()
                    _sync(dev)
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
                return out, best

            def run_dense():
                x = encode.onehot_matrix(
                    torch.as_tensor(prows, device=dev), torch.as_tensor(tids, device=dev),
                    **shape,
                )
                return support_ops.pair_counts(x)

            def run_bitpack():
                return popcount.popcount_pair_counts(prows, tids, **shape, device=dev)

            def run_sparse():
                if dev.type == "cuda":
                    return sparse.sparse_pair_counts_device(prows, tids, **shape, device=dev)
                return sparse.sparse_pair_counts_np(prows, tids, **shape)

            results: dict[str, torch.Tensor] = {}
            timings: dict[str, float | None] = {"dense": None, "bitpack": None, "sparse": None}
            # per-family guards keep the grid affordable: an unmeasured
            # family is None, never an extrapolated number
            if elems <= dense_max_elems:
                results["dense"], timings["dense"] = best_of(run_dense)
            results["bitpack"], timings["bitpack"] = best_of(run_bitpack)
            events, _ = sparse.pair_event_count(prows, n_playlists)
            if events <= sparse_max_events:
                results["sparse"], timings["sparse"] = best_of(run_sparse)
            host = {k: torch.as_tensor(v).cpu().numpy() for k, v in results.items()}
            del results
            ref_name = next(k for k in ("dense", "bitpack") if k in host)
            identical = all(np.array_equal(host[ref_name], other) for other in host.values())
            timed = {k: v for k, v in timings.items() if v is not None}
            winner = min(timed, key=timed.get)
            records.append(
                {
                    "density": rows / max(elems, 1),
                    "elems": elems,
                    "shape": f"{n_playlists}x{n_tracks}",
                    "rows": rows,
                    **{f"{k}_s": v for k, v in timings.items()},
                    "identical": identical,
                    "winner": winner,
                }
            )
            print(
                f"density {rows / max(elems, 1):.5f} {n_playlists}x{n_tracks}: "
                + " ".join(f"{k} {v:.6f}s" for k, v in timed.items())
                + f" -> {winner} (identical={identical})"
            )
    return records


def write_results_csv(cfg: MiningConfig, records: list[dict]) -> str:
    path = os.path.join(cfg.base_dir, RESULTS_FILE)
    header = "min_support,missing_songs,frequent_items,duration_s"
    lines = [header] + [
        f'{round(r["min_support"], 6)},{r["missing_songs"]},'
        f'{r["frequent_items"]},{r["duration_s"]}'
        for r in records
    ]
    atomic_write_text(path, "\n".join(lines) + "\n")
    return path


def bank_density_table(records: list[dict], device: torch.device, out: str) -> dict:
    """Fold density-sweep records into the measured dispatch table under
    ``device``'s backend, merged over the current table, and write it to
    ``out``. → the table."""
    import socket

    from . import dispatch

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    table = dispatch.table_from_records(
        records, backend_name(device),
        measured_on=f"{socket.gethostname()}/{kind}",
        banked_at=time.time(),
        base=dispatch.load_table(),
    )
    dispatch.save_table(out, table)
    return table


def main() -> int:
    device = torch_device_from_env()
    if len(sys.argv) > 1 and sys.argv[1] == "density":
        # `python -m kmlserver_tpu_torch.mining.sweep density [out.json]`
        # (default: the packaged table the dispatcher consults)
        from . import dispatch

        device = resolve_device(device)
        records = run_density_sweep(repeat=BANK_REPEAT, device=device)
        out = sys.argv[2] if len(sys.argv) > 2 else dispatch.builtin_table_path()
        bank_density_table(records, device, out)
        print(
            f"wrote measured dispatch table ({len(records)} points, "
            f"backend {backend_name(device)}) to {out}"
        )
        return 0
    cfg = MiningConfig.from_env()
    start = float(os.getenv("KMLS_SWEEP_START", "0.03"))
    stop = float(os.getenv("KMLS_SWEEP_STOP", "0.2"))
    step = float(os.getenv("KMLS_SWEEP_STEP", "0.0025"))
    supports = np.arange(start, stop, step)  # reference grid (main.py:452)
    # the job's KMLS_MESH_SHAPE contract, the multi-rank bootstrap included
    from ..parallel.distributed import maybe_initialize, resolve_mesh, shutdown

    # before the first touch of the device: it pins the rank's card
    distributed = maybe_initialize(device=device)
    records = run_sweep(
        cfg, supports, mesh=resolve_mesh(cfg.mesh_shape, distributed=distributed),
        device=device,
    )
    path = write_results_csv(cfg, records)
    print(f"wrote {len(records)} sweep points to {path}")
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
