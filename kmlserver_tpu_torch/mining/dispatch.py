"""Measured count-path dispatch: dense vs bitpack vs sparse, by evidence —
a copy of ``kmlserver_tpu/mining/dispatch.py``.

Three families can count pairs, and the right choice depends on where the
workload sits in (density, size) space: the dense int8 product wins at
small sizes, the bit-packed popcount when the dense operand cannot fit,
the sparse hybrid when the matrix is mostly air. The decision:

- the key is the (density band, element-count band) cell of a small 2-D
  grid (:func:`table_cell`);
- the table's cells come from a density sweep, banked per backend: the
  port's ``dispatch_table.json`` holds the reference's ``cpu`` cells
  unchanged and the ``gpu`` cells its own sweep
  (``mining/sweep.py::run_density_sweep``) banked on an H100, looked up on
  a CUDA device under ``"gpu"`` (``utils/device.py::backend_name``); a
  cell no sweep measured falls through to the heuristic;
- :func:`plan_count_path` consults the table at plan time (one O(nnz) host
  bincount measures the exact density and pair-event volume), and the
  chosen path + its provenance ride ``MiningResult.count_path`` /
  ``count_path_source``;
- ``KMLS_COUNT_PATH=dense|bitpack|sparse`` pins a family; any other
  spelling fails SAFE to the auto behavior with a loud warning. ``auto``
  (the default) and a missing/unparseable table degrade to the
  ``bitpack_wanted`` heuristic.

Explicit ``bitpack_threshold_elems`` values (an int, or "none"/"never")
keep their historical meaning and BYPASS the table.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os

logger = logging.getLogger("kmlserver_tpu_torch.dispatch")

PATHS = ("dense", "bitpack", "sparse")

# band upper edges; the last band is everything above the final edge.
# Chosen to straddle the regimes the density sweep actually measures:
# >5% (toy/dense), 1-5% (ds2-like), 0.1-1%, 0.01-0.1%, <0.01% (the
# production playlist regime — millions of users, tens-of-track baskets)
DENSITY_EDGES = (0.0001, 0.001, 0.01, 0.05)
ELEMS_EDGES = (1 << 22, 1 << 26, 1 << 30)

TABLE_FILENAME = "dispatch_table.json"
TABLE_VERSION = 1


def _band(value: float, edges: tuple) -> int:
    for i, edge in enumerate(edges):
        if value <= edge:
            return i
    return len(edges)


def table_cell(density: float, elems: float) -> str:
    """The lookup key for a workload: ``"d<i>:e<j>"`` band coordinates."""
    return f"d{_band(density, DENSITY_EDGES)}:e{_band(elems, ELEMS_EDGES)}"


@dataclasses.dataclass(frozen=True)
class CountPlan:
    """One resolved dispatch decision, with its provenance for telemetry."""

    path: str  # "dense" | "bitpack" | "sparse"
    source: str  # "override" | "threshold" | "table" | "heuristic"
    density: float
    elems: int
    cell: str
    # exact Σ k(k-1)/2 over short baskets (None: not measured — sparse
    # was never a candidate for this plan)
    pair_events: int | None = None


def resolve_override(value: str | None) -> str | None:
    """``KMLS_COUNT_PATH`` → a pinned path, or None for auto. The
    fail-safe direction: anything unrecognized behaves exactly like
    auto (the current behavior), loudly."""
    if value in (None, ""):
        return None
    word = str(value).strip().lower()
    if word == "auto":
        return None
    if word in PATHS:
        return word
    logger.warning(
        "KMLS_COUNT_PATH=%r is not one of %s/auto; keeping the measured "
        "auto dispatch (fail-safe)", value, "/".join(PATHS),
    )
    return None


_table_cache: dict[tuple[str, float], dict | None] = {}


def builtin_table_path() -> str:
    return os.path.join(os.path.dirname(__file__), TABLE_FILENAME)


def load_table(path: str | None = None) -> dict | None:
    """The measured dispatch table: ``path`` argument >
    ``KMLS_DISPATCH_TABLE`` env > the packaged bench-banked file. A
    missing or unparseable table is None (plan falls back to the
    heuristic — fail-safe, with a warning for an EXPLICITLY configured
    table only; the packaged file missing is a clean checkout state,
    not an operator error). Cached per (path, mtime)."""
    explicit = path or os.environ.get("KMLS_DISPATCH_TABLE") or None
    resolved = explicit or builtin_table_path()
    try:
        mtime = os.path.getmtime(resolved)
    except OSError:
        if explicit:
            logger.warning(
                "dispatch table %s unreadable; using the heuristic "
                "fallback", resolved,
            )
        return None
    key = (resolved, mtime)
    if key in _table_cache:
        return _table_cache[key]
    try:
        with open(resolved, "rb") as fh:
            table = json.load(fh)
        if table.get("version") != TABLE_VERSION or "backends" not in table:
            raise ValueError(f"unsupported table shape {sorted(table)}")
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        logger.warning(
            "dispatch table %s invalid (%s); using the heuristic fallback",
            resolved, exc,
        )
        table = None
    _table_cache.clear()  # one live entry; stale mtimes must not pile up
    _table_cache[key] = table
    return table


def table_lookup(
    table: dict | None, backend: str, cell: str
) -> dict | None:
    """→ the measured cell record ``{"path": ..., "rows_per_s": {...}}``
    or None when this (backend, cell) was never measured."""
    if not table:
        return None
    backend_entry = table.get("backends", {}).get(backend)
    if not backend_entry:
        return None
    rec = backend_entry.get("cells", {}).get(cell)
    if not isinstance(rec, dict) or rec.get("path") not in PATHS:
        return None
    return rec


def sparse_feasible(
    n_tracks: int,
    pair_events: int | None,
    hbm_budget_bytes: int,
    long_rows: int = 0,
    k_max: int = 256,
    backend: str = "cpu",
) -> bool:
    """Memory-feasibility gate for the sparse family, matching what the
    miner would ACTUALLY run: the fully-sparse count→emit (no ``(V, V)``
    matrix ever) exists only on the CPU route with no long baskets —
    there the plan charges the event stream (keys + sort scratch) plus
    the rule tensors. Every other route (long-basket fallback, and the
    device scatter-add twin any non-CPU backend dispatches) materializes
    the full count matrix, so the matrix plus accumulator transients
    (~16 bytes/cell worst-case) must fit. A plan-time event measurement
    must exist either way. Event COUNT is a speed question, not a
    feasibility one — the measured table owns speed."""
    if pair_events is None:
        return False
    if long_rows or backend != "cpu":
        return 16 * n_tracks * n_tracks <= hbm_budget_bytes
    return (
        32 * pair_events + 8 * k_max * n_tracks <= hbm_budget_bytes
    )


def plan_count_path(
    cfg,
    n_playlists: int,
    n_tracks: int,
    nnz: int,
    *,
    backend: str,
    n_devices: int = 1,
    baskets=None,
    table: dict | None = None,
) -> CountPlan:
    """THE three-family dispatch decision (the seam the miner resolves
    through; in the reference the support sweep and the delta recount too).

    Order: explicit ``KMLS_COUNT_PATH`` override → explicit legacy
    threshold semantics → measured table cell → legacy heuristic (with
    sparse as the new last-resort capability when NEITHER dense-shaped
    formulation fits the budget but the sparse one does).
    """
    from ..ops import sparse as sparse_mod
    from .miner import bitpack_wanted

    density = nnz / max(n_playlists * n_tracks, 1)
    elems = n_playlists * n_tracks
    cell = table_cell(density, elems)
    threshold = getattr(cfg, "bitpack_threshold_elems", "auto")
    budget = getattr(cfg, "hbm_budget_bytes", 12 << 30)
    pair_events: int | None = None
    long_rows = 0
    if baskets is not None:
        pair_events, long_rows = sparse_mod.pair_event_count(
            baskets.playlist_rows, n_playlists,
            getattr(cfg, "sparse_long_basket", 0) or None,
        )
    k_max = getattr(cfg, "k_max_consequents", 256)

    override = resolve_override(getattr(cfg, "count_path", None))
    if override is not None:
        return CountPlan(
            path=override, source="override", density=density,
            elems=elems, cell=cell, pair_events=pair_events,
        )

    if threshold != "auto":
        # the historical explicit contract: an int element count or
        # none/never pins the dense-vs-bitpack decision — tests, demos
        # and deployments that force a path this way keep working
        path = "bitpack" if bitpack_wanted(
            n_playlists, n_tracks, threshold,
            hbm_budget_bytes=budget, n_devices=n_devices,
            n_rows=nnz, backend=backend,
        ) else "dense"
        return CountPlan(
            path=path, source="threshold", density=density,
            elems=elems, cell=cell, pair_events=pair_events,
        )

    rec = table_lookup(
        table if table is not None
        else load_table(getattr(cfg, "dispatch_table", "") or None),
        backend, cell,
    )
    if rec is not None:
        path = rec["path"]
        feasible = True
        if path == "sparse":
            feasible = sparse_feasible(
                n_tracks, pair_events, budget, long_rows, k_max,
                backend=backend,
            )
        elif path == "dense":
            # the table measured small shapes; dense must still FIT here
            feasible = not bitpack_wanted(
                n_playlists, n_tracks, "auto",
                hbm_budget_bytes=budget, n_devices=n_devices, n_rows=nnz,
            )
        if feasible:
            return CountPlan(
                path=path, source="table", density=density,
                elems=elems, cell=cell, pair_events=pair_events,
            )

    # legacy heuristic, unchanged — plus the one new capability: when
    # neither dense-shaped formulation fits the budget but sparse does,
    # mine sparse instead of proceeding toward an allocator failure
    wants_bitpack = bitpack_wanted(
        n_playlists, n_tracks, "auto",
        hbm_budget_bytes=budget, n_devices=n_devices,
        n_rows=nnz, backend=backend,
    )
    path = "bitpack" if wants_bitpack else "dense"
    if wants_bitpack and sparse_feasible(
        n_tracks, pair_events, budget, long_rows, k_max, backend=backend
    ):
        from .miner import bitpack_plan_bytes

        if bitpack_plan_bytes(
            n_playlists, n_tracks, n_devices=n_devices, n_rows=nnz
        ) > budget:
            path = "sparse"
            print(
                "NOTE: neither dense-shaped formulation fits the HBM "
                "budget but the sparse event stream does "
                f"({pair_events} pair events) — mining SPARSE instead "
                "of risking the allocator failure warned above"
            )
    return CountPlan(
        path=path, source="heuristic", density=density,
        elems=elems, cell=cell, pair_events=pair_events,
    )


def table_from_records(
    records: list[dict],
    backend: str,
    *,
    measured_on: str,
    banked_at: float,
    base: dict | None = None,
) -> dict:
    """Fold density-sweep records (``mining/sweep.py::run_density_sweep``:
    one record per measured (density, shape) point with per-path ``<path>_s``
    timings) into a dispatch table, merging over ``base`` so
    successive bench rounds accumulate cells per backend exactly like
    the bench bank merges brackets. The winner of a cell measured twice
    is the NEWER measurement (same newest-wins rule as the bank)."""
    table: dict = {
        "version": TABLE_VERSION,
        "banked_at": banked_at,
        "density_edges": list(DENSITY_EDGES),
        "elems_edges": list(ELEMS_EDGES),
        "backends": {},
    }
    if base and base.get("version") == TABLE_VERSION:
        for b, entry in base.get("backends", {}).items():
            table["backends"][b] = {
                "measured_on": entry.get("measured_on", ""),
                "banked_at": entry.get("banked_at", 0.0),
                "cells": dict(entry.get("cells", {})),
            }
    entry = table["backends"].setdefault(
        backend, {"measured_on": measured_on, "banked_at": banked_at, "cells": {}}
    )
    entry["measured_on"] = measured_on
    entry["banked_at"] = banked_at
    for rec in records:
        timings = {
            p: rec[f"{p}_s"]
            for p in PATHS
            if rec.get(f"{p}_s") is not None
        }
        if not timings:
            continue
        winner = min(timings, key=timings.get)
        entry["cells"][table_cell(rec["density"], rec["elems"])] = {
            "path": winner,
            "rows_per_s": {
                p: round(rec["rows"] / s, 1) for p, s in timings.items() if s > 0
            },
            "shape": rec.get("shape", ""),
            "identical": rec.get("identical"),
        }
    return table


def save_table(path: str, table: dict) -> None:
    """Persist a measured table (atomic, like every artifact write)."""
    from ..io.artifacts import atomic_write_text

    atomic_write_text(path, json.dumps(table, indent=1, sort_keys=True) + "\n")
