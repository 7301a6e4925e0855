"""Dataset registry, run-history rotation, and the invalidation token.

This is the reference's inter-run scheduling state (reference:
machine-learning/main.py:315-411): a ``datasets_list.txt`` enumerating the
discovered CSVs, a ``dataset_history.csv`` append-only run log whose last line
drives a wraparound index rotation (so alternate runs mine alternate
datasets — the system's pseudo-cron state machine), and the
``last_execution.txt`` token whose rewrite is THE cross-workload cache
invalidation signal every API replica polls
(reference: machine-learning/main.py:406-408 → rest_api/app/main.py:82-97).

The file formats are byte-compatible with the reference so either side could
run against a PVC the other populated:
- ``dataset_history.csv`` has header ``time,dataset_index,dataset_file`` and
  rows ``{time},{index},{file}`` (reference: machine-learning/main.py:394-405);
- first run discovers datasets by glob and persists the sorted list;
- each run reads the history's last index, adds 1, wraps to ``BASE_INDEX``
  when past the end (reference: machine-learning/main.py:386-387);
- each run appends its row and rewrites the token.
"""

from __future__ import annotations

import glob as _glob
import os

from ..config import BASE_INDEX, MiningConfig
from ..utils.timeutil import get_current_time_str_precise
from .artifacts import atomic_write_text, read_text

HISTORY_HEADER = "time,dataset_index,dataset_file"


def discover_datasets(cfg: MiningConfig) -> list[str]:
    """Glob ``datasets_dir`` for dataset CSVs (reference: main.py:315-320, :38)."""
    pattern = os.path.join(cfg.datasets_dir, cfg.regex_filename)
    return sorted(_glob.glob(pattern))


def _datasets_list_path(cfg: MiningConfig) -> str:
    return os.path.join(cfg.base_dir, cfg.datasets_list_file)


def _history_path(cfg: MiningConfig) -> str:
    return os.path.join(cfg.base_dir, cfg.dataset_history_file)


def token_path_for(base_dir: str, data_invalidation_file: str) -> str:
    return os.path.join(base_dir, data_invalidation_file)


def write_dataset_list(cfg: MiningConfig, datasets: list[str]) -> None:
    """Persist the discovered dataset list (reference: main.py:329-346)."""
    atomic_write_text(_datasets_list_path(cfg), "\n".join(datasets) + "\n")


def read_dataset_list(cfg: MiningConfig) -> list[str]:
    """Read the persisted dataset list (reference: main.py:322-327)."""
    text = read_text(_datasets_list_path(cfg))
    return [
        line for line in (raw.strip() for raw in text.splitlines()) if line
    ]


def get_dataset_list(cfg: MiningConfig, persist: bool = True) -> list[str]:
    """First run: discover + persist; later runs: read the persisted list
    (reference: main.py:315-346 call pattern at :425).

    ``persist=False`` skips the first-run write — non-zero ranks of a
    multi-host job must not race rank 0 on the shared PVC (the sorted glob
    over the same volume is deterministic, so every rank sees one list)."""
    path = _datasets_list_path(cfg)
    if os.path.exists(path):
        existing = read_dataset_list(cfg)
        if existing:
            return existing
    datasets = discover_datasets(cfg)
    if not datasets:
        raise FileNotFoundError(
            f"no datasets matching {cfg.regex_filename!r} under {cfg.datasets_dir!r}"
        )
    if persist:
        write_dataset_list(cfg, datasets)
    return datasets


def read_history(cfg: MiningConfig) -> list[tuple[str, int, str]]:
    """Parse ``dataset_history.csv`` rows as ``(time, index, dataset_file)``
    (reference: main.py:349-362; row layout documented at main.py:377-378).

    Malformed lines are skipped (the reference instead falls back to
    ``BASE_INDEX`` when the *last* line is malformed, main.py:389-392 — here a
    corrupt tail degrades to the last parseable record instead of restarting
    the rotation).
    """
    path = _history_path(cfg)
    if not os.path.exists(path):
        return []
    rows: list[tuple[str, int, str]] = []
    for line in read_text(path).splitlines():
        line = line.strip()
        if not line or line == HISTORY_HEADER:
            continue
        parts = line.split(",", 2)
        if len(parts) != 3:
            continue
        try:
            rows.append((parts[0].strip(), int(parts[1].strip()), parts[2].strip()))
        except ValueError:
            continue
    return rows


def get_next_run_index(cfg: MiningConfig, datasets: list[str]) -> int:
    """Last history index + 1, wrapping to ``BASE_INDEX`` past the end of the
    dataset list (reference: main.py:364-392; wraparound :386-387).

    Indices are 1-based like the reference's ``BASE_INDEX = 1``
    (machine-learning/main.py:46).
    """
    history = read_history(cfg)
    if not history:
        return BASE_INDEX
    next_index = history[-1][1] + 1
    if next_index > len(datasets) + BASE_INDEX - 1:
        next_index = BASE_INDEX
    return next_index


def append_history_and_invalidate(
    cfg: MiningConfig, run_index: int, dataset: str, timestamp: str | None = None
) -> str:
    """Append the run record and rewrite the invalidation token — the only
    cross-workload signal in the system (reference: main.py:394-411; token
    write :406-408). Returns the token value written."""
    timestamp = timestamp or get_current_time_str_precise()
    path = _history_path(cfg)
    os.makedirs(cfg.base_dir, exist_ok=True)
    is_new = not os.path.exists(path)
    with open(path, "a", encoding="utf-8") as fh:
        if is_new:
            fh.write(HISTORY_HEADER + "\n")
        fh.write(f"{timestamp},{run_index},{dataset}\n")
    token = timestamp
    atomic_write_text(token_path_for(cfg.base_dir, cfg.data_invalidation_file), token)
    return token
