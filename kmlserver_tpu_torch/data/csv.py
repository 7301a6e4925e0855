"""CSV ingestion — counterpart of ``kmlserver_tpu/data/csv.py``, on the
stdlib ``csv`` module and numpy (no pandas).

Semantics are the reference loader's: RFC-4180 fields (quotes, ``""``
escapes, embedded commas and newlines), every column except ``pid`` kept
as its verbatim string (empty cells stay ``""``), ``pid`` parsed as a
strict int64 (a float spelling such as ``1.0`` is an error, never a silent
truncation), ``DROP_COLUMNS`` dropped, and ``sample_ratio`` a head slice of
``max(1, int(n · ratio))`` rows.

Expected schema: ``pid, track_uri, track_name, artist_name, artist_uri,
album_name, duration_ms`` (extra columns tolerated); only ``pid`` and
``track_name`` are required.
"""

from __future__ import annotations

import csv
import dataclasses
import re
from collections.abc import Iterable

import numpy as np

from ..config import DROP_COLUMNS

REQUIRED_COLUMNS = ("pid", "track_name")
OPTIONAL_COLUMNS = ("track_uri", "artist_name", "artist_uri", "album_name")

# what strtoll accepts with nothing left over: leading space, a sign, digits
_PID = re.compile(r"[ \t\n\v\f\r]*[+-]?[0-9]+")
_INT64 = np.iinfo(np.int64)


@dataclasses.dataclass
class TrackTable:
    """Row-oriented membership table: one row per (playlist, track) pair."""

    pid: np.ndarray  # int64
    track_name: np.ndarray  # object (str)
    track_uri: np.ndarray | None = None
    artist_name: np.ndarray | None = None
    artist_uri: np.ndarray | None = None
    album_name: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.pid)

    @property
    def n_playlists(self) -> int:
        return len(np.unique(self.pid))

    @property
    def n_tracks(self) -> int:
        return len(np.unique(self.track_name))


def _parse_pids(path: str, values: list[str]) -> np.ndarray:
    pids = np.empty(len(values), dtype=np.int64)
    for i, raw in enumerate(values):
        if not _PID.fullmatch(raw):
            raise ValueError(f"{path}: invalid pid column: row {i + 1}: {raw[:64]!r}")
        value = int(raw)
        if not _INT64.min <= value <= _INT64.max:
            raise ValueError(f"{path}: invalid pid column: row {i + 1} exceeds int64")
        pids[i] = value
    return pids


def read_tracks(path: str, sample_ratio: float = 1.0) -> TrackTable:
    """Read a membership CSV, optionally head-sampling ``sample_ratio`` of
    the rows, and drop ``duration_ms`` (reference: read_tracks
    main.py:152-166 + clean_df main.py:148-150)."""
    with open(path, newline="", encoding="utf-8", errors="replace") as fh:
        return parse_tracks(fh, path, sample_ratio)


def parse_tracks(
    fh: Iterable[str], path: str, sample_ratio: float = 1.0
) -> TrackTable:
    """:func:`read_tracks` over an open text stream (opened with
    ``newline=""``): a header line, then the rows. ``path`` names the
    source in errors. The delta route parses appended rows through this
    one parser, so they read exactly as a full read of the file would."""
    reader = csv.reader(fh)
    header = next(reader, None)
    if header is None:
        raise ValueError(f"{path}: empty file, no header")
    rows = [row for row in reader if row]
    missing = [c for c in REQUIRED_COLUMNS if c not in header]
    if missing:
        raise ValueError(f"{path}: missing required columns {missing}; has {header}")
    for n, row in enumerate(rows):
        if len(row) != len(header):
            raise ValueError(
                f"{path}: row {n + 1} has {len(row)} fields, header has {len(header)}"
            )
    if 0 < sample_ratio < 1.0:
        rows = rows[: max(1, int(len(rows) * sample_ratio))]
    columns = list(zip(*rows)) if rows else [()] * len(header)

    def col(name: str) -> np.ndarray | None:
        if name not in header or name in DROP_COLUMNS:
            return None
        values = np.empty(len(rows), dtype=object)
        values[:] = columns[header.index(name)]
        return values

    return TrackTable(
        pid=_parse_pids(path, list(columns[header.index("pid")])),
        track_name=col("track_name"),
        track_uri=col("track_uri"),
        artist_name=col("artist_name"),
        artist_uri=col("artist_uri"),
        album_name=col("album_name"),
    )


def write_tracks_csv(path: str, table: TrackTable) -> None:
    """Emit a membership table as CSV (tests and the synthetic generator;
    the reference has no writer — its datasets are inputs only)."""
    names = ["pid", "track_name"] + [
        c for c in OPTIONAL_COLUMNS if getattr(table, c) is not None
    ]
    cols = [getattr(table, c) for c in names]
    with open(path, "w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(names)
        writer.writerows(zip(*(c.tolist() for c in cols)))
