"""Vocabulary + auxiliary mapping artifacts (reference components M5-M8, M10).

Everything here is the host-side ID⇄name layer the device kernels depend on:
the mining compute works on dense int track-ids; these builders produce the
id↔name vocabulary plus the four auxiliary artifacts the reference pickles
(reference: machine-learning/main.py:51-133, 168-184, 195-207).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..data.csv import TrackTable


class DuplicateArtistURIError(ValueError):
    """Raised when one artist_name maps to more than one artist_uri —
    mirroring the reference's validation failure
    (reference: machine-learning/main.py:62-68)."""


@dataclasses.dataclass
class Vocab:
    """Track-name vocabulary: sorted unique names ↔ dense int ids."""

    names: list[str]
    index: dict[str, int]

    @staticmethod
    def build(track_names: np.ndarray) -> "Vocab":
        names = sorted(set(track_names.tolist()))
        return Vocab(names=names, index={n: i for i, n in enumerate(names)})

    def __len__(self) -> int:
        return len(self.names)

    def encode(self, track_names: np.ndarray) -> np.ndarray:
        """Vectorized name→id (int32) via binary search over the sorted name
        array (the per-row Python dict loop costs seconds at reference CSV
        scale). Unknown names map to -1."""
        names_arr = np.asarray(self.names, dtype=object)
        queries = np.asarray(track_names, dtype=object)
        pos = np.searchsorted(names_arr, queries)
        pos = np.clip(pos, 0, len(names_arr) - 1)
        ids = np.where(names_arr[pos] == queries, pos, -1)
        return ids.astype(np.int32)


def validate_and_map_artists(table: TrackTable) -> dict[str, str]:
    """artist_name → artist_uri, raising if any name maps to >1 distinct URI
    (reference: validate_and_map_artists_names_to_ids main.py:51-83)."""
    if table.artist_name is None or table.artist_uri is None:
        return {}
    mapping: dict[str, str] = {}
    duplicates: dict[str, set[str]] = {}
    for name, uri in zip(table.artist_name, table.artist_uri):
        name, uri = str(name), str(uri)
        prev = mapping.get(name)
        if prev is None:
            mapping[name] = uri
        elif prev != uri:
            duplicates.setdefault(name, {prev}).add(uri)
    if duplicates:
        raise DuplicateArtistURIError(
            f"{len(duplicates)} artist names map to multiple URIs, e.g. "
            f"{dict(list(duplicates.items())[:3])}"
        )
    return mapping


def extract_repeated_track_names(table: TrackTable) -> dict[str, list[str]]:
    """track_name → list of distinct track_uris, only for names with >1 URI
    (reference: extract_repeated_track_names main.py:86-109)."""
    if table.track_uri is None:
        return {}
    uris: dict[str, set[str]] = {}
    for name, uri in zip(table.track_name, table.track_uri):
        uris.setdefault(str(name), set()).add(str(uri))
    return {name: sorted(u) for name, u in uris.items() if len(u) > 1}


def map_track_ids_to_info(table: TrackTable) -> dict[str, dict[str, str]]:
    """track_uri → first-seen {track_name, artist_name, album_name}
    (reference: map_song_ids_to_song_info main.py:112-133)."""
    if table.track_uri is None:
        return {}
    info: dict[str, dict[str, str]] = {}
    artist = table.artist_name if table.artist_name is not None else np.repeat("", len(table))
    album = table.album_name if table.album_name is not None else np.repeat("", len(table))
    for uri, name, art, alb in zip(table.track_uri, table.track_name, artist, album):
        uri = str(uri)
        if uri not in info:
            info[uri] = {
                "track_name": str(name),
                "artist_name": str(art),
                "album_name": str(alb),
            }
    return info


def most_frequent_tracks(
    table: TrackTable, top_percentile: float
) -> list[dict[str, object]]:
    """Row-count popularity ranking, keeping the top ``top_percentile``
    fraction, as a list of ``{"track_name": ..., "count": ...}`` descending —
    the exact ``best_tracks.pickle`` object shape
    (reference: get_most_frequent_tracks + filter_best_tracks
    main.py:168-184, saved at :443-446).

    The keep count TRUNCATES (``int(N · pct)``, no minimum) to match the
    reference's slice — with a tiny vocabulary this can legitimately be
    empty, exactly as a reference-written PVC could be."""
    names, counts = np.unique(table.track_name, return_counts=True)
    order = np.lexsort((names, -counts))  # count desc, name asc for stable ties
    keep = int(len(names) * top_percentile)
    return [
        {"track_name": str(names[i]), "count": int(counts[i])}
        for i in order[:keep]
    ]


@dataclasses.dataclass
class Baskets:
    """The transaction DB in tensor form: deduplicated (playlist_row, track_id)
    membership pairs over dense ids — the device-side replacement for the
    reference's ``{pid: [track_name, ...]}`` dict
    (reference: group_tracks_by_playlist_and_generate_homogeneous_data
    main.py:195-207)."""

    playlist_rows: np.ndarray  # int32, dense 0..P-1
    track_ids: np.ndarray  # int32, dense 0..V-1
    n_playlists: int
    vocab: Vocab

    @property
    def n_tracks(self) -> int:
        return len(self.vocab)


def build_baskets(table: TrackTable, vocab: Vocab | None = None) -> Baskets:
    """Group memberships by pid into dense-id pairs, deduplicating repeated
    (pid, track) rows so each membership contributes one count — matching the
    reference, where baskets are dicts keyed by name and the one-hot encoder
    sets a boolean (machine-learning/main.py:195-207, 267-269)."""
    vocab = vocab or Vocab.build(table.track_name)
    pids, playlist_rows = np.unique(table.pid, return_inverse=True)
    track_ids = vocab.encode(table.track_name)
    valid = track_ids >= 0
    pairs = np.stack(
        [playlist_rows[valid].astype(np.int64), track_ids[valid].astype(np.int64)], axis=1
    )
    pairs = np.unique(pairs, axis=0)
    return Baskets(
        playlist_rows=pairs[:, 0].astype(np.int32),
        track_ids=pairs[:, 1].astype(np.int32),
        n_playlists=len(pids),
        vocab=vocab,
    )
