"""Synthetic basket generation — the scale driver the reference lacks.

BASELINE.json's configs go up to 10M playlists × 1M tracks; the reference has
no generator (its datasets are course-provided CSVs, two of which are not in
the repo). This produces Zipf-popularity membership data shaped like the real
ds2 (240,249 rows over 2,246 playlists × 2,171 tracks — relatorio.pdf p.6)
at any scale, deterministically.

Generation is vectorized numpy: draw playlist sizes (Poisson around the
target mean), draw track ids from a Zipf(s) law, then deduplicate
(playlist, track) pairs — matching how real playlists can't contain a track
twice (the reference's encoder has the same set semantics,
machine-learning/main.py:267-269).
"""

from __future__ import annotations

import numpy as np

from ..mining.vocab import Baskets, Vocab
from .csv import TrackTable


def zipf_weights(n_tracks: int, exponent: float = 1.0) -> np.ndarray:
    w = 1.0 / np.arange(1, n_tracks + 1, dtype=np.float64) ** exponent
    return w / w.sum()


def synthetic_memberships(
    n_playlists: int,
    n_tracks: int,
    target_rows: int,
    *,
    zipf_exponent: float = 1.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """→ deduplicated ``(playlist_rows int32, track_ids int32)`` with roughly
    ``target_rows`` memberships."""
    rng = np.random.default_rng(seed)
    # oversample draws: Zipf popularity makes duplicate (playlist, track)
    # draws common, and dedup would otherwise undershoot the target density
    draw_rows = int(target_rows * 1.8)
    mean_len = max(draw_rows / n_playlists, 1.0)
    sizes = np.maximum(rng.poisson(mean_len, size=n_playlists), 1)
    playlist_rows = np.repeat(np.arange(n_playlists, dtype=np.int64), sizes)
    track_ids = rng.choice(
        n_tracks, size=playlist_rows.shape[0], p=zipf_weights(n_tracks, zipf_exponent)
    )
    key = playlist_rows * np.int64(n_tracks) + track_ids
    unique_key = np.unique(key)
    if len(unique_key) > target_rows:
        unique_key = np.sort(
            rng.choice(unique_key, size=target_rows, replace=False)
        )
    return (
        (unique_key // n_tracks).astype(np.int32),
        (unique_key % n_tracks).astype(np.int32),
    )


def synthetic_baskets(
    n_playlists: int,
    n_tracks: int,
    target_rows: int,
    *,
    zipf_exponent: float = 1.0,
    seed: int = 0,
) -> Baskets:
    """Basket tensor ready for the miner, with a generated name vocabulary."""
    rows, tids = synthetic_memberships(
        n_playlists, n_tracks, target_rows, zipf_exponent=zipf_exponent, seed=seed
    )
    names = [f"Track {i:07d}" for i in range(n_tracks)]
    vocab = Vocab(names=names, index={n: i for i, n in enumerate(names)})
    return Baskets(
        playlist_rows=rows, track_ids=tids, n_playlists=n_playlists, vocab=vocab
    )


def synthetic_table(
    n_playlists: int,
    n_tracks: int,
    target_rows: int,
    *,
    zipf_exponent: float = 1.0,
    seed: int = 0,
) -> TrackTable:
    """Full membership table (with uri/artist/album metadata) for exercising
    the complete pipeline incl. the aux-artifact builders."""
    rows, tids = synthetic_memberships(
        n_playlists, n_tracks, target_rows, zipf_exponent=zipf_exponent, seed=seed
    )
    names = np.asarray([f"Track {i:07d}" for i in range(n_tracks)], dtype=object)
    artists = np.asarray([f"Artist {i % 997:04d}" for i in range(n_tracks)], dtype=object)
    return TrackTable(
        pid=rows.astype(np.int64),
        track_name=names[tids],
        track_uri=np.asarray([f"spotify:track:{t:07d}" for t in tids], dtype=object),
        artist_name=artists[tids],
        artist_uri=np.asarray(
            [f"spotify:artist:{t % 997:04d}" for t in tids], dtype=object
        ),
        album_name=np.asarray([f"Album {t // 12:06d}" for t in tids], dtype=object),
    )


# the published shape of the reference's ds2 run (relatorio.pdf p.6)
DS2_SHAPE = dict(n_playlists=2246, n_tracks=2171, target_rows=240249)
