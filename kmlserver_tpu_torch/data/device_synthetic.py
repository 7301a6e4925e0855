"""Device-born synthetic workload — BASELINE config 4's bitset drawn on the
card, in the operand format the pair count reads, with no host membership
array at all.

Counterpart of ``kmlserver_tpu/data/device_synthetic.py``, name for name.

**Bernoulli-Zipf bipartite model.** Playlist p holds track t with an
independent Bernoulli(q_t), ``q_t = min(1, target_rows · w_t / P)``, where
``w_t`` is the Zipf law the host generator draws from
(``data/synthetic.zipf_weights``). Expected per-track counts match the host
model's, and a (p, t) pair exists or not, so the bitset needs no dedup. The
``(v_pad, w_pad)`` bitset is written directly by ``ops/bernoulli.py``'s
kernel, its draws JAX's threefry bit for bit (``ops/threefry.py``): the
same ``q`` and seed give the reference's bitset.

**Exact Apriori pruning, analytically.** Only candidate-frequent rows are
generated: tracks whose expected count ``P·q_t`` is at least
``min_count − margin·sqrt(min_count)``. An excluded track reaches
``min_count`` with probability at most exp(−margin²/2) (Chernoff): at 8
standard deviations < 1e-8 after a union bound over 10⁶ tracks. Rows kept
by the margin but empirically below ``min_count`` are dropped by emission
on their true counts. Pad rows get q = 0 and stay zero.

On a mesh (``dp`` only) each rank draws only its own word slab, under a key
folded with its ``dp`` index, its positions masked against the slab's
global word offset.

Under a running profiler (``utils/profiling.span``) a call is a
``kmls:gen`` span with ``kmls:gen.host`` (q, the cut and the padding on the
host) and ``kmls:gen.draw`` (the keys and the kernel's launch) inside it.

**The whole catalog as events** (:func:`device_synthetic_events`, the
embed phase's input at config 4): the head's set bits and the tail's
tracks, drawn by geometric gaps (``ops/events.py``), as one int32 event
list ordered by (track, playlist) — no host membership array either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bernoulli, threefry
from ..utils.device import resolve_device
from ..utils.profiling import span
from .synthetic import zipf_weights

# margin (in standard deviations of Binomial at min_count) for the analytic
# candidate-frequent cut; 8σ ⇒ drop probability < 1e-8 after a union bound
# over a 10⁶-track vocabulary
CANDIDATE_MARGIN_SIGMAS = 8.0

_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def zipf_bit_probs(
    n_tracks: int,
    n_playlists: int,
    target_rows: int,
    zipf_exponent: float = 1.0,
) -> np.ndarray:
    """Per-track membership probability ``q_t`` (float64, descending)."""
    w = zipf_weights(n_tracks, zipf_exponent)
    return np.minimum(target_rows * w / n_playlists, 1.0)


def candidate_frequent_count(
    q: np.ndarray,
    n_playlists: int,
    min_count: int,
    margin_sigmas: float = CANDIDATE_MARGIN_SIGMAS,
) -> int:
    """How many (Zipf-descending) tracks clear the analytic cut
    ``P·q_t ≥ min_count − margin·sqrt(min_count)``. The bound separates
    only when ``min_count`` exceeds about ``margin²``; below that every
    track with q > 0 is a candidate (small shapes only)."""
    cut = min_count - margin_sigmas * np.sqrt(max(min_count, 1))
    if cut <= 1.0:
        return int((q > 0).sum())
    return int(np.searchsorted(-(q * n_playlists), -cut, side="right"))


def _q_tensor(q_padded, v_pad: int, device: torch.device) -> torch.Tensor:
    q = torch.as_tensor(np.asarray(q_padded, dtype=np.float32)
                        if not isinstance(q_padded, torch.Tensor) else q_padded)
    if q.shape != (v_pad,):
        raise ValueError(f"q_padded has shape {tuple(q.shape)}, want ({v_pad},)")
    return q.to(device=device, dtype=torch.float32)


def bitset_from_probs(
    q_padded,
    seed: int,
    *,
    n_playlists: int,
    v_pad: int,
    w_pad: int,
    row_block: int = 32,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The ``(v_pad, w_pad)`` int32 bitset on ``device``: bit p of word
    ``[t, p // 32]`` ~ Bernoulli(q_padded[t]) for p < n_playlists, all
    independent; positions past ``n_playlists`` stay zero. ``seed`` is the
    reference's ``PRNGKey`` seed, a 32-bit integer there (its jit refuses
    a larger one, and so does this)."""
    if v_pad % row_block:
        raise ValueError(f"v_pad {v_pad} must be a multiple of row_block {row_block}")
    if not _INT32_MIN <= int(seed) <= _INT32_MAX:
        raise OverflowError(
            f"seed {seed} is outside int32, which the single-device generator "
            "takes (sharded_bitset_from_probs takes any seed modulo 2**32)"
        )
    dev = resolve_device(device)
    keys = threefry.split(threefry.prng_key(seed), v_pad // row_block)
    return bernoulli.bernoulli_words(
        keys, _q_tensor(q_padded, v_pad, dev), row_block=row_block, w_width=w_pad,
        word_offset=0, n_playlists=n_playlists,
    )


def shard_keys(seed: int, shard: int, n_blocks: int) -> torch.Tensor:
    """The row-block keys of ``dp`` shard ``shard``: the seed truncated to
    uint32, folded with the shard index, split per block (reference
    ``_sharded_gen_fn``)."""
    base = threefry.fold_in(threefry.prng_key(int(seed) & threefry.MASK), shard)
    return threefry.split(base, n_blocks)


def sharded_bitset_from_probs(
    q_padded,
    seed: int,
    mesh,
    *,
    n_playlists: int,
    v_pad: int,
    w_pad: int,
    row_block: int = 32,
    rank: int | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Multi-rank twin of :func:`bitset_from_probs`: rank ``rank`` (default:
    this process's) of the ``dp``-only ``mesh`` draws only its own
    ``(v_pad, w_pad/dp)`` word slab — the slab at its ``dp`` index —
    under the key ``fold_in(PRNGKey(seed mod 2**32), index)``, positions
    masked against the slab's global word offset. Feed the slab to
    ``parallel.support.counts_from_sharded_bitset``."""
    from ..parallel.mesh import AXIS_DP, AXIS_TP, this_rank

    if mesh.shape.get(AXIS_TP, 1) > 1:
        raise ValueError(
            f"sharded_bitset_from_probs needs a dp-only (Nx1) mesh, got {mesh.shape}"
        )
    dp = mesh.shape[AXIS_DP]
    if w_pad % dp:
        raise ValueError(f"w_pad {w_pad} must divide over dp={dp}")
    w_local = w_pad // dp
    if v_pad % row_block:
        raise ValueError(f"v_pad {v_pad} must be a multiple of row_block {row_block}")
    shard = mesh.position(this_rank() if rank is None else rank)[0]
    dev = resolve_device(device)
    return bernoulli.bernoulli_words(
        shard_keys(seed, shard, v_pad // row_block), _q_tensor(q_padded, v_pad, dev),
        row_block=row_block, w_width=w_local, word_offset=shard * w_local,
        n_playlists=n_playlists,
    )


def device_synthetic_bitset(
    n_playlists: int,
    n_tracks: int,
    target_rows: int,
    min_count: int,
    *,
    zipf_exponent: float = 1.0,
    seed: int = 0,
    row_block: int = 32,
    margin_sigmas: float = CANDIDATE_MARGIN_SIGMAS,
    mesh=None,
    device: str | torch.device = "cuda",
    q: np.ndarray | None = None,
) -> tuple[torch.Tensor, int, dict]:
    """The whole device-side workload → ``(bitset, n_candidates, info)``:
    the ``(v_pad, w_pad)`` int32 bitset on ``device`` (with ``mesh``, a
    ``dp``-only mesh: this rank's ``(v_pad, w_pad/dp)`` slab, ``w_pad``
    rounded up to ``dp · WORD_CHUNK``), and the reference's analytic
    accounting (expected rows over the whole vocabulary, the candidate cut,
    the whole bitset's bytes). ``q``: the whole catalog's float64
    membership probabilities where the caller has them already.

    The ``kmls:gen`` span opens before the candidate cut is known, so it
    carries the call's sizes (``p``, ``tracks``, ``rows``); ``kmls:gen.draw``
    carries the cut and the bitset's shape (``f``, ``p``, ``v_pad``,
    ``w_pad``)."""
    from ..ops import popcount as pc

    with span("gen", p=n_playlists, tracks=n_tracks, rows=target_rows):
        with span("gen.host"):
            if q is None:
                q = zipf_bit_probs(n_tracks, n_playlists, target_rows, zipf_exponent)
            f = candidate_frequent_count(q, n_playlists, min_count, margin_sigmas)
            if f == 0:
                raise ValueError(
                    f"no candidate-frequent tracks at min_count {min_count}; "
                    "lower min_support or raise target_rows"
                )
            v_pad, w_pad = pc.padded_shape(f, n_playlists)
            q_padded = np.zeros(v_pad, dtype=np.float32)
            q_padded[:f] = q[:f]
            if mesh is not None:
                from ..parallel.mesh import AXIS_DP, round_up

                w_pad = round_up(w_pad, mesh.shape[AXIS_DP] * pc.word_chunk())
        with span("gen.draw", f=f, p=n_playlists, v_pad=v_pad, w_pad=w_pad):
            if mesh is not None:
                bitset = sharded_bitset_from_probs(
                    q_padded, seed, mesh, n_playlists=n_playlists, v_pad=v_pad, w_pad=w_pad,
                    row_block=row_block, device=device,
                )
            else:
                bitset = bitset_from_probs(
                    q_padded, seed, n_playlists=n_playlists, v_pad=v_pad, w_pad=w_pad,
                    row_block=row_block, device=device,
                )
    info = {
        "model": "bernoulli-zipf",
        "expected_rows_total": float(n_playlists * q.sum()),
        "expected_rows_candidates": float(n_playlists * q[:f].sum()),
        "candidate_cut_count": f,
        "margin_sigmas": margin_sigmas,
        "v_pad": v_pad,
        "w_pad": w_pad,
        "bitset_bytes": int(v_pad) * int(w_pad) * 4,
    }
    return bitset, f, info


def device_synthetic_events(
    n_playlists: int,
    n_tracks: int,
    target_rows: int,
    min_count: int,
    *,
    zipf_exponent: float = 1.0,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole catalog's memberships as an event list on ``device`` →
    int32 ``(playlist_rows, track_ids)``, ordered by (track, playlist), each
    (playlist, track) pair once: the model above over all ``n_tracks``
    tracks, not only the candidate head.

    - **head** (tracks ``[0, f)``, ``f`` the candidate cut): the set bits of
      :func:`device_synthetic_bitset` under the same arguments and seed;
    - **tail** (tracks ``[f, n_tracks)``): ``ops/events.py``'s geometric
      gaps under the key ``fold_in(PRNGKey(seed), 0x7461696C)``: draw ``j``
      of track ``t`` is ``threefry2x32(key, (t, j))``, its 53 bits
      ``n = (y0 >> 11)·2^32 + y1`` the uniform ``u = (n + 1)·2^-53``, the
      gap ``floor(log_basic(u) / log_basic(1 - q_t))`` in float64 (IEEE
      adds, multiplies and divides only), the next playlist ``pos + 1 +
      gap`` from ``pos = -1``, until one reaches ``n_playlists``.

    On the card each part is a count pass and a write pass into one list
    allocated when both counts are known; the bitset is freed before this
    returns, so the peak is the bitset and the list. Under a running
    profiler the call is a ``kmls:gen.events`` span (``tracks``, and
    ``events``: the model's expected count) holding the bitset's ``gen``
    span, then ``gen.tail`` and ``gen.compact`` for the count passes and
    again, with the ``events`` each wrote, for the write passes."""
    from ..ops import events

    dev = resolve_device(device)
    q = zipf_bit_probs(n_tracks, n_playlists, target_rows, zipf_exponent)
    with span("gen.events", tracks=n_tracks, events=int(round(n_playlists * float(q.sum())))):
        bitset, f, _ = device_synthetic_bitset(
            n_playlists, n_tracks, target_rows, min_count, zipf_exponent=zipf_exponent,
            seed=seed, device=dev, q=q)
        key = events.tail_key(seed)
        q_tail = torch.as_tensor(q[f:], dtype=torch.float64).to(dev)
        words = -(-n_playlists // 32)
        if dev.type != "cuda":
            with span("gen.compact", rows=f, words=words):
                head = events.bitset_events_plain(bitset, f, n_playlists)
            del bitset
            with span("gen.tail", tracks=n_tracks - f):
                tail = (events.tail_events_plain(q_tail, f, n_playlists, key) if n_tracks > f
                        else (head[0][:0], head[1][:0]))
            return torch.cat([head[0], tail[0]]), torch.cat([head[1], tail[1]])
        with span("gen.tail", tracks=n_tracks - f):
            tail = events.count_tail(q_tail, f, n_playlists, key) if n_tracks > f else None
        with span("gen.compact", rows=f, words=words):
            head = events.count_bitset(bitset, f, n_playlists)
            totals = torch.stack([head.total, tail.total if tail is not None
                                  else torch.zeros_like(head.total)]).tolist()
        n_head, n_tail = totals
        playlists = torch.empty(n_head + n_tail, dtype=torch.int32, device=dev)
        tracks = torch.empty(n_head + n_tail, dtype=torch.int32, device=dev)
        with span("gen.compact", rows=f, words=words, events=n_head):
            events.write(head, playlists[:n_head], tracks[:n_head])
            del head, bitset
        if tail is not None:
            with span("gen.tail", tracks=n_tracks - f, events=n_tail):
                events.write(tail, playlists[n_head:], tracks[n_head:])
    return playlists, tracks
