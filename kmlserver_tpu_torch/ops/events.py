"""The event list of the device-born catalog — every (playlist, track)
membership of config 4's Bernoulli-Zipf model as two int32 columns,
ordered by (track, playlist) — the port's CUDA kernels
``ops/csrc/events.cu``.

Two sources, one list:

- **the head** (:func:`bitset_events`): the set bits of the candidate
  tracks' bitset that ``ops/bernoulli.py`` draws; row ``t`` is track ``t``,
  bit ``b`` of word ``w`` playlist ``32·w + b``.
- **the tail** (:func:`tail_events`): the tracks past the head, drawn by
  geometric gaps. Track ``t`` with membership probability ``q`` takes
  draws ``j = 0, 1, ...``: ``(y0, y1) = threefry2x32(key, (t, j))``, the
  53 bits ``n = (y0 >> 11)·2^32 + y1``, the uniform ``u = (n + 1)·2^-53``
  of ``(0, 1]``, the gap ``g = floor(log_basic(u) / log_basic(1 - q))``
  and the next playlist ``pos + 1 + g`` (``pos`` starts at -1); the track
  ends at the first draw whose playlist would reach ``n_playlists``. Every
  step is an IEEE-rounded float64 add, multiply or divide, and
  :func:`log_basic` is built of those alone, so every implementation gives
  the same gaps bit for bit. The key is :func:`tail_key` of the seed.

On a CUDA tensor each source is a count pass (one unit's events: a tile
of 1,024 bitset words, or a tail track), a cumulative sum to each unit's
first slot, and a write pass into the list the caller allocated once
(:func:`count` then :func:`write`); launches count in ``LAUNCHES``, two a
source a list. On a CPU tensor the plain versions run
(:func:`bitset_events_plain`, :func:`tail_events_plain`): the same
function in PyTorch ops.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import threefry

# launches of the CUDA kernels, counted by the wrapper where it launches:
# each source's count pass and write pass
LAUNCHES = {"bitset_events": 0, "tail_events": 0}

# the tail's key is fold_in(PRNGKey(seed), TAIL_TAG): a data word no split
# of the head's key reaches (it splits into v_pad / 32 keys)
TAIL_TAG = 0x7461696C

TILE_WORDS = 1024  # bitset words a warp counts and writes

# log_basic's constants (the float64 nearest each real number)
SQRT2 = float.fromhex("0x1.6a09e667f3bcdp+0")
LN2 = float.fromhex("0x1.62e42fefa39efp-1")
INV_ODD = tuple(1.0 / (2 * k + 1) for k in range(11))

_MANTISSA = (1 << 52) - 1
_ONE_BITS = 0x3FF << 52


def tail_key(seed: int) -> tuple[int, int]:
    """The tail's threefry key: ``fold_in(PRNGKey(seed), TAIL_TAG)``."""
    key = threefry.fold_in(threefry.prng_key(seed), TAIL_TAG)
    return int(key[0]), int(key[1])


def log_basic(x: torch.Tensor) -> torch.Tensor:
    """``log(x)`` of float64 ``x`` in ``(0, 1]`` from IEEE-rounded adds,
    multiplies and divides alone (the kernel's ``log_basic``): ``x = m·2^e``
    with ``m`` in ``(sqrt(1/2), sqrt(2)]``, ``s = (m - 1)/(m + 1)``,
    ``log m = 2s·(1 + s²/3 + ... + s²⁰/21)`` by Horner, plus ``e·ln 2``."""
    bits = x.view(torch.int64)
    e = ((bits >> 52) & 0x7FF) - 1023
    m = ((bits & _MANTISSA) | _ONE_BITS).view(torch.float64)
    big = m > SQRT2
    m = torch.where(big, m * 0.5, m)
    e = e + big.to(torch.int64)
    s = (m - 1.0) / (m + 1.0)
    z = s * s
    p = torch.full_like(s, INV_ODD[-1])
    for c in reversed(INV_ODD[:-1]):
        p = p * z + c
    return e.to(torch.float64) * LN2 + (s + s) * p


def tail_gaps(key: tuple[int, int], track: torch.Tensor, draw: torch.Tensor,
              log_keep: torch.Tensor) -> torch.Tensor:
    """The float64 gap of draw ``draw`` of track ``track`` (int64 tensors,
    broadcast) at ``log_keep = log_basic(1 - q)``."""
    y0, y1 = threefry.threefry2x32(key[0], key[1], track, draw)
    n = ((y0 >> 11) << 32) | y1
    u = (n + 1).to(torch.float64) * 2.0 ** -53
    return torch.floor(log_basic(u) / log_keep)


def bitset_events_plain(bitset: torch.Tensor, rows: int, n_playlists: int):
    """The set bits of rows ``[0, rows)`` of an int32 bitset → int32
    ``(playlists, tracks)`` ordered by (row, playlist)."""
    words = -(-n_playlists // 32)
    bit = torch.arange(32, dtype=torch.int64, device=bitset.device)
    block = bitset[:rows, :words].to(torch.int64) & threefry.MASK
    hit = ((block[:, :, None] >> bit) & 1).bool().reshape(rows, words * 32)
    track, playlist = hit.nonzero(as_tuple=True)
    return playlist.to(torch.int32), track.to(torch.int32)


def tail_events_plain(q: torch.Tensor, first_track: int, n_playlists: int,
                      key: tuple[int, int]):
    """The tail's events of tracks ``first_track + i`` at probabilities
    ``q[i]`` (float64) → int32 ``(playlists, tracks)`` ordered by (track,
    playlist): every live track takes its draws together, one draw a
    step."""
    dev = q.device
    tracks = first_track + torch.arange(q.shape[0], dtype=torch.int64, device=dev)
    live = q > 0
    log_keep = log_basic(1.0 - q)
    pos = torch.full_like(tracks, -1)
    got_pl, got_tr = [], []
    j = 0
    while bool(live.any()):
        idx = live.nonzero().flatten()
        g = tail_gaps(key, tracks[idx], torch.full_like(idx, j), log_keep[idx])
        ok = g < (n_playlists - 1 - pos[idx]).to(torch.float64)
        live[idx[~ok]] = False
        idx = idx[ok]
        pos[idx] += 1 + g[ok].to(torch.int64)
        got_pl.append(pos[idx].clone())
        got_tr.append(tracks[idx])
        j += 1
    if not got_pl:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return empty, empty.clone()
    pl, tr = torch.cat(got_pl), torch.cat(got_tr)
    order = torch.sort(tr * n_playlists + pl).indices
    return pl[order].to(torch.int32), tr[order].to(torch.int32)


@dataclasses.dataclass
class Counted:
    """One source's count pass: each unit's first slot (``starts``, int64
    on the device, relative to the source's own first slot) and the
    source's event count as a 0-d device tensor (``total``)."""

    kind: str  # "bitset_events" or "tail_events"
    starts: torch.Tensor
    total: torch.Tensor
    args: tuple


def _starts(counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    return ends - counts, ends[-1]


def _launch(fn, what: str, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def count_bitset(bitset: torch.Tensor, rows: int, n_playlists: int) -> Counted:
    """The head's count pass over rows ``[0, rows)`` of the int32
    ``bitset`` on the card."""
    words = -(-n_playlists // 32)
    if bitset.dtype != torch.int32 or bitset.dim() != 2 or not bitset.is_contiguous():
        raise ValueError(f"bitset must be a contiguous 2-D int32 tensor, got {bitset.dtype} "
                         f"{tuple(bitset.shape)}")
    if not 0 < rows <= bitset.shape[0] or words > bitset.shape[1]:
        raise ValueError(f"{rows} rows of {words} words outside the bitset's "
                         f"{tuple(bitset.shape)}")
    tiles = rows * -(-words // TILE_WORDS)
    counts = torch.empty(tiles, dtype=torch.int32, device=bitset.device)
    args = (bitset.data_ptr(), rows, bitset.shape[1], words)
    lib = kernel_lib()
    with torch.cuda.device(bitset.device):
        stream = torch.cuda.current_stream(bitset.device).cuda_stream
        _launch(lib.kmls_bitset_events_count, "bitset_events count", *args,
                counts.data_ptr(), stream)
    LAUNCHES["bitset_events"] += 1
    starts, total = _starts(counts)
    return Counted("bitset_events", starts, total, (bitset, args))


def count_tail(q: torch.Tensor, first_track: int, n_playlists: int,
               key: tuple[int, int]) -> Counted:
    """The tail's count pass over tracks ``first_track + i`` at the float64
    probabilities ``q`` on the card."""
    if q.dtype != torch.float64 or q.dim() != 1 or q.shape[0] == 0:
        raise ValueError(f"q must be a non-empty 1-D float64 tensor, got {q.dtype} "
                         f"{tuple(q.shape)}")
    q = q.contiguous()
    counts = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    args = (q.data_ptr(), q.shape[0], first_track, n_playlists, key[0], key[1])
    lib = kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(lib.kmls_tail_events_count, "tail_events count", *args, counts.data_ptr(),
                stream)
    LAUNCHES["tail_events"] += 1
    starts, total = _starts(counts)
    return Counted("tail_events", starts, total, (q, args))


def write(counted: Counted, playlists: torch.Tensor, tracks: torch.Tensor) -> None:
    """The write pass of ``counted`` into the int32 columns ``playlists``
    and ``tracks``: contiguous slices of the list, ``counted``'s event
    count long."""
    keep_alive, args = counted.args
    dev = keep_alive.device
    n = int(counted.total)
    for col in (playlists, tracks):
        if (col.dtype != torch.int32 or col.dim() != 1 or not col.is_contiguous()
                or col.device != dev or col.shape[0] != n):
            raise ValueError(f"a column must be contiguous int32 ({n},) on {dev}, got "
                             f"{col.dtype} {tuple(col.shape)} on {col.device}")
    fn = {"bitset_events": kernel_lib().kmls_bitset_events_write,
          "tail_events": kernel_lib().kmls_tail_events_write}[counted.kind]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(fn, f"{counted.kind} write", *args, counted.starts.data_ptr(),
                playlists.data_ptr(), tracks.data_ptr(), stream)
    LAUNCHES[counted.kind] += 1


def kernel_lib() -> ctypes.CDLL:
    from . import cuda_build

    lib = cuda_build.load("events")
    if lib.kmls_bitset_events_count.argtypes is None:
        ptr, i64, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint
        lib.kmls_bitset_events_count.argtypes = [ptr, i64, i64, i64, ptr, ptr]
        lib.kmls_bitset_events_write.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr]
        lib.kmls_tail_events_count.argtypes = [ptr, i64, i64, i64, u32, u32, ptr, ptr]
        lib.kmls_tail_events_write.argtypes = [ptr, i64, i64, i64, u32, u32, ptr, ptr, ptr,
                                               ptr]
        for fn in (lib.kmls_bitset_events_count, lib.kmls_bitset_events_write,
                   lib.kmls_tail_events_count, lib.kmls_tail_events_write):
            fn.restype = ctypes.c_int
    return lib
