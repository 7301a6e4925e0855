"""Pair-support counting over bit-packed baskets — the port's CUDA kernels.

Counterpart of ``kmlserver_tpu/ops/popcount.py``. Packing the PLAYLIST axis
into 32-bit words shrinks the operand 32x and turns pair counting into

    C[i, j] = Σ_w popcount(Bt[i, w] & Bt[j, w]) = Σ_k U[i, k] · U[j, k]

where ``Bt (V_pad, W_pad)`` holds track i's playlist membership as a bitset
(int32 tensors carrying the reference's uint32 bit pattern) and
``U = unpack_bits(Bt)`` is the same matrix with one 0/1 int8 per bit.

On a CUDA tensor :func:`popcount_pair_counts_padded` launches a kernel of
``ops/csrc/popcount.cu`` and raises if it cannot; on a CPU tensor it runs
:func:`popcount_pair_counts_plain`, the same function written straight out
in PyTorch. The CPU tests use the plain version, and ``chip_smoke.py``
holds both kernels against it on the card.

- ``swar=False`` (the default): the Hopper kernel, which replaces the Pallas
  kernel ``_popcount_padded_jit`` with its ``_kernel_bcast`` /
  ``_kernel_row`` bodies and is also the counterpart of the reference's XLA
  route ``_mxu_padded_jit``. It runs on the int8 tensor cores (``wgmma``),
  unpacks the bits on their way into the operands (the unpacked operand
  never exists in device memory) and computes one triangle of the
  symmetric C, mirroring each off-diagonal tile. It is bound by int8
  tensor-core operations; ``PERF.md`` has its time beside that bound.
  Launches count in ``LAUNCHES["popcount_pairs"]``.
- ``swar=True``: the reference's path without a popcount primitive
  (``_popcount_words``): a SIMT kernel with a shift-add popcount whose
  block tile follows the knobs (:func:`block_shape`). Launches count in
  ``LAUNCHES["popcount_pairs_swar"]``.

Knobs keep the reference's names, defaults and lazy reads:
``KMLS_POPCOUNT_TILE_I/TILE_J/WORD_CHUNK`` (read at call time by
:func:`resolve_tiles`, never at import), ``KMLS_POPCOUNT_VARIANT`` and
``KMLS_POPCOUNT_SWAR``. For the tensor-core kernel ``TILE_I``/``TILE_J`` set
only the padding unit of V (its block tile is fixed at 128 x 128 and it
masks the ragged edge); ``WORD_CHUNK`` stays the padding unit of the word
axis. Both variants map to the same kernel (the Pallas pair existed only as
a Mosaic-lowering hedge).
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from ..utils.device import resolve_device
from . import encode

TILE_I_DEFAULT = 32
TILE_J_DEFAULT = 128
WORD_CHUNK_DEFAULT = 512
_SUB = 128  # the reference's lane-aligned word slice (word-chunk validation)

VARIANTS = ("bcast", "row")

# launches of the CUDA kernels, counted by the wrapper where it launches
LAUNCHES = {"popcount_pairs": 0, "popcount_pairs_swar": 0}

_MASK32 = 0xFFFFFFFF

# int64 elements per block of the plain version's (rows, V, words) temporaries
_PLAIN_BLOCK_ELEMS = {"cuda": 1 << 26, "cpu": 1 << 22}


def resolve_tiles(
    tile_i: int | None = None,
    tile_j: int | None = None,
    word_chunk: int | None = None,
) -> tuple[int, int, int]:
    """``(TILE_I, TILE_J, WORD_CHUNK)`` — explicit args > env knobs >
    defaults, validated. Read at call time, never at import."""
    if tile_i is None:
        tile_i = int(os.environ.get("KMLS_POPCOUNT_TILE_I", TILE_I_DEFAULT))
    if tile_j is None:
        tile_j = int(os.environ.get("KMLS_POPCOUNT_TILE_J", TILE_J_DEFAULT))
    if word_chunk is None:
        word_chunk = int(
            os.environ.get("KMLS_POPCOUNT_WORD_CHUNK", WORD_CHUNK_DEFAULT)
        )
    if tile_i < 1 or tile_j < 1 or word_chunk < 1:
        raise ValueError(
            f"popcount tiles must be positive, got "
            f"{tile_i}x{tile_j}x{word_chunk}"
        )
    if word_chunk > _SUB and word_chunk % _SUB != 0:
        raise ValueError(
            f"KMLS_POPCOUNT_WORD_CHUNK={word_chunk} must be a multiple of "
            f"{_SUB} (or at most {_SUB}): the bcast kernel slices word "
            f"chunks in {_SUB}-wide pieces and a ragged tail would be "
            "dropped"
        )
    return tile_i, tile_j, word_chunk


def v_tile(tile_i: int | None = None, tile_j: int | None = None) -> int:
    """The vocab-axis padding unit: a multiple of BOTH tile sizes."""
    ti, tj, _ = resolve_tiles(tile_i, tile_j)
    return math.lcm(ti, tj)


def word_chunk() -> int:
    """The resolved word-chunk size (lazy env read)."""
    return resolve_tiles()[2]


def resolve_kernel_opts(
    variant: str | None, swar: bool | None
) -> tuple[str, bool]:
    """Variant / popcount selection with env defaults
    (``KMLS_POPCOUNT_VARIANT``, ``KMLS_POPCOUNT_SWAR``)."""
    if variant is None:
        variant = os.environ.get("KMLS_POPCOUNT_VARIANT", "bcast")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if swar is None:
        swar = os.environ.get("KMLS_POPCOUNT_SWAR", "0") == "1"
    return variant, swar


def block_shape(tile_i: int, tile_j: int) -> tuple[int, int]:
    """The SWAR kernel's output tile for the ``(TILE_I, TILE_J)`` knobs:
    the knobs themselves where they fit the kernel (4 x 4 register tile per
    thread, at most 1024 threads, 32-word staging within 48 KB), else the
    default 32 x 128 with the ragged edge masked."""
    threads = (tile_i // 4) * (tile_j // 4)
    staging = 4 * 32 * (tile_i + tile_j + 2)
    if tile_i % 4 == 0 and tile_j % 4 == 0 and threads <= 1024 and staging <= 48 * 1024:
        return tile_i, tile_j
    return TILE_I_DEFAULT, TILE_J_DEFAULT


def _popcount32_(x: torch.Tensor) -> torch.Tensor:
    """In-place SWAR popcount of int64 values in ``[0, 2**32)`` (so every
    shift is logical) — adds and shifts only, Hacker's Delight fig. 5-2."""
    t = torch.bitwise_right_shift(x, 1)
    x.sub_(t.bitwise_and_(0x55555555))
    torch.bitwise_right_shift(x, 2, out=t)
    x.bitwise_and_(0x33333333).add_(t.bitwise_and_(0x33333333))
    torch.bitwise_right_shift(x, 4, out=t)
    x.add_(t).bitwise_and_(0x0F0F0F0F)
    torch.bitwise_right_shift(x, 16, out=t)
    x.add_(t)
    torch.bitwise_right_shift(x, 8, out=t)
    return x.add_(t).bitwise_and_(0x3F)


def popcount_pair_counts_plain(bt: torch.Tensor) -> torch.Tensor:
    """The kernel's function written straight out: AND every row pair's
    words, SWAR-popcount them in int64, sum over words. Works in
    ``(rows, V, words)`` blocks of at most ``_PLAIN_BLOCK_ELEMS`` elements
    for ``bt``'s device so memory stays bounded. → int32 ``(V, V)`` on
    ``bt``'s device."""
    max_elems = _PLAIN_BLOCK_ELEMS["cuda" if bt.is_cuda else "cpu"]
    v, w = bt.shape
    out = torch.zeros((v, v), dtype=torch.int64, device=bt.device)
    if v == 0 or w == 0:
        return out.to(torch.int32)
    words = bt.long() & _MASK32
    wc = max(1, min(w, max_elems // v))
    rows = max(1, max_elems // (v * wc))
    for w0 in range(0, w, wc):
        b = words[None, :, w0:w0 + wc]
        for i0 in range(0, v, rows):
            a = words[i0:i0 + rows, None, w0:w0 + wc]
            out[i0:i0 + rows] += _popcount32_(a & b).sum(dim=2)
    return out.to(torch.int32)


def popcount_pair_counts_padded(
    bt: torch.Tensor,
    *,
    variant: str = "bcast",
    swar: bool = False,
    tile_i: int | None = None,
    tile_j: int | None = None,
    word_chunk: int | None = None,
) -> torch.Tensor:
    """Pair counts from an already-padded bitset ``bt (V_pad, W_pad)``
    int32 with ``V_pad % lcm(TILE_I, TILE_J) == 0`` and
    ``W_pad % WORD_CHUNK == 0`` → int32 ``(V_pad, V_pad)``.

    A CUDA tensor launches the tensor-core kernel (``swar=True``: the SWAR
    kernel; ``variant`` is accepted for the reference's signature, both
    variants are the same kernel); a CPU tensor takes
    :func:`popcount_pair_counts_plain`."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    ti, tj, wk = resolve_tiles(tile_i, tile_j, word_chunk)
    if bt.dim() != 2:
        raise ValueError(f"bt must be 2-D (V_pad, W_pad), got {tuple(bt.shape)}")
    v_pad, w_pad = bt.shape
    if v_pad % ti or v_pad % tj or w_pad % wk:
        raise ValueError(
            f"bt {tuple(bt.shape)} must pad V to a multiple of "
            f"lcm(TILE_I, TILE_J)={math.lcm(ti, tj)} and W to a multiple of "
            f"WORD_CHUNK={wk}; a truncating grid would silently skip output "
            "tiles"
        )
    if bt.dtype != torch.int32:
        raise TypeError(f"bt must be int32 (uint32 bit pattern), got {bt.dtype}")
    if bt.device.type == "cpu":
        return popcount_pair_counts_plain(bt)
    if bt.device.type != "cuda":
        raise ValueError(f"no popcount kernel for device {bt.device}")
    if not bt.is_contiguous():
        raise ValueError("bt must be contiguous")
    out = torch.empty((v_pad, v_pad), dtype=torch.int32, device=bt.device)
    if v_pad == 0:
        return out
    if w_pad == 0:
        return out.zero_()
    lib = kernel_lib()
    with torch.cuda.device(bt.device):
        stream = torch.cuda.current_stream(bt.device).cuda_stream
        if swar:
            name = "popcount_pairs_swar"
            rc = lib.kmls_popcount_pair_counts_swar(
                bt.data_ptr(), out.data_ptr(), v_pad, w_pad, *block_shape(ti, tj), stream
            )
        else:
            name = "popcount_pairs"
            rc = lib.kmls_popcount_pair_counts(
                bt.data_ptr(), out.data_ptr(), v_pad, w_pad, stream
            )
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} (bt {tuple(bt.shape)})"
        )
    LAUNCHES[name] += 1
    return out


def kernel_lib() -> ctypes.CDLL:
    from . import cuda_build

    lib = cuda_build.load("popcount")
    if lib.kmls_popcount_pair_counts.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.kmls_popcount_pair_counts.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.kmls_popcount_pair_counts_swar.argtypes = [
            ptr, ptr, i32, i32, i32, i32, ptr,
        ]
        lib.kmls_popcount_pair_counts.restype = ctypes.c_int
        lib.kmls_popcount_pair_counts_swar.restype = ctypes.c_int
    return lib


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_shape(n_tracks: int, n_playlists: int) -> tuple[int, int]:
    """``(v_pad, w_pad)`` the kernel allocates: the vocabulary padded to
    ``lcm(TILE_I, TILE_J)`` and the word count ``ceil(P/32)`` padded to
    ``WORD_CHUNK`` (tiles resolved lazily, call by call)."""
    ti, tj, wk = resolve_tiles()
    vt = math.lcm(ti, tj)
    v_pad = _round_up(max(n_tracks, vt), vt)
    w_pad = _round_up(
        (n_playlists + encode.WORD_BITS - 1) // encode.WORD_BITS, wk
    )
    return v_pad, w_pad


def _on_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def bitpack_by_track(
    playlist_rows,
    track_ids,
    *,
    n_playlists: int,
    n_tracks: int,
    v_pad: int,
    w_pad: int,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Bitset matrix ``(v_pad, w_pad)`` int32 on ``device``: bit p of word
    ``Bt[t, p // 32]`` set iff playlist p contains track t — the same
    scatter as ``encode.bitpack_matrix`` with the axes' roles swapped."""
    if n_playlists > w_pad * encode.WORD_BITS:
        raise ValueError(f"w_pad {w_pad} too small for {n_playlists} playlists")
    return encode.bitpack_matrix(
        _on_device(track_ids, device),  # rows = tracks
        _on_device(playlist_rows, device),  # bits = playlists
        n_playlists=v_pad,
        n_tracks=w_pad * encode.WORD_BITS,
    )


def bitpack_slab_by_track(
    playlist_rows,
    track_ids,
    *,
    n_playlists: int,
    n_tracks: int,
    v_pad: int,
    w_total: int,
    dp: int,
    rank: int,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Rank ``rank``'s slab of the dp-sharded bitset: the contiguous int32
    ``(v_pad, w_total // dp)`` block of words ``[rank·S, (rank+1)·S)`` of
    ``bitpack_by_track(..., w_pad=w_total)``, built from the membership
    rows of that block's playlists alone, their bits shifted down by
    ``32·rank·S``. The reference packs the whole bitset and lets its
    output sharding cut it (``parallel/support.py:167-177``); a rank here
    never holds the whole bitset."""
    if dp < 1 or w_total % dp:
        raise ValueError(f"w_total {w_total} must split into dp={dp} equal slabs")
    if not 0 <= rank < dp:
        raise ValueError(f"rank {rank} outside dp={dp}")
    if n_playlists > w_total * encode.WORD_BITS:
        raise ValueError(f"w_total {w_total} too small for {n_playlists} playlists")
    slab_bits = (w_total // dp) * encode.WORD_BITS
    lo = rank * slab_bits
    rows = _on_device(playlist_rows, device)
    tids = _on_device(track_ids, device)
    here = (rows >= lo) & (rows < lo + slab_bits)
    return encode.bitpack_matrix(
        tids[here], rows[here] - lo, n_playlists=v_pad, n_tracks=slab_bits
    )


def popcount_pair_counts(
    playlist_rows,
    track_ids,
    *,
    n_playlists: int,
    n_tracks: int,
    variant: str | None = None,
    swar: bool | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Public entry: DEDUPLICATED membership pairs → ``(V, V)`` int32 pair
    counts on ``device`` from the bit-packed operand. ``variant``/``swar``
    default from ``KMLS_POPCOUNT_VARIANT`` / ``KMLS_POPCOUNT_SWAR``."""
    variant, swar = resolve_kernel_opts(variant, swar)
    v_pad, w_pad = padded_shape(n_tracks, n_playlists)
    bt = bitpack_by_track(
        playlist_rows, track_ids,
        n_playlists=n_playlists, n_tracks=n_tracks,
        v_pad=v_pad, w_pad=w_pad, device=resolve_device(device),
    )
    counts = popcount_pair_counts_padded(bt, variant=variant, swar=swar)
    return counts[:n_tracks, :n_tracks]
