"""dp-sharded pair counting over the rank mesh — counterpart of
``kmlserver_tpu/parallel/support.py:130-240`` (``sharded_bitpack_pair_counts``,
``counts_from_sharded_bitset`` and the ``_sharded_counts_fn`` Pallas call
site).

The word (playlist) axis of the bit-packed operand is cut into ``dp``
contiguous slabs, exactly as the reference's ``P(None, 'dp')`` sharding
cuts it: ``w_total = round_up(ceil(P/32), dp · WORD_CHUNK)`` words, slab r
= words ``[r·S, (r+1)·S)``. Each rank packs only its slab, launches the
CUDA popcount kernel on it (``ops/popcount.py``) and the partial counts
are summed with ``torch.distributed.all_reduce`` over the mesh's group
(the reference's ``psum`` over ``dp``), so every rank holds the full
padded counts. The sum is exact: every count is at most P < 2³¹.

Not ported: the dense sharded implementations (``gspmd``, ``allgather``,
``ring``, ``:62-127``) and the vocab-sharded emission (``:270-322``),
which are XLA; ``restricted_pair_counts``; and the reference's
``impl="mxu"`` unpack-matmul, which is XLA too.
"""

from __future__ import annotations

import torch

from ..mining.vocab import Baskets
from ..ops import encode
from ..ops import popcount as pc
from ..utils.device import resolve_device
from .mesh import AXIS_DP, AXIS_TP, RankMesh, round_up, this_rank


def _require_dp_only(mesh: RankMesh, name: str) -> None:
    if mesh.shape.get(AXIS_TP, 1) > 1:
        raise ValueError(
            f"{name} needs a dp-only (Nx1) mesh, got {mesh.shape}; "
            "flatten ranks onto dp first"
        )


def sharded_padded_shape(n_tracks: int, n_playlists: int, dp: int) -> tuple[int, int]:
    """``(v_pad, w_total)`` of the dp-sharded bitset: every slab is a
    multiple of ``WORD_CHUNK`` words, so the kernel's padding contract
    holds on every rank (reference ``support.py:161-166``)."""
    vt = pc.v_tile()
    v_pad = round_up(max(n_tracks, vt), vt)
    w_total = round_up(encode.n_words(n_playlists), dp * pc.word_chunk())
    return v_pad, w_total


def pack_rank_slab(
    baskets: Baskets, mesh: RankMesh, device: str | torch.device = "cuda"
) -> torch.Tensor:
    """This rank's ``(v_pad, w_total // dp)`` slab of the bitset."""
    _require_dp_only(mesh, "pack_rank_slab")
    dp = mesh.shape[AXIS_DP]
    v_pad, w_total = sharded_padded_shape(baskets.n_tracks, baskets.n_playlists, dp)
    return pc.bitpack_slab_by_track(
        baskets.playlist_rows, baskets.track_ids,
        n_playlists=baskets.n_playlists, n_tracks=baskets.n_tracks,
        v_pad=v_pad, w_total=w_total, dp=dp, rank=mesh.ranks().index(this_rank()),
        device=resolve_device(device),
    )


def reduce_counts(counts: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Sum the ranks' partial counts in place over the mesh's group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=mesh.group)
    elif mesh.size != 1:
        raise RuntimeError(
            f"a mesh of {mesh.size} ranks needs the distributed runtime "
            "(parallel.distributed.maybe_initialize)"
        )
    return counts


def counts_from_sharded_bitset(
    bt_slab: torch.Tensor,
    mesh: RankMesh,
    variant: str | None = None,
    swar: bool | None = None,
) -> torch.Tensor:
    """Pair counts from this rank's padded slab: the kernel on the slab,
    then the all-reduce → the full padded ``(v_pad, v_pad)`` int32 counts
    on every rank. ``variant``/``swar`` default from
    ``KMLS_POPCOUNT_VARIANT`` / ``KMLS_POPCOUNT_SWAR``."""
    _require_dp_only(mesh, "counts_from_sharded_bitset")
    variant, swar = pc.resolve_kernel_opts(variant, swar)
    counts = pc.popcount_pair_counts_padded(bt_slab, variant=variant, swar=swar)
    return reduce_counts(counts, mesh)


def sharded_bitpack_pair_counts(
    baskets: Baskets,
    mesh: RankMesh,
    variant: str | None = None,
    swar: bool | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Pair counts over the mesh from bit-packed slabs: each rank packs and
    counts its slab of the word axis, the partials are all-reduced →
    ``(V, V)`` int32 on every rank. Needs an ``Nx1`` mesh."""
    _require_dp_only(mesh, "sharded_bitpack_pair_counts")
    v = baskets.n_tracks
    slab = pack_rank_slab(baskets, mesh, device)
    return counts_from_sharded_bitset(slab, mesh, variant=variant, swar=swar)[:v, :v]


def sharded_counts_plain(slabs: list[torch.Tensor]) -> torch.Tensor:
    """The sharded count written straight out in one process: the sum of
    the kernel's plain version over every rank's slab."""
    total = pc.popcount_pair_counts_plain(slabs[0])
    for slab in slabs[1:]:
        total += pc.popcount_pair_counts_plain(slab)
    return total
