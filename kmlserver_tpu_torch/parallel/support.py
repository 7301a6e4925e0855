"""Pair counting and rule emission over the rank mesh — counterpart of
``kmlserver_tpu/parallel/support.py``.

**The dp-sharded bit-packed count** (reference ``:130-240``,
``sharded_bitpack_pair_counts``, ``counts_from_sharded_bitset`` and the
``_sharded_counts_fn`` Pallas call site). The word (playlist) axis of the
bit-packed operand is cut into ``dp`` contiguous slabs, exactly as the
reference's ``P(None, 'dp')`` sharding cuts it: ``w_total =
round_up(ceil(P/32), dp · WORD_CHUNK)`` words, slab r = words
``[r·S, (r+1)·S)``. Each rank packs only its slab, launches the CUDA
popcount kernel on it (``ops/popcount.py``) and the partial counts are
summed over the flattened ``dp`` axis (``collectives.all_reduce_sum_``,
the reference's ``psum`` over ``dp``), so every rank holds the full padded
counts. The sum is exact: every count is at most P < 2³¹.

**The dense sharded counts** (reference ``:43-127``, ``:243-269``) over a
``(dp, tp)`` mesh. Rank ``(d, t)`` builds its block of the padded int8
one-hot, transposed: ``Xᵀ[t·V_loc:(t+1)·V_loc, d·P_loc:(d+1)·P_loc]``,
with ``V_pad`` a multiple of ``8·tp`` and ``P_pad`` of ``8·dp`` so every
operand of ``ops/support.int8_gram`` (``torch._int_mm``) already has the
shape it wants and is never copied. Each schedule gives the rank its rows
``C[lo:hi, :]`` of ``C = XᵀX`` — by symmetry the transpose of the
reference's column block ``C[:, lo:hi]`` — summed over ``dp``:

- ``allgather``: an all-gather of the vocab blocks over ``tp``, one local
  product ``Xᵀ_loc · Xᵀ_colsᵀ``, then an all-reduce over ``dp``;
- ``ring``: the blocks rotate around ``tp`` one send/receive per step,
  one ``(V_loc, V_loc)`` product per step placed at the block's column;
  never more than three blocks on a rank. Then the all-reduce over ``dp``;
- ``gspmd``: the reference leaves the collectives to XLA's partitioner,
  which emits, for this dot over ``P('dp','tp')`` operands, an all-gather
  over ``tp``, the local product and an all-reduce over ``dp``: here it
  is the ``allgather`` schedule under the name ``gspmd``.

**The vocab-sharded emission** (reference ``:270-322``, ``:401-469``): each
rank emits the rule rows of its slab (``ops/rules.emit_rule_tensors`` with
the slab's row offset: the diagonal masked at the global index), the
singleton supports are the slab's diagonal, and the row blocks are
gathered over ``tp`` so every rank holds the ``(V, K)`` tensors. The
sparse-sharded route feeds the same emission from the port's sparse count
of the rank's rows alone, on its card.

Every collective runs on the axis's group through ``parallel/collectives.py``.
Each device function has a plain version in one process that computes the
ranks' blocks one after another and joins them (``*_plain``).

:func:`restricted_pair_counts` is the delta recount (reference
``:326-398``): rows ``R`` of ``C`` against every basket. On one rank, on
the host below the reference's size threshold and through
``torch._int_mm`` on the card above it. Over a ``(dp, tp)`` mesh (the
reference's ``_restricted_counts_fn``, ``C[R, :] = X[:, R]ᵀ X`` over the
``P('dp','tp')`` one-hot), at any size: rank ``(d, t)`` builds its block
of ``Xᵀ`` and the ``R`` rows of its own playlists straight from the host
baskets (nothing is exchanged to build them), ``int8_gram`` gives its
``(R, V_loc)`` block, summed over ``dp`` and gathered over ``tp``. Not
ported: the reference's ``impl="mxu"`` unpack-matmul, which is XLA.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..mining.vocab import Baskets
from ..ops import encode
from ..ops import popcount as pc
from ..ops import rules
from ..ops.support import int8_gram, int8_gram_plain
from ..utils.device import resolve_device
from . import collectives
from .mesh import AXIS_DP, AXIS_TP, RankMesh, round_up, this_rank

# P·V at or below which the restricted recount runs on the host in float64
# (the reference's threshold, so the same inputs take the same route)
HOST_RECOUNT_ELEMS = 16_000_000
# the dense sharded count's schedules (KMLS_SHARDED_IMPL)
SHARDED_IMPLS = ("gspmd", "allgather", "ring")
# calls that ran on a CUDA device: the restricted recount's int8 product
LAUNCHES = {"restricted_recount": 0}
# calls of the sharded routes on a CUDA device. These run library ops
# (torch._int_mm, torch.topk, collectives), no hand kernel, so they count
# calls, not kernel launches. gspmd runs the all-gather schedule and counts
# under it.
CALLS = {
    "sharded_counts_allgather": 0,
    "sharded_counts_ring": 0,
    "sharded_emit": 0,
    "sparse_sharded_counts": 0,
    "restricted_recount_sharded": 0,
}


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
    return collectives.all_reduce_sum_(counts, mesh.axis(AXIS_DP))


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


def _phase(timer, name: str):
    return timer.phase(name) if timer is not None else contextlib.nullcontext()


def check_impl(impl: str) -> str:
    """``impl`` when it names a dense sharded schedule; else the reference's
    ``ValueError`` (raised where the count starts, as there)."""
    if impl not in SHARDED_IMPLS:
        raise ValueError(f"impl must be one of {sorted(SHARDED_IMPLS)}, got {impl!r}")
    return impl


def dense_padded_shape(n_playlists: int, n_tracks: int, dp: int, tp: int) -> tuple[int, int]:
    """``(p_pad, v_pad)`` of the dense sharded one-hot. A rank's block is
    ``(v_pad/tp, p_pad/dp)``, both sides multiples of 8, the unit
    ``int8_gram`` pads to, so no operand is copied to be padded. Zero rows
    and columns count nothing and are sliced off."""
    return round_up(max(n_playlists, 1), 8 * dp), round_up(max(n_tracks, 1), 8 * tp)


def onehot_block_t(
    baskets: Baskets, mesh: RankMesh, rank: int | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Rank ``(d, t)``'s block of the padded one-hot, built transposed:
    int8 ``(V_loc, P_loc)`` = ``Xᵀ[t·V_loc:(t+1)·V_loc, d·P_loc:(d+1)·P_loc]``
    (reference ``_onehot_padded``, ``P('dp','tp')``), from the membership
    pairs that fall in it."""
    dp, tp = mesh.shape[AXIS_DP], mesh.shape[AXIS_TP]
    p_pad, v_pad = dense_padded_shape(baskets.n_playlists, baskets.n_tracks, dp, tp)
    p_loc, v_loc = p_pad // dp, v_pad // tp
    d, t = mesh.position(this_rank() if rank is None else rank)
    rows = np.asarray(baskets.playlist_rows)
    tids = np.asarray(baskets.track_ids)
    keep = ((rows >= d * p_loc) & (rows < (d + 1) * p_loc)
            & (tids >= t * v_loc) & (tids < (t + 1) * v_loc))
    dev = resolve_device(device)
    return encode.onehot_matrix(
        torch.as_tensor(tids[keep] - t * v_loc, device=dev),
        torch.as_tensor(rows[keep] - d * p_loc, device=dev),
        n_playlists=v_loc, n_tracks=p_loc,
    )


def _ring_slab(xt: torch.Tensor, mesh: RankMesh, timer) -> torch.Tensor:
    """The ring (reference ``_ring_counts``): at step i this rank holds the
    vocab block of the rank i places before it on ``tp``, takes its
    ``(V_loc, V_loc)`` product with its own block and places it at that
    block's columns, then passes the block on."""
    axis = mesh.axis(AXIS_TP)
    v_loc, tp = xt.shape[0], axis.size
    me = axis.ranks.index(this_rank())
    slab = torch.empty((v_loc, v_loc * tp), dtype=torch.int32, device=xt.device)
    block = xt
    for step in range(tp):
        src = (me - step) % tp
        with _phase(timer, "pair_counts"):
            slab[:, src * v_loc:(src + 1) * v_loc] = int8_gram(xt, block)
        if step + 1 < tp:
            with _phase(timer, "ring"):
                block = collectives.shift(block, torch.empty_like(block), axis)
    return slab


def _padded_sharded_counts(
    baskets: Baskets, mesh: RankMesh, impl: str = "gspmd",
    device: str | torch.device = "cuda", timer=None,
) -> tuple[torch.Tensor, int]:
    """This rank's rows of the pair counts, still padded: int32
    ``(V_loc, V_pad)`` = ``C[lo:hi, :]``, ``lo = t·V_loc``, summed over
    ``dp`` → ``(slab, V)``. The vocab-sharded emission takes the slab as it
    is; :func:`sharded_pair_counts` gathers the whole matrix."""
    check_impl(impl)
    with _phase(timer, "onehot"):
        xt = onehot_block_t(baskets, mesh, device=device)
    if impl == "ring":
        slab = _ring_slab(xt, mesh, timer)
    else:
        # gspmd: the schedule XLA's partitioner gives this dot
        with _phase(timer, "all_gather"):
            cols = collectives.all_gather_cat(xt, mesh.axis(AXIS_TP))
        with _phase(timer, "pair_counts"):
            slab = int8_gram(xt, cols)
        del cols
    del xt
    with _phase(timer, "all_reduce"):
        collectives.all_reduce_sum_(slab, mesh.axis(AXIS_DP))
    if slab.is_cuda:
        CALLS["sharded_counts_ring" if impl == "ring" else "sharded_counts_allgather"] += 1
    return slab, baskets.n_tracks


def sharded_pair_counts(
    baskets: Baskets, mesh: RankMesh, impl: str = "gspmd",
    device: str | torch.device = "cuda", timer=None,
) -> torch.Tensor:
    """Pair counts ``(V, V)`` int32 over the mesh on every rank: the rank's
    rows (:func:`_padded_sharded_counts`) gathered over ``tp``."""
    slab, v = _padded_sharded_counts(baskets, mesh, impl, device, timer)
    with _phase(timer, "gather_counts"):
        full = collectives.all_gather_cat(slab, mesh.axis(AXIS_TP))
    return full[:v, :v]


def sharded_pair_counts_plain(
    baskets: Baskets, dp: int, tp: int, device: str | torch.device = "cpu",
    chunk: int | None = None,
) -> torch.Tensor:
    """The dense sharded count written out in one process: every rank's
    block built, its product with its row's blocks taken by
    ``int8_gram_plain`` (over playlist chunks of ``chunk`` when given),
    the ``dp`` partials summed and the ``tp`` rows joined → the padded
    ``(V_pad, V_pad)`` counts. Every schedule gives these integers."""
    grid = RankMesh(grid=tuple(tuple(d * tp + t for t in range(tp)) for d in range(dp)))
    rows = []
    for t in range(tp):
        total = None
        for d in range(dp):
            blocks = [onehot_block_t(baskets, grid, rank=d * tp + u, device=device)
                      for u in range(tp)]
            cols = torch.cat(blocks)
            step = chunk or cols.shape[1]
            for lo in range(0, cols.shape[1], step):
                part = int8_gram_plain(blocks[t][:, lo:lo + step], cols[:, lo:lo + step])
                total = part if total is None else total + part
            del blocks, cols
        rows.append(total)
    return torch.cat(rows)


def emit_slab(
    slab: torch.Tensor, lo: int, min_count: int, k_max: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One rank's emission (reference ``_sharded_emit_fn``) from its rows
    ``C[lo:lo+n, :]`` → ``(rule_ids, rule_counts, row_valid, item_counts)``
    of those rows: the diagonal masked at the global index, the threshold,
    the top-k with the lowest column first; the singleton supports are the
    slab's diagonal."""
    rule_ids, rule_counts, row_valid = rules.emit_rule_tensors(
        slab, min_count, k_max=k_max, row_offset=lo
    )
    r = torch.arange(slab.shape[0], device=slab.device)
    item_counts = slab[r, lo + r]
    if slab.is_cuda:
        CALLS["sharded_emit"] += 1
    return rule_ids, rule_counts, row_valid, item_counts


def emit_slabs_plain(
    counts: torch.Tensor, tp: int, v: int, min_count: int, k_max: int
) -> tuple[np.ndarray, ...]:
    """The vocab-sharded emission in one process: :func:`emit_slab` over
    each ``tp`` block of the padded ``counts`` in turn, joined and sliced
    to ``V``."""
    v_loc = counts.shape[0] // tp
    parts = [emit_slab(counts[t * v_loc:(t + 1) * v_loc], t * v_loc, min_count, k_max)
             for t in range(tp)]
    return tuple(torch.cat(col)[:v].cpu().numpy() for col in zip(*parts))


def _emit_and_gather(
    slab: torch.Tensor, mesh: RankMesh, v: int, min_count: int, k_max: int, timer
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Emit this rank's rows, gather the row blocks over ``tp`` (one
    collective for the four tensors) → host ``(rule_ids, rule_counts,
    row_valid, item_counts)`` sliced to ``V``, on every rank."""
    lo = mesh.position(this_rank())[1] * slab.shape[0]
    with _phase(timer, "rule_emission"):
        ids, counts, valid, items = emit_slab(slab, lo, min_count, k_max)
    with _phase(timer, "gather_rules"):
        packed = torch.cat([ids, counts, valid[:, None], items[:, None]], dim=1)
        joined = collectives.all_gather_cat(packed, mesh.axis(AXIS_TP))[:v].cpu().numpy()
    k = ids.shape[1]
    return (np.ascontiguousarray(joined[:, :k]), np.ascontiguousarray(joined[:, k:2 * k]),
            joined[:, 2 * k].copy(), joined[:, 2 * k + 1].copy())


def sharded_rule_tensors(
    baskets: Baskets, mesh: RankMesh, min_count: int, k_max: int,
    impl: str = "gspmd", device: str | torch.device = "cuda", timer=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The vocab-sharded count → emit mining core
    (``KMLS_MODEL_LAYOUT=sharded``): each rank counts and emits its rows;
    only the ``(V, K)`` rule tensors are gathered. Returns host
    ``(rule_ids, rule_counts, row_valid, item_counts)`` on every rank,
    equal to the dense one-card emission."""
    slab, v = _padded_sharded_counts(baskets, mesh, impl, device, timer)
    return _emit_and_gather(slab, mesh, v, min_count, k_max, timer)


def sparse_sharded_slab(
    baskets: Baskets, mesh: RankMesh, long_basket_threshold: int | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """This rank's rows of the sparse count, padded: int32 ``(V_loc,
    V_loc·tp)`` = ``C[lo:lo+V_loc, :]``, counted on its device by
    ``ops/sparse.sparse_pair_count_rows`` (the long-basket block through
    the popcount kernel on the card, tile by tile), so no rank ever holds
    the whole ``(V, V)``."""
    from ..ops import sparse as sparse_mod

    dev = resolve_device(device)
    tp = mesh.shape[AXIS_TP]
    v_loc = round_up(max(baskets.n_tracks, 1), tp) // tp
    slab = sparse_mod.sparse_pair_count_rows(
        baskets.playlist_rows, baskets.track_ids, n_tracks=baskets.n_tracks,
        lo=mesh.position(this_rank())[1] * v_loc, n_rows=v_loc, n_cols=v_loc * tp,
        long_basket_threshold=long_basket_threshold, device=dev,
    )
    if dev.type == "cuda":
        CALLS["sparse_sharded_counts"] += 1
    return slab


def sparse_sharded_rule_tensors(
    baskets: Baskets, mesh: RankMesh, min_count: int, k_max: int,
    long_basket_threshold: int | None = None,
    device: str | torch.device = "cuda", timer=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The sparse count feeding the same vocab-sharded emission (reference
    ``:401-443``): each rank counts only its rows
    (:func:`sparse_sharded_slab`) and emits them; the rule tensors are
    gathered."""
    with _phase(timer, "sparse_counts"):
        slab = sparse_sharded_slab(baskets, mesh, long_basket_threshold, device)
    return _emit_and_gather(slab, mesh, baskets.n_tracks, min_count, k_max, timer)


def restricted_pair_counts(
    baskets: Baskets,
    row_ids,
    count_path: str | None = None,
    device: str | torch.device = "cuda",
    mesh: RankMesh | None = None,
    timer=None,
) -> np.ndarray:
    """Rows ``row_ids`` of ``C = XᵀX`` → host ``(R, V)`` int32, each equal
    to that row of the full count matrix: the delta recount, the affected
    columns against every basket. Routes, as in the reference:

    - ``count_path="sparse"``: the host event expansion
      (``ops/sparse.py::sparse_restricted_pair_counts_np``);
    - ``P·V <= HOST_RECOUNT_ELEMS``: the one-hot in float64 on the host
      (exact: every count is at most P < 2**53);
    - above it, on ``device``: the padded one-hot built transposed,
      ``Xᵀ (V_pad, P_pad)`` int8, its rows ``R`` gathered into an operand
      that is already padded, and ``int8_gram(Xᵀ[R], Xᵀ)`` with int32
      accumulation (``int8_gram_plain`` on the CPU);
    - with ``mesh``, at any size (the reference takes its host shortcut
      only without one): every rank of the mesh calls this, and each gets
      the rows (:func:`_restricted_counts_sharded`)."""
    row_ids = np.asarray(row_ids, dtype=np.int32)
    v = baskets.n_tracks
    if row_ids.size == 0:
        return np.zeros((0, v), dtype=np.int32)
    if np.any(row_ids < 0) or np.any(row_ids >= v):
        raise ValueError(f"row_ids outside the vocabulary (V={v})")
    if count_path == "sparse":
        from ..ops import sparse as sparse_mod

        return sparse_mod.sparse_restricted_pair_counts_np(
            baskets.playlist_rows, baskets.track_ids, row_ids,
            n_playlists=baskets.n_playlists, n_tracks=v,
        )
    if mesh is not None:
        return _restricted_counts_sharded(baskets, row_ids, mesh, device, timer)
    p = baskets.n_playlists
    if p * v <= HOST_RECOUNT_ELEMS:
        x = np.zeros((p, v), dtype=np.float64)
        x[baskets.playlist_rows, baskets.track_ids] = 1.0
        return (x[:, row_ids].T @ x).astype(np.int32)
    dev = resolve_device(device)
    v_pad, p_pad = round_up(v, 8), round_up(max(p, 1), 8)
    # the transposed one-hot, built at the padded shape int8_gram wants, so
    # no second copy of the largest tensor is ever made
    xt = encode.onehot_matrix(
        torch.as_tensor(baskets.track_ids, device=dev),
        torch.as_tensor(baskets.playlist_rows, device=dev),
        n_playlists=v_pad, n_tracks=p_pad,
    )
    r = len(row_ids)
    a = torch.zeros((round_up(max(r, 17), 8), p_pad), dtype=torch.int8, device=dev)
    torch.index_select(xt, 0, torch.as_tensor(row_ids, device=dev, dtype=torch.int64),
                       out=a[:r])
    gram = int8_gram if dev.type == "cuda" else int8_gram_plain
    counts = gram(a, xt)[:r, :v]
    if dev.type == "cuda":
        LAUNCHES["restricted_recount"] += 1
    return counts.cpu().numpy()


def restricted_rows_block(
    baskets: Baskets, row_ids: np.ndarray, mesh: RankMesh, rank: int | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The requested rows of the one-hot over rank ``(d, t)``'s playlists,
    int8 ``(R_pad, P_loc)``: ``A[i, p] = X[d·P_loc + p, row_ids[i]]`` for
    distinct sorted ``row_ids``, built from the membership pairs, padded to
    ``int8_gram``'s shape (``R_pad`` a multiple of 8, above 16)."""
    dp, tp = mesh.shape[AXIS_DP], mesh.shape[AXIS_TP]
    p_pad, _ = dense_padded_shape(baskets.n_playlists, baskets.n_tracks, dp, tp)
    p_loc = p_pad // dp
    d, _t = mesh.position(this_rank() if rank is None else rank)
    rows = np.asarray(baskets.playlist_rows)
    tids = np.asarray(baskets.track_ids)
    pos = np.minimum(np.searchsorted(row_ids, tids), len(row_ids) - 1)
    keep = (row_ids[pos] == tids) & (rows >= d * p_loc) & (rows < (d + 1) * p_loc)
    dev = resolve_device(device)
    return encode.onehot_matrix(
        torch.as_tensor(pos[keep], device=dev),
        torch.as_tensor(rows[keep] - d * p_loc, device=dev),
        n_playlists=round_up(max(len(row_ids), 17), 8), n_tracks=p_loc,
    )


def _restricted_counts_sharded(
    baskets: Baskets, row_ids: np.ndarray, mesh: RankMesh,
    device: str | torch.device, timer=None,
) -> np.ndarray:
    """Rows ``row_ids`` of ``C`` over the mesh → host ``(R, V)`` int32 on
    every rank: rank ``(d, t)``'s ``(R, V_loc)`` block ``A_d · Xᵀ_{d,t}ᵀ``
    (its playlists' requested rows against its block of the one-hot),
    summed over ``dp``, the ``tp`` column blocks gathered. No rank holds a
    ``(P, V)`` one-hot: its largest operands are ``(V/tp, P/dp)`` and
    ``(R, P/dp)``."""
    v = baskets.n_tracks
    uniq, inverse = np.unique(row_ids, return_inverse=True)
    with _phase(timer, "onehot"):
        xt = onehot_block_t(baskets, mesh, device=device)
        a = restricted_rows_block(baskets, uniq.astype(np.int64), mesh, device=device)
    with _phase(timer, "pair_counts"):
        block = int8_gram(a, xt) if xt.is_cuda else int8_gram_plain(a, xt)
    del a, xt
    with _phase(timer, "all_reduce"):
        collectives.all_reduce_sum_(block, mesh.axis(AXIS_DP))
    with _phase(timer, "gather_counts"):
        cols = collectives.all_gather_cat(block.t().contiguous(), mesh.axis(AXIS_TP))
    if block.is_cuda:
        CALLS["restricted_recount_sharded"] += 1
    counts = cols.t()[: len(uniq), :v].cpu().numpy()
    return np.ascontiguousarray(counts[inverse])


def restricted_counts_sharded_plain(
    baskets: Baskets, row_ids, dp: int, tp: int, device: str | torch.device = "cpu",
) -> np.ndarray:
    """The mesh recount written out in one process: every rank's block
    product taken in turn (``int8_gram_plain``), summed over ``dp`` and
    joined over ``tp``."""
    row_ids = np.asarray(row_ids, dtype=np.int64)
    uniq, inverse = np.unique(row_ids, return_inverse=True)
    grid = RankMesh(grid=tuple(tuple(d * tp + t for t in range(tp)) for d in range(dp)))
    cols = []
    for t in range(tp):
        total = None
        for d in range(dp):
            rank = d * tp + t
            part = int8_gram_plain(
                restricted_rows_block(baskets, uniq, grid, rank=rank, device=device),
                onehot_block_t(baskets, grid, rank=rank, device=device),
            )
            total = part if total is None else total + part
        cols.append(total)
    counts = torch.cat(cols, dim=1)[: len(uniq), : baskets.n_tracks].cpu().numpy()
    return np.ascontiguousarray(counts[inverse])
