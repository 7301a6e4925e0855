"""ALS item embeddings — the second model family, counterpart of
``kmlserver_tpu/mining/als.py``.

The binary membership matrix ``X ∈ {0,1}^{P×V}`` (the mining one-hot) is
factorized as ``X ≈ U Fᵀ`` minimizing ``‖X − U Fᵀ‖²_F + λ(‖U‖²_F + ‖F‖²_F)``
with every cell observed, so both half-sweeps share one rank × rank
Gramian and each is one batched normal-equation solve:

    U ← X F (FᵀF + λI)⁻¹        F ← Xᵀ U (UᵀU + λI)⁻¹

Two storages, decided by the reference's byte formulas against
``hbm_budget_bytes`` so both packages decide alike, and two layouts:

- **dense**: X as f32 on the device; the two big × skinny products are
  ``torch.matmul`` (TF32 off, PyTorch's default) and the solves
  ``torch.linalg.solve`` (LU, as ``jnp.linalg.solve``);
- **sparse** (``KMLS_ALS_SPARSE``): X kept as its nnz events; the products
  become segment sums (``ops/segsum.py``: a hand-written CUDA kernel on the
  card, deterministic, over CSR/CSC orderings built once per training;
  the loss's cross term is one more over the CSR: ``Σ_r u_r·(X F)_r``).
  The two orderings add ``2·(8·(n+1) + 4·nnz)`` bytes the reference's
  formula does not count; ``chip_smoke.py`` records the measured peak.

Serving consumes only the item factors, L2-normalized (cosine similarity
in item space). The init is the reference's fixed-seed host draw (users,
then items), so both packages start from identical factors; the sparse
route on a CUDA device draws the same values on the card
(``ops/normals.py``). Two trainings on the same card give bit-identical
factors, which the ``embed`` phase's checkpoint resume and the manifest
sha256 rely on.

- **mesh-sharded** (``KMLS_MODEL_LAYOUT=sharded``, or ``auto`` where one
  device's dense matrix would bust the budget; reference
  ``_train_sharded``): each rank keeps X's ``(P, V/tp)`` f32 column block
  and its rows of the item factors, zero-padded past V. The item Gramian
  and ``X F`` are summed over ``tp`` in rank order
  (``parallel/collectives.sum_in_order``), so every rank solves the same
  users; the item solve is local. The sharded factors are float-different
  from one card's, as the reference's are, and bit-identical run to run.
"""

from __future__ import annotations

import logging
import time
from typing import Any

import numpy as np
import torch

from ..config import MiningConfig
from ..ops import encode, normals
from ..ops.segsum import build_csr, segment_sum
from ..parallel import collectives
from ..parallel.layout import validate_layout
from ..parallel.mesh import AXIS_TP, round_up, this_rank
from ..utils.device import resolve_device
from ..utils.profiling import span
from .vocab import Baskets

ALS_SPARSE_MODES = ("auto", "always", "never")
# sweeps of the mesh-sharded training that ran on a CUDA device (calls of
# torch.matmul and torch.linalg.solve, not hand-kernel launches)
CALLS = {"sharded_sweep": 0}

# elements of the residual the sharded loss builds at a time (1 GiB of f32)
_LOSS_CHUNK_ELEMS = 1 << 28

# rows of the init drawn and rounded at a time (8 MiB of float64 at R = 32)
_INIT_BLOCK_ROWS = 1 << 15

# leading user rows of an init drawn on the card checked against numpy's draw
_INIT_CHECK_ROWS = 64

# chunks of the gather form's cross term (``_sparse_als_loss``) gathered at a
# time (512 MiB of rows a side at R = 32 and the full chunk)
_LOSS_GROUP_CHUNKS = 64

# rows of the item factors normalized on the card checked against numpy's
_NORM_CHECK_ROWS = 2048

# accumulation-chunk ceiling of the reference's sparse half-sweeps; the
# budget formula counts one (chunk, R) gathered block, and the loss's
# cross term runs over chunks of this size
_SPARSE_CHUNK = 1 << 16


def _als_chunk(nnz: int) -> int:
    """Power-of-two accumulation chunk: capped by ``_SPARSE_CHUNK`` and
    scaled down to the event count at small shapes (the reference's)."""
    chunk = 256
    while chunk < min(max(nnz, 1), _SPARSE_CHUNK):
        chunk <<= 1
    return chunk


def resolve_als_sparse(value: str | None) -> str:
    """``KMLS_ALS_SPARSE`` validation: a typo resolves to ``auto`` with a
    warning (dense while it fits — what every deployment trains today)."""
    word = (value or "auto").strip().lower()
    if word in ALS_SPARSE_MODES:
        return word
    logging.getLogger("kmlserver_tpu_torch.mining").warning(
        "KMLS_ALS_SPARSE=%r is not one of %s; using 'auto'",
        value, "/".join(ALS_SPARSE_MODES),
    )
    return "auto"


def sparse_als_bytes(nnz: int, p: int, v: int, rank: int) -> int:
    """Planned device bytes of the compressed formulation (the reference's
    formula): the two int32 index vectors, both factor matrices and their
    right-hand sides, and one gathered chunk."""
    return 8 * nnz + 8 * rank * (p + v) + 4 * _als_chunk(nnz) * rank


def _eye_reg(rank: int, reg: torch.Tensor) -> torch.Tensor:
    return reg * torch.eye(rank, dtype=torch.float32, device=reg.device)


def _als_sweep(
    x_mat: torch.Tensor, user_f: torch.Tensor, item_f: torch.Tensor, reg: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One dense alternating sweep: users then items, each one batched
    normal-equation solve against the shared rank × rank Gramian."""
    eye = _eye_reg(user_f.shape[1], reg)
    g_item = item_f.T @ item_f + eye
    user_f = torch.linalg.solve(g_item, (x_mat @ item_f).T).T
    g_user = user_f.T @ user_f + eye
    item_f = torch.linalg.solve(g_user, (x_mat.T @ user_f).T).T
    return user_f, item_f


def _als_loss(
    x_mat: torch.Tensor, user_f: torch.Tensor, item_f: torch.Tensor, reg: torch.Tensor
) -> torch.Tensor:
    resid = torch.addmm(x_mat, user_f, item_f.T, alpha=-1.0)
    return torch.sum(resid.square_()) + reg * (
        torch.sum(user_f * user_f) + torch.sum(item_f * item_f)
    )


def _draw_init(rng: np.random.Generator, out) -> None:
    """Fill ``out`` (float32 ``(n, rank)``, a host array or a tensor) with
    the reference's init rows: ``rng``'s float64 standard normals rounded
    to float32, over ``sqrt(rank)`` in float64, rounded to float32 again.
    The generator fills blocks of :data:`_INIT_BLOCK_ROWS` rows in the
    order one draw of the whole would, so the values are the same, without
    the whole float64 draw and its full-size copies on the host."""
    n, rank = out.shape
    buf = np.empty((min(_INIT_BLOCK_ROWS, n), rank))
    for lo in range(0, n, _INIT_BLOCK_ROWS):
        block = buf[:min(_INIT_BLOCK_ROWS, n - lo)]
        rng.standard_normal(out=block)
        rows = normals.round_rows(block, rank)
        if isinstance(out, np.ndarray):
            out[lo:lo + len(rows)] = rows
        else:
            out[lo:lo + len(rows)].copy_(torch.from_numpy(rows))


def _host_init(seed: int, p: int, v: int, rank: int, device: torch.device | None = None):
    """The init's user then item rows from the host's draw: host arrays,
    or (``device``) tensors there filled block by block."""
    rng = np.random.default_rng(seed)
    if device is None:
        outs = [np.empty((n, rank), dtype=np.float32) for n in (p, v)]
    else:
        outs = [torch.empty((n, rank), dtype=torch.float32, device=device) for n in (p, v)]
    for out in outs:
        _draw_init(rng, out)
    return outs


def _card_init(seed: int, p: int, v: int, rank: int, device: torch.device):
    """The init's user and item rows drawn on the CUDA ``device``
    (``ops/normals.py``: numpy's values bit for bit, users then items), its
    first rows checked against numpy's own draw; where the kernels decline
    or the check fails, :func:`_host_init`."""
    drawn = normals.init_rows(seed, (p, v), rank, device)
    if drawn is not None:
        want = np.empty((min(p, _INIT_CHECK_ROWS), rank), dtype=np.float32)
        _draw_init(np.random.default_rng(seed), want)
        got = drawn[0][:want.shape[0]].cpu().numpy()
        if np.array_equal(got.view(np.int32), want.view(np.int32)):
            return drawn
        logging.getLogger("kmlserver_tpu_torch.mining").warning(
            "the init drawn on %s differs from numpy's draw on its first rows; "
            "drawing it on the host", device)
    return _host_init(seed, p, v, rank, device)


def _csr_fields(csr, rank: int) -> dict:
    """A half-sweep span's fields: the segment sum's shape (its roofline's
    dimensions)."""
    return {"rows": csr.n_out, "n_in": csr.n_in, "events": csr.nnz, "longest": csr.longest,
            "r": rank}


def _sparse_als_sweep(by_user, by_item, user_f, item_f, reg, keep=None):
    """One sweep over the compressed matrix: ``X F`` and ``Xᵀ U`` are
    segment sums over the events; the Gramians and solves are unchanged.
    ``keep`` (a dict, or None) receives the sweep's inputs, Gramians
    (``+ λI``) and right-hand sides."""
    rank = user_f.shape[1]
    eye = _eye_reg(rank, reg)
    with span("als.users", **_csr_fields(by_user, rank)):
        g_item = item_f.T @ item_f + eye
        xf = segment_sum(item_f, by_user)  # X F
        new_user = torch.linalg.solve(g_item, xf.T).T
    with span("als.items", **_csr_fields(by_item, rank)):
        g_user = new_user.T @ new_user + eye
        xtu = segment_sum(new_user, by_item)  # Xᵀ U
        new_item = torch.linalg.solve(g_user, xtu.T).T
    if keep is not None:
        keep.update(user_in=user_f, item_in=item_f, g_item=g_item, rhs_users=xf,
                    g_user=g_user, rhs_items=xtu)
    return new_user, new_item


def _sparse_als_loss(rows, cols, user_f, item_f, reg) -> torch.Tensor:
    """The gather form of the exact loss (the plain version of
    :func:`_sparse_als_loss_rows`): ``‖X − U Fᵀ‖² = nnz − 2·Σ_nnz u_r·f_c
    + Σ (UᵀU)∘(FᵀF)``, both factor rows of every event gathered, the cross
    term summed chunk by chunk in fp32: each chunk's dot products summed,
    then the chunks' sums. The rows are gathered
    :data:`_LOSS_GROUP_CHUNKS` chunks at a time."""
    nnz = rows.shape[0]
    chunk = _als_chunk(nnz)
    step = chunk * _LOSS_GROUP_CHUNKS
    gram = torch.sum((user_f.T @ user_f) * (item_f.T @ item_f))
    sums = []
    for lo in range(0, nnz, step):
        dots = torch.sum(user_f[rows[lo:lo + step]] * item_f[cols[lo:lo + step]], dim=1)
        dots = torch.nn.functional.pad(dots, (0, -dots.shape[0] % chunk))
        sums.append(torch.sum(dots.view(-1, chunk), dim=1))
    cross = torch.sum(torch.cat(sums)) if sums else torch.zeros(
        (), dtype=torch.float32, device=user_f.device)
    penalty = reg * (torch.sum(user_f * user_f) + torch.sum(item_f * item_f))
    return float(nnz) - 2.0 * cross + gram + penalty


def _sparse_als_loss_rows(by_user, user_f, item_f, reg) -> torch.Tensor:
    """The exact loss over the playlist CSR, the training's: the cross term
    reordered as ``Σ_nnz u_r·f_c = Σ_r u_r·(X F)_r``, ``X F`` one segment
    sum (each row the in-order fp32 sum of its events, as the sweeps'),
    then each row's dot, the dots summed in chunks of ``_als_chunk(P)``
    rows, then the chunks' sums. The Gramian and penalty terms are
    :func:`_sparse_als_loss`'s."""
    dots = torch.sum(segment_sum(item_f, by_user).mul_(user_f), dim=1)
    chunk = _als_chunk(dots.shape[0])
    dots = torch.nn.functional.pad(dots, (0, -dots.shape[0] % chunk))
    cross = torch.sum(torch.sum(dots.view(-1, chunk), dim=1))
    gram = torch.sum((user_f.T @ user_f) * (item_f.T @ item_f))
    penalty = reg * (torch.sum(user_f * user_f) + torch.sum(item_f * item_f))
    return float(by_user.nnz) - 2.0 * cross + gram + penalty


def _event_column(ids, device: torch.device) -> torch.Tensor:
    """An event column as int32 on ``device``: a tensor already there is
    used in place, host ids are uploaded."""
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(ids, np.int32), device=device)


def _train_sparse(
    baskets: Baskets, user_init, item_init, reg: torch.Tensor, iters: int, p: int, v: int,
    device: torch.device, keep: dict | None = None,
) -> tuple[torch.Tensor, float]:
    """The compressed-storage sweep loop → ``(item factors on the device,
    final loss)``. ``keep`` (a dict, or None) receives both CSRs, the last
    sweep's inputs, Gramians and right-hand sides, and the final factors."""
    with span("als.csr"):
        rows = _event_column(baskets.playlist_rows, device)
        cols = _event_column(baskets.track_ids, device)
        by_user = build_csr(rows, cols, p, v)  # X F: a playlist's tracks
        by_item = build_csr(cols, rows, v, p)  # Xᵀ U: a track's playlists
        del rows, cols
    user_f = torch.as_tensor(user_init, device=device)
    item_f = torch.as_tensor(item_init, device=device)
    for i in range(iters):
        with span("als.sweep", i=i):
            user_f, item_f = _sparse_als_sweep(
                by_user, by_item, user_f, item_f, reg,
                keep if i == iters - 1 else None)
    if keep is not None:
        keep.update(by_user=by_user, by_item=by_item, user_out=user_f, item_out=item_f)
    del by_item
    with span("als.loss", **_csr_fields(by_user, user_f.shape[1])):
        loss = float(_sparse_als_loss_rows(by_user, user_f, item_f, reg))
    return item_f, loss


def _train_dense(
    baskets: Baskets, user_init: np.ndarray, item_init: np.ndarray,
    reg: torch.Tensor, iters: int, p: int, v: int, device: torch.device,
) -> tuple[np.ndarray, float]:
    """The dense sweep loop over the f32 one-hot → ``(item factors, final
    loss)``."""
    x_mat = encode.onehot_matrix(
        torch.as_tensor(baskets.playlist_rows, device=device),
        torch.as_tensor(baskets.track_ids, device=device),
        n_playlists=p, n_tracks=v,
    ).to(torch.float32)
    user_f = torch.as_tensor(user_init, device=device)
    item_f = torch.as_tensor(item_init, device=device)
    for _ in range(iters):
        user_f, item_f = _als_sweep(x_mat, user_f, item_f, reg)
    loss = float(_als_loss(x_mat, user_f, item_f, reg))
    return item_f.cpu().numpy(), loss


def _sharded_sweep(x_blocks, user_f, item_blocks, reg, total):
    """One sweep with the item axis cut into vocab blocks (reference
    ``_sharded_sweep_fn``): ``total`` sums the blocks' partials of the item
    Gramian and of ``X F``; every block's item solve is local. A rank holds
    one block and ``total`` sums over ``tp``; the plain version holds them
    all and sums them in the same order."""
    eye = _eye_reg(user_f.shape[1], reg)
    g_item = total([f.T @ f for f in item_blocks]) + eye
    xf = total([x @ f for x, f in zip(x_blocks, item_blocks)])
    user_f = torch.linalg.solve(g_item, xf.T).T
    g_user = user_f.T @ user_f + eye
    item_blocks = [torch.linalg.solve(g_user, (x.T @ user_f).T).T for x in x_blocks]
    return user_f, item_blocks


def _sharded_loss(x_blocks, user_f, item_blocks, reg, total) -> float:
    """The loss over the blocks (reference ``_sharded_loss_fn``): each
    block's residual and item penalty summed over the blocks, the user
    penalty added once on the host. A block's residual ``X − U Fᵀ`` is
    built over row chunks of at most ``_LOSS_CHUNK_ELEMS`` elements, summed
    in chunk order, so a rank holds its X block and one chunk."""
    local = []
    for x, f in zip(x_blocks, item_blocks):
        step = max(1, _LOSS_CHUNK_ELEMS // max(x.shape[1], 1))
        resid = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, x.shape[0], step):
            chunk = torch.addmm(x[lo:lo + step], user_f[lo:lo + step], f.T, alpha=-1.0)
            resid = resid + torch.sum(chunk.square_())
            del chunk  # freed before the next chunk is made: one at a time
        local.append(resid + reg * torch.sum(f * f))
    user_host = user_f.cpu().numpy()
    return float(total(local)) + float(reg) * float(np.sum(user_host * user_host))


def _x_block(baskets: Baskets, p: int, lo: int, width: int, device) -> torch.Tensor:
    """Columns ``[lo, lo + width)`` of the f32 interaction matrix, built at
    that width (zero past V) with no int8 staging copy."""
    rows = np.asarray(baskets.playlist_rows)
    tids = np.asarray(baskets.track_ids)
    keep = (tids >= lo) & (tids < lo + width)
    x = torch.zeros((p, width), dtype=torch.float32, device=device)
    x.index_put_(
        (torch.as_tensor(rows[keep], device=device).long(),
         torch.as_tensor(tids[keep] - lo, device=device).long()),
        torch.ones((), dtype=torch.float32, device=device),
    )
    return x


def _vocab_blocks(item_init: np.ndarray, v: int, tp: int) -> tuple[int, np.ndarray]:
    """``(V_loc, the item init zero-padded to tp·V_loc rows)``: padded rows
    meet zero interaction columns and solve to zero in every sweep."""
    v_loc = round_up(max(v, 1), tp) // tp
    padded = np.zeros((v_loc * tp, item_init.shape[1]), dtype=np.float32)
    padded[:v] = item_init
    return v_loc, padded


def _train_sharded(
    baskets: Baskets, mesh, user_init: np.ndarray, item_init: np.ndarray,
    reg: torch.Tensor, iters: int, p: int, v: int, device: torch.device,
) -> tuple[np.ndarray, float]:
    """This rank's part of the mesh-sharded training → ``(item factors
    (V, R), final loss)``, the same on every rank: its X block and item
    rows, the sums over its ``tp`` row, the item blocks gathered at the
    end."""
    axis = mesh.axis(AXIS_TP)
    t = axis.ranks.index(this_rank())
    v_loc, padded = _vocab_blocks(item_init, v, axis.size)
    x_blocks = [_x_block(baskets, p, t * v_loc, v_loc, device)]
    item_blocks = [torch.as_tensor(padded[t * v_loc:(t + 1) * v_loc], device=device)]
    user_f = torch.as_tensor(user_init, device=device)

    def total(parts):
        return collectives.sum_in_order(parts[0], axis)

    for _ in range(iters):
        user_f, item_blocks = _sharded_sweep(x_blocks, user_f, item_blocks, reg, total)
        if device.type == "cuda":
            CALLS["sharded_sweep"] += 1
    loss = _sharded_loss(x_blocks, user_f, item_blocks, reg, total)
    items = collectives.all_gather_cat(item_blocks[0], axis)
    return items[:v].cpu().numpy(), loss


def train_sharded_plain(
    baskets: Baskets, user_init: np.ndarray, item_init: np.ndarray,
    reg: torch.Tensor, iters: int, tp: int, device: str | torch.device = "cpu",
) -> tuple[np.ndarray, float]:
    """:func:`_train_sharded` in one process: all ``tp`` blocks held, their
    partials summed in block order — the same bits as the ranks' on the
    same device."""
    dev = resolve_device(device)
    p, v = baskets.n_playlists, baskets.n_tracks
    v_loc, padded = _vocab_blocks(item_init, v, tp)
    x_blocks = [_x_block(baskets, p, t * v_loc, v_loc, dev) for t in range(tp)]
    item_blocks = [torch.as_tensor(padded[t * v_loc:(t + 1) * v_loc], device=dev)
                   for t in range(tp)]
    user_f = torch.as_tensor(user_init, device=dev)
    reg = reg.to(dev)
    for _ in range(iters):
        user_f, item_blocks = _sharded_sweep(x_blocks, user_f, item_blocks, reg,
                                             collectives.add_in_order)
    loss = _sharded_loss(x_blocks, user_f, item_blocks, reg, collectives.add_in_order)
    return torch.cat(item_blocks)[:v].cpu().numpy(), loss


def normalize_factors(item_factors: np.ndarray) -> np.ndarray:
    """Row-L2-normalize → unit vectors (cosine similarities in [-1, 1]); a
    zero row keeps a zero vector instead of NaN."""
    norms = np.linalg.norm(item_factors, axis=1, keepdims=True)
    return (item_factors / np.maximum(norms, 1e-12)).astype(np.float32)


def _f32(op, *args: torch.Tensor) -> torch.Tensor:
    """``op`` of float32 tensors rounded as one float32 operation: done in
    float64 and rounded once, which for an add, a multiply, a divide or a
    square root of float32 inputs is the correctly rounded float32 result
    (53 ≥ 2·24 + 2 bits), whatever the backend's float32 kernels do."""
    return op(*(a.double() for a in args)).float()


def _row_sums_pairwise(sq: torch.Tensor) -> torch.Tensor:
    """The sums of ``sq``'s rows (at most 128 float32 items) in the order
    numpy's float32 reduction adds them (``pairwise_sum``: under 8 items
    one by one from 0; else eight running sums over whole groups of 8,
    combined pairwise, then the rest one by one), so they are numpy's bit
    for bit."""
    n = sq.shape[1]
    if n < 8:
        acc = torch.zeros(sq.shape[0], dtype=sq.dtype, device=sq.device)
        for i in range(n):
            acc = _f32(torch.add, acc, sq[:, i])
        return acc
    whole = n - n % 8
    r = sq[:, 0:8]
    for i in range(8, whole, 8):
        r = _f32(torch.add, r, sq[:, i:i + 8])
    half = [_f32(torch.add, r[:, j], r[:, j + 1]) for j in range(0, 8, 2)]
    acc = _f32(torch.add, _f32(torch.add, half[0], half[1]), _f32(torch.add, half[2], half[3]))
    for i in range(whole, n):
        acc = _f32(torch.add, acc, sq[:, i])
    return acc


def _normalize_rows(f: torch.Tensor) -> torch.Tensor:
    """:func:`normalize_factors` in torch ops on ``f``'s device (float32
    rows of at most 128): the same norms, floor and division, each step a
    correctly rounded float32 operation as numpy's."""
    norms = _f32(torch.sqrt, _row_sums_pairwise(_f32(torch.mul, f, f)))[:, None]
    return _f32(torch.div, f, torch.clamp_min(norms, 1e-12))


def _fetch_normalized(item_f: torch.Tensor) -> np.ndarray:
    """The payload's item factors from the trained ones: on a CUDA device
    normalized there (:func:`_normalize_rows`, checked on evenly spaced rows
    against :func:`normalize_factors`) and copied back once; else, or
    where the check fails, copied back and normalized on the host."""
    if item_f.is_cuda and item_f.dtype == torch.float32 and item_f.shape[1] <= 128:
        unit = _normalize_rows(item_f).cpu().numpy()
        step = max(1, item_f.shape[0] // _NORM_CHECK_ROWS)
        want = normalize_factors(item_f[::step].cpu().numpy())
        if np.array_equal(unit[::step].view(np.int32), want.view(np.int32)):
            return unit
        logging.getLogger("kmlserver_tpu_torch.mining").warning(
            "the item factors normalized on %s differ from numpy's on sampled rows; "
            "normalizing on the host", item_f.device)
    return normalize_factors(item_f.cpu().numpy())


def _als_shards(cfg: MiningConfig, mesh, p: int, v: int, rank: int) -> int:
    """How many vocab shards the reference would lay the item axis over:
    only when the mesh spans ``tp`` and the layout is ``sharded``, or
    ``auto`` with the dense slab over the layout budget."""
    if mesh is None:
        return 1
    tp = mesh.shape.get(AXIS_TP, 1)
    if tp <= 1:
        return 1
    layout = validate_layout(getattr(cfg, "model_layout", "replicated"))
    if layout == "sharded":
        return tp
    layout_budget = getattr(cfg, "device_budget_bytes", 0) or cfg.hbm_budget_bytes
    if layout == "auto" and 5 * p * v + 8 * rank * (p + v) > layout_budget:
        return tp
    return 1


def _skipped(rank: int, iters: int, cfg: MiningConfig, reason: str) -> dict[str, Any]:
    return {
        "item_factors": None, "rank": rank, "iters": iters, "reg": float(cfg.als_reg),
        "final_loss": None, "duration_s": 0.0, "storage": "none", "skipped": reason,
    }


def train_embeddings(
    baskets: Baskets, cfg: MiningConfig, seed: int = 0, mesh=None,
    device: str | torch.device = "cuda", keep: dict | None = None,
) -> dict[str, Any]:
    """Train item embeddings on ``device`` → the ``embed`` phase's payload
    (host objects only): ``{"item_factors": f32 (V, rank) L2-normalized,
    "rank", "iters", "reg", "final_loss", "duration_s", "shards",
    "storage", "nnz"}`` — or, when the chosen storage would not fit
    ``cfg.hbm_budget_bytes``, ``item_factors=None`` with a ``skipped``
    reason (a function of config and dataset shape alone, so every rank and
    every resume decides alike).

    The baskets' event columns may be host arrays or tensors; tensors
    already on ``device`` are trained from in place (the device-born
    catalog's route). ``keep`` (a dict, or None: nothing kept) receives,
    on the sparse route, for a checker in the same process: ``by_user`` and
    ``by_item`` (the CSRs), ``user_in`` / ``item_in`` (the factors entering
    the last sweep), ``g_item`` / ``g_user`` (that sweep's Gramians, ``+
    λI``), ``rhs_users`` / ``rhs_items`` (its segment sums ``X F`` and
    ``Xᵀ U``), ``user_out`` / ``item_out`` (the final factors before
    normalization) and ``user_init`` / ``item_init`` (the init), all on
    the device. The payload does not change.

    Under a running profiler a training is a ``kmls:als.train`` span
    (``storage``, ``nnz``, ``p``, ``v``, ``r``, ``iters``) holding
    ``als.init`` (``values``: the draw, on the card for the sparse route
    on a CUDA device, else on the host and uploaded), on the sparse
    route ``als.csr``, ``als.sweep`` (``i``) ⊃ ``als.users``, ``als.items``
    (the segment sum's shape) and ``als.loss``, then ``als.fetch`` (the
    normalization, on the card for the sparse route there, and the copy
    back)."""
    dev = resolve_device(device)
    rank = max(1, cfg.als_rank)
    iters = max(1, cfg.als_iters)
    p, v = baskets.n_playlists, baskets.n_tracks
    nnz = len(baskets.playlist_rows)
    shards = _als_shards(cfg, mesh, p, v, rank)
    storage_mode = resolve_als_sparse(getattr(cfg, "als_sparse", "auto"))
    # the dense slab divides across the vocab shards (the reference's guard)
    dense_bytes = 5 * p * v // shards + 8 * rank * (p + v)
    sparse_bytes = sparse_als_bytes(nnz, p, v, rank)
    budget = cfg.hbm_budget_bytes
    use_sparse = False
    if storage_mode == "always":
        if shards > 1:
            print(
                "NOTE: KMLS_ALS_SPARSE=always under the mesh-sharded "
                "layout keeps the sharded dense half-sweeps (the mesh "
                "already divides the matrix); sparse storage applies to "
                "single-device training"
            )
        elif sparse_bytes > budget:
            return _skipped(rank, iters, cfg, (
                f"KMLS_ALS_SPARSE=always pins the compressed form but "
                f"~{sparse_bytes >> 20} MiB for {nnz} nnz exceeds "
                f"hbm_budget_bytes ({budget >> 20} MiB); embed phase skipped "
                "— serving stays rules-only"
            ))
        else:
            use_sparse = True
    elif (storage_mode == "auto" and shards == 1 and dense_bytes > budget
          and sparse_bytes <= budget):
        use_sparse = True
    if not use_sparse and dense_bytes > budget:
        return _skipped(rank, iters, cfg, (
            f"dense {p}x{v} interaction matrix (~{dense_bytes >> 20} MiB per "
            f"device across {shards} shard(s)) exceeds hbm_budget_bytes "
            f"({budget >> 20} MiB) and sparse storage is "
            + ("disabled (KMLS_ALS_SPARSE=never)" if storage_mode == "never"
               else f"also over budget (~{sparse_bytes >> 20} MiB for {nnz} nnz)"
               if shards == 1 else "single-device only (sharded layout active)")
            + "; embed phase skipped — serving stays rules-only"
        ))
    t0 = time.perf_counter()
    storage = "sparse" if use_sparse else "dense"
    with span("als.train", storage=storage, nnz=nnz, p=p, v=v, r=rank, iters=iters):
        with span("als.init", values=(p + v) * rank):
            # the reference's fixed-seed init, users then items: numpy's
            # draw, or the same values drawn on the card for the sparse
            # route (elsewhere its rows go to the device block by block)
            if use_sparse and dev.type == "cuda":
                user_init, item_init = _card_init(seed, p, v, rank, dev)
            else:
                user_init, item_init = _host_init(seed, p, v, rank, dev if use_sparse else None)
            if keep is not None and use_sparse:
                keep.update(user_init=user_init, item_init=item_init)
            reg = torch.tensor(cfg.als_reg, dtype=torch.float32, device=dev)
        if use_sparse:
            item_raw, final_loss = _train_sparse(
                baskets, user_init, item_init, reg, iters, p, v, dev, keep)
        elif shards > 1:
            item_raw, final_loss = _train_sharded(
                baskets, mesh, user_init, item_init, reg, iters, p, v, dev
            )
        else:
            item_raw, final_loss = _train_dense(
                baskets, user_init, item_init, reg, iters, p, v, dev)
        with span("als.fetch"):
            if isinstance(item_raw, torch.Tensor):
                item_factors = _fetch_normalized(item_raw)
            else:
                item_factors = normalize_factors(item_raw)
    return {
        "item_factors": item_factors,
        "rank": rank,
        "iters": iters,
        "reg": float(cfg.als_reg),
        "final_loss": final_loss,
        "duration_s": time.perf_counter() - t0,
        "shards": shards,
        "storage": storage,
        "nnz": nnz,
    }
