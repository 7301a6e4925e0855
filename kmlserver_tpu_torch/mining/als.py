"""ALS item embeddings — the second model family, counterpart of
``kmlserver_tpu/mining/als.py``.

The binary membership matrix ``X ∈ {0,1}^{P×V}`` (the mining one-hot) is
factorized as ``X ≈ U Fᵀ`` minimizing ``‖X − U Fᵀ‖²_F + λ(‖U‖²_F + ‖F‖²_F)``
with every cell observed, so both half-sweeps share one rank × rank
Gramian and each is one batched normal-equation solve:

    U ← X F (FᵀF + λI)⁻¹        F ← Xᵀ U (UᵀU + λI)⁻¹

Two storages, decided by the reference's byte formulas against
``hbm_budget_bytes`` so both packages decide alike:

- **dense**: X as f32 on the device; the two big × skinny products are
  ``torch.matmul`` (TF32 off, PyTorch's default) and the solves
  ``torch.linalg.solve`` (LU, as ``jnp.linalg.solve``);
- **sparse** (``KMLS_ALS_SPARSE``): X kept as its nnz events; the products
  become segment sums (``ops/segsum.py``: a hand-written CUDA kernel on the
  card, deterministic, over CSR/CSC orderings built once per training).
  The two orderings add ``2·(8·(n+1) + 4·nnz)`` bytes the reference's
  formula does not count; ``chip_smoke.py`` records the measured peak.

Serving consumes only the item factors, L2-normalized (cosine similarity
in item space). The init is the reference's fixed-seed host draw (users,
then items), so both packages start from identical factors; two trainings
on the same card give bit-identical factors, which the ``embed`` phase's
checkpoint resume and the manifest sha256 rely on.

The reference's mesh-sharded sweep (``_train_sharded``) is not ported:
where it would shard, a ``NOTE:`` is printed and the training runs on one
card with the single-device storage decision (the reference's own layouts
are float-different, so this is another float-different route, not a
different model).
"""

from __future__ import annotations

import logging
import time
from typing import Any

import numpy as np
import torch

from ..config import MiningConfig
from ..ops import encode
from ..ops.segsum import build_csr, segment_sum
from ..parallel.layout import validate_layout
from ..parallel.mesh import AXIS_TP
from ..utils.device import resolve_device
from .vocab import Baskets

ALS_SPARSE_MODES = ("auto", "always", "never")

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


def _sparse_als_sweep(by_user, by_item, user_f, item_f, reg):
    """One sweep over the compressed matrix: ``X F`` and ``Xᵀ U`` are
    segment sums over the events; the Gramians and solves are unchanged."""
    eye = _eye_reg(user_f.shape[1], reg)
    g_item = item_f.T @ item_f + eye
    user_f = torch.linalg.solve(g_item, segment_sum(item_f, by_user).T).T  # X F
    g_user = user_f.T @ user_f + eye
    item_f = torch.linalg.solve(g_user, segment_sum(user_f, by_item).T).T  # Xᵀ U
    return user_f, item_f


def _sparse_als_loss(rows, cols, user_f, item_f, reg) -> torch.Tensor:
    """Exact loss without densifying: ``‖X − U Fᵀ‖² = nnz − 2·Σ_nnz u_r·f_c
    + Σ (UᵀU)∘(FᵀF)``, the cross term summed chunk by chunk in fp32."""
    nnz = rows.shape[0]
    chunk = _als_chunk(nnz)
    gram = torch.sum((user_f.T @ user_f) * (item_f.T @ item_f))
    cross = torch.zeros((), dtype=torch.float32, device=user_f.device)
    for lo in range(0, nnz, chunk):
        u = user_f[rows[lo:lo + chunk]]
        f = item_f[cols[lo:lo + chunk]]
        cross = cross + torch.sum(torch.sum(u * f, dim=1))
    penalty = reg * (torch.sum(user_f * user_f) + torch.sum(item_f * item_f))
    return float(nnz) - 2.0 * cross + gram + penalty


def _train_sparse(
    baskets: Baskets, user_init: np.ndarray, item_init: np.ndarray,
    reg: torch.Tensor, iters: int, p: int, v: int, device: torch.device,
) -> tuple[np.ndarray, float]:
    """The compressed-storage sweep loop → ``(item factors, final loss)``."""
    rows = torch.as_tensor(np.asarray(baskets.playlist_rows, np.int32), device=device)
    cols = torch.as_tensor(np.asarray(baskets.track_ids, np.int32), device=device)
    by_user = build_csr(rows, cols, p, v)  # X F: a playlist's tracks
    by_item = build_csr(cols, rows, v, p)  # Xᵀ U: a track's playlists
    user_f = torch.as_tensor(user_init, device=device)
    item_f = torch.as_tensor(item_init, device=device)
    for _ in range(iters):
        user_f, item_f = _sparse_als_sweep(by_user, by_item, user_f, item_f, reg)
    del by_user, by_item
    loss = float(_sparse_als_loss(rows.long(), cols.long(), user_f, item_f, reg))
    return item_f.cpu().numpy(), loss


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


def normalize_factors(item_factors: np.ndarray) -> np.ndarray:
    """Row-L2-normalize → unit vectors (cosine similarities in [-1, 1]); a
    zero row keeps a zero vector instead of NaN."""
    norms = np.linalg.norm(item_factors, axis=1, keepdims=True)
    return (item_factors / np.maximum(norms, 1e-12)).astype(np.float32)


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
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Train item embeddings on ``device`` → the ``embed`` phase's payload
    (host objects only): ``{"item_factors": f32 (V, rank) L2-normalized,
    "rank", "iters", "reg", "final_loss", "duration_s", "shards",
    "storage", "nnz"}`` — or, when the chosen storage would not fit
    ``cfg.hbm_budget_bytes``, ``item_factors=None`` with a ``skipped``
    reason (a function of config and dataset shape alone, so every rank and
    every resume decides alike)."""
    dev = resolve_device(device)
    rank = max(1, cfg.als_rank)
    iters = max(1, cfg.als_iters)
    p, v = baskets.n_playlists, baskets.n_tracks
    nnz = len(baskets.playlist_rows)
    if _als_shards(cfg, mesh, p, v, rank) > 1:
        print(
            "NOTE: the mesh-sharded ALS sweep is not ported; training on one "
            "card with the single-device storage decision (float-different "
            "from the sharded layout, as the reference's layouts are from "
            "each other)"
        )
    storage_mode = resolve_als_sparse(getattr(cfg, "als_sparse", "auto"))
    dense_bytes = 5 * p * v + 8 * rank * (p + v)
    sparse_bytes = sparse_als_bytes(nnz, p, v, rank)
    budget = cfg.hbm_budget_bytes
    use_sparse = False
    if storage_mode == "always":
        if sparse_bytes > budget:
            return _skipped(rank, iters, cfg, (
                f"KMLS_ALS_SPARSE=always pins the compressed form but "
                f"~{sparse_bytes >> 20} MiB for {nnz} nnz exceeds "
                f"hbm_budget_bytes ({budget >> 20} MiB); embed phase skipped "
                "— serving stays rules-only"
            ))
        use_sparse = True
    elif storage_mode == "auto" and dense_bytes > budget and sparse_bytes <= budget:
        use_sparse = True
    if not use_sparse and dense_bytes > budget:
        return _skipped(rank, iters, cfg, (
            f"dense {p}x{v} interaction matrix (~{dense_bytes >> 20} MiB per "
            f"device across 1 shard(s)) exceeds hbm_budget_bytes "
            f"({budget >> 20} MiB) and sparse storage is "
            + ("disabled (KMLS_ALS_SPARSE=never)" if storage_mode == "never"
               else f"also over budget (~{sparse_bytes >> 20} MiB for {nnz} nnz)")
            + "; embed phase skipped — serving stays rules-only"
        ))
    t0 = time.perf_counter()
    # fixed-seed host init, users then items: the reference's draw, whose
    # float64 quotient its device upload rounds to float32
    rng = np.random.default_rng(seed)
    user_init = (rng.standard_normal((p, rank)).astype(np.float32) / np.sqrt(rank)).astype(np.float32)
    item_init = (rng.standard_normal((v, rank)).astype(np.float32) / np.sqrt(rank)).astype(np.float32)
    reg = torch.tensor(cfg.als_reg, dtype=torch.float32, device=dev)
    train = _train_sparse if use_sparse else _train_dense
    item_raw, final_loss = train(baskets, user_init, item_init, reg, iters, p, v, dev)
    return {
        "item_factors": normalize_factors(item_raw),
        "rank": rank,
        "iters": iters,
        "reg": float(cfg.als_reg),
        "final_loss": final_loss,
        "duration_s": time.perf_counter() - t0,
        "shards": 1,
        "storage": "sparse" if use_sparse else "dense",
        "nnz": nnz,
    }
