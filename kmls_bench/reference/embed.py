"""Config 4's embed phase, written straight out: the whole catalog's event
list and the sparse ALS training over it.

- **The events** (the workload of ``reference/mine.py`` over every track,
  not only the candidate head): track ``t < f`` (``f`` the candidate cut)
  holds the playlists whose bits are set in row ``t`` of the mine's bitset
  (:func:`mine.bitset_rows`). A track past the cut with probability ``q``
  is drawn by geometric gaps under the key ``threefry2x32((0, seed mod
  2**32), (0, 0x7461696C))``: draw ``j`` is ``(y0, y1) = threefry2x32(key,
  (t, j))``, its 53 bits ``n = (y0 >> 11)·2**32 + y1``, the uniform
  ``u = (n + 1)·2**-53``, the gap ``g = floor(log_basic(u) / log_basic(1
  - q))``, the playlist ``pos + 1 + g`` from ``pos = -1``, until one
  reaches ``P``. :func:`log_basic` is made of float64 adds, multiplies and
  divides alone, each rounded once, so these are the same gaps on any
  machine.
- **The segment sums** a half-sweep makes (``X F``: a playlist's tracks;
  ``Xᵀ U``: a track's playlists) are the sequential float32 sums of the
  chosen factor rows in event order: :func:`sequential_segment_rows`.
- **Float64 from kept tensors**: the Gramians ``FᵀF + λI``
  (:func:`gram64`), the residual of a solve (:func:`solve_residual64`) and
  the loss ``‖X − U Fᵀ‖² + λ(‖U‖² + ‖F‖²)`` (:func:`loss64`), in blocks of
  rows.
- **The whole training** from the fixed-seed host init (users, then
  items; :func:`init32`), ``iters`` sweeps of a Gramian, the segment sums
  and a solve, users first: in float32 with an ``index_add_`` over the
  events in their order (:func:`als_plain`, small shapes), and in float64
  with the sums as products of the 0/1 matrix in compressed rows
  (:func:`train64`, any shape the device holds).
- **The payload's factors**: the final item factors over their row norms
  (:func:`normalize32`).

TF32 is off wherever a product runs here (both of PyTorch's flags False).
"""

from __future__ import annotations

import contextlib
import math
import warnings

import numpy as np
import torch

from . import mine
from .threefry import M32, threefry2x32

TAIL_TAG = 0x7461696C
SQRT2 = float.fromhex("0x1.6a09e667f3bcdp+0")
LN2 = float.fromhex("0x1.62e42fefa39efp-1")
INV_ODD = [1.0 / (2 * k + 1) for k in range(11)]
BLOCK_ROWS = 1 << 20  # rows of a float64 block


@contextlib.contextmanager
def no_tf32():
    """Both TF32 flags False inside, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def workload(cfg: dict) -> dict:
    """The mine's shape (``reference/mine.py``) with the whole catalog's
    float64 ``q`` (``q64``) and its track count."""
    shape = mine.workload({**cfg, "k_max": 0})
    shape["q64"] = mine.membership_probs(int(cfg["tracks"]), int(cfg["playlists"]),
                                         int(cfg["rows"]), float(cfg["zipf_s"]))
    shape["tracks"] = int(cfg["tracks"])
    return shape


def log_basic(x: torch.Tensor) -> torch.Tensor:
    """``log(x)`` of float64 ``x`` in ``(0, 1]``: ``x = m·2**e`` with ``m``
    in ``(sqrt(1/2), sqrt(2)]``, ``s = (m − 1)/(m + 1)``, ``log m =
    2s·Σ_k s**(2k)/(2k + 1)`` for k ≤ 10 by Horner, plus ``e·ln 2``."""
    bits = x.view(torch.int64)
    e = ((bits >> 52) & 0x7FF) - 1023
    m = ((bits & ((1 << 52) - 1)) | (0x3FF << 52)).view(torch.float64)
    big = m > SQRT2
    m = torch.where(big, m * 0.5, m)
    e = e + big.to(torch.int64)
    s = (m - 1.0) / (m + 1.0)
    z = s * s
    acc = torch.full_like(s, INV_ODD[10])
    for k in range(9, -1, -1):
        acc = acc * z + INV_ODD[k]
    return e.to(torch.float64) * LN2 + (s + s) * acc


def tail_key(seed: int) -> tuple[int, int]:
    a, b = threefry2x32(0, int(seed) & M32, torch.tensor(0), torch.tensor(TAIL_TAG))
    return int(a), int(b)


def _tail_track(key, track: int, q: float, p: int, device) -> torch.Tensor:
    """Track ``track``'s playlists (int64, ascending) from its gaps."""
    if not q > 0.0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    log_keep = log_basic(torch.tensor([1.0 - q], dtype=torch.float64, device=device))
    batch = int(p * q + 6.0 * math.sqrt(p * q) + 64)
    parts, pos, j0 = [], -1, 0
    while True:
        j = torch.arange(j0, j0 + batch, dtype=torch.int64, device=device)
        y0, y1 = threefry2x32(key[0], key[1], torch.full_like(j, track), j)
        u = ((((y0 >> 11) << 32) | y1) + 1).to(torch.float64) * 2.0 ** -53
        g = torch.floor(log_basic(u) / log_keep)
        g = torch.where(g < float(p), g, torch.full_like(g, float(p)))
        at = pos + torch.cumsum(g.to(torch.int64) + 1, 0)
        inside = at < p
        if not bool(inside.all()):
            parts.append(at[: int(torch.argmin(inside.to(torch.int8)))])
            return torch.cat(parts)
        parts.append(at)
        pos, j0 = int(at[-1]), j0 + batch


def event_tracks(seed: int, tracks, shape: dict, *, device="cpu") -> dict[int, torch.Tensor]:
    """The playlists (int64, ascending) of each track of ``tracks`` under
    ``seed`` → ``{track: playlists}``."""
    f, p = shape["candidates"], shape["playlists"]
    tracks = [int(t) for t in tracks]
    out: dict[int, torch.Tensor] = {}
    head = [t for t in tracks if t < f]
    if head:
        rows = mine.bitset_rows(seed, head, shape, device=device).to(torch.int64) & M32
        bit = torch.arange(32, dtype=torch.int64, device=device)
        for t, row in zip(head, rows):
            hit = ((row[:, None] >> bit) & 1).bool().flatten()
            out[t] = hit[:p].nonzero().flatten()
    key = tail_key(seed)
    for t in tracks:
        if t >= f:
            out[t] = _tail_track(key, t, float(shape["q64"][t]), p, device)
    return out


def sequential_segment_rows(mat: torch.Tensor, csr_rows, chunk: int = 1 << 22) -> np.ndarray:
    """The float32 sums of ``mat``'s rows ``idx`` for each index list of
    ``csr_rows``, each added in the list's order from 0.0, one add at a
    time (``np.add.accumulate`` is strictly sequential; each column runs
    along a contiguous row of the transposed block, the sum so far added
    into its first element) → ``(len(csr_rows), R)`` float32."""
    out = np.zeros((len(csr_rows), mat.shape[1]), dtype=np.float32)
    for i, idx in enumerate(csr_rows):
        acc = np.zeros(mat.shape[1], dtype=np.float32)
        for lo in range(0, len(idx), chunk):
            cols = mat[idx[lo:lo + chunk]].T.contiguous().cpu().numpy()
            cols[:, 0] = acc + cols[:, 0]
            acc = np.add.accumulate(cols, axis=1)[:, -1].copy()
        out[i] = acc
    return out


def segment_rows64(mat: torch.Tensor, csr_rows) -> torch.Tensor:
    """The float64 sums of ``mat``'s rows for each index list (any order)."""
    out = torch.zeros((len(csr_rows), mat.shape[1]), dtype=torch.float64, device=mat.device)
    for i, idx in enumerate(csr_rows):
        for lo in range(0, len(idx), BLOCK_ROWS):
            out[i] += mat[idx[lo:lo + BLOCK_ROWS]].to(torch.float64).sum(dim=0)
    return out


def gram64(f: torch.Tensor, reg: float) -> torch.Tensor:
    """``FᵀF + λI`` in float64 over row blocks of ``f``."""
    g = torch.zeros((f.shape[1], f.shape[1]), dtype=torch.float64, device=f.device)
    with no_tf32():
        for lo in range(0, f.shape[0], BLOCK_ROWS):
            b = f[lo:lo + BLOCK_ROWS].to(torch.float64)
            g += b.T @ b
    return g + reg * torch.eye(f.shape[1], dtype=torch.float64, device=f.device)


def solve_residual64(x: torch.Tensor, g64: torch.Tensor, r64: torch.Tensor) -> float:
    """``‖x·G − r‖ / ‖r‖`` (Frobenius) in float64: how far the solved rows
    ``x`` are from solving ``x·G = r`` (``G`` symmetric)."""
    with no_tf32():
        resid = x.to(torch.float64) @ g64 - r64
    return float(torch.linalg.norm(resid) / torch.linalg.norm(r64))


def loss64(rows: torch.Tensor, cols: torch.Tensor, user: torch.Tensor, item: torch.Tensor,
           reg: float) -> float:
    """``‖X − U Fᵀ‖² + λ(‖U‖² + ‖F‖²)`` in float64 for the 0/1 matrix whose
    ones are the events ``(rows[e], cols[e])``: ``nnz − 2·Σ_e u_r·f_c +
    Σ (UᵀU)∘(FᵀF)`` plus the penalty, over blocks of events."""
    cross = torch.zeros((), dtype=torch.float64, device=user.device)
    for lo in range(0, rows.shape[0], BLOCK_ROWS):
        u = user[rows[lo:lo + BLOCK_ROWS].long()].to(torch.float64)
        f = item[cols[lo:lo + BLOCK_ROWS].long()].to(torch.float64)
        cross += (u * f).sum()
    gu, gf = gram64(user, 0.0), gram64(item, 0.0)
    penalty = reg * (torch.diagonal(gu).sum() + torch.diagonal(gf).sum())
    return float(rows.shape[0] - 2.0 * cross + (gu * gf).sum() + penalty)


def init32(seed: int, p: int, v: int, rank: int) -> tuple[np.ndarray, np.ndarray]:
    """The training's init: ``default_rng(seed)``'s float64 standard
    normals, users' ``(p, rank)`` then items' ``(v, rank)``, each rounded
    to float32, over ``sqrt(rank)`` in float64, rounded to float32 again."""
    rng = np.random.default_rng(seed)
    user = (rng.standard_normal((p, rank)).astype(np.float32) / np.sqrt(rank)).astype(np.float32)
    item = (rng.standard_normal((v, rank)).astype(np.float32) / np.sqrt(rank)).astype(np.float32)
    return user, item


def normalize32(item: np.ndarray) -> np.ndarray:
    """The payload's item factors: each float32 row over its norm (at least
    1e-12), in float32."""
    norms = np.linalg.norm(item, axis=1, keepdims=True)
    return (item / np.maximum(norms, 1e-12)).astype(np.float32)


def als_plain(events, p: int, v: int, rank: int, iters: int, reg: float, seed: int) -> dict:
    """The whole training in float32 on the events' device → ``{"user",
    "item"}`` (the final factors, not normalized) and ``"loss"``
    (:func:`loss64` of them)."""
    rows, cols = (torch.as_tensor(e).to(torch.int64) for e in events)
    dev = rows.device
    user, item = (torch.as_tensor(f, device=dev) for f in init32(seed, p, v, rank))
    eye = torch.tensor(reg, dtype=torch.float32, device=dev) * torch.eye(
        rank, dtype=torch.float32, device=dev)
    with no_tf32():
        for _ in range(iters):
            xf = torch.zeros((p, rank), dtype=torch.float32, device=dev)
            xf.index_add_(0, rows, item[cols])
            user = torch.linalg.solve(item.T @ item + eye, xf.T).T
            xtu = torch.zeros((v, rank), dtype=torch.float32, device=dev)
            xtu.index_add_(0, cols, user[rows])
            item = torch.linalg.solve(user.T @ user + eye, xtu.T).T
    return {"user": user, "item": item, "loss": loss64(rows, cols, user, item, reg)}


def _ones_csr(seg: torch.Tensor, other: torch.Tensor, n_rows: int, n_cols: int,
              ones: torch.Tensor) -> torch.Tensor:
    """The 0/1 matrix with a one at ``(seg[e], other[e])`` for each event,
    in compressed rows (float64; each row's columns in the events' order)."""
    order = torch.sort(seg, stable=True).indices
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=seg.device)
    crow[1:] = torch.cumsum(torch.bincount(seg.long(), minlength=n_rows), 0)
    col = other[order].long()
    del order
    return torch.sparse_csr_tensor(crow, col, ones, (n_rows, n_cols), check_invariants=False)


def _solve_rows(g: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The rows ``x`` with ``x·G = rhs`` (``G`` symmetric), in blocks."""
    out = torch.empty_like(rhs)
    for lo in range(0, rhs.shape[0], BLOCK_ROWS):
        out[lo:lo + BLOCK_ROWS] = torch.linalg.solve(g, rhs[lo:lo + BLOCK_ROWS].T).T
    return out


def train64(rows: torch.Tensor, cols: torch.Tensor, p: int, v: int, rank: int, iters: int,
            reg: float, seed: int, item_init: np.ndarray | None = None) -> dict:
    """The whole training in float64 on the events' device, from
    :func:`init32`'s factors (``item_init``: its item rows, drawn already):
    each sweep ``U = X F (FᵀF + λI)⁻¹`` then ``F = Xᵀ U (UᵀU + λI)⁻¹``,
    ``X F`` and ``Xᵀ U`` as products of the 0/1 matrix kept in compressed
    rows → ``{"user", "item"}`` (float64, not normalized)."""
    dev = rows.device
    # the first sweep solves the users from the items alone
    item = init32(seed, p, v, rank)[1] if item_init is None else item_init
    item = torch.as_tensor(item, device=dev).to(torch.float64)
    ones = torch.ones(rows.shape[0], dtype=torch.float64, device=dev)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
        warnings.filterwarnings("ignore", message="Sparse invariant checks are implicitly")
        x = _ones_csr(rows, cols, p, v, ones)  # X: a playlist's tracks
        xt = _ones_csr(cols, rows, v, p, ones)  # Xᵀ: a track's playlists
        eye = reg * torch.eye(rank, dtype=torch.float64, device=dev)
        with no_tf32():
            for _ in range(iters):
                user = _solve_rows(item.T @ item + eye, x @ item)
                item = _solve_rows(user.T @ user + eye, xt @ user)
    return {"user": user, "item": item}


def rel_gap64(got: torch.Tensor, want: torch.Tensor) -> float:
    """``‖got − want‖ / ‖want‖`` (Frobenius) in float64, over row blocks."""
    num = torch.zeros((), dtype=torch.float64, device=want.device)
    den = torch.zeros((), dtype=torch.float64, device=want.device)
    for lo in range(0, want.shape[0], BLOCK_ROWS):
        w = want[lo:lo + BLOCK_ROWS].to(torch.float64)
        num += ((got[lo:lo + BLOCK_ROWS].to(w.device, torch.float64) - w) ** 2).sum()
        den += (w * w).sum()
    return float(torch.sqrt(num / den))
