"""Frequent-itemset support counting — counterpart of
``kmlserver_tpu/ops/support.py``.

The dense formulation: with the int8 one-hot ``X (P, V)``,

    pair_counts[i, j] = Σ_p X[p, i]·X[p, j]  =  (XᵀX)[i, j]

one int8×int8→int32 product; triples and quads extend frequent pairs and
triples by a product over masked column products (``YᵀX``). The reference
leaves these products to XLA, outside any Pallas kernel, so here they are
``torch._int_mm`` (:func:`int8_gram`), the int8 tensor-core GEMM on the card.
:func:`int8_gram_plain` is the same product written straight out, for the
tests and for ``chip_smoke.py``'s comparison on the card.

Thresholding is done in INTEGER counts computed on the host in float64, so
no device float rounding can flip a frequency decision.
"""

from __future__ import annotations

import math

import torch


def min_count_for(min_support: float, n_playlists: int) -> int:
    """Smallest integer count c with c / n_playlists >= min_support, computed
    in float64 exactly as a CPU oracle would compare (mlxtend keeps itemsets
    with support >= min_support). Clamped to at least 1."""
    c = int(math.ceil(min_support * n_playlists))
    # ceil can overshoot when min_support * n is an exact integer in f64
    while c > 1 and (c - 1) / n_playlists >= min_support:
        c -= 1
    return max(c, 1)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _padded(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if tuple(a.shape) == (rows, cols) and a.is_contiguous():
        return a
    out = torch.zeros((rows, cols), dtype=a.dtype, device=a.device)
    out[: a.shape[0], : a.shape[1]] = a
    return out


def int8_gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ bᵀ`` for int8 ``a (M, K)`` and ``b (N, K)`` → int32 ``(M, N)``,
    through ``torch._int_mm``. On CUDA that call needs ``M > 16`` and ``K``,
    ``N`` multiples of 8, with A row-major and B column-major; every device
    gets the same zero padding (zeros add nothing to a count) so the CPU
    tests run the shapes the card sees, and the result is sliced back."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_gram needs int8 operands, got {a.dtype}, {b.dtype}")
    m, k = a.shape
    n = b.shape[0]
    if b.shape[1] != k:
        raise ValueError(f"inner sizes differ: {tuple(a.shape)} @ {tuple(b.shape)}ᵀ")
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=a.device)
    kp = _round_up(k, 8)
    a_p = _padded(a, _round_up(max(m, 17), 8), kp)
    b_p = _padded(b, _round_up(n, 8), kp)
    out = torch._int_mm(a_p, b_p.t())
    if out.shape != (m, n):
        out = out[:m, :n].contiguous()
    return out


def int8_gram_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`int8_gram` written straight out: an int32 product on the CPU.
    cuBLAS has no int32 product, so on a CUDA tensor it multiplies in
    float64, which is exact: every partial sum is an integer at most
    ``K < 2**53``."""
    if a.is_cuda:
        return (a.double() @ b.double().t()).to(torch.int32)
    return a.to(torch.int32) @ b.to(torch.int32).t()


def pair_counts(x_onehot: torch.Tensor) -> torch.Tensor:
    """``XᵀX`` over the playlist axis: int8 ``(P, V)`` → int32 ``(V, V)``.
    Diagonal = singleton supports; off-diagonal = pair supports."""
    xt = x_onehot.t().contiguous()
    return int8_gram(xt, xt)


def item_counts(x_onehot: torch.Tensor) -> torch.Tensor:
    """Per-item singleton supports: int32 ``(V,)``."""
    return x_onehot.sum(dim=0, dtype=torch.int32)


def triple_counts(
    x_onehot: torch.Tensor, pair_i: torch.Tensor, pair_j: torch.Tensor
) -> torch.Tensor:
    """Supports of {i, j, k} for E candidate pairs × all k: int32 ``(E, V)``.

    ``Yᵀ[e, p] = X[p, i_e]·X[p, j_e]`` (elementwise), then ``YᵀX``. Columns
    k ∈ {i_e, j_e} hold pair supports, not proper triples, and must be
    masked by the caller."""
    xt = x_onehot.t().contiguous()
    yt = xt[pair_i.long()] * xt[pair_j.long()]  # (E, P) int8
    return int8_gram(yt, xt)


def quad_counts(
    x_onehot: torch.Tensor,
    trip_i: torch.Tensor,
    trip_j: torch.Tensor,
    trip_k: torch.Tensor,
) -> torch.Tensor:
    """Supports of {i, j, k, l} for E candidate triples × all l: int32
    ``(E, V)``, as :func:`triple_counts` one level up. Columns
    l ∈ {i_e, j_e, k_e} hold the triple support itself."""
    xt = x_onehot.t().contiguous()
    yt = xt[trip_i.long()] * xt[trip_j.long()] * xt[trip_k.long()]
    return int8_gram(yt, xt)


def frequent_pairs(
    counts: torch.Tensor, min_count: int, *, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Up to ``capacity`` frequent off-diagonal pairs (i < j) of the
    pair-count matrix, ranked by count with equal counts in ascending flat
    index — the order ``jax.lax.top_k`` gives. ``torch.topk`` promises no
    order among equal values, so it ranks the unique key
    ``count·V² + (V²-1-flat)``.

    Returns ``(pair_i, pair_j, pair_count, n_frequent)``, each array of
    length ``capacity``; entries past ``n_frequent`` are -1/-1/0 padding.
    ``n_frequent`` may exceed ``capacity`` — the caller checks."""
    v = counts.shape[0]
    v2 = v * v
    dev = counts.device
    c = counts.to(torch.int64)
    upper = torch.ones((v, v), dtype=torch.bool, device=dev).triu_(1)
    valid = upper & (c >= min_count)
    n_frequent = int(valid.sum())
    score = torch.where(valid, c, torch.full_like(c, -1)).reshape(-1)
    k = min(capacity, v2)
    flat = torch.arange(v2, device=dev, dtype=torch.int64)
    top_key = torch.topk(score * v2 + (v2 - 1 - flat), k, sorted=True).values
    top_idx = (v2 - 1) - torch.remainder(top_key, v2)
    top_counts = score[top_idx]
    keep = top_counts > 0
    sentinel = torch.full_like(top_idx, -1)
    pair_i = torch.where(keep, top_idx // v, sentinel).to(torch.int32)
    pair_j = torch.where(keep, top_idx % v, sentinel).to(torch.int32)
    top_counts = torch.where(keep, top_counts, 0).to(torch.int32)
    if k < capacity:  # pad so the declared capacity shape holds
        pad = capacity - k
        pair_i = torch.nn.functional.pad(pair_i, (0, pad), value=-1)
        pair_j = torch.nn.functional.pad(pair_j, (0, pad), value=-1)
        top_counts = torch.nn.functional.pad(top_counts, (0, pad))
    return pair_i, pair_j, top_counts, n_frequent
