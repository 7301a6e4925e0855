"""The config-4 mine, written straight out: the Bernoulli-Zipf bitset, the
pair counts and the rule emission.

- **The workload** (BASELINE config 4, born on the card): playlist ``p``
  holds track ``t`` with probability ``q_t = min(1, rows · w_t / P)``,
  ``w_t`` the Zipf(s) law over the vocabulary. Only the candidate-frequent
  tracks are drawn, those with ``P·q_t ≥ min_count − 8·sqrt(min_count)``
  (a track below the cut reaches ``min_count`` with probability under
  1e-8). Row ``t`` of the ``(v_pad, w_pad)`` bitset holds, at bit ``b``
  of word ``w``, the draw ``u < q_t`` where ``u`` is element
  ``((t mod 32)·w_pad + w)·32 + b`` of a uniform draw under key
  ``t // 32`` of ``split(PRNGKey(seed), v_pad / 32)``, and 0 at playlist
  positions ``32·w + b ≥ P``. The vocabulary pads to 128 rows and the
  words to 512: the layout the configuration states.
- **The counts**: ``C[i, j]`` is the number of playlists holding both
  tracks, computed over unpacked 0/1 columns in float32 (TF32 off; every
  partial sum is an integer below 2**24, so exact) and summed in int64.
- **The emission** (support mode): row ``i`` keeps the columns
  ``j ≠ i`` with ``C[i, j] ≥ min_count``, ranked by count, equal counts by
  ascending ``j``, the first ``k_max``; confidence ``float32(C / P)``.

Rows are worked out one sample at a time: :func:`bitset_rows` from the
seed alone, :func:`count_rows` from a bitset, :func:`emit_rows` from
count rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .threefry import bits, split_keys, uniform

CANDIDATE_SIGMAS = 8.0
ROW_BLOCK = 32
V_UNIT = 128
WORD_UNIT = 512
DRAWS_PER_CHUNK = 1 << 24  # draws a row computes at once (int64 temporaries)


def min_count_for(min_support: float, n_playlists: int) -> int:
    """The least integer count ``c`` with ``c / P ≥ min_support``."""
    c = math.ceil(min_support * n_playlists)
    while c > 1 and (c - 1) / n_playlists >= min_support:
        c -= 1
    return max(c, 1)


def membership_probs(n_tracks: int, n_playlists: int, rows: int, zipf_s: float) -> np.ndarray:
    """``q_t`` in float64, most popular first."""
    w = 1.0 / np.arange(1, n_tracks + 1, dtype=np.float64) ** zipf_s
    w /= w.sum()
    return np.minimum(rows * w / n_playlists, 1.0)


def candidate_count(q: np.ndarray, n_playlists: int, min_count: int) -> int:
    """How many (most popular) tracks clear the analytic cut."""
    cut = min_count - CANDIDATE_SIGMAS * math.sqrt(max(min_count, 1))
    expected = q * n_playlists
    if cut <= 1.0:
        return int((q > 0).sum())
    return int((expected >= cut).sum())


def padded_shape(n_candidates: int, n_playlists: int) -> tuple[int, int]:
    v_pad = -(-max(n_candidates, V_UNIT) // V_UNIT) * V_UNIT
    words = -(-n_playlists // 32)
    return v_pad, -(-words // WORD_UNIT) * WORD_UNIT


def workload(cfg: dict) -> dict:
    """The shape of a mine from the configuration: ``q`` (float32, padded
    with zeros), the candidate count, ``min_count`` and the padded bitset
    shape."""
    p = int(cfg["playlists"])
    q = membership_probs(int(cfg["tracks"]), p, int(cfg["rows"]), float(cfg["zipf_s"]))
    min_count = min_count_for(float(cfg["min_support"]), p)
    f = candidate_count(q, p, min_count)
    v_pad, w_pad = padded_shape(f, p)
    q32 = np.zeros(v_pad, dtype=np.float32)
    q32[:f] = q[:f]
    return {"q": q32, "candidates": f, "min_count": min_count, "v_pad": v_pad,
            "w_pad": w_pad, "playlists": p, "k_max": int(cfg["k_max"])}


def bitset_rows(
    seed: int, rows, shape: dict, *, device="cpu", compare_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Rows ``rows`` of the bitset drawn under ``seed`` → int32
    ``(len(rows), w_pad)`` with the uint32 bit pattern. ``compare_dtype``
    below float32 is the control: the draw compared in a lower precision."""
    p, w_pad = shape["playlists"], shape["w_pad"]
    q_all = torch.as_tensor(shape["q"], device=device)
    rows = torch.as_tensor(rows, dtype=torch.int64, device=device)
    out = torch.zeros((len(rows), w_pad), dtype=torch.int64, device=device)
    keys = split_keys(seed, rows // ROW_BLOCK)
    real_words = -(-p // 32)
    bit = torch.arange(32, dtype=torch.int64, device=device)
    w_step = max(1, min(real_words, DRAWS_PER_CHUNK // 32))
    for i in range(len(rows)):
        q = q_all[rows[i]]
        if float(q) <= 0.0:
            continue
        k0, k1 = keys[i, 0], keys[i, 1]
        first = (rows[i] % ROW_BLOCK) * w_pad
        for w0 in range(0, real_words, w_step):
            w = torch.arange(w0, min(w0 + w_step, real_words), dtype=torch.int64, device=device)
            index = (first + w[:, None]) * 32 + bit
            u = uniform(bits(k0, k1, index))
            hit = u.to(compare_dtype) < q.to(compare_dtype)
            hit &= (w[:, None] * 32 + bit) < p
            out[i, w0:w0 + len(w)] = (hit.to(torch.int64) << bit).sum(dim=1)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def count_rows(bitset: torch.Tensor, rows, *, word_chunk: int = 1024) -> torch.Tensor:
    """``C[rows, :]`` from a ``(v, w)`` int32 bitset → int64
    ``(len(rows), v)``, on the bitset's device."""
    dev = bitset.device
    rows = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    v, w = bitset.shape
    out = torch.zeros((len(rows), v), dtype=torch.int64, device=dev)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for w0 in range(0, w, word_chunk):
            block = bitset[:, w0:w0 + word_chunk]
            cols = ((block[:, :, None] >> shifts) & 1).reshape(v, -1).to(torch.float32)
            out += (cols[rows] @ cols.t()).to(torch.int64)
            del cols
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def emit_rows(counts: np.ndarray, rows, *, min_count: int, k_max: int, n_playlists: int) -> dict:
    """The emission of count rows ``counts`` (int64 ``(len(rows), v)``,
    row ``i`` of it being matrix row ``rows[i]``) → per row the rule ids
    (-1 padded), counts, float32 confidences, the item count and the
    number of valid consequents."""
    counts = np.asarray(counts, dtype=np.int64)
    n, v = counts.shape
    ids = np.full((n, k_max), -1, dtype=np.int64)
    cnt = np.zeros((n, k_max), dtype=np.int64)
    item = np.zeros(n, dtype=np.int64)
    n_valid = np.zeros(n, dtype=np.int64)
    cols = np.arange(v)
    for i, r in enumerate(np.asarray(rows, dtype=np.int64)):
        row = counts[i]
        item[i] = row[r]
        valid = (row >= min_count) & (cols != r)
        n_valid[i] = int(valid.sum())
        cand = cols[valid]
        order = np.lexsort((cand, -row[cand]))[:k_max]
        ids[i, :len(order)] = cand[order]
        cnt[i, :len(order)] = row[cand[order]]
    confs = (cnt.astype(np.float64) / n_playlists).astype(np.float32)
    return {"rule_ids": ids, "rule_counts": cnt, "rule_confs": confs,
            "item_counts": item, "row_valid": n_valid}
