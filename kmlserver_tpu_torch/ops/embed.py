"""The embedding lookup: cosine top-k over the item factors.

Counterpart of ``kmlserver_tpu/ops/embed.py::_embed_topk_impl``
(``:46-87``), which the reference leaves to XLA. The seeds' unit item
vectors are scored against every item by dot product (cosine similarity:
the factors are row-normalized at publication), max-merged over the seed
slots, the seeds themselves masked out, and the top k extracted:

- ``-1``-padded seed slots contribute nothing; a row with no valid seed
  returns all ``-1``;
- the merge is a running max over one ``(B, R) @ (R, V)`` product per
  seed slot, so live memory stays O(B·V), never O(B·L·V);
- the seeds are masked through a spill column V, as in the reference;
- ties keep the lowest index first, as ``jax.lax.top_k`` does:
  ``torch.topk`` promises no tie order, so the top k comes from a stable
  descending sort. Ties are common: tracks with identical membership
  columns solve to bitwise-identical factor rows.

Full fp32: the products run with TF32 off (PyTorch's default for
``matmul``); TF32 would move the similarities by about 1e-3. These are
torch ops on either device; a fused hand kernel is ROADMAP X5.
"""

from __future__ import annotations

import torch

# large-but-finite floor instead of -inf: masked lanes stay out of every
# max without breeding NaNs
NEG = -3.0e38


def embed_topk(
    item_factors: torch.Tensor, seed_ids: torch.Tensor, *, k_best: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``item_factors`` f32 (V, R), ``seed_ids`` int32 (B, L) with -1
    padding, on one device → ``(top_ids int32 (B, k_best) -1-padded,
    top_sims f32 (B, k_best) 0-padded)``."""
    v = item_factors.shape[0]
    b = seed_ids.shape[0]
    seeds = seed_ids.to(torch.int64)
    valid_seed = seeds >= 0
    safe = torch.where(valid_seed, seeds, torch.zeros_like(seeds))
    # NEG enters as a Python scalar or a fill, never as torch.tensor(...,
    # device=...): that copy from pageable host memory would synchronize
    # the host with the card on every dispatch
    running = torch.full((b, v), NEG, dtype=item_factors.dtype, device=item_factors.device)
    factors_t = item_factors.t()
    for slot in range(seeds.shape[1]):
        sims = item_factors[safe[:, slot]] @ factors_t  # (B, V)
        sims = torch.where(valid_seed[:, slot, None], sims, NEG)
        torch.maximum(running, sims, out=running)
    # mask the seeds out of their own candidates; padding lands in column V
    pad = torch.full((b, 1), NEG, dtype=item_factors.dtype, device=item_factors.device)
    scores = torch.cat([running, pad], dim=1)
    targets = torch.where(valid_seed, seeds, torch.full_like(seeds, v))
    scores.scatter_(1, targets, NEG)
    k = min(k_best, v)
    top_sims, top_ids = torch.sort(scores[:, :v], dim=1, descending=True, stable=True)
    top_sims, top_ids = top_sims[:, :k], top_ids[:, :k].to(torch.int32)
    valid = top_sims > NEG / 2
    top_ids = torch.where(valid, top_ids, torch.full_like(top_ids, -1))
    top_sims = torch.where(valid, top_sims, torch.zeros_like(top_sims))
    if k < k_best:  # callers always see k_best columns
        pad = k_best - k
        top_ids = torch.nn.functional.pad(top_ids, (0, pad), value=-1)
        top_sims = torch.nn.functional.pad(top_sims, (0, pad), value=0.0)
    return top_ids, top_sims
