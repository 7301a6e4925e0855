"""The blend-weight sweep — counterpart of ``kmlserver_tpu/quality/sweep.py``.

The hybrid rule ∪ embedding blend serves ``(1-w)·conf + w·sim``. The eval
phase (``quality/eval.py``) sweeps ``w`` over :data:`WEIGHT_GRID` on the
held-out split, and the argmax is published as ``measured_blend_weight`` in
``quality.report.json``; the engine serves it under
``KMLS_HYBRID_BLEND_WEIGHT=measured``.

The sweep re-merges on the host only: the harness computes both families'
candidates once on the device, and each grid point re-ranks them through
the engine's ``blend_candidates`` — 21 host merges per playlist, no device
pass.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

# the serving default (ServingConfig.hybrid_blend_weight): the fail-safe
# when no report is published
DEFAULT_BLEND_WEIGHT = 0.5

# 21 points over [0, 1]. The endpoints are real candidates: at w = 0 the
# embeddings still backfill rule-less candidates, at w = 1 the rule-only
# rows keep their answers
WEIGHT_GRID = tuple(round(w, 2) for w in np.arange(0.0, 1.0001, 0.05))


def sweep_blend_weight(
    compose_at: Callable[[float, int], list[str]],
    target_names: list[list[str]],
    n_eval: int,
    k: int,
) -> dict[str, Any]:
    """Sweep :data:`WEIGHT_GRID` → the recall and MRR curves and the argmax.

    ``compose_at(w, e)`` is the blended answer for eval playlist ``e`` at
    weight ``w``. Ties go to the lowest weight (the rule model's side)."""
    from .eval import _rank_metrics

    weights: list[float] = []
    recalls: list[float] = []
    mrrs: list[float] = []
    for w in WEIGHT_GRID:
        per_recall, per_rr = [], []
        for e in range(n_eval):
            recall, rr = _rank_metrics(compose_at(w, e), target_names[e], k)
            per_recall.append(recall)
            per_rr.append(rr)
        weights.append(float(w))
        recalls.append(round(float(np.mean(per_recall)), 6))
        mrrs.append(round(float(np.mean(per_rr)), 6))
    best_i = max(range(len(weights)), key=lambda i: (recalls[i], -weights[i]))
    return {
        "weights": weights,
        "recall_at_k": recalls,
        "mrr": mrrs,
        "best_weight": weights[best_i],
        "best_recall_at_k": recalls[best_i],
        "best_mrr": mrrs[best_i],
    }


__all__ = ["DEFAULT_BLEND_WEIGHT", "WEIGHT_GRID", "sweep_blend_weight"]
