"""The serving API's answer, written straight out: the rule lookup, the
embedding top-k, the blend, and the popularity fallback.

For one request (a list of track names) over a publication:

- **rules**: the seeds that are frequent rule keys; per consequent the
  largest confidence over those seeds' rule rows; the ``k`` best by
  confidence, equal confidences by ascending rule-vocabulary id.
- **embeddings**: the seeds in the embedding vocabulary; per item the
  largest cosine (dot product of the row-normalized factors) over those
  seeds, the seeds themselves left out; the ``k`` best, equal scores by
  ascending id.
- **blend**, when both families know a seed: the union of the two lists,
  each name scored ``(1 - w)·confidence + w·similarity`` (a side it is
  missing from adds nothing), ranked by score, equal scores by name; the
  first ``k``. With only one family knowing a seed, that family's list.
- **fallback**, when neither does: ``k`` names sampled from the
  popularity list by ``random.Random(h)``, ``h`` the first 8 bytes of the
  BLAKE2b digest of the sorted seeds joined by ``\\x1f`` (big-endian).

Similarities are computed in float64. The control computes them as
TF32 does: each factor rounded to TF32's 10-bit mantissa (to nearest,
ties away from zero), products summed in float32.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch


def stable_seed(seeds: list[str]) -> int:
    digest = hashlib.blake2b("\x1f".join(sorted(seeds)).encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "big")


def fallback(seeds: list[str], best_names: list[str], k: int) -> list[str]:
    return random.Random(stable_seed(seeds)).sample(best_names, min(k, len(best_names)))


class Reference:
    """The answers of one publication. ``names`` is the catalog (the
    embedding vocabulary, most popular first); the rule vocabulary is its
    first ``len(rule_ids)`` names; ``factors`` the float32 (V, R)
    row-normalized item factors; ``rule_confs`` float32 as served."""

    def __init__(self, pub: dict, *, k_best: int, weight: float, max_seeds: int, tol: float,
                 device="cpu", precision: str = "float64"):
        self.names = pub["names"]
        self.index = {n: i for i, n in enumerate(self.names)}
        self.n_rule = pub["rule_ids"].shape[0]
        self.rule_ids = np.asarray(pub["rule_ids"], dtype=np.int64)
        self.rule_confs = confidences(pub)
        self.known = np.asarray(pub["item_counts"]) >= pub["min_count"]
        self.best = pub["best_names"]
        self.k = k_best
        self.w = min(max(weight, 0.0), 1.0)
        self.max_seeds = max_seeds
        self.device = torch.device(device)
        self.tol = tol
        factors = torch.as_tensor(pub["factors"], device=self.device)
        if precision == "float64":
            self.factors = factors.to(torch.float64)
        elif precision == "tf32":
            self.factors = to_tf32(factors)
        else:
            raise ValueError(f"unknown precision {precision!r}")

    def rule_seeds(self, seeds: list[str]) -> list[int]:
        ids = [self.index[s] for s in seeds if s in self.index and self.index[s] < self.n_rule]
        return [i for i in ids if self.known[i]][: self.max_seeds]

    def emb_seeds(self, seeds: list[str]) -> list[int]:
        return [self.index[s] for s in seeds if s in self.index][: self.max_seeds]

    def rules_top(self, ids: list[int]) -> list[tuple[int, float]]:
        best: dict[int, float] = {}
        for i in ids:
            for j, c in zip(self.rule_ids[i], self.rule_confs[i]):
                if j >= 0 and c > 0 and c > best.get(int(j), 0.0):
                    best[int(j)] = float(c)
        return sorted(best.items(), key=lambda jc: (-jc[1], jc[0]))[: self.k]

    def sims(self, ids: list[int]) -> torch.Tensor:
        """Per item the largest similarity to a seed (the seeds at -inf),
        as float64 on the reference's device."""
        seeds = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            best = None
            for lo in range(0, len(ids), 32):
                part = (self.factors[seeds[lo:lo + 32]] @ self.factors.t()).amax(dim=0)
                best = part if best is None else torch.maximum(best, part)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        best = best.to(torch.float64)
        best[seeds] = -float("inf")
        return best

    def emb_top(self, sims: torch.Tensor) -> list[tuple[int, float]]:
        vals, idx = torch.topk(sims, min(4 * self.k + 16, sims.shape[0]))
        pairs = sorted(zip(idx.tolist(), vals.tolist()), key=lambda jv: (-jv[1], jv[0]))
        return pairs[: self.k]

    def answer(self, seeds: list[str]) -> dict:
        """→ ``{"kind", "names", "scores", "score_of"}``: the reference's
        list with its scores, and ``score_of(name)``, the score a served
        name earns: its similarity, or in a blend its weighted confidence
        plus, where it is an embedding candidate (among the reference's
        ``k``, or within ``tol`` of the ``k``-th similarity, a near-tie that
        another summation order may rank in), its weighted similarity."""
        r_ids, e_ids = self.rule_seeds(seeds), self.emb_seeds(seeds)
        if not r_ids and not e_ids:
            names = fallback(seeds, self.best, self.k)
            return {"kind": "fallback", "names": names, "scores": None, "score_of": None}
        rules = self.rules_top(r_ids) if r_ids else []
        if not e_ids:
            names = [self.names[j] for j, _ in rules]
            conf = {self.names[j]: c for j, c in rules}
            return {"kind": "rules", "names": names, "scores": [c for _, c in rules],
                    "score_of": lambda n: conf.get(n)}
        sims = self.sims(e_ids)
        emb = self.emb_top(sims)

        def sim_of(name: str) -> float | None:
            j = self.index.get(name)
            if j is None:
                return None
            s = float(sims[j])
            return None if s == -float("inf") else s

        if not r_ids:
            return {"kind": "embed", "names": [self.names[j] for j, _ in emb],
                    "scores": [s for _, s in emb], "score_of": sim_of}
        conf = {self.names[j]: c for j, c in rules}
        scores: dict[str, float] = {}
        for name, c in conf.items():
            scores[name] = (1.0 - self.w) * c
        for j, s in emb:
            name = self.names[j]
            scores[name] = scores.get(name, 0.0) + self.w * s
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[: self.k]

        in_emb = {self.names[j] for j, _ in emb}
        floor = min(v for _, v in emb) - self.tol if emb else float("inf")

        def blend_of(name: str) -> float | None:
            s = sim_of(name)
            if s is None and name not in conf:
                return None
            base = (1.0 - self.w) * conf.get(name, 0.0)
            # a name earns its similarity as an embedding candidate: one of
            # the reference's k, or tied with the k-th within the tolerance
            if s is not None and (name in in_emb or s >= floor):
                return base + self.w * s
            return base

        return {"kind": "hybrid", "names": [n for n, _ in ranked],
                "scores": [v for _, v in ranked], "score_of": blend_of}


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero), still stored as float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    sign = bits & torch.tensor(-(1 << 31), dtype=torch.int32, device=x.device)
    mag = (bits & 0x7FFFFFFF) + (1 << 12)
    return (sign | (mag & ~0x1FFF)).view(torch.float32)


def confidences(pub: dict) -> np.ndarray:
    """Confidence-mode rule confidences as served: ``float32(count /
    max(item_count, 1))`` in float64 division."""
    denom = np.maximum(np.asarray(pub["item_counts"], dtype=np.int64), 1)[:, None]
    return (np.asarray(pub["rule_counts"], dtype=np.int64) / denom.astype(np.float64)).astype(np.float32)


def judge(ref_answer: dict, served: list[str]) -> tuple[float, bool]:
    """One served answer against the reference's → ``(score gap, exact
    mismatch)``. The gap is the largest amount by which a served name's
    score lies below the reference's at the same position; a name the
    reference cannot score, a repeated name, or a list of another length
    is an exact mismatch. Fallback and rules-only answers compare
    exactly."""
    names = ref_answer["names"]
    if len(served) != len(names) or len(set(served)) != len(served):
        return 0.0, True
    if ref_answer["kind"] in ("fallback", "rules"):
        return 0.0, served != names
    gap = 0.0
    for pos, name in enumerate(served):
        s = ref_answer["score_of"](name)
        if s is None:
            return gap, True
        gap = max(gap, ref_answer["scores"][pos] - s)
    return gap, False
