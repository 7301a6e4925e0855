"""The rule model: rule tensors on the device + vocabulary + the lookup —
counterpart of ``kmlserver_tpu/models/rule_model.py``. The serving engine
keeps its own bundles (hot-swap state); both sit on the same primitives."""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from ..config import MiningConfig
from ..io import artifacts
from ..mining.vocab import Baskets
from ..ops.serve import recommend_batch
from ..utils.device import resolve_device
from . import _seeds


@dataclasses.dataclass
class RuleModel:
    """Association-rule model over a track vocabulary."""

    vocab: list[str]
    index: dict[str, int]
    rule_ids: torch.Tensor  # int32 (V, K_max) on the device
    rule_confs: torch.Tensor  # float32 (V, K_max) on the device
    mode: str  # "support" | "confidence"

    @classmethod
    def _from_tensors(cls, vocab, rule_ids, rule_confs, mode: str, device) -> "RuleModel":
        dev = resolve_device(device)
        return cls(
            vocab=list(vocab),
            index={n: i for i, n in enumerate(vocab)},
            rule_ids=torch.as_tensor(np.asarray(rule_ids, dtype=np.int32), device=dev),
            rule_confs=torch.as_tensor(np.asarray(rule_confs, dtype=np.float32), device=dev),
            mode=mode,
        )

    @staticmethod
    def fit(
        baskets: Baskets, cfg: MiningConfig | None = None,
        device: str | torch.device = "cuda",
    ) -> "RuleModel":
        """Mine a model from a transaction DB on ``device``."""
        from ..mining.miner import mine

        result = mine(baskets, cfg or MiningConfig(), device=device)
        t = result.tensors
        return RuleModel._from_tensors(result.vocab_names, t.rule_ids, t.rule_confs, t.mode, device)

    @staticmethod
    def load(npz_path: str, device: str | torch.device = "cuda") -> "RuleModel":
        """Load the tensor artifact the mining job writes onto ``device``."""
        loaded = artifacts.load_rule_tensors(npz_path)
        return RuleModel._from_tensors(
            loaded["vocab"], loaded["rule_ids"], loaded["rule_confs"], loaded["mode"], device
        )

    def encode_seeds(self, seed_sets: list[list[str]], pad_len: int | None = None) -> np.ndarray:
        """Seed names → int32 (B, L) id batch, -1 padded; unknown names drop."""
        return _seeds.encode_seeds(self.index, seed_sets, pad_len)

    def recommend(self, seed_sets: list[list[str]], k_best: int = 10) -> list[list[str]]:
        """One lookup for the whole batch, padded to power-of-two buckets."""
        seeds = torch.as_tensor(_seeds.bucketed_seeds(self.index, seed_sets),
                                device=self.rule_ids.device)
        top_ids, _ = self.apply_fn(k_best)(self.rule_ids, self.rule_confs, seeds)
        top_ids = top_ids.cpu().numpy()[: len(seed_sets)]
        return [[self.vocab[int(i)] for i in row if i >= 0] for row in top_ids]

    @staticmethod
    def apply_fn(k_best: int = 10):
        """The raw forward step (the rule lookup)."""
        return partial(recommend_batch, k_best=k_best)
