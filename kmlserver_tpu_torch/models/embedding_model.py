"""The embedding model: ALS item factors on the device + vocabulary + the
cosine top-k — counterpart of ``kmlserver_tpu/models/embedding_model.py``.
Training is ``mining/als.py``, inference ``ops/embed.py``, serialization
the manifest-covered ``embeddings.npz``; the serving engine carries the
factors in its own bundles for the hybrid merge."""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from ..config import MiningConfig
from ..io import artifacts
from ..mining.vocab import Baskets
from ..ops.embed import embed_topk
from ..utils.device import resolve_device
from . import _seeds


@dataclasses.dataclass
class EmbeddingModel:
    """ALS item-embedding model over a track vocabulary."""

    vocab: list[str]
    index: dict[str, int]
    item_factors: torch.Tensor  # float32 (V, rank), rows L2-normalized, on the device
    rank: int

    @classmethod
    def _from_factors(cls, vocab, item_factors: np.ndarray, device) -> "EmbeddingModel":
        return cls(
            vocab=list(vocab),
            index={n: i for i, n in enumerate(vocab)},
            item_factors=torch.as_tensor(np.asarray(item_factors, dtype=np.float32),
                                         device=resolve_device(device)),
            rank=int(item_factors.shape[1]),
        )

    @staticmethod
    def fit(
        baskets: Baskets, cfg: MiningConfig | None = None,
        device: str | torch.device = "cuda",
    ) -> "EmbeddingModel":
        """Train from a transaction DB on ``device`` (ALS)."""
        from ..mining.als import train_embeddings

        result = train_embeddings(baskets, cfg or MiningConfig(), device=device)
        if result["item_factors"] is None:
            raise ValueError(f"ALS training skipped: {result['skipped']}")
        return EmbeddingModel._from_factors(baskets.vocab.names, result["item_factors"], device)

    @staticmethod
    def load(npz_path: str, device: str | torch.device = "cuda") -> "EmbeddingModel":
        """Load the embedding artifact the mining job publishes onto ``device``."""
        loaded = artifacts.load_embeddings(npz_path)
        return EmbeddingModel._from_factors(loaded["vocab"], loaded["item_factors"], device)

    def encode_seeds(self, seed_sets: list[list[str]], pad_len: int | None = None) -> np.ndarray:
        """Seed names → int32 (B, L) id batch, -1 padded; unknown names drop."""
        return _seeds.encode_seeds(self.index, seed_sets, pad_len)

    def recommend(self, seed_sets: list[list[str]], k_best: int = 10) -> list[list[str]]:
        """One cosine top-k for the whole batch, padded to power-of-two
        buckets; the seeds themselves never come back."""
        seeds = torch.as_tensor(_seeds.bucketed_seeds(self.index, seed_sets),
                                device=self.item_factors.device)
        top_ids, _ = self.apply_fn(k_best)(self.item_factors, seeds)
        top_ids = top_ids.cpu().numpy()[: len(seed_sets)]
        return [[self.vocab[int(i)] for i in row if i >= 0] for row in top_ids]

    @staticmethod
    def apply_fn(k_best: int = 10):
        """The raw forward step (cosine top-k over item space)."""
        return partial(embed_topk, k_best=k_best)
