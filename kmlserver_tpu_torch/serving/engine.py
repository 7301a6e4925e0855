"""Serving state and lookups — counterpart of the reference
``kmlserver_tpu/serving/engine.py`` for this slice: load the rule tensors
from the PVC onto the device, hot-swap them when the invalidation token
changes, and answer seed sets through ``ops/serve.recommend_batch``.

Semantics are the reference's (rest_api/app/main.py:205-254): seeds are
filtered by rule-dict membership and cut to ``max_seed_tracks``; a request
with no known seed gets the deterministic popularity fallback; a request
whose known seeds all have empty rows gets an empty list. The async front
end, micro-batcher, answer cache, replicas, mesh and embeddings are not
part of this slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import random
import threading
import time
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from ..config import ServingConfig
from ..io import artifacts, registry
from ..ops.serve import recommend_batch
from ..ops.support import min_count_for
from ..utils.device import resolve_device

logger = logging.getLogger("kmlserver_tpu_torch.serving")


def stable_seed(seed_tracks: list[str]) -> int:
    """Process-independent replacement for the reference's salted
    ``hash(tuple(sorted(seed_tracks)))`` (rest_api/app/main.py:214)."""
    digest = hashlib.blake2b(
        "\x1f".join(sorted(seed_tracks)).encode("utf-8"), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big")


@dataclasses.dataclass
class RuleBundle:
    """One immutable generation of serving state, swapped atomically."""

    vocab: list[str]
    index: dict[str, int]
    rule_ids: torch.Tensor  # int32 (V, K) on the serving device
    rule_confs: torch.Tensor  # float32 (V, K) on the serving device
    known_mask: np.ndarray  # host bool (V,) — rule-dict key membership
    model_token: str  # invalidation-token value when loaded


def bundle_from_arrays(
    arrays: Mapping[str, Any],
    *,
    token: str = "",
    device: str | torch.device = "cuda",
) -> RuleBundle:
    """Carry rule tensors onto the device as a serving bundle.

    ``arrays`` is the dict either package's ``load_rule_tensors`` returns
    for a ``.tensors.npz`` (``vocab``, ``rule_ids``, ``rule_confs``,
    ``item_counts``, ``n_playlists``, ``min_support``: the key set is the
    frequent items), or ``vocab``/``rule_ids``/``rule_confs`` with an
    explicit ``known_mask``."""
    dev = resolve_device(device)
    vocab = list(arrays["vocab"])
    if "known_mask" in arrays:
        known = np.asarray(arrays["known_mask"], dtype=bool)
    else:
        known = np.asarray(arrays["item_counts"]) >= min_count_for(
            float(arrays["min_support"]), int(arrays["n_playlists"])
        )
    return RuleBundle(
        vocab=vocab,
        index={n: i for i, n in enumerate(vocab)},
        rule_ids=torch.as_tensor(
            np.ascontiguousarray(arrays["rule_ids"], dtype=np.int32), device=dev
        ),
        rule_confs=torch.as_tensor(
            np.ascontiguousarray(arrays["rule_confs"], dtype=np.float32), device=dev
        ),
        known_mask=known,
        model_token=token,
    )


class RecommendEngine:
    """Holds serving state and executes lookups on ``device`` (default
    ``cuda``; raises when no card is present). Thread-safe: the bundle and
    best-tracks references are replaced atomically."""

    def __init__(self, cfg: ServingConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bundle: RuleBundle | None = None
        self.best_tracks: list[dict] | None = None
        self.cache_value: str | None = None  # the reference's app.cache_value
        self.finished_loading = False
        self.reload_counter = 0
        self._reload_lock = threading.Lock()

    # ---------- artifact loading / hot swap ----------

    def _token_path(self) -> str:
        return registry.token_path_for(self.cfg.base_dir, self.cfg.data_invalidation_file)

    def _read_token(self) -> str | None:
        try:
            return artifacts.read_text(self._token_path())
        except FileNotFoundError:
            return None

    def is_data_stale(self) -> bool:
        """Token-comparison staleness (reference: rest_api/app/main.py:82-97);
        a missing token counts as stale. Pure: ``cache_value`` moves only
        when a new bundle actually loads."""
        token = self._read_token()
        if token is None:
            logger.warning("invalidation token %s missing", self._token_path())
            return True
        return token != self.cache_value

    def load(self) -> bool:
        """Build a fresh bundle from the PVC and swap it in. Returns False
        (fail-soft, last-good bundle kept) when the artifacts are absent or
        unreadable."""
        with self._reload_lock:
            if self.finished_loading and not self.is_data_stale():
                return True
            cfg = self.cfg
            best_path = os.path.join(cfg.pickles_dir, cfg.best_tracks_file)
            rec_path = os.path.join(cfg.pickles_dir, cfg.recommendations_file)
            try:
                token = self._read_token() or ""
                best = artifacts.load_pickle(best_path)
                bundle = self._load_bundle(rec_path, token)
                if bundle.vocab:
                    # one lookup on the new tensors before publishing: the
                    # first gather/scatter/sort on a device pays its lazy
                    # initialisation here instead of inside a request
                    recommend_batch(
                        bundle.rule_ids, bundle.rule_confs,
                        torch.zeros((1, 1), dtype=torch.int32, device=self.device),
                        k_best=self.cfg.k_best_tracks,
                    )
            except FileNotFoundError as exc:
                logger.warning("artifacts not ready: %s", exc)
                return False
            except Exception:
                logger.exception("artifact load failed; keeping current bundle")
                return False
            self.best_tracks = best
            self.bundle = bundle
            self.cache_value = bundle.model_token or self.cache_value
            self.finished_loading = True
            self.reload_counter += 1
            logger.info(
                "reload #%d complete: %d tracks, %d rule keys on %s, token %r",
                self.reload_counter, len(bundle.vocab),
                int(bundle.known_mask.sum()), self.device, bundle.model_token,
            )
            return True

    def _load_bundle(self, rec_path: str, token: str) -> RuleBundle:
        """The npz twin when present (counts → float64 → float32 confs),
        else the reference pickle dict."""
        npz_path = artifacts.tensor_artifact_path(rec_path)
        if self.cfg.prefer_tensor_artifact and os.path.exists(npz_path):
            loaded = artifacts.load_rule_tensors(npz_path)
            return bundle_from_arrays(loaded, token=token, device=self.device)
        rules_dict = artifacts.load_pickle(rec_path)
        vocab = sorted(set(rules_dict) | {o for row in rules_dict.values() for o in row})
        rule_ids, rule_confs, known = artifacts.tensors_from_rules_dict(
            rules_dict, vocab,
            k_max=max((len(r) for r in rules_dict.values()), default=1),
        )
        return bundle_from_arrays(
            {"vocab": vocab, "rule_ids": rule_ids, "rule_confs": rule_confs,
             "known_mask": known},
            token=token, device=self.device,
        )

    def reload_if_required(self) -> None:
        """Reload when stale or never fully loaded
        (reference: rest_api/app/main.py:110-114)."""
        if self.is_data_stale() or not self.finished_loading:
            self.load()

    # ---------- lookups ----------

    def recommend(self, seed_tracks: list[str]) -> tuple[list[str], str]:
        """→ ``(songs, source)``, source ∈ {"rules", "fallback", "empty"}."""
        return self.recommend_many([seed_tracks])[0]

    def recommend_many(
        self, seed_sets: list[list[str]]
    ) -> list[tuple[list[str], str]]:
        """One device call for a batch of seed sets; per-request semantics
        identical to :meth:`recommend`."""
        bundle = self.bundle
        if bundle is None:
            # degrade + nudge a reload, like the reference's late-load path
            threading.Thread(target=self.reload_if_required, daemon=True).start()
            return [(self.static_recommendation(s), "fallback") for s in seed_sets]
        known = [
            [
                bundle.index[s]
                for s in seeds
                if s in bundle.index and bundle.known_mask[bundle.index[s]]
            ][: self.cfg.max_seed_tracks]
            for seeds in seed_sets
        ]
        out: list[tuple[list[str], str] | None] = [None] * len(seed_sets)
        rows = [r for r, ids in enumerate(known) if ids]
        for r, seeds in enumerate(seed_sets):
            if not known[r]:
                logger.info("no seed of %d known; static fallback", len(seeds))
                out[r] = (self.static_recommendation(seeds), "fallback")
        if rows:
            length = max(len(known[r]) for r in rows)
            arr = np.full((len(rows), length), -1, dtype=np.int32)
            for n, r in enumerate(rows):
                arr[n, : len(known[r])] = known[r]
            top_ids, _ = recommend_batch(
                bundle.rule_ids, bundle.rule_confs,
                torch.as_tensor(arr, device=self.device),
                k_best=self.cfg.k_best_tracks,
            )
            host_ids = top_ids.cpu().numpy()
            for n, r in enumerate(rows):
                songs = [bundle.vocab[int(i)] for i in host_ids[n] if i >= 0]
                out[r] = (songs, "rules" if songs else "empty")
        return out  # type: ignore[return-value]

    def static_recommendation(self, seed_tracks: list[str]) -> list[str]:
        """Deterministic popular-tracks sample (reference:
        rest_api/app/main.py:205-222), keyed by a stable hash of the seeds."""
        best = self.best_tracks
        if not best:
            return []
        names = [b["track_name"] for b in best]
        k = min(self.cfg.k_best_tracks, len(names))
        return random.Random(stable_seed(seed_tracks)).sample(names, k)

    # ---------- background polling ----------

    def start_polling(self) -> threading.Thread:
        """First load + periodic staleness re-check, like the reference's
        lifespan + @repeat_every timer (rest_api/app/main.py:100-108)."""

        def loop() -> None:
            interval = max(self.cfg.polling_wait_in_minutes * 60.0, 0.05)
            while True:  # a failed load must not kill the poller
                try:
                    self.reload_if_required()
                except Exception:
                    logger.exception("reload failed; will retry next poll")
                time.sleep(interval)

        thread = threading.Thread(target=loop, daemon=True, name="kmls-reload-poller")
        thread.start()
        return thread
