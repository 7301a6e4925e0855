"""Serving state and lookups — counterpart of the reference
``kmlserver_tpu/serving/engine.py``: load the rule tensors from the PVC
onto every serving device, warm every (batch, length) bucket, hot-swap
them when the invalidation token changes, and answer seed sets through
``ops/serve.recommend_batch`` as a dispatch / finish pair the
micro-batcher pipelines.

Semantics are the reference's (rest_api/app/main.py:205-254): seeds are
filtered by rule-dict membership and cut to ``max_seed_tracks``; a request
with no known seed gets the deterministic popularity fallback; a request
whose known seeds all have empty rows gets an empty list.

On a card, :meth:`RecommendEngine.recommend_many_async` enqueues the whole
batch — the seed copy to the device, the lookup and the copy of the ids
back into pinned host memory — on the replica's current stream and records
a CUDA event after it; ``finish()`` waits on that event alone. A later
batch's kernels, enqueued behind it on the same stream, never delay it.
Fault tolerance is the reference's: before any bytes are trusted the
artifact set is checked against the mining job's manifest (a mismatched
npz falls back to the pickle, a mismatched pickle aborts the reload); a
failed reload keeps the last-good bundle serving without consuming the
invalidation token, backs off exponentially, and after
``quarantine_after_failures`` consecutive failures moves the files that
fail to parse into ``pickles/quarantine/``. Rule ids outside the
vocabulary are dropped on the host before any upload, as the reference's
XLA scatter drops them, so a crafted or stale npz cannot raise a
device-side assert that would poison the CUDA context.

Hybrid serving (the reference's second model family): when the PVC
carries an ``embeddings.npz`` (ALS item factors, ``mining/als.py``), every
replica also holds the factors, and a batch dispatches two lookups — the
rule max-merge and the embedding cosine top-k (``ops/embed.py``) — whose
per-request lists merge at finish per ``KMLS_HYBRID_MODE`` (``rules`` |
``embed`` | ``blend``, weight ``KMLS_HYBRID_BLEND_WEIGHT``). A seed unknown
to the rules but known to the embedding vocabulary is answered from the
embedding space instead of the popularity fallback. An absent, torn or
checksum-failing embedding artifact degrades to rules only; the reload
never fails for it.

Cost attribution (``observability/costmodel.py``, on unless
``KMLS_COSTMODEL=0``): each finished batch reports its dispatch → CUDA
event seconds and its bucket's shape as a ``serve_rules`` observation
(and the embedding lookup's as ``embed_topk``), each publication the
tensors' bytes and the allocator's watermark, and the unwarmed dispatches
of each lookup are watched as ``kmls_compiles_total``.

Continuous freshness (``KMLS_DELTA_ENABLED``): the poll also reads the
delta chain of the serving generation and applies each new
``delta-<seq>.bundle`` in place (:meth:`RecommendEngine.apply_pending_deltas`)
through ``freshness/delta.py``'s one application. The replicas are rebuilt
from the patched host tensors through the load path's own steps and warmed
before the swap; the epoch stays (the app's cache invalidates the touched
seeds only) unless a blend-mode hybrid bundle's ``n_playlists`` moved. A
torn, mis-bound or out-of-order bundle is rejected, and the base keeps
serving.

The native host kernel, the vocab-sharded layout and the serve mesh are not
part of this package.
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
from typing import Any, Callable

import numpy as np
import torch

from .. import faults
from ..config import ServingConfig
from ..io import artifacts, registry
from ..io.artifacts import ArtifactIntegrityError
from ..io.iohealth import MONITOR
from ..observability import costmodel as costmodel_mod
from ..ops.embed import embed_topk
from ..ops.serve import recommend_batch
from ..ops.support import min_count_for
from ..utils.device import resolve_device

logger = logging.getLogger("kmlserver_tpu_torch.serving")


def blend_candidates(
    rule_pairs: list[tuple[str, float]],
    emb_pairs: list[tuple[str, float]],
    weight: float,
    k_best: int,
) -> list[str]:
    """The hybrid blend merge: the union of both families' (name, score)
    candidates scored ``(1-w)·conf + w·sim``, ranked by (score desc, name
    asc) so every replica and epoch composes the same answer."""
    w = min(max(weight, 0.0), 1.0)
    scores: dict[str, float] = {}
    for name, conf in rule_pairs:
        scores[name] = (1.0 - w) * float(conf)
    for name, sim in emb_pairs:
        scores[name] = scores.get(name, 0.0) + w * float(sim)
    ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
    return [n for n, _ in ranked[:k_best]]


def stable_seed(seed_tracks: list[str]) -> int:
    """Process-independent replacement for the reference's salted
    ``hash(tuple(sorted(seed_tracks)))`` (rest_api/app/main.py:214)."""
    digest = hashlib.blake2b(
        "\x1f".join(sorted(seed_tracks)).encode("utf-8"), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big")


@dataclasses.dataclass
class RuleBundle:
    """One immutable generation of serving state on one device, swapped
    atomically. With several replicas, one bundle exists per device: the
    vocab/index/known-mask host state is shared across the set, the rule
    tensors live on each replica's own device."""

    vocab: list[str]
    index: dict[str, int]
    rule_ids: torch.Tensor  # int32 (V, K) on the serving device
    rule_confs: torch.Tensor  # float32 (V, K) on the serving device
    known_mask: np.ndarray  # host bool (V,) — rule-dict key membership
    model_token: str  # invalidation-token value when loaded
    device: torch.device = torch.device("cpu")
    # the publication counter the answer cache keys on
    epoch: int = 0
    # every (batch, length) seed shape run before publication — a dispatch
    # outside it is counted in unwarmed_dispatches
    warmed_shapes: set = dataclasses.field(default_factory=set)
    # ALS item factors, f32 (V_emb, rank) rows L2-normalized, on this
    # replica's device, with their own vocabulary (the full encode
    # vocabulary, broader than the pruned rule one; the hybrid merge is by
    # name). None = no embeddings: rules only
    emb_factors: torch.Tensor | None = None
    emb_vocab: list[str] | None = None
    emb_index: dict[str, int] | None = None
    # the (batch, length) shapes the embedding lookup ran before publication
    emb_warmed_shapes: set = dataclasses.field(default_factory=set)


def _host_rule_arrays(arrays: Mapping[str, Any]) -> tuple[list[str], np.ndarray, np.ndarray, np.ndarray]:
    """→ (vocab, known mask, int32 rule ids, float32 rule confs) from the
    dict either package's ``load_rule_tensors`` returns for a
    ``.tensors.npz`` (the key set is the frequent items), or
    ``vocab``/``rule_ids``/``rule_confs`` with an explicit ``known_mask``.

    Checked here, on the host, before any upload: the shapes must agree
    (``ValueError`` otherwise, so the load rolls back), and rule ids
    outside ``[0, V)`` become -1. That gives the reference's answers — its
    scatter sends an id equal to V into the spill slot and drops one past
    it — where the lookup's scatter would raise on such an id, on a card
    as a device-side assert."""
    vocab = list(arrays["vocab"])
    if "known_mask" in arrays:
        known = np.asarray(arrays["known_mask"], dtype=bool)
    else:
        known = np.asarray(arrays["item_counts"]) >= min_count_for(
            float(arrays["min_support"]), int(arrays["n_playlists"])
        )
    ids = np.ascontiguousarray(arrays["rule_ids"], dtype=np.int32)
    confs = np.ascontiguousarray(arrays["rule_confs"], dtype=np.float32)
    if ids.ndim != 2 or confs.shape != ids.shape:
        raise ValueError(f"rule_ids {ids.shape} and rule_confs {confs.shape} disagree")
    if not len(vocab) == len(known) == ids.shape[0]:
        raise ValueError(
            f"{len(vocab)} vocabulary entries, {len(known)} known flags and "
            f"{ids.shape[0]} rule rows disagree"
        )
    outside = ids >= len(vocab)
    if outside.any():
        logger.warning(
            "%d rule ids outside [0, %d) dropped", int(outside.sum()), len(vocab)
        )
        ids = np.where(outside, np.int32(-1), ids)
    return vocab, known, ids, confs


def bundle_from_arrays(
    arrays: Mapping[str, Any],
    *,
    token: str = "",
    device: str | torch.device = "cuda",
) -> RuleBundle:
    """Carry rule tensors onto ``device`` as a serving bundle (see
    :func:`_host_rule_arrays` for the accepted dicts)."""
    dev = resolve_device(device)
    vocab, known, ids, confs = _host_rule_arrays(arrays)
    return RuleBundle(
        vocab=vocab, index={n: i for i, n in enumerate(vocab)},
        rule_ids=torch.as_tensor(ids, device=dev),
        rule_confs=torch.as_tensor(confs, device=dev),
        known_mask=known, model_token=token, device=dev,
    )


class RecommendEngine:
    """Holds serving state and executes lookups on ``device`` (default
    ``cuda``: every card, or ``serve_devices`` of them; raises when no card
    is present). Thread-safe: the replica set and best-tracks references
    are replaced atomically; readers never block."""

    def __init__(self, cfg: ServingConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bundle: RuleBundle | None = None
        # the full replica set (one bundle per serving device); `bundle`
        # stays the primary replica for single-device callers
        self.replicas: list[RuleBundle] = []
        # monotonic publication counter — the answer cache's key prefix.
        # 0 = nothing published yet.
        self.bundle_epoch = 0
        # cumulative per-replica dispatch counters (they survive hot swaps)
        self.dispatch_counts: list[int] = []
        self._dispatch_lock = threading.Lock()
        self.best_tracks: list[dict] | None = None
        self.cache_value: str | None = None  # the reference's app.cache_value
        self.finished_loading = False
        self.reload_counter = 0
        # dispatches whose (batch, length) shape was never warmed, of either
        # lookup (the embedding lookup's also counted on their own); stays
        # 0 unless a caller passes more rows than batch_max_size
        self.unwarmed_dispatches = 0
        self.unwarmed_embed_dispatches = 0
        # per-kernel cost attribution; None with KMLS_COSTMODEL=0, making
        # every call site one attribute check
        self.cost_model = (
            costmodel_mod.CostModel(device=self.device) if cfg.costmodel_enabled else None
        )
        # the first-shape probes the cost model watches: stable callables,
        # since the watcher re-baselines on a new one
        self._unwarmed_rules_probe = (
            lambda: self.unwarmed_dispatches - self.unwarmed_embed_dispatches
        )
        self._unwarmed_embed_probe = lambda: self.unwarmed_embed_dispatches
        # embedding-artifact failures are survivable (the bundle publishes
        # rules-only), so they have counters of their own; degraded = the
        # last publication wanted embeddings but serves rules only
        self.embedding_load_failures = 0
        self.last_embedding_error: str | None = None
        self.embedding_degraded = False
        # the blend optimum read from quality.report.json at load
        # (KMLS_HYBRID_BLEND_WEIGHT=measured), committed with the bundle
        self.measured_blend_weight: float | None = None
        # per-artifact publication stamps (wall clock), for /readyz and
        # kmls_artifact_age_seconds; empty before the first load
        self._artifact_written_at: dict[str, float] = {}
        self._reload_lock = threading.Lock()
        # failed reloads: each one KEPT the last-good bundle serving (the
        # rollback counter); consecutive ones drive the retry backoff and
        # the quarantine strikes
        self.reload_failures = 0
        self.consecutive_reload_failures = 0
        self.artifact_quarantines = 0
        self.last_load_error: str | None = None
        # monotonic deadline before which reload_if_required() won't retry
        # a failed load (direct load() calls always go through)
        self._backoff_until = 0.0
        # continuous freshness: the chain position applied on top of the
        # base generation (the serving epoch is the pair (bundle_epoch,
        # delta_seq); a full load resets it to 0)
        self.delta_seq = 0
        self.delta_applied_total = 0
        self.delta_rejected_total = 0
        self.last_delta_error: str | None = None
        # bundles in the serving generation's chain file, applied or not
        # (the compaction trigger's gauge)
        self.delta_chain_length = 0
        # called as fn(touched_names, wholesale) after a delta swap commits
        self.delta_listeners: list[Callable[[set, bool], None]] = []
        # the logical tensors deltas patch (the npz load's counts); None
        # when the bundle came from the pickle or carries merged float64
        # confidences — such a generation serves with deltas off
        self._host_state: dict | None = None
        # sha256 of the npz the host state came from: a bundle's
        # base_npz_sha256 must match it
        self._base_npz_sha: str | None = None
        # wall-clock publication stamp of the newest applied generation
        # (base manifest or chain entry): the freshness lag
        self._applied_written_at = 0.0
        # rejection backoff of the polling path (direct applies go through)
        self._delta_backoff_until = 0.0
        # seconds of the last apply: read, patch, upload, warm-up, swap
        self.last_delta_apply_s = 0.0
        # the free-space gauge follows the artifact volume, and every read
        # below feeds the latency EWMAs behind the storage-slow conviction
        MONITOR.watch_disk(cfg.pickles_dir)

    # ---------- artifact loading / hot swap ----------

    def _token_path(self) -> str:
        return registry.token_path_for(self.cfg.base_dir, self.cfg.data_invalidation_file)

    def _read_deadline(self) -> float | None:
        """Deadline for reload-path artifact reads (None = unbounded)."""
        return self.cfg.io_read_deadline_s or None

    def _read_token(self) -> str | None:
        try:
            return artifacts.read_text(self._token_path(), op="token_poll")
        except FileNotFoundError:
            return None
        except OSError as exc:
            # a transient EIO or stall on the poll must not flip
            # is_data_stale (one flaky read would churn reloads): report
            # the cached token and let the next poll retry
            logger.warning("token poll failed (%s); keeping cached token", exc)
            return self.cache_value

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
        """Build a fresh replica set from the PVC, run every seed bucket on
        every replica, and swap it in. Returns False (fail-soft, last-good
        bundle kept, token not consumed) when the artifacts are absent,
        fail their manifest or do not load."""
        with self._reload_lock:
            if self.finished_loading and not self.is_data_stale():
                return True
            if self.cost_model is not None:
                # a publication starts: bank the unwarmed dispatches served
                # so far, so its warm-up is never billed as serving-path
                self.cost_model.note_prepublish()
            cfg = self.cfg
            best_path = os.path.join(cfg.pickles_dir, cfg.best_tracks_file)
            rec_path = os.path.join(cfg.pickles_dir, cfg.recommendations_file)
            npz_path = artifacts.tensor_artifact_path(rec_path)
            try:
                # KMLS_FAULT_RELOAD_FAIL / faults.inject("engine.load") fails
                # the reload like a torn artifact: same rollback and backoff
                faults.fire("engine.load")
                token = self._read_token() or ""
                use_npz, use_emb = self._verify_before_load(best_path, rec_path, npz_path)
                best = artifacts.load_pickle(best_path, deadline_s=self._read_deadline())
                replicas, host_state, npz_sha = self._build_replicas(
                    rec_path, npz_path, token, use_npz=use_npz
                )
                # the second model family, fail-soft: a bad embeddings.npz
                # costs the embedding path, never the reload. Its status
                # stays local until the swap commits below
                emb_degraded, emb_error = self._attach_embeddings(replicas, use_emb=use_emb)
                # every bucket on every replica BEFORE publishing: a shape's
                # first launch grows the caching allocators and the sort's
                # scratch space, and must not land inside a request
                for bundle in replicas:
                    self._warmup(bundle)
            except FileNotFoundError as exc:
                logger.warning("artifacts not ready: %s", exc)
                return False
            except Exception as exc:
                # corrupt or torn artifacts: keep the current bundle, back
                # off, quarantine persistent offenders. cache_value moves
                # only on success, so every retry still sees the staleness
                logger.exception("artifact load failed; keeping current bundle")
                self._note_reload_failure(exc, best_path, rec_path, npz_path)
                return False
            # ordering contract for the epoch-keyed cache: the bundle
            # references land BEFORE the epoch bump, so an answer stored
            # under the new epoch can only come from the new rules
            epoch = self.bundle_epoch + 1
            for bundle in replicas:
                bundle.epoch = epoch
            self.best_tracks = best
            self.replicas = replicas
            self.bundle = replicas[0]
            self.bundle_epoch = epoch
            with self._dispatch_lock:
                while len(self.dispatch_counts) < len(replicas):
                    self.dispatch_counts.append(0)
            self.cache_value = replicas[0].model_token or self.cache_value
            # a full load starts the chain over at seq 0; a pending chain of
            # this generation applies right after (reload_if_required)
            self.delta_seq = 0
            self._host_state = host_state
            self._base_npz_sha = npz_sha
            self._delta_backoff_until = 0.0
            self.delta_chain_length = 0
            if cfg.delta_enabled:
                chain = artifacts.read_delta_state(cfg.pickles_dir)
                if chain is not None and chain.get("base_token") == self.cache_value:
                    self.delta_chain_length = len(chain.get("entries", ()))
            manifest = artifacts.load_manifest(cfg.pickles_dir, deadline_s=self._read_deadline())
            if manifest is not None and manifest.get("token") == self.cache_value:
                rules_at = float(manifest.get("written_at") or time.time())
            else:
                rules_at = time.time()
            self._applied_written_at = rules_at
            self._artifact_written_at = {
                "rules": rules_at,
                "popularity": self._file_written_at(best_path, rules_at),
            }
            if replicas[0].emb_factors is not None:
                self._artifact_written_at["embeddings"] = self._file_written_at(
                    artifacts.embeddings_artifact_path(cfg.pickles_dir), rules_at
                )
            self.measured_blend_weight = self._read_measured_blend_weight()
            # the embedding status commits with the bundle it describes
            self.embedding_degraded = emb_degraded
            self.last_embedding_error = emb_error
            if emb_degraded:
                self.embedding_load_failures += 1
            if self.cost_model is not None:
                self._note_publish_cost(replicas)
            self.finished_loading = True
            self.reload_counter += 1
            self.consecutive_reload_failures = 0
            self.last_load_error = None
            self._backoff_until = 0.0
            logger.info(
                "reload #%d complete (epoch %d): %d tracks, %d rule keys, "
                "%d replica(s) on %s, embeddings %s, token %r",
                self.reload_counter, epoch, len(replicas[0].vocab),
                int(replicas[0].known_mask.sum()), len(replicas),
                ", ".join(str(b.device) for b in replicas),
                (f"on ({len(replicas[0].emb_vocab)} tracks)"
                 if replicas[0].emb_factors is not None else "off"),
                replicas[0].model_token,
            )
            return True

    def _note_publish_cost(self, replicas: list[RuleBundle]) -> None:
        """Publish-time cost-model bookkeeping (caller holds
        ``_reload_lock``): the rule tensors' bytes against the budget, the
        allocator's bytes-in-use watermark, and the first-shape snapshot,
        taken after warm-up so later growth is a serving-path dispatch."""
        cm = self.cost_model
        bundle = replicas[0]
        tensor_bytes = {
            "rule_ids": int(bundle.rule_ids.nbytes), "rule_confs": int(bundle.rule_confs.nbytes),
        }
        if bundle.emb_factors is not None:
            tensor_bytes["embeddings"] = int(bundle.emb_factors.nbytes)
        cm.note_publish(
            tensor_bytes,
            self.cfg.device_budget_bytes,
            watermark_bytes=costmodel_mod.device_watermark_bytes(bundle.device),
        )
        cm.watch_compiles("serve_rules", self._unwarmed_rules_probe)
        if bundle.emb_factors is not None:
            cm.watch_compiles("embed_topk", self._unwarmed_embed_probe)
        cm.mark_published()

    def _verify_before_load(
        self, best_path: str, rec_path: str, npz_path: str
    ) -> tuple[bool, bool]:
        """Check the artifact set against the mining job's manifest before
        any bytes are trusted. A mismatched best-tracks or recommendations
        pickle aborts the reload (raise → last-good keeps serving); a
        mismatched npz only turns off the tensor fast path for this reload,
        since the pickle carries the same generation, and a mismatched
        embeddings.npz only turns off the embedding path. The current token
        gates the check: a manifest stamped for another generation steps
        aside. → (use_npz, use_emb)."""
        if not self.cfg.verify_manifest:
            return True, True
        emb_path = artifacts.embeddings_artifact_path(self.cfg.pickles_dir)
        bad = artifacts.verify_files(
            self.cfg.pickles_dir,
            [os.path.basename(p) for p in (best_path, rec_path, npz_path, emb_path)],
            token=self._read_token(),
        )
        use_npz = npz_path not in bad
        if not use_npz:
            logger.warning(
                "tensor artifact %s fails its manifest checksum; falling back "
                "to the pickle", npz_path,
            )
            bad.remove(npz_path)
        use_emb = emb_path not in bad
        if not use_emb:
            logger.warning(
                "embedding artifact %s fails its manifest checksum; serving "
                "rules-only this generation", emb_path,
            )
            bad.remove(emb_path)
        if bad:
            raise ArtifactIntegrityError(f"artifact checksum mismatch vs manifest: {bad}", bad)
        return use_npz, use_emb

    def _attach_embeddings(
        self, replicas: list[RuleBundle], use_emb: bool = True
    ) -> tuple[bool, str | None]:
        """Load ``embeddings.npz`` if published and put the item factors on
        every replica's device. Never raises: a bad second-model artifact
        degrades to rules-only serving. Fires the ``embed.artifact`` chaos
        site. → ``(degraded, error)`` for the caller to commit with the
        swap."""
        if self.cfg.hybrid_mode == "rules":
            return False, None  # pinned rules-only: the file is not read
        emb_path = artifacts.embeddings_artifact_path(self.cfg.pickles_dir)
        if not os.path.exists(emb_path):
            return False, None  # no second model published: not degraded
        try:
            if not use_emb:
                raise ArtifactIntegrityError(f"{emb_path} fails its manifest checksum", [emb_path])
            faults.fire("embed.artifact")
            loaded = artifacts.load_embeddings(emb_path, deadline_s=self._read_deadline())
        except FileNotFoundError:
            # raced a writer retiring it (an embed-disabled publication
            # removes it before the token rewrite): absent, not corrupt
            logger.info(
                "embedding artifact %s vanished mid-load (retired by the "
                "miner); serving rules-only", emb_path,
            )
            return False, None
        except Exception as exc:
            logger.exception("embedding artifact %s unusable; serving rules-only", emb_path)
            return True, f"{type(exc).__name__}: {exc}"
        emb_vocab = loaded["vocab"]
        emb_index = {n: i for i, n in enumerate(emb_vocab)}
        for bundle in replicas:
            bundle.emb_vocab = emb_vocab
            bundle.emb_index = emb_index
            bundle.emb_factors = torch.as_tensor(loaded["item_factors"], device=bundle.device)
        return False, None

    def _note_reload_failure(
        self, exc: Exception, best_path: str, rec_path: str, npz_path: str
    ) -> None:
        """Failed-reload bookkeeping (caller holds ``_reload_lock``): count
        the rollback, arm the exponential retry backoff, and once the same
        set has failed ``quarantine_after_failures`` consecutive reloads,
        quarantine the files that are actually corrupt."""
        self.reload_failures += 1
        self.consecutive_reload_failures += 1
        self.last_load_error = f"{type(exc).__name__}: {exc}"
        backoff = min(
            self.cfg.reload_backoff_base_s * (2 ** (self.consecutive_reload_failures - 1)),
            self.cfg.reload_backoff_max_s,
        )
        self._backoff_until = time.monotonic() + backoff
        logger.warning(
            "reload failure #%d (consecutive); retrying in %.1fs",
            self.consecutive_reload_failures, backoff,
        )
        threshold = self.cfg.quarantine_after_failures
        if threshold > 0 and self.consecutive_reload_failures >= threshold:
            self._quarantine_corrupt_artifacts(best_path, rec_path, npz_path)

    def _quarantine_corrupt_artifacts(self, best_path: str, rec_path: str, npz_path: str) -> None:
        """Move persistently corrupt artifacts into ``pickles/quarantine/``.
        Only a PARSE failure condemns a file, never a manifest mismatch
        alone (two polls inside one slow publication see new bytes under
        the old manifest), and never a probe that timed out."""
        probes = (
            (best_path, artifacts.load_pickle),
            (rec_path, artifacts.load_pickle),
            (npz_path, artifacts.load_rule_tensors),
        )
        for path, probe in probes:
            if not os.path.exists(path):
                continue
            try:
                probe(path, deadline_s=self._read_deadline())
                continue  # parses fine: never quarantine on suspicion
            except (FileNotFoundError, artifacts.IoStallError):
                continue
            except Exception:
                pass
            dest = artifacts.quarantine_file(path)
            if dest is not None:
                self.artifact_quarantines += 1
                logger.warning("quarantined corrupt artifact %s -> %s", path, dest)

    def _build_replicas(
        self, rec_path: str, npz_path: str, token: str, use_npz: bool = True
    ) -> tuple[list[RuleBundle], dict | None, str | None]:
        """Load the rule tensors once (the npz twin when present and
        verified — counts → float64 → float32 confs — else the reference
        pickle dict), then copy them onto every serving device. → (the
        replica set, the candidate host state a delta can patch, the npz's
        sha256), the last two committed with the swap; both None unless
        deltas are on and the npz carries plain counts (no pickle, no
        merged ``rule_confs64``, which a patch cannot re-derive)."""
        arrays = None
        if self.cfg.prefer_tensor_artifact and use_npz and os.path.exists(npz_path):
            try:
                arrays = artifacts.load_rule_tensors(npz_path, deadline_s=self._read_deadline())
            except artifacts.IoStallError:
                # a hung read is not a torn artifact: fail the reload rather
                # than fall back to an equally hung pickle read
                raise
            except Exception:
                # a torn npz beside a possibly intact pickle of the same
                # generation: fall through to the pickle
                logger.exception("tensor artifact %s unreadable; trying the pickle", npz_path)
        if arrays is None:
            rules_dict = artifacts.load_pickle(rec_path, deadline_s=self._read_deadline())
            vocab = sorted(set(rules_dict) | {o for row in rules_dict.values() for o in row})
            rule_ids, rule_confs, known = artifacts.tensors_from_rules_dict(
                rules_dict, vocab,
                k_max=max((len(r) for r in rules_dict.values()), default=1),
            )
            arrays = {"vocab": vocab, "rule_ids": rule_ids, "rule_confs": rule_confs,
                      "known_mask": known}
        host_state = npz_sha = None
        if self.cfg.delta_enabled and "rule_counts" in arrays and arrays.get("rule_confs64") is None:
            host_state = {
                "vocab": list(arrays["vocab"]),
                "rule_ids": np.asarray(arrays["rule_ids"], dtype=np.int32),
                "rule_counts": np.asarray(arrays["rule_counts"], dtype=np.int32),
                "item_counts": np.asarray(arrays["item_counts"], dtype=np.int32),
                "n_playlists": int(arrays["n_playlists"]),
                "min_support": float(arrays["min_support"]),
                "mode": str(arrays["mode"]),
                "min_confidence": float(arrays["min_confidence"]),
            }
            npz_sha = artifacts.file_digest(npz_path)["sha256"]
        return self._replicas_from_arrays(arrays, token), host_state, npz_sha

    def _replicas_from_arrays(self, arrays: Mapping[str, Any], token: str) -> list[RuleBundle]:
        """Host rule arrays (:func:`_host_rule_arrays`' dicts) → one bundle
        per serving device — the one upload path a load and a delta apply
        share, the out-of-range id mapping included."""
        vocab, known, ids, confs = _host_rule_arrays(arrays)
        index = {n: i for i, n in enumerate(vocab)}
        return [
            RuleBundle(
                vocab=vocab, index=index,
                rule_ids=torch.as_tensor(ids, device=dev),
                rule_confs=torch.as_tensor(confs, device=dev),
                known_mask=known, model_token=token, device=dev,
            )
            for dev in self._serve_devices()
        ]

    def _serve_devices(self) -> list[torch.device]:
        """The devices the replica set spans. On ``cuda``: every card
        (``serve_devices == 0``) or the first ``serve_devices`` of them; a
        device with an explicit index pins that one card. On the CPU: one
        replica, or ``serve_devices`` copies on the host (the reference's
        virtual-device replicas, for exercising the replica lanes)."""
        n = self.cfg.serve_devices
        if self.device.type != "cuda":
            return [self.device] * max(1, n)
        if self.device.index is not None:
            return [self.device]
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return devs[: min(n, len(devs))] if n > 0 else devs

    @property
    def n_replicas(self) -> int:
        """Serving replicas currently published (1 before the first load —
        the batcher's least-loaded dispatcher sizes its lanes off this)."""
        return max(1, len(self.replicas))

    def _note_dispatch(self, idx: int) -> None:
        with self._dispatch_lock:
            while len(self.dispatch_counts) <= idx:
                self.dispatch_counts.append(0)
            self.dispatch_counts[idx] += 1

    def _warmup(self, bundle: RuleBundle) -> None:
        """Run EVERY (batch-bucket, length-bucket) shape through the
        dispatch path on ``bundle`` before it publishes, the copies and
        the pinned host buffers included — the rule lookup, and the
        embedding lookup when factors are attached."""
        for length in self._len_buckets():
            for batch in self._batch_buckets():
                shape = (batch, length)
                if bundle.vocab:  # an empty rule vocabulary knows no seed
                    self._launch(bundle, self._staging(shape, bundle.device))()
                    bundle.warmed_shapes.add(shape)
                if bundle.emb_factors is not None:
                    self._launch_embed(bundle, self._staging(shape, bundle.device))()
                    bundle.emb_warmed_shapes.add(shape)

    def _read_measured_blend_weight(self) -> float | None:
        """The published blend optimum (``quality.report.json``) under
        ``KMLS_HYBRID_BLEND_WEIGHT=measured``, else None. Fail-soft: no
        report, or one without a usable weight, serves the configured
        weight with a warning."""
        if not self.cfg.hybrid_blend_measured:
            return None
        report = artifacts.load_quality_report(self.cfg.pickles_dir)
        weight = report.get("measured_blend_weight") if report else None
        if isinstance(weight, (int, float)) and 0.0 <= float(weight) <= 1.0:
            return float(weight)
        logger.warning(
            "KMLS_HYBRID_BLEND_WEIGHT=measured but no usable quality.report.json "
            "on the PVC (report %s); serving the default weight %.2f",
            "absent" if report is None else "carries no measured weight",
            self.cfg.hybrid_blend_weight,
        )
        return None

    @property
    def blend_weight(self) -> float:
        """The effective blend weight: the measured optimum when one was
        published under ``measured``, else the configured float."""
        if self.measured_blend_weight is not None:
            return self.measured_blend_weight
        return self.cfg.hybrid_blend_weight

    @property
    def embedding_active(self) -> bool:
        """True when the published bundle carries item factors (the hybrid
        merge is live)."""
        bundle = self.bundle
        return bundle is not None and bundle.emb_factors is not None

    @staticmethod
    def _file_written_at(path: str, fallback: float) -> float:
        """Best-effort artifact publication stamp: the file's mtime, or
        the generation's manifest stamp when the file can't answer."""
        try:
            return os.path.getmtime(path)
        except OSError:
            return fallback

    def artifact_ages(self) -> dict[str, float]:
        """Seconds since publication of every artifact the server answers
        from. ``delta-chain`` is the newest applied generation's age (base
        or delta): with no delta applied it equals ``rules``, and an apply
        shrinks it. Empty before the first load."""
        if not self._artifact_written_at:
            return {}
        now = time.time()
        out = {
            name: max(now - stamp, 0.0)
            for name, stamp in self._artifact_written_at.items()
        }
        out["delta-chain"] = self.freshness_lag_s()
        return out

    def reload_if_required(self) -> None:
        """Reload when stale or never fully loaded
        (reference: rest_api/app/main.py:110-114). After a failed reload
        this retries on the backoff ladder instead of every poll; the
        staleness signal survives (is_data_stale is pure), so the retry
        always comes. With deltas on, a load is followed by the pending
        chain, and a generation that is not stale checks its chain (a
        rejection backs off on its own deadline)."""
        if time.monotonic() < self._backoff_until:
            return
        if self.is_data_stale() or not self.finished_loading:
            if self.load():
                self.apply_pending_deltas()
        elif self.cfg.delta_enabled and time.monotonic() >= self._delta_backoff_until:
            self.apply_pending_deltas()

    # ---------- continuous freshness: in-place delta application ----------

    def freshness_lag_s(self) -> float:
        """Seconds since the newest applied generation (base publication or
        chain entry) was published; 0.0 before the first load."""
        if not self._applied_written_at:
            return 0.0
        return max(time.time() - self._applied_written_at, 0.0)

    def _note_delta_rejection(self, seq: int, message: str) -> None:
        self.delta_rejected_total += 1
        self.last_delta_error = message
        self._delta_backoff_until = time.monotonic() + self.cfg.reload_backoff_base_s
        logger.warning(
            "delta bundle %d REJECTED (%s); base generation keeps serving, "
            "retry after %.1fs", seq, message, self.cfg.reload_backoff_base_s,
        )

    def apply_pending_deltas(self) -> int:
        """Apply every bundle of the serving generation's chain newer than
        ``delta_seq``, in place → bundles applied.

        Each apply patches the host tensors (``apply_delta_to_tensors``),
        rebuilds the replicas through the load's upload path, carries the
        embedding factors over, warms every bucket on the new replicas and
        then swaps the references — so requests in flight finish on the
        bundle they started with (their ``finish()`` holds it until the
        batch's CUDA event) and an apply adds no ``kmls_compiles_total``.
        The epoch stays: the listeners invalidate the touched seeds only,
        except for a blend-mode hybrid bundle whose ``n_playlists`` moved
        (every blended ranking shifts), whose epoch is bumped. A chain gap,
        a bundle bound to another token or npz, torn bytes or the
        ``delta.apply`` fault reject the bundle: the current state keeps
        serving and the poll backs off."""
        if not self.cfg.delta_enabled or not self.finished_loading:
            return 0
        state = artifacts.read_delta_state(self.cfg.pickles_dir)
        if state is None:
            return 0
        from ..freshness import delta as delta_mod

        applied = 0
        with self._reload_lock:
            if state.get("base_token") != self.cache_value:
                return 0  # a chain of another generation: inert here
            self.delta_chain_length = len(state.get("entries", ()))
            pending = [
                e for e in sorted(state.get("entries", []), key=lambda e: e.get("seq", 0))
                if e.get("seq", 0) > self.delta_seq
            ]
            if not pending:
                return 0
            if self._host_state is None:
                logger.warning(
                    "delta chain present but this bundle has no patchable host "
                    "tensors (pickle-only load or merged-confidence artifact); "
                    "serving the base generation"
                )
                return 0
            if self.cost_model is not None:
                # as in load(): the re-warm below is publication, not serving
                self.cost_model.note_prepublish()
            for entry in pending:
                seq = int(entry.get("seq", 0))
                if seq != self.delta_seq + 1:
                    self._note_delta_rejection(seq, f"chain gap: expected seq {self.delta_seq + 1}")
                    break
                path = os.path.join(self.cfg.pickles_dir, str(entry.get("file", "")))
                t_apply = time.perf_counter()
                try:
                    # KMLS_FAULT_DELTA_CORRUPT rejects here
                    faults.fire("delta.apply")
                    bundle = artifacts.load_delta_bundle(path, expect_sha256=entry.get("sha256"))
                    if bundle["base_token"] != self.cache_value:
                        raise ValueError("bundle base token != serving generation")
                    if self._base_npz_sha is not None and (
                        bundle["base_npz_sha256"] != self._base_npz_sha
                    ):
                        raise ValueError("bundle bound to different base artifact bytes")
                    patched = delta_mod.apply_delta_to_tensors(self._host_state, bundle)
                    vocab, rule_ids, rule_confs, known = delta_mod.derive_serving_arrays(patched)
                    old_replicas = self.replicas
                    replicas = self._replicas_from_arrays(
                        {"vocab": vocab, "rule_ids": rule_ids, "rule_confs": rule_confs,
                         "known_mask": known},
                        self.cache_value or "",
                    )
                    # the second model family rides along: its factors are
                    # on each device already and their shapes stay warmed
                    for nb, src in zip(replicas, old_replicas):
                        nb.emb_factors = src.emb_factors
                        nb.emb_vocab = src.emb_vocab
                        nb.emb_index = src.emb_index
                        nb.emb_warmed_shapes = src.emb_warmed_shapes
                    for nb in replicas:
                        self._warmup(nb)
                except Exception as exc:
                    self._note_delta_rejection(seq, f"{type(exc).__name__}: {exc}")
                    break
                wholesale = (
                    self.cfg.hybrid_mode == "blend"
                    and any(r.emb_factors is not None for r in replicas)
                    and patched["n_playlists"] != self._host_state["n_playlists"]
                )
                epoch = self.bundle_epoch + (1 if wholesale else 0)
                for nb in replicas:
                    nb.epoch = epoch
                # the replica references land BEFORE the invalidation signal
                # (the epoch bump or the listeners), so an answer cached
                # under a post-invalidation key comes from the patched rules
                self.replicas = replicas
                self.bundle = replicas[0]
                if wholesale:
                    self.bundle_epoch = epoch
                self._host_state = patched
                self.delta_seq = seq
                self.delta_applied_total += 1
                self.last_delta_error = None
                self._applied_written_at = float(entry.get("written_at") or time.time())
                self.last_delta_apply_s = time.perf_counter() - t_apply
                if self.cost_model is not None:
                    self._note_publish_cost(replicas)
                applied += 1
                touched = delta_mod.touched_names(bundle)
                logger.info(
                    "delta %d applied in place (epoch %d/%d) in %.3f ms: %d changed "
                    "rows, %d tombstones, %d touched names%s",
                    seq, self.bundle_epoch, self.delta_seq, 1e3 * self.last_delta_apply_s,
                    len(bundle["changed_rows"]),
                    len(bundle["tombstones"]), len(touched),
                    " [wholesale invalidation]" if wholesale else "",
                )
                for fn in list(self.delta_listeners):
                    try:
                        fn(touched, wholesale)
                    except Exception:
                        logger.exception("delta listener failed")
        return applied

    # ---------- lookups ----------

    def _len_buckets(self) -> list[int]:
        """Coarse seed-length buckets; the cap itself is always a member."""
        cap = self.cfg.max_seed_tracks
        return sorted({min(b, cap) for b in (1, 8, 32, 128)} | {cap})

    def _bucket_len(self, n: int) -> int:
        buckets = self._len_buckets()
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def _batch_buckets(self) -> list[int]:
        """Power-of-two batch buckets 1, 2, 4, …, up to (and always
        including) ``batch_max_size`` — the full set the warmup runs."""
        cap = max(self.cfg.batch_max_size, 1)
        buckets = []
        b = 1
        while b < cap:
            buckets.append(b)
            b *= 2
        buckets.append(cap)
        return buckets

    def _bucket_batch(self, n: int) -> int:
        """Smallest warmed batch bucket holding ``n`` rows; oversized
        batches (direct ``recommend_many`` calls only — the micro-batcher
        caps at ``batch_max_size``) round up to a multiple of the cap."""
        cap = max(self.cfg.batch_max_size, 1)
        if n > cap:
            return ((n + cap - 1) // cap) * cap
        for b in self._batch_buckets():
            if n <= b:
                return b
        return cap

    @staticmethod
    def _fill_seed_rows(
        bundle: RuleBundle, seed_sets: list[list[str]],
        arr: np.ndarray, length: int,
    ) -> np.ndarray:
        """Membership-filter each seed set into its -1-padded row of
        ``arr`` → per-row any-known-seed mask (a copy, not a view)."""
        for r, seeds in enumerate(seed_sets):
            ids = [
                bundle.index[s]
                for s in seeds
                if s in bundle.index and bundle.known_mask[bundle.index[s]]
            ][:length]
            arr[r, : len(ids)] = ids
        return (arr[: len(seed_sets)] >= 0).any(axis=1)

    @staticmethod
    def _staging(shape: tuple[int, int], device: torch.device) -> torch.Tensor:
        """A fresh -1-filled int32 host tensor for one dispatch's seeds,
        pinned when the copy goes to a card. Fresh per dispatch: the
        non-blocking copy may still be reading it when the next batch is
        staged, and the dispatch keeps it alive until its finish()."""
        return torch.full(shape, -1, dtype=torch.int32, pin_memory=device.type == "cuda")

    def _stage_seeds(
        self, bundle: RuleBundle, seed_sets: list[list[str]],
        rows: int, length: int,
    ) -> tuple[torch.Tensor, np.ndarray]:
        """Fill the padded (rows, length) host seed tensor → (host seed
        tensor, per-row any-known-seed mask)."""
        shape = (rows, length)
        seeds = self._staging(shape, bundle.device)
        known_rows = self._fill_seed_rows(bundle, seed_sets, seeds.numpy(), length)
        if shape not in bundle.warmed_shapes:
            self.unwarmed_dispatches += 1
            logger.warning(
                "unwarmed seed shape %s dispatched; warmed buckets: batches "
                "%s x lengths %s", shape, self._batch_buckets(), self._len_buckets(),
            )
        return seeds, known_rows

    @staticmethod
    def _enqueue(
        lookup: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
        seeds: torch.Tensor, dev: torch.device,
    ) -> Callable[[], tuple[np.ndarray, np.ndarray]]:
        """Start ``lookup`` on the host ``seeds`` on ``dev`` → ``wait()``,
        which returns the (rows, k_best) host ids and scores.

        On a card the seed copy, the lookup and the copies of its two
        outputs into pinned host tensors are enqueued on the device's
        current stream with a CUDA event after them, and ``wait()``
        synchronizes on that event only (releasing the GIL). On the CPU the
        lookup runs inside ``wait()``, so a dispatch never computes on the
        caller's thread."""
        if dev.type != "cuda":
            def wait_cpu() -> tuple[np.ndarray, np.ndarray]:
                ids, scores = lookup(seeds)
                return ids.numpy(), scores.numpy()

            return wait_cpu
        with torch.cuda.device(dev):
            seeds_dev = seeds.to(dev, non_blocking=True)
            outs = lookup(seeds_dev)
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs]
            for h, t in zip(host, outs):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()

        # _staged keeps the fresh pinned seed tensor alive until the copy
        # that reads it has provably finished
        def wait_cuda(_staged: torch.Tensor = seeds) -> tuple[np.ndarray, np.ndarray]:
            done.synchronize()
            return host[0].numpy(), host[1].numpy()

        return wait_cuda

    def _launch(self, bundle: RuleBundle, seeds: torch.Tensor):
        """The rule lookup of ``seeds`` on ``bundle`` → ``wait()`` for the
        host (ids, confidences)."""
        k_best = self.cfg.k_best_tracks
        return self._enqueue(
            lambda s: recommend_batch(bundle.rule_ids, bundle.rule_confs, s, k_best=k_best),
            seeds, bundle.device,
        )

    def _launch_embed(self, bundle: RuleBundle, seeds: torch.Tensor):
        """The embedding lookup of ``seeds`` (embedding ids) on ``bundle``
        → ``wait()`` for the host (ids, similarities)."""
        k_best = self.cfg.k_best_tracks
        return self._enqueue(
            lambda s: embed_topk(bundle.emb_factors, s, k_best=k_best), seeds, bundle.device,
        )

    def _dispatch_embed(
        self, bundle: RuleBundle, seed_sets: list[list[str]], n_rows: int, length: int,
    ) -> tuple[Callable[[], tuple[np.ndarray, np.ndarray]], np.ndarray] | None:
        """Stage and enqueue the embedding lookup for a batch → ``(wait,
        per-row embed-known mask)``, or None when the bundle has no
        factors, the mode is ``rules``, or no row has a seed the embedding
        vocabulary knows (the full-vocabulary product would be thrown away).
        Its seeds go into a fresh pinned tensor of their own, kept alive
        until the lookup's CUDA event."""
        if bundle.emb_factors is None or self.cfg.hybrid_mode == "rules":
            return None
        shape = (n_rows, length)
        seeds = self._staging(shape, bundle.device)
        arr = seeds.numpy()
        known = np.zeros(len(seed_sets), dtype=bool)
        index = bundle.emb_index or {}
        for r, names in enumerate(seed_sets):
            ids = [index[s] for s in names if s in index][:length]
            arr[r, : len(ids)] = ids
            known[r] = len(ids) > 0
        if not known.any():
            return None
        if shape not in bundle.emb_warmed_shapes:
            self.unwarmed_dispatches += 1
            self.unwarmed_embed_dispatches += 1
            logger.warning(
                "unwarmed embedding seed shape %s dispatched; warmed buckets: "
                "batches %s x lengths %s", shape, self._batch_buckets(), self._len_buckets(),
            )
        return self._launch_embed(bundle, seeds), known

    def _compose_answer(
        self, bundle: RuleBundle, seeds: list[str], rule_known: bool,
        ids_row, confs_row, emb_row,
    ) -> tuple[list[str], str]:
        """Merge the two families' top-k for one request → (songs, source
        ∈ {"rules", "embed", "hybrid", "fallback", "empty"}). ``emb_row``
        is ``(ids, sims, known)`` or None (no embeddings, or rules mode),
        which gives the rules-only answer bit for bit. The merge is host
        float arithmetic with a fixed tie order (score desc, name asc)."""
        emb_known = emb_row is not None and bool(emb_row[2])
        if not rule_known and not emb_known:
            return self.static_recommendation(seeds), "fallback"
        if not emb_known:
            songs = [bundle.vocab[int(i)] for i in ids_row if i >= 0]
            return songs, ("rules" if songs else "empty")
        emb_pairs = [
            (bundle.emb_vocab[int(i)], float(s)) for i, s in zip(emb_row[0], emb_row[1]) if i >= 0
        ]
        if self.cfg.hybrid_mode == "embed" or not rule_known:
            # embed mode, or a cold-start seed the rules never saw
            songs = [n for n, _ in emb_pairs]
            return songs, ("embed" if songs else "empty")
        rule_pairs = [
            (bundle.vocab[int(i)], float(c)) for i, c in zip(ids_row, confs_row) if i >= 0
        ]
        songs = blend_candidates(rule_pairs, emb_pairs, self.blend_weight, self.cfg.k_best_tracks)
        return songs, ("hybrid" if songs else "empty")

    def recommend(self, seed_tracks: list[str]) -> tuple[list[str], str]:
        """→ ``(songs, source)``, source ∈ {"rules", "embed", "hybrid",
        "fallback", "empty"}."""
        return self.recommend_many_async([seed_tracks])()[0]

    def recommend_many(
        self, seed_sets: list[list[str]]
    ) -> list[tuple[list[str], str]]:
        """One device call for a batch of seed sets; per-request semantics
        identical to :meth:`recommend`."""
        return self.recommend_many_async(seed_sets)()

    def recommend_many_async(
        self, seed_sets: list[list[str]], replica: int | None = None,
    ) -> Callable[[], list[tuple[list[str], str]]]:
        """Batched lookup split into DISPATCH (staged and enqueued on the
        device; returns at once) and FINISH (a zero-arg callable that waits
        for this batch's result and builds the answers). ``replica``
        selects the replica that runs the batch (the batcher's least-loaded
        pick); None uses the primary. The batch is padded up to its
        (batch, length) bucket; each lookup is launched only when some row
        has a seed its vocabulary knows. Both lookups are enqueued before
        either is awaited."""
        replicas = self.replicas
        idx = replica % len(replicas) if (replica is not None and replicas) else 0
        bundle = replicas[idx] if replicas else self.bundle
        if bundle is None:
            # degrade + nudge a reload, like the reference's late-load path
            threading.Thread(target=self.reload_if_required, daemon=True).start()

            def finish_fallback() -> list[tuple[list[str], str]]:
                return [(self.static_recommendation(s), "fallback") for s in seed_sets]

            return finish_fallback
        length = self._bucket_len(max((len(s) for s in seed_sets), default=1))
        n_rows = self._bucket_batch(max(len(seed_sets), 1))
        seeds, known_rows = self._stage_seeds(bundle, seed_sets, n_rows, length)
        cm = self.cost_model
        t_kernel = time.perf_counter()
        wait = self._launch(bundle, seeds) if known_rows.any() else None
        emb = self._dispatch_embed(bundle, seed_sets, n_rows, length)
        self._note_dispatch(idx)

        def finish() -> list[tuple[list[str], str]]:
            # chaos site on the completion path, where a real device
            # failure or stall surfaces
            faults.fire("replica.kernel", replica=idx)
            host_ids = host_confs = None
            t_rules = time.perf_counter()
            if wait is not None:
                host_ids, host_confs = wait()
                t_rules = time.perf_counter()
                if cm is not None:
                    # dispatch → the batch's CUDA event (the wait above is
                    # its fence): the same span kmls_device_ms reports, an
                    # upper bound on device time, so the MFU is a lower bound
                    cm.observe_kernel(
                        "serve_rules", t_rules - t_kernel,
                        b=n_rows, l=length, k_max=bundle.rule_ids.shape[1],
                        v=len(bundle.vocab), k_best=self.cfg.k_best_tracks,
                    )
            emb_ids = emb_sims = emb_known = None
            if emb is not None:
                (emb_ids, emb_sims), emb_known = emb[0](), emb[1]
                if cm is not None:
                    # the rule lookup is fenced already and the stream runs
                    # in order, so this span bills the embedding lookup
                    cm.observe_kernel(
                        "embed_topk", time.perf_counter() - t_rules,
                        b=n_rows, l=length, v=len(bundle.emb_vocab or ()),
                        r=int(bundle.emb_factors.shape[1]), k_best=self.cfg.k_best_tracks,
                    )
            return [
                self._compose_answer(
                    bundle, s, bool(known_rows[r]),
                    host_ids[r] if host_ids is not None else None,
                    host_confs[r] if host_confs is not None else None,
                    None if emb_ids is None else (emb_ids[r], emb_sims[r], emb_known[r]),
                )
                for r, s in enumerate(seed_sets)
            ]

        return finish

    def static_recommendation(
        self, seed_tracks: list[str], deadline: float | None = None
    ) -> list[str]:
        """Deterministic popular-tracks sample (reference:
        rest_api/app/main.py:205-222), keyed by a stable hash of the seeds.
        Past ``deadline`` (perf_counter seconds) the cheapest legitimate
        answer: the head of the popularity ranking."""
        best = self.best_tracks
        if not best:
            return []
        names = [b["track_name"] for b in best]
        k = min(self.cfg.k_best_tracks, len(names))
        if deadline is not None and time.perf_counter() >= deadline:
            return names[:k]
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
