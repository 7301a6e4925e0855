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

Cost attribution (``observability/costmodel.py``, on unless
``KMLS_COSTMODEL=0``): each finished batch reports its dispatch → CUDA
event seconds and its bucket's shape as a ``serve_rules`` observation,
each publication the rule tensors' bytes and the allocator's watermark,
and the unwarmed dispatches are watched as ``kmls_compiles_total``.

The native host kernel, the vocab-sharded layout, the serve mesh,
embeddings and deltas are not part of this package.
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
        # dispatches whose (batch, length) shape was never warmed; stays 0
        # unless a caller passes more rows than batch_max_size
        self.unwarmed_dispatches = 0
        # per-kernel cost attribution; None with KMLS_COSTMODEL=0, making
        # every call site one attribute check
        self.cost_model = (
            costmodel_mod.CostModel(device=self.device) if cfg.costmodel_enabled else None
        )
        # the first-shape probe the cost model watches: one stable callable,
        # since the watcher re-baselines on a new one
        self._unwarmed_probe = lambda: self.unwarmed_dispatches
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
                use_npz = self._verify_before_load(best_path, rec_path, npz_path)
                best = artifacts.load_pickle(best_path, deadline_s=self._read_deadline())
                replicas = self._build_replicas(rec_path, npz_path, token, use_npz=use_npz)
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
            manifest = artifacts.load_manifest(cfg.pickles_dir, deadline_s=self._read_deadline())
            if manifest is not None and manifest.get("token") == self.cache_value:
                rules_at = float(manifest.get("written_at") or time.time())
            else:
                rules_at = time.time()
            self._artifact_written_at = {
                "rules": rules_at,
                "popularity": self._file_written_at(best_path, rules_at),
            }
            if self.cost_model is not None:
                self._note_publish_cost(replicas)
            self.finished_loading = True
            self.reload_counter += 1
            self.consecutive_reload_failures = 0
            self.last_load_error = None
            self._backoff_until = 0.0
            logger.info(
                "reload #%d complete (epoch %d): %d tracks, %d rule keys, "
                "%d replica(s) on %s, token %r",
                self.reload_counter, epoch, len(replicas[0].vocab),
                int(replicas[0].known_mask.sum()), len(replicas),
                ", ".join(str(b.device) for b in replicas), replicas[0].model_token,
            )
            return True

    def _note_publish_cost(self, replicas: list[RuleBundle]) -> None:
        """Publish-time cost-model bookkeeping (caller holds
        ``_reload_lock``): the rule tensors' bytes against the budget, the
        allocator's bytes-in-use watermark, and the first-shape snapshot,
        taken after warm-up so later growth is a serving-path dispatch."""
        cm = self.cost_model
        bundle = replicas[0]
        cm.note_publish(
            {"rule_ids": int(bundle.rule_ids.nbytes), "rule_confs": int(bundle.rule_confs.nbytes)},
            self.cfg.device_budget_bytes,
            watermark_bytes=costmodel_mod.device_watermark_bytes(bundle.device),
        )
        cm.watch_compiles("serve_rules", self._unwarmed_probe)
        cm.mark_published()

    def _verify_before_load(self, best_path: str, rec_path: str, npz_path: str) -> bool:
        """Check the artifact set against the mining job's manifest before
        any bytes are trusted. A mismatched best-tracks or recommendations
        pickle aborts the reload (raise → last-good keeps serving); a
        mismatched npz only turns off the tensor fast path for this reload,
        since the pickle carries the same generation. The current token
        gates the check: a manifest stamped for another generation steps
        aside. → whether the npz may be used."""
        if not self.cfg.verify_manifest:
            return True
        bad = artifacts.verify_files(
            self.cfg.pickles_dir,
            [os.path.basename(p) for p in (best_path, rec_path, npz_path)],
            token=self._read_token(),
        )
        use_npz = npz_path not in bad
        if not use_npz:
            logger.warning(
                "tensor artifact %s fails its manifest checksum; falling back "
                "to the pickle", npz_path,
            )
            bad.remove(npz_path)
        if bad:
            raise ArtifactIntegrityError(f"artifact checksum mismatch vs manifest: {bad}", bad)
        return use_npz

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
    ) -> list[RuleBundle]:
        """Load the rule tensors once (the npz twin when present and
        verified — counts → float64 → float32 confs — else the reference
        pickle dict), then copy them onto every serving device. Host state
        is shared."""
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
        the pinned host buffers included."""
        if not bundle.vocab:
            return  # nothing can be known: every answer is the fallback
        for length in self._len_buckets():
            for batch in self._batch_buckets():
                seeds = self._staging((batch, length), bundle.device)
                self._launch(bundle, seeds)()
                bundle.warmed_shapes.add((batch, length))

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
        from. ``delta-chain`` is the newest applied generation's age; with
        no delta path it equals ``rules``. Empty before the first load."""
        if not self._artifact_written_at:
            return {}
        now = time.time()
        out = {
            name: max(now - stamp, 0.0)
            for name, stamp in self._artifact_written_at.items()
        }
        out["delta-chain"] = out["rules"]
        return out

    def reload_if_required(self) -> None:
        """Reload when stale or never fully loaded
        (reference: rest_api/app/main.py:110-114). After a failed reload
        this retries on the backoff ladder instead of every poll; the
        staleness signal survives (is_data_stale is pure), so the retry
        always comes."""
        if time.monotonic() < self._backoff_until:
            return
        if self.is_data_stale() or not self.finished_loading:
            self.load()

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

    def _launch(self, bundle: RuleBundle, seeds: torch.Tensor) -> Callable[[], np.ndarray]:
        """Start the lookup of the host ``seeds`` on ``bundle``'s device →
        ``wait()``, which returns the (rows, k_best) host ids.

        On a card the seed copy, the lookup and the copy of the ids into a
        pinned host tensor are enqueued on the replica's current stream
        with a CUDA event after them, and ``wait()`` synchronizes on that
        event only (releasing the GIL). On the CPU the lookup runs inside
        ``wait()``, so a dispatch never computes on the caller's thread."""
        k_best = self.cfg.k_best_tracks
        dev = bundle.device
        if dev.type != "cuda":
            def wait_cpu() -> np.ndarray:
                ids, _ = recommend_batch(bundle.rule_ids, bundle.rule_confs, seeds, k_best=k_best)
                return ids.numpy()

            return wait_cpu
        with torch.cuda.device(dev):
            seeds_dev = seeds.to(dev, non_blocking=True)
            top_ids, _ = recommend_batch(bundle.rule_ids, bundle.rule_confs, seeds_dev,
                                         k_best=k_best)
            host_ids = torch.empty(top_ids.shape, dtype=torch.int32, pin_memory=True)
            host_ids.copy_(top_ids, non_blocking=True)
            done = torch.cuda.Event()
            done.record()

        # _staged keeps the pinned seed tensor alive until the copy that
        # reads it has provably finished
        def wait_cuda(_staged: torch.Tensor = seeds) -> np.ndarray:
            done.synchronize()
            return host_ids.numpy()

        return wait_cuda

    def _compose_answer(
        self, bundle: RuleBundle, seeds: list[str], rule_known: bool, ids_row,
    ) -> tuple[list[str], str]:
        """One request's answer → (songs, source ∈ {"rules", "fallback",
        "empty"})."""
        if not rule_known:
            return self.static_recommendation(seeds), "fallback"
        songs = [bundle.vocab[int(i)] for i in ids_row if i >= 0]
        return songs, ("rules" if songs else "empty")

    def recommend(self, seed_tracks: list[str]) -> tuple[list[str], str]:
        """→ ``(songs, source)``, source ∈ {"rules", "fallback", "empty"}."""
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
        (batch, length) bucket; a batch with no known seed in any row
        launches nothing."""
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
        self._note_dispatch(idx)

        def finish() -> list[tuple[list[str], str]]:
            # chaos site on the completion path, where a real device
            # failure or stall surfaces
            faults.fire("replica.kernel", replica=idx)
            host_ids = wait() if wait is not None else None
            if cm is not None and wait is not None:
                # dispatch → the batch's CUDA event (the wait above is its
                # fence): the same span kmls_device_ms reports, an upper
                # bound on device time, so the MFU is a lower bound
                cm.observe_kernel(
                    "serve_rules", time.perf_counter() - t_kernel,
                    b=n_rows, l=length, k_max=bundle.rule_ids.shape[1],
                    v=len(bundle.vocab), k_best=self.cfg.k_best_tracks,
                )
            return [
                self._compose_answer(
                    bundle, s, bool(known_rows[r]),
                    host_ids[r] if host_ids is not None else None,
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
