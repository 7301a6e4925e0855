"""Mining driver: baskets → rule tensors, on the bit-packed count route.

Counterpart of ``kmlserver_tpu/mining/miner.py`` for the reference's default
configuration (support mode, ``max_itemset_len=2``): Apriori prune on the
host, pair counts ``C = XᵀX`` from the bit-packed operand through the CUDA
popcount kernel (``ops/popcount.py``), then threshold + top-k emission.
With a rank mesh every rank runs the same prune, packs its slab of the
word axis, counts it with the kernel and all-reduces the partials
(``parallel/support.py``; the reference's ``sharded-bitpack`` route,
``miner.py:199-232``, ``tp`` flattened onto ``dp``). Counts are exact
integers, so the rule tensors equal the reference's whichever count route
the reference took. The dense-fused, sparse, native-CPU and dense sharded
routes, their dispatch and the itemset census are not ported.

Timing brackets rule generation like the reference (machine-learning/
main.py:264,306-308), synchronising the device at each phase boundary so
device work lands inside its phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from ..config import MiningConfig
from ..ops import popcount, rules
from ..ops.support import min_count_for
from ..parallel import layout, support
from ..parallel.mesh import RankMesh
from ..utils.device import resolve_device
from .vocab import Baskets, Vocab


@dataclasses.dataclass
class MiningResult:
    tensors: rules.RuleTensors
    # names for the tensor rows — the (possibly Apriori-pruned) vocabulary
    vocab_names: list[str]
    n_playlists: int
    n_tracks: int  # full dataset unique-track count (pre-pruning)
    duration_s: float
    pruned_vocab: int | None = None  # size after pruning, when it ran
    phase_timings: dict[str, float] | None = None
    # which pair-count route ran: "bitpack-cuda" (the CUDA kernel),
    # "bitpack-torch" (its plain PyTorch version on the CPU), the same two
    # with a "sharded-" prefix over a rank mesh, or "pruned-empty"
    # (nothing frequent in a large vocabulary)
    count_path: str | None = None
    # launches of the CUDA popcount kernel during this mine (this rank's)
    kernel_launches: int = 0


class PhaseTimer:
    """Named wall-clock phases; on a CUDA device each phase synchronises
    at its end so asynchronous kernels are billed to the phase that
    launched them."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0


def format_phases(phases: dict[str, float]) -> str:
    parts = ", ".join(f"{k} {v:.3f}s" for k, v in phases.items())
    return f"phase timings: {parts}" if parts else "phase timings: (none)"


def prune_infrequent(baskets: Baskets, min_count: int) -> tuple[Baskets, np.ndarray]:
    """Apriori pre-filter: drop items whose SINGLETON support is below
    min_count before pair counting. Exact — an infrequent item cannot occur
    in any frequent itemset. Returns (reduced baskets, kept original ids)."""
    item_counts = np.bincount(baskets.track_ids, minlength=baskets.n_tracks)
    keep_ids = np.flatnonzero(item_counts >= min_count)
    remap = np.full(baskets.n_tracks, -1, dtype=np.int32)
    remap[keep_ids] = np.arange(len(keep_ids), dtype=np.int32)
    mapped = remap[baskets.track_ids]
    selected = mapped >= 0
    names = [baskets.vocab.names[i] for i in keep_ids]
    reduced = Baskets(
        playlist_rows=baskets.playlist_rows[selected],
        track_ids=mapped[selected],
        n_playlists=baskets.n_playlists,  # denominator stays ALL playlists
        vocab=Vocab(names=names, index={n: i for i, n in enumerate(names)}),
    )
    return reduced, keep_ids


def mine(
    baskets: Baskets,
    cfg: MiningConfig,
    device: str | torch.device = "cuda",
    mesh: RankMesh | None = None,
) -> MiningResult:
    """Run the mining compute on ``device``, timed like the reference's rule
    step. Raises when ``device`` is CUDA and no card is present. With a
    ``mesh`` every rank of it must call this with the same baskets: the
    count is dp-sharded and all-reduced (phase ``all_reduce``)."""
    dev = resolve_device(device)
    if mesh is not None:
        if layout.wants_sharded_mining(cfg, mesh):
            print(
                "NOTE: KMLS_MODEL_LAYOUT=sharded: the vocab-sharded count and "
                "emission are not ported; counting on the dp-sharded "
                "bit-packed route with tp flattened onto dp (exact counts, "
                "so the same rule tensors)"
            )
        mesh = mesh.flattened()
    timer = PhaseTimer(dev)
    launches0 = sum(popcount.LAUNCHES.values())
    if dev.type == "cuda":
        # build (or load) the kernel library before the bracket: library
        # setup is environment preparation, not rule generation
        popcount.kernel_lib()
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    n_total = baskets.n_tracks
    pruned_vocab = None
    mined = baskets
    min_count = min_count_for(cfg.min_support, baskets.n_playlists)
    if baskets.n_tracks > cfg.prune_vocab_threshold:
        with timer.phase("apriori_prune"):
            mined, _ = prune_infrequent(baskets, min_count)
            pruned_vocab = mined.n_tracks
        if mined.n_tracks == 0:
            if baskets.n_tracks <= 4096:
                # nothing frequent, small vocab: mine the unpruned
                # vocabulary (emission finds no rules either way)
                mined, pruned_vocab = baskets, None
            else:
                # nothing frequent, LARGE vocab: emit the empty result on
                # the host instead of building infeasible shapes
                k = cfg.k_max_consequents
                tensors = rules.RuleTensors(
                    rule_ids=np.full((0, k), -1, np.int32),
                    rule_counts=np.zeros((0, k), np.int32),
                    rule_confs=np.zeros((0, k), np.float32),
                    item_counts=np.zeros(0, np.int32),
                    n_playlists=baskets.n_playlists,
                    min_support=cfg.min_support,
                    min_count=min_count,
                    mode=cfg.confidence_mode,
                    min_confidence=cfg.min_confidence,
                    n_frequent_items=0,
                    n_songs_missing=n_total,
                    overflow_rows=0,
                    row_valid_counts=np.zeros(0, np.int32),
                )
                return MiningResult(
                    tensors=tensors, vocab_names=[],
                    n_playlists=baskets.n_playlists, n_tracks=n_total,
                    duration_s=time.perf_counter() - t0, pruned_vocab=0,
                    phase_timings=dict(timer.phases), count_path="pruned-empty",
                )
    with timer.phase("bitpack"):
        if mesh is None:
            v_pad, w_pad = popcount.padded_shape(mined.n_tracks, mined.n_playlists)
            bt = popcount.bitpack_by_track(
                mined.playlist_rows, mined.track_ids,
                n_playlists=mined.n_playlists, n_tracks=mined.n_tracks,
                v_pad=v_pad, w_pad=w_pad, device=dev,
            )
        else:
            bt = support.pack_rank_slab(mined, mesh, dev)
    with timer.phase("pair_counts"):
        variant, swar = popcount.resolve_kernel_opts(None, None)
        counts = popcount.popcount_pair_counts_padded(bt, variant=variant, swar=swar)
        del bt
    if mesh is not None:
        with timer.phase("all_reduce"):
            support.reduce_counts(counts, mesh)
    with timer.phase("rule_emission"):
        tensors = rules.mine_rules_from_counts(
            counts[: mined.n_tracks, : mined.n_tracks],
            n_playlists=mined.n_playlists,
            min_support=cfg.min_support,
            k_max=cfg.k_max_consequents,
            mode=cfg.confidence_mode,
            min_confidence=cfg.min_confidence,
            n_total_songs=n_total,
        )
    return MiningResult(
        tensors=tensors,
        vocab_names=list(mined.vocab.names),
        n_playlists=mined.n_playlists,
        n_tracks=n_total,
        duration_s=time.perf_counter() - t0,
        pruned_vocab=pruned_vocab,
        phase_timings=dict(timer.phases),
        count_path=("bitpack-" if mesh is None else "sharded-bitpack-")
        + ("cuda" if dev.type == "cuda" else "torch"),
        kernel_launches=sum(popcount.LAUNCHES.values()) - launches0,
    )
