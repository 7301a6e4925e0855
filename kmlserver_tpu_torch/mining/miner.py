"""The mining compute: baskets → rule tensors, on the count route the
measured dispatch picks.

Counterpart of ``kmlserver_tpu/mining/miner.py``. Apriori prune on the
host, then the reference's count dispatch (``mining/dispatch.py``, looked
up under ``utils/device.py::backend_name``) picks one of three families:

- **dense** — the int8 one-hot ``X`` and ``C = XᵀX`` (``ops/support.py``).
  ``dense-fused`` runs one-hot → product → emission on the device with one
  fetch (``ops/rules.py::fused_dense_rule_tensors``) whenever nothing
  downstream needs the one-hot; the staged ``dense`` route keeps ``X`` and
  ``C`` for the itemset census and the triple/quad merge.
- **bitpack** — ``C`` from the bit-packed operand through the CUDA popcount
  kernel (``ops/popcount.py``; ``bitpack-cuda``, or ``bitpack-torch``, its
  plain version, on the CPU).
- **sparse** — ``sparse-hybrid``: pair events expanded on the host and
  scatter-added on the device, the long-basket block through the popcount
  kernel (``ops/sparse.py``); on the CPU the reference's host route.

With ``max_itemset_len ≥ 3`` the frequent-itemset census follows (outside
the bracket in support mode), and in confidence mode the merged
multi-antecedent confidences (inside it): frequent pairs → triple
extension → (quad extension) → ``rules.merge_confidence_contributions``.

With a rank mesh every rank runs the same prune and takes the reference's
routes (``parallel/support.py``): the bit-packed count with ``tp``
flattened onto ``dp`` where bitpack is wanted (``sharded-bitpack-*``:
each rank packs and counts its slab of the word axis and the partials are
all-reduced), else the dense sharded count (``sharded-dense-<impl>``,
``KMLS_SHARDED_IMPL``). Under ``KMLS_MODEL_LAYOUT=sharded`` on a mesh with
a vocab axis, each rank counts and emits its own rows
(``sharded-vocab-<impl>``), or feeds its rows of the sparse count to the
same emission (``sparse-sharded``). Counts are exact integers, so the rule
tensors equal the reference's whichever count route either package took.

When the caller asks for the CPU, the dense family's count is the native
POPCNT counter (``native-cpu``, ``ops/cpu_popcount.py``) and its emission
the native top-k, as in the reference on a CPU backend: one rank, no
census or triple merge, ``native_cpu_pair_counts`` on, and the library
built. On a card nothing changes route for the library.

Timing brackets rule generation like the reference (machine-learning/
main.py:264,306-308), synchronising the device at each phase boundary so
device work lands inside its phase.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import MiningConfig
from ..ops import cpu_popcount, encode, popcount, rules, sparse
from ..ops import support as support_ops
from ..ops.support import min_count_for
from ..parallel import collectives, layout, support
from ..parallel.mesh import AXIS_DP, RankMesh
from ..utils import profiling
from ..utils.device import backend_name, resolve_device
from ..utils.profiling import PhaseTimer, trace_session
from . import dispatch
from .vocab import Baskets, Vocab

# frequent pairs (triples) the triple (quad) extension takes; more is
# reported as not enumerated, never silently truncated
PAIR_CAPACITY = 1 << 16
TRIPLE_CAPACITY = 1 << 16


@dataclasses.dataclass
class MiningResult:
    tensors: rules.RuleTensors
    # names for the tensor rows — the (possibly Apriori-pruned) vocabulary
    vocab_names: list[str]
    n_playlists: int
    n_tracks: int  # full dataset unique-track count (pre-pruning)
    duration_s: float
    pruned_vocab: int | None = None  # size after pruning, when it ran
    itemset_census: dict[int, int] | None = None  # length → frequent-itemset count
    phase_timings: dict[str, float] | None = None
    # confidence mode with max_itemset_len >= 3: True when the triple-rule
    # merge ran, False when it had to be skipped (confidences pairwise-only),
    # None when not applicable
    triple_merge_applied: bool | None = None
    # which pair-count route ran: "dense-fused", "dense", "sparse-hybrid",
    # "bitpack-cuda" (the CUDA kernel), "bitpack-torch" (its plain PyTorch
    # version on the CPU), the last two with a "sharded-" prefix over a
    # rank mesh, "sharded-dense-<impl>", "sharded-vocab-<impl>",
    # "sparse-sharded", or "pruned-empty" (nothing frequent in a large
    # vocabulary)
    count_path: str | None = None
    # how the dispatch decided (mining/dispatch.py CountPlan.source:
    # override/threshold/table/heuristic, or census-override)
    count_path_source: str | None = None
    # exact pair-event count the sparse plan measured (None: not measured)
    sparse_events: int | None = None
    # launches of the CUDA popcount kernels during this mine (this rank's)
    kernel_launches: int = 0


def bitpack_plan_bytes(
    n_playlists: int,
    n_tracks: int,
    *,
    n_devices: int = 1,
    n_rows: int = 0,
) -> int:
    """Planned per-device bytes of the bit-packed formulation: bitset slab
    (word axis sharded over dp) + int32 counts with top-k scratch + one
    unpacked int8 slab + membership operands — the reference's formula over
    the port's own ``padded_shape`` / ``word_chunk``. The one copy of this
    footprint: the dispatch heuristic and :func:`bitpack_wanted` agree on
    what 'bitpack fits' means."""
    v_pad, w_pad = popcount.padded_shape(n_tracks, n_playlists)
    return (
        v_pad * w_pad * 4 // max(n_devices, 1)
        + 8 * v_pad * v_pad
        + v_pad * popcount.word_chunk() * 32
        + 8 * n_rows // max(n_devices, 1)
    )


def bitpack_wanted(
    n_playlists: int,
    n_tracks: int,
    threshold: int | str | None,
    *,
    hbm_budget_bytes: int = 12 << 30,
    n_devices: int = 1,
    n_rows: int = 0,
    backend: str | None = None,
) -> bool:
    """The ONE bitpack-vs-dense decision (single-device and sharded), a
    copy of the reference's.

    - ``threshold == "auto"``: bitpack when the dense formulation's planned
      device bytes — the int8 one-hot (sharded over ``n_devices``) plus the
      int32 count matrix and an equal-size top-k scratch — exceed
      ``hbm_budget_bytes`` per device. On a non-TPU backend (``backend``
      given and != "tpu", so ``"gpu"`` and ``"cpu"`` here) a speed rule
      also applies: above 2^26 one-hot elements, bitpack. Callers that only
      ask "does dense FIT?" pass ``backend=None``.
    - ``threshold`` an int: bitpack above that many one-hot elements.
    - ``threshold is None`` (or ``"none"``/``"never"``): never bitpack.
    """
    if isinstance(threshold, str):
        if threshold == "auto":
            dense_bytes = (
                n_playlists * n_tracks // max(n_devices, 1)
                + 8 * n_tracks * n_tracks
                + 8 * n_rows // max(n_devices, 1)
            )
            if dense_bytes > hbm_budget_bytes:
                bitpack_bytes = bitpack_plan_bytes(
                    n_playlists, n_tracks,
                    n_devices=n_devices, n_rows=n_rows,
                )
                if bitpack_bytes > hbm_budget_bytes:
                    print(
                        "WARNING: neither the dense one-hot "
                        f"(~{dense_bytes / (1 << 30):.1f} GiB) nor the "
                        f"bit-packed path (~{bitpack_bytes / (1 << 30):.1f} "
                        "GiB: bitset + counts + unpack slab) fits the "
                        f"{hbm_budget_bytes / (1 << 30):.1f} GiB HBM budget "
                        f"per device (x{max(n_devices, 1)}); proceeding "
                        "bit-packed but expect an allocator failure — "
                        "shard over more devices or raise min_support to "
                        "shrink the frequent vocabulary"
                    )
                return True
            return (
                backend is not None
                and backend != "tpu"
                and n_playlists * n_tracks // max(n_devices, 1) > 1 << 26
            )
        if threshold in ("none", "never"):
            return False
        raise ValueError(
            f"bitpack threshold must be 'auto', 'none'/'never', None, or an "
            f"element count, got {threshold!r}"
        )
    if threshold is None:
        return False
    return n_playlists * n_tracks > threshold


def _on(device: torch.device, a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device)


def pair_count_fn(
    baskets: Baskets,
    device: torch.device,
    timer: PhaseTimer,
    mesh: RankMesh | None = None,
    bitpack_threshold_elems: int | str | None = None,
    hbm_budget_bytes: int = 12 << 30,
    sharded_impl: str = "gspmd",
) -> tuple[torch.Tensor, torch.Tensor | None, str]:
    """The staged count: one-hot encode + pair counts, bit-packed or dense,
    over a rank mesh or on one device.

    Returns ``(counts, x_onehot_or_None, path)``: the ``(V, V)`` int32
    counts on ``device``, and the one-hot on the dense single-device route
    (the census reuses it; the sharded and bit-packed routes never build
    the whole of it). ``path`` names the route that ran — the one source of
    ``count_path``."""
    suffix = "cuda" if device.type == "cuda" else "torch"
    v = baskets.n_tracks
    n_rows = len(baskets.playlist_rows)
    if mesh is not None:
        if bitpack_wanted(
            baskets.n_playlists, v, bitpack_threshold_elems,
            hbm_budget_bytes=hbm_budget_bytes, n_devices=mesh.size,
            n_rows=n_rows, backend=backend_name(device),
        ):
            # the bitpack count shards the word axis over dp only: flatten
            # every rank onto dp (reference miner.py:216-219)
            mesh = mesh.flattened()
            with timer.phase("bitpack"):
                bt = support.pack_rank_slab(baskets, mesh, device)
            with timer.phase("pair_counts"):
                counts = _popcount_counts(bt)
            with timer.phase("all_reduce"):
                collectives.all_reduce_sum_(counts, mesh.axis(AXIS_DP))
            return counts[:v, :v], None, f"sharded-bitpack-{suffix}"
        with timer.phase("pair_counts"):
            counts = support.sharded_pair_counts(baskets, mesh, sharded_impl, device)
        return counts, None, f"sharded-dense-{sharded_impl}"
    if bitpack_wanted(
        baskets.n_playlists, v, bitpack_threshold_elems,
        hbm_budget_bytes=hbm_budget_bytes, n_rows=n_rows,
        backend=backend_name(device),
    ):
        with timer.phase("bitpack"):
            v_pad, w_pad = popcount.padded_shape(v, baskets.n_playlists)
            bt = popcount.bitpack_by_track(
                baskets.playlist_rows, baskets.track_ids,
                n_playlists=baskets.n_playlists, n_tracks=v,
                v_pad=v_pad, w_pad=w_pad, device=device,
            )
        with timer.phase("pair_counts"):
            counts = _popcount_counts(bt)
        return counts[:v, :v], None, f"bitpack-{suffix}"
    with timer.phase("onehot"):
        x = encode.onehot_matrix(
            _on(device, baskets.playlist_rows), _on(device, baskets.track_ids),
            n_playlists=baskets.n_playlists, n_tracks=v,
        )
    with timer.phase("pair_counts"):
        counts = support_ops.pair_counts(x)
    return counts, x, "dense"


def native_cpu_eligible(
    cfg: MiningConfig, device: torch.device, mesh: RankMesh | None = None
) -> bool:
    """True when the native POPCNT counter carries the pair count: the
    mine runs on the CPU, on one rank, with no downstream step (itemset
    census, triple/quad extensions) needing the one-hot, the knob is on
    and the library loads. May build the library — call it outside any
    timed bracket. The one copy of the gate: the sweep takes it too."""
    return (
        device.type == "cpu"
        and mesh is None
        and cfg.max_itemset_len < 3
        and cfg.native_cpu_pair_counts
        and cpu_popcount.available()
    )


def native_pair_counts(baskets: Baskets) -> np.ndarray:
    """The native counter, called exactly as the miner calls it."""
    return cpu_popcount.pair_counts(
        baskets.playlist_rows, baskets.track_ids,
        n_playlists=baskets.n_playlists, n_tracks=baskets.n_tracks,
    )


def _popcount_counts(bt: torch.Tensor) -> torch.Tensor:
    variant, swar = popcount.resolve_kernel_opts(None, None)
    return popcount.popcount_pair_counts_padded(bt, variant=variant, swar=swar)


def compute_triple_extension(
    x: torch.Tensor,
    counts: torch.Tensor,
    min_count: int,
    pair_capacity: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int] | None:
    """Frequent pairs + their triple extensions, computed ONCE and shared by
    the itemset census and the confidence-mode triple-rule merge.

    → ``(pair_i, pair_j, pair_counts, triple_counts, n_pairs)`` as host
    arrays, or None when the frequent pairs overflow ``pair_capacity``
    (default :data:`PAIR_CAPACITY`, read at call time). The reference
    extends all ``capacity`` rows of ``frequent_pairs`` and its consumers
    mask the padding; the frequent pairs are that array's first
    ``n_pairs`` rows, so the port keeps only those: ``Y`` is
    ``(P, n_pairs)`` and the extension ``(n_pairs, V)``."""
    cap = PAIR_CAPACITY if pair_capacity is None else pair_capacity
    pair_i, pair_j, pair_cnt, n_pairs = support_ops.frequent_pairs(
        counts, min_count, capacity=cap
    )
    if n_pairs > cap:
        return None
    pi, pj = pair_i[:n_pairs], pair_j[:n_pairs]
    t = support_ops.triple_counts(x, pi, pj)
    return (
        pi.cpu().numpy(),
        pj.cpu().numpy(),
        pair_cnt[:n_pairs].cpu().numpy(),
        t.cpu().numpy(),
        n_pairs,
    )


def frequent_triples_from_extension(
    triple_data: tuple, min_count: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Unique frequent triples (i < j < k) + their supports, extracted from
    the pair→triple extension. Each triple appears under exactly one pair
    row (its (i, j) with k > j), so restricting to k > j dedups across the
    three pair rows that could generate it."""
    pi, pj, _, t, _ = triple_data
    valid = pi >= 0
    v = t.shape[1]
    k_ids = np.arange(v)[None, :]
    mask = valid[:, None] & (k_ids > pj[:, None]) & (t >= min_count)
    e_idx, k_idx = np.nonzero(mask)
    return (
        pi[e_idx].astype(np.int32),
        pj[e_idx].astype(np.int32),
        k_idx.astype(np.int32),
        t[e_idx, k_idx].astype(np.int32),
    )


def compute_quad_extension(
    x: torch.Tensor,
    triple_data: tuple,
    min_count: int,
    capacity: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None:
    """Frequent triples + their quad extensions:
    ``(ti, tj, tk, triple_supports, quad_counts (E3, V))`` as host arrays,
    or None when the frequent triples exceed ``capacity`` (default
    :data:`TRIPLE_CAPACITY`, read at call time). The reference pads the
    triple arrays to a multiple of 1024 to bound its compiled shapes;
    PyTorch runs eagerly, so the port extends the frequent triples alone."""
    cap = TRIPLE_CAPACITY if capacity is None else capacity
    ti, tj, tk, tc = frequent_triples_from_extension(triple_data, min_count)
    n = len(ti)
    if n > cap:
        return None
    if n == 0:
        return ti, tj, tk, tc, np.zeros((0, x.shape[1]), np.int32)
    q = support_ops.quad_counts(
        x, _on(x.device, ti), _on(x.device, tj), _on(x.device, tk)
    )
    return ti, tj, tk, tc, q.cpu().numpy()


def _itemset_census(
    counts: torch.Tensor,
    min_count: int,
    max_len: int,
    triple_data: tuple | None,
    n_pairs: int | None,
    quad_data: tuple | None = None,
) -> dict[int, int]:
    """Exact frequent-itemset counts per length (1, 2, and — via the shared
    triple/quad extensions — 3 and 4). Lengths beyond 4, and any length
    whose extension isn't available (sharded or bit-packed mining,
    capacity overflow), are reported as -1 (not enumerated) rather than
    silently dropped."""
    item_counts = torch.diagonal(counts).cpu().numpy()
    census = {1: int((item_counts >= min_count).sum())}

    def finish(first_unenumerated: int) -> dict[int, int]:
        # EVERY non-enumerated length gets an explicit -1, never a missing key
        for length in range(first_unenumerated, max_len + 1):
            census[length] = -1
        return census

    if max_len < 2:
        return census
    if n_pairs is None:
        n_pairs = support_ops.frequent_pairs(counts, min_count, capacity=1)[3]
    census[2] = n_pairs
    if max_len < 3:
        return census
    if triple_data is None:
        return finish(3)  # capacity overflow / no one-hot: report honestly
    if quad_data is not None:
        # quad extraction already enumerated the triples — reuse its count
        census[3] = int((quad_data[0] >= 0).sum())
    else:
        # one shared dedup rule with the rule merge: a triple {i,j,k} is
        # counted once, under its frequent (i,j) row with k > j > i
        census[3] = len(
            frequent_triples_from_extension(triple_data, min_count)[0]
        )
    if max_len < 4:
        return census
    if quad_data is None:
        return finish(4)  # triple-capacity overflow: report honestly
    ti, tj, tk, _, q = quad_data
    v = q.shape[1] if q.ndim == 2 else 0
    l_ids = np.arange(v)[None, :]
    # quad {i,j,k,l} counted once: under its (i,j,k) with l > k > j > i
    qmask = (ti >= 0)[:, None] & (l_ids > tk[:, None]) & (q >= min_count)
    census[4] = int(qmask.sum())
    return finish(5)


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


def _empty_result(
    baskets: Baskets, cfg: MiningConfig, min_count: int, t0: float, timer: PhaseTimer
) -> MiningResult:
    """Nothing frequent in a LARGE vocabulary: the empty result, emitted on
    the host instead of building infeasible shapes."""
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
        n_songs_missing=baskets.n_tracks,
        overflow_rows=0,
        row_valid_counts=np.zeros(0, np.int32),
    )
    census = (
        {length: 0 for length in range(1, cfg.max_itemset_len + 1)}
        if cfg.max_itemset_len >= 3 else None
    )
    return MiningResult(
        tensors=tensors, vocab_names=[],
        n_playlists=baskets.n_playlists, n_tracks=baskets.n_tracks,
        duration_s=time.perf_counter() - t0, pruned_vocab=0,
        itemset_census=census, phase_timings=dict(timer.phases),
        count_path="pruned-empty",
    )


def mine(
    baskets: Baskets,
    cfg: MiningConfig,
    device: str | torch.device = "cuda",
    mesh: RankMesh | None = None,
) -> MiningResult:
    """Run the mining compute on ``device``, timed like the reference's rule
    step. Raises when ``device`` is CUDA and no card is present. With a
    ``mesh`` every rank of it must call this with the same baskets."""
    dev = resolve_device(device)
    backend = backend_name(dev)
    timer = PhaseTimer(dev)
    launches0 = sum(popcount.LAUNCHES.values())
    if dev.type == "cuda":
        # build (or load) the kernel library before the bracket: library
        # setup is environment preparation, not rule generation
        popcount.kernel_lib()
        torch.cuda.synchronize(dev)
    # so are the profiler's one-time start when KMLS_PROFILE_DIR is set and
    # the native counter's load (its one-time build on a fresh checkout)
    profiling.prime()
    native_ok = native_cpu_eligible(cfg, dev, mesh)
    t0 = time.perf_counter()
    # a torch.profiler trace of the mine when KMLS_PROFILE_DIR is set
    with trace_session("mine"):
        return _mine_timed(
            baskets, cfg, dev, mesh, backend, timer, t0, launches0, native_ok
        )


def _mine_timed(
    baskets: Baskets, cfg: MiningConfig, dev: torch.device, mesh: RankMesh | None,
    backend: str, timer: PhaseTimer, t0: float, launches0: int, native_ok: bool,
) -> MiningResult:
    """The body of :func:`mine`, inside its timing bracket."""
    n_total = baskets.n_tracks
    pruned_vocab = None
    mined = baskets
    min_count = min_count_for(cfg.min_support, baskets.n_playlists)
    if baskets.n_tracks > cfg.prune_vocab_threshold:
        with timer.phase("apriori_prune"):
            mined, _ = prune_infrequent(baskets, min_count)
            pruned_vocab = mined.n_tracks
        if mined.n_tracks == 0:
            if baskets.n_tracks > 4096:
                return _empty_result(baskets, cfg, min_count, t0, timer)
            # nothing frequent, small vocab: mine the unpruned vocabulary
            # (emission finds no rules either way)
            mined, pruned_vocab = baskets, None
    n_rows = len(mined.playlist_rows)
    plan = dispatch.plan_count_path(
        cfg, mined.n_playlists, mined.n_tracks, n_rows,
        backend=backend, n_devices=mesh.size if mesh is not None else 1,
        baskets=mined,
    )
    wants_bitpack = plan.path == "bitpack"
    use_sparse = plan.path == "sparse"
    plan_source = plan.source
    if use_sparse and cfg.max_itemset_len >= 3:
        # the census and the triple/quad extensions need the one-hot and
        # the counts, which the sparse route never builds: fall back to
        # the legacy dense/bitpack decision, loudly
        print(
            "NOTE: max_itemset_len >= 3 needs materialized device "
            "intermediates for the census/triple merge, which the "
            f"sparse path never builds — the {plan.source} sparse "
            "decision is overridden by the legacy dense/bitpack "
            "dispatch"
        )
        use_sparse = False
        plan_source = "census-override"
        wants_bitpack = bitpack_wanted(
            mined.n_playlists, mined.n_tracks, "auto",
            hbm_budget_bytes=cfg.hbm_budget_bytes, n_rows=n_rows,
            backend=backend,
        )
    staged_threshold = cfg.bitpack_threshold_elems
    if plan.source == "override":
        # a pinned family must reach the staged pair_count_fn branch too,
        # which re-derives bitpack-vs-dense from the threshold
        if wants_bitpack:
            staged_threshold = 1
        elif plan.path == "dense":
            staged_threshold = None
    if (
        wants_bitpack
        and mesh is None
        and cfg.max_itemset_len >= 3
        and not bitpack_wanted(
            mined.n_playlists, mined.n_tracks, "auto",
            hbm_budget_bytes=cfg.hbm_budget_bytes, n_rows=n_rows,
        )
    ):
        # the census and the merge need the dense one-hot, and it fits
        print(
            "NOTE: max_itemset_len >= 3 needs the dense one-hot for "
            "the census/triple merge and it fits the HBM budget — "
            "overriding the bitpack threshold with the dense path"
        )
        wants_bitpack = False
        plan_source = "census-override"
        staged_threshold = None
    # the native counter is the dense family's CPU implementation: a sparse
    # plan outranks it, and a pinned bitpack family runs as named
    use_native_cpu = (
        native_ok
        and not use_sparse
        and not (plan.source == "override" and plan.path == "bitpack")
    )
    # the vocab-sharded count + emit (reference miner.py:635-660): each
    # rank counts and emits its own rows; the census and the triple merge
    # need the whole one-hot, so they keep the staged route
    use_shard_mine = (
        layout.wants_sharded_mining(cfg, mesh)
        and not wants_bitpack
        and not use_sparse
        and cfg.max_itemset_len < 3
    )
    use_fused = (
        mesh is None
        and not wants_bitpack
        and not use_sparse
        and cfg.max_itemset_len < 3
        and not use_native_cpu
    )
    counts = x = None
    emit = dict(
        n_playlists=mined.n_playlists, min_support=cfg.min_support,
        k_max=cfg.k_max_consequents, mode=cfg.confidence_mode,
        min_confidence=cfg.min_confidence, n_total_songs=n_total,
        n_tracks=mined.n_tracks,
    )
    if use_sparse and layout.wants_sharded_mining(cfg, mesh):
        count_path = "sparse-sharded"
        with timer.phase("sparse_mine"):
            emitted = support.sparse_sharded_rule_tensors(
                mined, mesh, min_count, cfg.k_max_consequents,
                long_basket_threshold=cfg.sparse_long_basket or None, device=dev,
            )
            tensors = rules.assemble_rule_tensors(*emitted, **emit)
    elif use_sparse:
        count_path = "sparse-hybrid"
        tensors = _sparse_mine(mined, cfg, dev, timer, min_count, n_total)
    elif use_native_cpu:
        count_path = "native-cpu"
        with timer.phase("native_pair_counts"):
            counts_np = native_pair_counts(mined)
        with timer.phase("rule_emission"):
            tensors = rules.mine_rules_from_counts_np(
                counts_np,
                n_playlists=mined.n_playlists,
                min_support=cfg.min_support,
                k_max=cfg.k_max_consequents,
                mode=cfg.confidence_mode,
                min_confidence=cfg.min_confidence,
                n_total_songs=n_total,
            )
    elif use_shard_mine:
        count_path = f"sharded-vocab-{cfg.sharded_impl}"
        with timer.phase("sharded_mine"):
            emitted = support.sharded_rule_tensors(
                mined, mesh, min_count, cfg.k_max_consequents,
                impl=cfg.sharded_impl, device=dev,
            )
            tensors = rules.assemble_rule_tensors(*emitted, **emit)
    elif use_fused:
        count_path = "dense-fused"
        with timer.phase("fused_mine"):
            emitted = rules.fused_dense_rule_tensors(
                _on(dev, mined.playlist_rows), _on(dev, mined.track_ids), min_count,
                n_playlists=mined.n_playlists, n_tracks=mined.n_tracks,
                k_max=cfg.k_max_consequents,
            )
            emitted = tuple(t.cpu().numpy() for t in emitted)
            # the fetch is compacted to int16 when the shapes allow; log
            # what actually crossed the link, then upcast to the int32
            # RuleTensors contract
            fetch_bytes = sum(a.nbytes for a in emitted)
            print(
                f"Fused fetch: {fetch_bytes / 1e6:.3f} MB device->host "
                f"({mined.n_tracks}x{cfg.k_max_consequents} "
                f"rule tensors, {emitted[0].dtype}/{emitted[1].dtype})"
            )
            tensors = rules.assemble_rule_tensors(
                *(np.asarray(a, dtype=np.int32) for a in emitted), **emit
            )
    else:
        counts, x, count_path = pair_count_fn(
            mined, dev, timer, mesh,
            bitpack_threshold_elems=staged_threshold,
            hbm_budget_bytes=cfg.hbm_budget_bytes,
            sharded_impl=cfg.sharded_impl,
        )
        with timer.phase("rule_emission"):
            tensors = rules.mine_rules_from_counts(
                counts,
                n_playlists=mined.n_playlists,
                min_support=cfg.min_support,
                k_max=cfg.k_max_consequents,
                mode=cfg.confidence_mode,
                min_confidence=cfg.min_confidence,
                n_total_songs=n_total,
            )
    triple_data = quad_data = None
    triple_merge_applied = None
    needs_triples = cfg.confidence_mode == "confidence" and cfg.max_itemset_len >= 3
    if needs_triples:
        # multi-antecedent rules from frequent triples/quads — part of rule
        # generation, inside the bracket
        if cfg.max_itemset_len >= 5:
            print(
                "WARNING: confidence-mode antecedents are enumerated up "
                f"to size 3 (itemsets of length 4); max_itemset_len="
                f"{cfg.max_itemset_len} rules from longer itemsets are "
                "not merged and confidences may understate them"
            )
        if x is not None:
            with timer.phase("triple_extension"):
                triple_data = compute_triple_extension(x, counts, tensors.min_count)
        if triple_data is not None:
            if cfg.max_itemset_len >= 4:
                with timer.phase("quad_extension"):
                    quad_data = compute_quad_extension(
                        x, triple_data, tensors.min_count
                    )
                if quad_data is None:
                    print(
                        "WARNING: quad-rule merge skipped (frequent "
                        "triples exceed capacity); confidences include "
                        "antecedents up to size 2 only"
                    )
            # the O(E×V) contribution builds are the merge's dominant host
            # cost — keep them inside the timed merge phase
            with timer.phase("confidence_merge"):
                contributions = [
                    rules.antecedent_contributions(
                        (triple_data[0], triple_data[1]),
                        triple_data[2], triple_data[3],
                        min_count=tensors.min_count,
                        min_confidence=cfg.min_confidence,
                    )
                ]
                if quad_data is not None:
                    contributions.append(
                        rules.antecedent_contributions(
                            (quad_data[0], quad_data[1], quad_data[2]),
                            quad_data[3], quad_data[4],
                            min_count=tensors.min_count,
                            min_confidence=cfg.min_confidence,
                        )
                    )
                tensors = rules.merge_confidence_contributions(
                    tensors, contributions, k_max=cfg.k_max_consequents
                )
            triple_merge_applied = True
        else:
            # bit-packed / sharded route (no one-hot) or frequent pairs over
            # capacity: the merge CANNOT run — say so, confidences are
            # pairwise-only
            triple_merge_applied = False
            print(
                "WARNING: confidence-mode triple-rule merge skipped "
                + (
                    "(frequent pairs exceed capacity)"
                    if x is not None
                    else "(one-hot matrix not materialized on the "
                    "sharded/bit-packed path)"
                )
                + "; confidences are pairwise-only"
            )
    duration = time.perf_counter() - t0
    census = None
    if cfg.max_itemset_len >= 3:
        # census-only extensions (support mode) run OUTSIDE the
        # rule-generation bracket: reporting, not rule work
        if triple_data is None and x is not None and not needs_triples:
            with timer.phase("triple_extension"):
                triple_data = compute_triple_extension(x, counts, tensors.min_count)
        if (
            cfg.max_itemset_len >= 4
            and quad_data is None
            and triple_data is not None
            and x is not None
            and not needs_triples
        ):
            with timer.phase("quad_extension"):
                quad_data = compute_quad_extension(x, triple_data, tensors.min_count)
        with timer.phase("itemset_census"):
            census = _itemset_census(
                counts,
                tensors.min_count,
                cfg.max_itemset_len,
                triple_data,
                triple_data[4] if triple_data is not None else None,
                quad_data,
            )
    del x, counts, triple_data, quad_data  # the one-hot and counts go here
    return MiningResult(
        tensors=tensors,
        vocab_names=list(mined.vocab.names),
        n_playlists=mined.n_playlists,
        n_tracks=n_total,
        duration_s=duration,
        pruned_vocab=pruned_vocab,
        itemset_census=census,
        phase_timings=dict(timer.phases),
        triple_merge_applied=triple_merge_applied,
        count_path=count_path,
        count_path_source=plan_source,
        sparse_events=plan.pair_events,
        kernel_launches=sum(popcount.LAUNCHES.values()) - launches0,
    )


def _sparse_mine(
    mined: Baskets, cfg: MiningConfig, dev: torch.device, timer: PhaseTimer,
    min_count: int, n_total: int,
) -> rules.RuleTensors:
    """The sparse-hybrid route (phase ``sparse_mine``). On the CPU the
    reference's host route: membership pairs straight to rule rows, or,
    with long baskets, host counts + host emission. On a CUDA device the
    event stream is scatter-added there (the long-basket block through the
    popcount kernel) and emitted there."""
    thr = cfg.sparse_long_basket or None
    shape = dict(n_playlists=mined.n_playlists, n_tracks=mined.n_tracks)
    emit = dict(
        n_playlists=mined.n_playlists, min_support=cfg.min_support,
        k_max=cfg.k_max_consequents, mode=cfg.confidence_mode,
        min_confidence=cfg.min_confidence, n_total_songs=n_total,
    )
    with timer.phase("sparse_mine"):
        if dev.type == "cpu":
            emitted = sparse.sparse_rule_rows(
                mined.playlist_rows, mined.track_ids, **shape,
                min_count=min_count, k_max=cfg.k_max_consequents,
                long_basket_threshold=thr,
            )
            if emitted is not None:
                return rules.assemble_rule_tensors(
                    *emitted, n_tracks=mined.n_tracks, **emit
                )
            counts_host = sparse.sparse_pair_counts_np(
                mined.playlist_rows, mined.track_ids, **shape,
                long_basket_threshold=thr,
            )
            return rules.mine_rules_from_counts_np(counts_host, **emit)
        counts_dev = sparse.sparse_pair_counts_device(
            mined.playlist_rows, mined.track_ids, **shape,
            long_basket_threshold=thr, device=dev,
        )
        return rules.mine_rules_from_counts(counts_dev, **emit)
