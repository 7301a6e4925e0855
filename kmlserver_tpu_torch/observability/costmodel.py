"""Device cost attribution — counterpart of
``kmlserver_tpu/observability/costmodel.py``: per-kernel MFU and roofline,
memory accounting, and the serving path's unwarmed-dispatch counter.

- **Analytic cost specs** (:data:`KERNEL_COST_SPECS`): the reference's
  FLOPs(shape) and bytes-moved(shape) formulas, so the two packages
  attribute the same work to the same dispatch — except the pair count
  (``support_count``), which the port counts as its kernel computes it:
  one triangle of the symmetric result, read against the int8 tensor
  peak; the embedding lookup (``embed_topk``: the valid seeds); and the
  sparse ALS sweep (``als_sweep_sparse``: its segment sums' adds and
  bytes once, as ``kmls_bench/roofline/segsum.py`` counts them). They are leading-order counts (matmul 2·m·n·k, scatter/compare
  work, top-k ~ n·log2(k)), not instrumented truth; with the timings the
  serving and mining paths already take they give achieved FLOP/s and
  bytes/s, MFU against the device's peak, and a roofline class.
- **Peak tables**: per-device dense peak FLOP/s and memory bytes/s, keyed
  by the device name (``torch.cuda.get_device_name``), overridable with
  ``KMLS_PEAK_FLOPS`` / ``KMLS_PEAK_BYTES_PER_S``, and the int8 tensor
  peak of the cards that publish one (elsewhere the FLOP/s peak stands).
- :class:`CostModel`: the serving-side accumulator. The engine calls
  :meth:`CostModel.observe_kernel` in ``finish()`` with each lookup's
  device seconds — on a card the CUDA events recorded around its
  launches on its stream, read after the lookup's own fence; on the CPU
  the synchronous call's time — and the dispatch shape; ``/metrics``
  renders ``kmls_kernel_device_seconds{kernel}`` and friends from it. Its
  :class:`CompileWatcher` is the port's counterpart of the reference's
  jit-cache watch: PyTorch has no jit cache, so
  ``kmls_compiles_total{kernel="serve_rules"}`` counts dispatches of a
  (batch, length) bucket the publication did not warm — the same
  "never pay a first-shape cost inside a request" invariant — banked
  across re-publications. Memory gauges read ``torch.cuda.memory_stats``
  and ``mem_get_info``.

Zero cost when disabled (``KMLS_COSTMODEL=0``): the engine holds no
CostModel and every call site is one ``is not None`` check; the
module-level :data:`OBSERVATIONS_TOTAL` counter proves it.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Callable

import torch

# module-level observation counter: must never move while
# KMLS_COSTMODEL=0 (a disabled engine holds no CostModel). Benign
# GIL-coalesced increments, diagnostics only.
OBSERVATIONS_TOTAL = 0

PEAK_FLOPS_ENV = "KMLS_PEAK_FLOPS"
PEAK_BYTES_ENV = "KMLS_PEAK_BYTES_PER_S"

# per-device dense peak (FLOP/s, memory bytes/s) by device-name substring,
# matched case-insensitively in order. The reference's convention: the
# published dense bf16 tensor peak (the kernels run int32/float32, so MFU
# reads as a lower bound) and the TPU rows as the reference has them. The
# H100 rows are NVIDIA's H100 Tensor Core GPU data sheet, dense bf16
# without sparsity: the PCIe card (matched first, on "h100 pcie") 756
# TFLOP/s over 2.0 TB/s, the SXM5 card ("NVIDIA H100 80GB HBM3") 989.4
# TFLOP/s over 3.35 TB/s. The CPU entry is a deliberately generous
# envelope, so achieved/peak stays below 1 on any host.
PEAK_TABLE: tuple[tuple[str, float, float], ...] = (
    ("h100 pcie", 756e12, 2.0e12),
    ("h100", 989.4e12, 3.35e12),
    ("v6", 918e12, 1640e9),   # v6e (Trillium)
    ("v5p", 459e12, 2765e9),
    ("v5", 197e12, 819e9),    # v5e / "v5 lite" (matched after v5p)
    ("v4", 275e12, 1200e9),
    ("v3", 123e12, 900e9),
    ("v2", 45e12, 700e9),
    ("cpu", 2e11, 1e11),
)

# the dense int8 tensor peak (ops/s) by device-name substring, matched in
# order, where the card publishes one: NVIDIA's H100 data sheet, without
# sparsity (PCIe 1,513 TOP/s, SXM5 1,979 TOP/s). A kernel whose spec reads
# the int8 peak falls back to the FLOP/s peak on any other device.
INT8_PEAK_TABLE: tuple[tuple[str, float], ...] = (
    ("h100 pcie", 1513e12),
    ("h100", 1979e12),
)


def device_kind(device: torch.device | str | None = None) -> str:
    """``"<platform> <device name>"`` of ``device`` (default: the first
    card, else the CPU) — the string the peak table is matched against."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda {torch.cuda.get_device_name(device)}"
    return device.type


def resolve_peaks(device: torch.device | str | None = None) -> tuple[float, float, str]:
    """→ ``(peak_flops, peak_bytes_per_s, source)``. The env knobs win;
    otherwise the table is keyed by the name of ``device`` (default: the
    first card, else the CPU)."""
    env_flops = os.getenv(PEAK_FLOPS_ENV)
    env_bytes = os.getenv(PEAK_BYTES_ENV)
    kind = ""
    if device is not None or not env_flops or not env_bytes:
        kind = device_kind(device)
    auto_source = f"auto:{kind.strip()}"
    lowered = kind.lower()
    for needle, table_flops, table_bw in PEAK_TABLE:
        if needle in lowered:
            flops, bw = table_flops, table_bw
            break
    else:
        flops, bw = PEAK_TABLE[-1][1], PEAK_TABLE[-1][2]
        auto_source = f"auto-default:{kind.strip()}"
    if env_flops:
        flops = float(env_flops)
    if env_bytes:
        bw = float(env_bytes)
    # name BOTH values' origins: with one knob set, the other side of the
    # ridge still comes from the table
    if env_flops and env_bytes:
        source = "env"
    elif env_flops or env_bytes:
        source = f"env+{auto_source}"
    else:
        source = auto_source
    return flops, bw, source


def resolve_int8_peak(device: torch.device | str | None = None) -> float | None:
    """The int8 tensor peak (ops/s) of ``device`` (default: the first
    card, else the CPU), or None where the table has none."""
    lowered = device_kind(device).lower()
    for needle, ops in INT8_PEAK_TABLE:
        if needle in lowered:
            return ops
    return None


def _log2k(k: float) -> float:
    """Comparison depth of a top-k pass, floored at 1."""
    return max(1.0, math.log2(max(float(k), 2.0)))


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """Analytic leading-order cost of one jitted kernel, as functions of
    its dispatch shape (a plain dims dict — missing dims default sanely
    so a partial caller still gets an order-of-magnitude number)."""

    name: str
    flops: Callable[[dict], float]
    bytes_moved: Callable[[dict], float]
    doc: str
    # the peak its MFU is read against: "flops" (the device's FLOP/s row)
    # or "int8" (the int8 tensor peak where the device has one)
    peak: str = "flops"


def _d(dims: dict, key: str, default: float = 1.0) -> float:
    return float(dims.get(key, default))


def _serve_flops(dims: dict) -> float:
    # gather + scatter-max over b·l·k_max candidate lanes (≈2 ops per
    # lane: compare + select), then top-k over the (b, v) score vector
    b, length, k_max = _d(dims, "b"), _d(dims, "l"), _d(dims, "k_max")
    v, k_best = _d(dims, "v"), _d(dims, "k_best", 10)
    return b * (2.0 * length * k_max + v * _log2k(k_best))


def _serve_bytes(dims: dict) -> float:
    # rule-row gather (ids+confs, 8 B/lane), the transient (b, v+1)
    # score vector written+read, seeds in, top-k out
    b, length, k_max = _d(dims, "b"), _d(dims, "l"), _d(dims, "k_max")
    v, k_best = _d(dims, "v"), _d(dims, "k_best", 10)
    return (
        b * length * (k_max * 8.0 + 4.0)
        + b * (v + 1.0) * 8.0
        + b * k_best * 8.0
    )


def _sharded_serve_flops(dims: dict) -> float:
    # per-shard work is the replicated kernel partitioned (same total),
    # plus the cross-shard merge: shards·k_best candidate lanes per row
    # rescattered + one more global top-k
    b, v = _d(dims, "b"), _d(dims, "v")
    shards, k_best = _d(dims, "shards"), _d(dims, "k_best", 10)
    return _serve_flops(dims) + b * (
        2.0 * shards * k_best + v * _log2k(k_best)
    )


def _sharded_serve_bytes(dims: dict) -> float:
    # adds the all_gather of (shards, b, k_best) partials (both tensors,
    # send+receive) and the merge pass's second (b, v+1) score vector
    b, v = _d(dims, "b"), _d(dims, "v")
    shards, k_best = _d(dims, "shards"), _d(dims, "k_best", 10)
    return _serve_bytes(dims) + 2.0 * shards * b * k_best * 8.0 + b * (
        v + 1.0
    ) * 8.0


def _mesh_serve_flops(dims: dict) -> float:
    # ONE gang member's share of the pod-spanning lookup: the sharded
    # kernel's per-shard half (1/shards of the candidate-lane gather,
    # one slab partial top-k at GLOBAL width) plus the coordinator-side
    # merge over the rank-stacked partials — peers' slab work runs on
    # peer processes and is attributed there
    b, length, k_max = _d(dims, "b"), _d(dims, "l"), _d(dims, "k_max")
    v, shards, k_best = _d(dims, "v"), _d(dims, "shards"), _d(dims, "k_best", 10)
    return b * (
        2.0 * length * k_max / max(shards, 1.0)
        + 2.0 * v * _log2k(k_best)
        + 2.0 * shards * k_best
    )


def _mesh_serve_bytes(dims: dict) -> float:
    # slab gather (1/shards of the rule lanes) + the partial and merge
    # passes' (b, v+1) score vectors + the gang exchange: the seed batch
    # sent to every peer and (shards-1) stacked (b, k_best) partials
    # received over DCN (or the simulation transport's sockets)
    b, length, k_max = _d(dims, "b"), _d(dims, "l"), _d(dims, "k_max")
    v, shards, k_best = _d(dims, "v"), _d(dims, "shards"), _d(dims, "k_best", 10)
    return (
        b * length * (k_max * 8.0 / max(shards, 1.0) + 4.0)
        + 2.0 * b * (v + 1.0) * 8.0
        + (shards - 1.0) * b * (k_best * 8.0 + length * 4.0)
        + b * k_best * 8.0
    )


def _embed_flops(dims: dict) -> float:
    # each valid seed scores every item: r multiply-adds an item
    # (2·v·r); padded slots cost nothing (ops/csrc/embed_topk.cu). Without
    # a ``valid`` count every one of the b·l slots is taken as valid
    b, length, v = _d(dims, "b"), _d(dims, "l"), _d(dims, "v")
    valid = _d(dims, "valid", b * length)
    return 2.0 * valid * v * _d(dims, "r")


def _embed_bytes(dims: dict) -> float:
    # the factor matrix read once + the seeds + each row's k_best ids and
    # similarities
    b, length, v = _d(dims, "b"), _d(dims, "l"), _d(dims, "v")
    r, k_best = _d(dims, "r"), _d(dims, "k_best", 10)
    return v * r * 4.0 + b * (length * 4.0 + k_best * 8.0)


def _als_flops(dims: dict) -> float:
    # per iteration: two big×skinny matmuls (X F and Xᵀ U, 2·p·v·r
    # each), two rank² Gramians, two batched normal-equation solves
    p, v, r = _d(dims, "p"), _d(dims, "v"), _d(dims, "r")
    iters = _d(dims, "iters")
    return iters * (
        4.0 * p * v * r + 2.0 * r * r * (p + v) + 2.0 * r * r * r
    )


def _als_bytes(dims: dict) -> float:
    # X (f32) streamed twice per iteration + both factor matrices
    # read/written per half-sweep
    p, v, r = _d(dims, "p"), _d(dims, "v"), _d(dims, "r")
    iters = _d(dims, "iters")
    return iters * (2.0 * p * v * 4.0 + 4.0 * r * (p + v) * 4.0)


def _support_flops(dims: dict) -> float:
    # C = XᵀX over v tracks and p playlists, the work the result needs: one
    # triangle of the symmetric result with its diagonal, v(v+1)/2 dot
    # products of p terms, two operations each, whatever the route runs.
    # The popcount kernel computes just that; the dense route's int8 gram
    # and the ring compute the whole square, so there the figure (and the
    # MFU read from it) is the useful half of what they run. The reference
    # counts the whole square, 2·p·v².
    p, v = _d(dims, "p"), _d(dims, "v")
    return v * (v + 1.0) / 2.0 * p * 2.0


def _support_bytes(dims: dict) -> float:
    # int8 one-hot read (both operands of the symmetric contraction) +
    # the int32 count matrix out
    p, v = _d(dims, "p"), _d(dims, "v")
    return 2.0 * p * v + v * v * 4.0


def _recount_flops(dims: dict) -> float:
    # C[R, :] = X[:, R]ᵀ X — the row slice of the same contraction
    p, v, rows = _d(dims, "p"), _d(dims, "v"), _d(dims, "rows")
    return 2.0 * p * rows * v


def _recount_bytes(dims: dict) -> float:
    p, v, rows = _d(dims, "p"), _d(dims, "v"), _d(dims, "rows")
    return p * v + p * rows + rows * v * 4.0


def _sparse_count_flops(dims: dict) -> float:
    # one mirrored add per expanded pair event (2·E accumulates) plus
    # the O(nnz) expansion arithmetic itself — nnz-proportional, the
    # dense p·v² term is exactly what this kernel does NOT pay
    events, nnz = _d(dims, "events"), _d(dims, "nnz")
    return 2.0 * events + 4.0 * nnz


def _sparse_count_bytes(dims: dict) -> float:
    # expanded keys written+sorted+read (~12 B/event over the hybrid's
    # chunks), the membership indices in, the (v, v) int32 counts out
    events, nnz, v = _d(dims, "events"), _d(dims, "nnz"), _d(dims, "v")
    return 12.0 * events + 8.0 * nnz + v * v * 4.0


def _sparse_als_flops(dims: dict) -> float:
    # per iteration: two segment sums over the nnz events (X is 0/1, so a
    # product is one add per event and column: nnz·r each, where the
    # reference counts a multiply-add, 2·nnz·r), two rank² Gramians, two
    # batched solves
    nnz, p, v, r = _d(dims, "nnz"), _d(dims, "p"), _d(dims, "v"), _d(dims, "r")
    iters = _d(dims, "iters")
    return iters * (
        2.0 * nnz * r + 2.0 * r * r * (p + v) + 2.0 * r * r * r
    )


def _sparse_als_bytes(dims: dict) -> float:
    # per iteration, each segment sum's inputs read once and output written
    # once (kmls_bench/roofline/segsum.py): the int32 gather indices and the
    # int64 row offsets of both orderings, and both factor matrices read and
    # written per half-sweep. The gathered rows (8·nnz·r: the reference
    # counts them) are traffic a cache may save, not least work.
    nnz, p, v, r = _d(dims, "nnz"), _d(dims, "p"), _d(dims, "v"), _d(dims, "r")
    iters = _d(dims, "iters")
    return iters * (
        8.0 * nnz + 8.0 * (p + v + 2.0) + 16.0 * r * (p + v)
    )


# The reference's registry, every formula but ``support_count``'s,
# ``embed_topk``'s and ``als_sweep_sparse``'s unchanged. The serving engine
# observes ``serve_rules`` /
# ``serve_sharded`` / ``serve_mesh`` / ``serve_native`` and ``embed_topk``;
# the job's telemetry attributes ``support_count`` or ``sparse_count`` to
# the mine phase, ``als_sweep`` or ``als_sweep_sparse`` to the embed phase
# and ``delta_recount`` to a delta generation.
KERNEL_COST_SPECS: dict[str, CostSpec] = {
    "serve_rules": CostSpec(
        "serve_rules", _serve_flops, _serve_bytes,
        "replicated rule scatter-max + top-k (ops/serve.py "
        "recommend_batch; dims b, l, k_max, v, k_best)",
    ),
    "serve_sharded": CostSpec(
        "serve_sharded", _sharded_serve_flops, _sharded_serve_bytes,
        "vocab-sharded lookup + all_gather max-merge (ops/serve.py "
        "sharded_recommend_fn; dims + shards)",
    ),
    "serve_mesh": CostSpec(
        "serve_mesh", _mesh_serve_flops, _mesh_serve_bytes,
        "pod-spanning gang lookup: local slab partial + rank-stacked "
        "merge (ops/serve.py shard_partial_topk/merge_partial_topk via "
        "serving/mesh.py; dims + shards)",
    ),
    "serve_native": CostSpec(
        "serve_native", _serve_flops, _serve_bytes,
        "native host scatter-max kernel — identical algorithm to "
        "serve_rules, measured against host peaks",
    ),
    "embed_topk": CostSpec(
        "embed_topk", _embed_flops, _embed_bytes,
        "embedding cosine top-k (ops/embed.py embed_topk; dims b, l, "
        "valid, v, r, k_best: the valid seeds' products, the factors "
        "read once)",
    ),
    "als_sweep": CostSpec(
        "als_sweep", _als_flops, _als_bytes,
        "ALS half-sweeps, full training loop (mining/als.py; dims p, "
        "v, r, iters)",
    ),
    "support_count": CostSpec(
        "support_count", _support_flops, _support_bytes,
        "pair-support contraction C = XᵀX on the int8 tensor cores, "
        "counted as the one triangle the result needs on every route "
        "(ops/popcount.py computes that; ops/support.py's dense gram and "
        "parallel/support.py's ring compute the whole square; dims p, v)",
        peak="int8",
    ),
    "delta_recount": CostSpec(
        "delta_recount", _recount_flops, _recount_bytes,
        "delta restricted recount C[R, :] (parallel/support."
        "restricted_pair_counts; dims p, v, rows)",
    ),
    "sparse_count": CostSpec(
        "sparse_count", _sparse_count_flops, _sparse_count_bytes,
        "sparse CSR×bitpacked pair-support hybrid (ops/sparse.py "
        "sparse_pair_counts_np/_device; dims events, nnz, v)",
    ),
    "als_sweep_sparse": CostSpec(
        "als_sweep_sparse", _sparse_als_flops, _sparse_als_bytes,
        "ALS half-sweeps over the compressed interaction matrix "
        "(mining/als.py _train_sparse; dims nnz, p, v, r, iters)",
    ),
}


def phase_cost(kernel: str, **dims) -> tuple[float, float]:
    """Analytic ``(flops, bytes_moved)`` for one kernel invocation — the
    mining side's per-phase attribution (jobmetrics) and the bench's
    expected-work numerator both read this, so the serving and batch
    attributions can never use different formulas."""
    spec = KERNEL_COST_SPECS[kernel]
    return spec.flops(dims), spec.bytes_moved(dims)


def classify_roofline(
    flops: float, bytes_moved: float, peak_flops: float, peak_bytes_s: float
) -> str:
    """→ ``"compute"`` | ``"bandwidth"``: arithmetic intensity
    (flops/byte) vs the ridge point (peak_flops / peak_bytes_per_s).
    At or above the ridge the kernel can saturate the MXU; below it the
    memory system is the ceiling and MFU is bounded by
    intensity · peak_bw / peak_flops."""
    intensity = flops / max(bytes_moved, 1.0)
    ridge = peak_flops / max(peak_bytes_s, 1.0)
    return "compute" if intensity >= ridge else "bandwidth"


class CompileWatcher:
    """Per-kernel first-shape counters snapshotted at publication; growth
    afterwards is a first-shape cost paid inside a request, exported as
    ``kmls_compiles_total{kernel}``. The reference watches jit-cache sizes;
    the port watches a zero-arg probe returning a monotonic count (the
    engine's unwarmed dispatches). A re-publication banks the running
    count and re-snapshots, so the counter stays monotonic and counts only
    what landed outside a publication."""

    def __init__(self):
        self._fns: dict[str, Callable[[], int]] = {}
        self._base: dict[str, int] = {}
        self._accum: dict[str, int] = {}

    @staticmethod
    def _size(fn) -> int:
        try:
            return int(fn())
        except Exception:
            return 0

    def watch(self, kernel: str, fn: Callable[[], int] | None) -> None:
        """Track ``fn``'s count under ``kernel``. First sight snapshots the
        current value, so counts that predate watching are never billed."""
        if fn is None:
            return
        if self._fns.get(kernel) is not fn:
            self._fns[kernel] = fn
            self._base[kernel] = self._size(fn)
            self._accum.setdefault(kernel, 0)

    def note_prepublish(self) -> None:
        """Call BEFORE a (re)publication's warm-up: growth since the last
        snapshot was paid inside requests — bank it — and re-baseline."""
        for kernel, fn in self._fns.items():
            cur = self._size(fn)
            self._accum[kernel] = self._accum.get(kernel, 0) + max(
                0, cur - self._base.get(kernel, cur)
            )
            self._base[kernel] = cur

    def mark_published(self) -> None:
        """Call AFTER warm-up: re-snapshot WITHOUT banking — everything
        since :meth:`note_prepublish` was the publication warming up."""
        for kernel, fn in self._fns.items():
            self._base[kernel] = self._size(fn)

    def compiles(self) -> dict[str, int]:
        """kernel → growth since its last publication snapshot, plus
        everything banked across earlier publications."""
        out: dict[str, int] = {}
        for kernel, fn in self._fns.items():
            cur = self._size(fn)
            out[kernel] = self._accum.get(kernel, 0) + max(
                0, cur - self._base.get(kernel, cur)
            )
        return out


class CostModel:
    """Per-kernel device-time/FLOPs/bytes accumulator + the first-shape
    watcher + publish-time memory accounting. One per engine; the app
    renders it into ``/metrics``. Observation is completion-side only: one
    dict update under a private lock."""

    def __init__(
        self, peak_flops: float = 0.0, peak_bytes_s: float = 0.0,
        device: torch.device | str | None = None,
    ):
        # an explicit FLOP/s peak stands for every precision; otherwise the
        # device's int8 row, else its FLOP/s peak
        int8 = None if peak_flops > 0 else resolve_int8_peak(device)
        if peak_flops > 0 and peak_bytes_s > 0:
            self.peak_flops, self.peak_bytes_s = peak_flops, peak_bytes_s
            self.peak_source = "explicit"
        else:
            resolved_flops, resolved_bw, resolved_src = resolve_peaks(device)
            self.peak_flops = peak_flops if peak_flops > 0 else resolved_flops
            self.peak_bytes_s = peak_bytes_s if peak_bytes_s > 0 else resolved_bw
            self.peak_source = (
                f"explicit+{resolved_src}"
                if (peak_flops > 0 or peak_bytes_s > 0)
                else resolved_src
            )
        if int8 is None or os.getenv(PEAK_FLOPS_ENV):
            int8 = self.peak_flops
        self.peak_int8_ops = int8
        self._lock = threading.Lock()
        # kernel -> [device_s, flops, bytes, dispatches]
        self._kernels: dict[str, list[float]] = {}
        # dispatches naming a kernel with no registered spec: kept serving
        # (a zero-flop observation) but counted
        self.unspecced: dict[str, int] = {}
        self.observations = 0
        self.compile_watcher = CompileWatcher()
        # ---- publish-time memory accounting (engine-fed) ----
        self.tensor_bytes: dict[str, int] = {}  # artifact -> bytes (total)
        self.budget_bytes = 0
        self.n_shards = 1
        self.publish_watermark_bytes = 0

    # ---------- observation (completion path) ----------

    def observe_kernel(self, kernel: str, device_s: float, **dims) -> None:
        """Fold one timing into the per-kernel totals. ``device_s`` is the
        lookup's time on its stream, from its first launch's start to its
        last copy's end (the gaps between its launches included), so the
        derived MFU is a lower bound on what its kernels achieve."""
        global OBSERVATIONS_TOTAL
        OBSERVATIONS_TOTAL += 1  # benign race: the zero-cost proof counter
        spec = KERNEL_COST_SPECS.get(kernel)
        if spec is None:
            with self._lock:
                self.unspecced[kernel] = self.unspecced.get(kernel, 0) + 1
                entry = self._kernels.setdefault(kernel, [0.0, 0.0, 0.0, 0])
                entry[0] += max(device_s, 0.0)
                entry[3] += 1
                self.observations += 1
            return
        flops = spec.flops(dims)
        moved = spec.bytes_moved(dims)
        with self._lock:
            entry = self._kernels.setdefault(kernel, [0.0, 0.0, 0.0, 0])
            entry[0] += max(device_s, 0.0)
            entry[1] += flops
            entry[2] += moved
            entry[3] += 1
            self.observations += 1

    # ---------- first-shape telemetry ----------

    def watch_compiles(self, kernel: str, fn: Callable[[], int] | None) -> None:
        self.compile_watcher.watch(kernel, fn)

    def note_prepublish(self) -> None:
        self.compile_watcher.note_prepublish()

    def mark_published(self) -> None:
        self.compile_watcher.mark_published()

    def compiles_post_publish(self) -> dict[str, int]:
        return self.compile_watcher.compiles()

    # ---------- memory accounting ----------

    def note_publish(
        self,
        tensor_bytes: dict[str, int],
        budget_bytes: int,
        n_shards: int = 1,
        watermark_bytes: int = 0,
    ) -> None:
        """Publish-time snapshot from the engine: per-artifact tensor
        bytes, the per-device budget, and the live bytes-in-use
        watermark."""
        with self._lock:
            self.tensor_bytes = dict(tensor_bytes)
            self.budget_bytes = int(budget_bytes)
            self.n_shards = max(1, int(n_shards))
            self.publish_watermark_bytes = int(watermark_bytes)

    def headroom_bytes(self) -> int:
        """Budget minus the per-device tensor residency."""
        with self._lock:
            return self.budget_bytes - sum(self.tensor_bytes.values()) // self.n_shards

    # ---------- derived stats ----------

    def kernel_stats(self) -> dict[str, dict]:
        """kernel → {device_s, dispatches, flops, bytes, flops_per_s,
        bytes_per_s, mfu, roofline} (rates 0 while no time observed)."""
        with self._lock:
            snap = {k: list(v) for k, v in self._kernels.items()}
        out: dict[str, dict] = {}
        for kernel, (device_s, flops, moved, n) in snap.items():
            flops_s = flops / device_s if device_s > 0 else 0.0
            bytes_s = moved / device_s if device_s > 0 else 0.0
            spec = KERNEL_COST_SPECS.get(kernel)
            peak = self.peak_int8_ops if spec is not None and spec.peak == "int8" else self.peak_flops
            out[kernel] = {
                "device_s": device_s,
                "dispatches": n,
                "flops": flops,
                "bytes": moved,
                "flops_per_s": flops_s,
                "bytes_per_s": bytes_s,
                # not clamped (the reference clamps at 1): a reading above 1
                # says the formula overcounts the work or the time misses
                # part of it
                "mfu": flops_s / peak if peak > 0 else 0.0,
                "roofline": classify_roofline(flops, moved, peak, self.peak_bytes_s),
            }
        return out

    def summary(self) -> dict:
        """Peaks, per-kernel stats, first-shape counts, memory accounting."""
        return {
            "peak_flops": self.peak_flops,
            "peak_bytes_per_s": self.peak_bytes_s,
            "peak_source": self.peak_source,
            "observations": self.observations,
            "kernels": self.kernel_stats(),
            "compiles_post_publish": self.compiles_post_publish(),
            "unspecced": dict(self.unspecced),
            "tensor_bytes": dict(self.tensor_bytes),
            "budget_bytes": self.budget_bytes,
            "headroom_bytes": self.headroom_bytes(),
            "publish_watermark_bytes": self.publish_watermark_bytes,
        }

    # ---------- exposition ----------

    @staticmethod
    def device_memory_lines() -> list[str]:
        """Live per-card gauges (``kmls_device_bytes_in_use`` from
        ``torch.cuda.memory_stats``, ``kmls_device_bytes_limit`` from
        ``mem_get_info``) for the cards this process has initialised; no
        lines on the CPU, as the reference renders none there."""
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return []
        in_use: list[str] = []
        limit: list[str] = []
        for i in range(torch.cuda.device_count()):
            try:
                used = torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0)
                _free, cap = torch.cuda.mem_get_info(i)
            except RuntimeError:
                continue
            in_use.append(f'kmls_device_bytes_in_use{{device="{i}"}} {int(used)}')
            limit.append(f'kmls_device_bytes_limit{{device="{i}"}} {int(cap)}')
        lines: list[str] = []
        if in_use:
            lines.append("# TYPE kmls_device_bytes_in_use gauge")
            lines += in_use
        if limit:
            lines.append("# TYPE kmls_device_bytes_limit gauge")
            lines += limit
        return lines

    def render_lines(self) -> list[str]:
        """The cost-attribution block of ``/metrics``; every series is in
        ``serving.metrics.METRIC_REGISTRY``."""
        stats = self.kernel_stats()
        compiles = self.compiles_post_publish()
        lines = [
            "# TYPE kmls_costmodel_observations_total counter",
            f"kmls_costmodel_observations_total {self.observations}",
        ]
        if stats:
            blocks: list[tuple[str, str, Callable[[dict], str]]] = [
                ("kmls_kernel_device_seconds", "counter", lambda s: f"{s['device_s']:.6f}"),
                ("kmls_kernel_dispatches_total", "counter", lambda s: str(s["dispatches"])),
                ("kmls_kernel_flops_per_second", "gauge", lambda s: f"{s['flops_per_s']:.6g}"),
                ("kmls_kernel_bytes_per_second", "gauge", lambda s: f"{s['bytes_per_s']:.6g}"),
                ("kmls_mfu", "gauge", lambda s: f"{s['mfu']:.6g}"),
                ("kmls_kernel_compute_bound", "gauge",
                 lambda s: str(int(s["roofline"] == "compute"))),
            ]
            for name, mtype, value_of in blocks:
                lines.append(f"# TYPE {name} {mtype}")
                for kernel in sorted(stats):
                    lines.append(f'{name}{{kernel="{kernel}"}} {value_of(stats[kernel])}')
        if compiles:
            lines.append("# TYPE kmls_compiles_total counter")
            for kernel in sorted(compiles):
                lines.append(f'kmls_compiles_total{{kernel="{kernel}"}} {compiles[kernel]}')
        with self._lock:
            unspecced_total = sum(self.unspecced.values())
            tensor_bytes = dict(self.tensor_bytes)
            budget = self.budget_bytes
            watermark = self.publish_watermark_bytes
        lines += [
            "# TYPE kmls_costmodel_unspecced_total counter",
            f"kmls_costmodel_unspecced_total {unspecced_total}",
        ]
        if tensor_bytes:
            lines.append("# TYPE kmls_model_tensor_bytes gauge")
            for artifact in sorted(tensor_bytes):
                lines.append(
                    f'kmls_model_tensor_bytes{{artifact="{artifact}"}} {tensor_bytes[artifact]}'
                )
            lines += [
                "# TYPE kmls_device_budget_bytes gauge",
                f"kmls_device_budget_bytes {budget}",
                "# TYPE kmls_device_headroom_bytes gauge",
                f"kmls_device_headroom_bytes {self.headroom_bytes()}",
                "# TYPE kmls_publish_watermark_bytes gauge",
                f"kmls_publish_watermark_bytes {watermark}",
            ]
        lines += self.device_memory_lines()
        return lines


def device_watermark_bytes(device: torch.device | str | None = None) -> int:
    """Bytes the caching allocator has handed out on ``device`` (default:
    the first card), or 0 on the CPU — the publish-time watermark."""
    if device is None:
        if not torch.cuda.is_available():
            return 0
        device = "cuda"
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return int(torch.cuda.memory_allocated(device))
