"""Deterministic segment sums for the sparse ALS half-sweeps and loss.

    out[s, :] = Σ_{e : seg[e] = s} mat[gidx[e], :]

Counterpart of the reference's ``_sparse_accumulate``
(``kmlserver_tpu/mining/als.py:158-178``), which XLA lowers to a chunked
scatter-add. The reference promises that two trainings give bit-identical
factors (its embed checkpoint resume and the manifest sha256 rely on it);
``index_add_`` / ``scatter_add_`` on a CUDA tensor accumulate floats with
atomics in an order that changes from run to run, so the card runs a
hand-written kernel instead: ``ops/csrc/segsum.cu``, one persistent launch
that takes the rows longest first — a long row (at least
:data:`LONG_ROW_EVENTS` events) summed by a whole block through a
shared-memory gather ring, a short row by one warp — each lane summing its
column over the row's events in event order.

The events are handed over once per training as a :class:`Csr`: a stable
sort by segment (:func:`build_csr`), which keeps each row's events in
their original order, and the rows' schedule (lengths descending, ties by
row index; the count of long rows at its head). On a CUDA tensor
:func:`segment_sum` launches the kernel or raises; on a CPU tensor it runs
:func:`segment_sum_plain`, ``index_add_`` over the events in order — the
same additions in the same order per (row, column), so the kernel agrees
with it bit for bit. Launches count in ``LAUNCHES["segsum"]``: a sparse
training makes ``2·iters + 1`` (``X F`` and ``Xᵀ U`` a sweep, and the
loss's ``X F``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

# launches of the CUDA kernel, counted by the wrapper where it launches
LAUNCHES = {"segsum": 0}

# events per index_add_ call in the plain version: bounds the gathered
# (chunk, R) temporary; chunks run in event order, so the sum is unchanged
PLAIN_CHUNK = 1 << 20

# rows of at least this many events are summed by a whole block through the
# kernel's shared-memory ring, shorter ones by one warp each; set from the
# threshold sweep of ``chip_smoke.py`` phase 11 (c) on an H100 (PERF.md)
LONG_ROW_EVENTS = 2048


@dataclasses.dataclass(frozen=True)
class Csr:
    """Events grouped by output row: row ``s`` owns
    ``gidx[offsets[s]:offsets[s + 1]]``, in the events' original order."""

    offsets: torch.Tensor  # int64 (n_out + 1,)
    gidx: torch.Tensor  # int32 (nnz,), every entry in [0, n_in)
    n_in: int
    # the kernel's schedule: rows by length descending, ties by row index
    order: torch.Tensor  # int32 (n_out,), a permutation of [0, n_out)
    n_long: int  # rows at the head of ``order`` with >= LONG_ROW_EVENTS events
    longest: int = 0  # events of the longest row (its chain of adds)

    @property
    def n_out(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.gidx.shape[0]

    def segments(self) -> torch.Tensor:
        """int64 (nnz,) row of each event, in CSR order."""
        counts = self.offsets[1:] - self.offsets[:-1]
        return torch.repeat_interleave(
            torch.arange(self.n_out, device=self.offsets.device), counts
        )


def build_csr(seg: torch.Tensor, gidx: torch.Tensor, n_out: int, n_in: int) -> Csr:
    """Stable sort of the events ``(seg[e], gidx[e])`` by ``seg`` on their
    device, and one stable sort of the ``n_out`` row lengths for the
    schedule → :class:`Csr`. Raises ``ValueError`` on an id outside
    ``[0, n_out)`` / ``[0, n_in)``: the kernel reads unchecked."""
    if seg.shape != gidx.shape or seg.dim() != 1:
        raise ValueError(f"seg {tuple(seg.shape)} and gidx {tuple(gidx.shape)} must be equal 1-D")
    if seg.numel():
        lo_s, hi_s = int(seg.min()), int(seg.max())
        lo_g, hi_g = int(gidx.min()), int(gidx.max())
        if lo_s < 0 or hi_s >= n_out or lo_g < 0 or hi_g >= n_in:
            raise ValueError(
                f"segment ids in [{lo_s}, {hi_s}] / gather ids in [{lo_g}, {hi_g}] "
                f"outside [0, {n_out}) / [0, {n_in})"
            )
    seg64 = seg.to(torch.int64)
    order = torch.sort(seg64, stable=True).indices
    counts = torch.bincount(seg64, minlength=n_out)
    offsets = torch.zeros(n_out + 1, dtype=torch.int64, device=seg.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    rows = torch.sort(-counts, stable=True).indices.to(torch.int32)
    n_long, longest = (torch.stack([(counts >= LONG_ROW_EVENTS).sum(), counts.max()]).tolist()
                       if n_out else (0, 0))
    return Csr(offsets=offsets, gidx=gidx.to(torch.int32)[order].contiguous(), n_in=n_in,
               order=rows, n_long=n_long, longest=longest)


def segment_sum_plain(
    mat: torch.Tensor, seg: torch.Tensor, gidx: torch.Tensor, n_out: int
) -> torch.Tensor:
    """The plain version: ``index_add_`` of ``mat[gidx]`` into a zero
    ``(n_out, R)`` over the events in the order given, in chunks of
    :data:`PLAIN_CHUNK`. On the CPU ``index_add_`` adds in index order, so
    each (row, column) is the sequential fp32 sum of its events."""
    out = torch.zeros((n_out, mat.shape[1]), dtype=mat.dtype, device=mat.device)
    seg = seg.to(torch.int64)
    gidx = gidx.to(torch.int64)
    for lo in range(0, seg.shape[0], PLAIN_CHUNK):
        hi = lo + PLAIN_CHUNK
        out.index_add_(0, seg[lo:hi], mat[gidx[lo:hi]])
    return out


def kernel_lib() -> ctypes.CDLL:
    from . import cuda_build

    lib = cuda_build.load("segsum")
    if lib.kmls_segsum.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.kmls_segsum.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, ctypes.c_int, ptr]
        lib.kmls_segsum.restype = ctypes.c_int
        lib.kmls_segsum_plan.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.kmls_segsum_plan.restype = ctypes.c_int
    return lib


def kernel_plan(rank: int) -> dict:
    """The kernel's launch plan at ``rank`` on the current CUDA device (the
    ring's geometry and the grid), as ``kmls_segsum_plan`` reports it."""
    plan = (ctypes.c_int * 7)()
    rc = kernel_lib().kmls_segsum_plan(rank, plan)
    if rc != 0:
        raise RuntimeError(f"kmls_segsum_plan failed: CUDA error {rc}")
    keys = ("stage_events", "stages", "smem_bytes", "blocks_per_sm", "sms",
            "consumer_warps", "producer_warps")
    return dict(zip(keys, plan))


def segment_sum(mat: torch.Tensor, csr: Csr) -> torch.Tensor:
    """f32 ``(csr.n_out, R)`` segment sums of ``mat (csr.n_in, R)`` f32.
    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version over the CSR's events (bit-identical to the original order)."""
    if mat.dim() != 2 or mat.shape[0] != csr.n_in:
        raise ValueError(f"mat {tuple(mat.shape)} must be ({csr.n_in}, R)")
    if mat.dtype != torch.float32:
        raise TypeError(f"mat must be float32, got {mat.dtype}")
    if mat.device != csr.gidx.device or mat.device != csr.offsets.device or (
            mat.device != csr.order.device):
        raise ValueError(f"mat on {mat.device}, CSR on {csr.gidx.device}")
    if csr.order.dtype != torch.int32 or tuple(csr.order.shape) != (csr.n_out,):
        raise ValueError(f"order {csr.order.dtype} {tuple(csr.order.shape)} must be "
                         f"int32 ({csr.n_out},)")
    if not 0 <= csr.n_long <= csr.n_out:
        raise ValueError(f"n_long {csr.n_long} outside [0, {csr.n_out}]")
    if mat.device.type == "cpu":
        return segment_sum_plain(mat, csr.segments(), csr.gidx, csr.n_out)
    if mat.device.type != "cuda":
        raise ValueError(f"no segsum kernel for device {mat.device}")
    rank = mat.shape[1]
    if rank < 1:
        raise ValueError("rank must be at least 1")
    mat = mat.contiguous()
    out = torch.empty((csr.n_out, rank), dtype=torch.float32, device=mat.device)
    if csr.n_out == 0:
        return out
    lib = kernel_lib()
    counter = torch.zeros(1, dtype=torch.int32, device=mat.device)
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream(mat.device).cuda_stream
        rc = lib.kmls_segsum(
            mat.data_ptr(), csr.offsets.data_ptr(), csr.gidx.data_ptr(),
            csr.order.data_ptr(), out.data_ptr(), counter.data_ptr(),
            csr.n_out, csr.n_long, rank, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"segsum kernel launch failed: CUDA error {rc} "
            f"(mat {tuple(mat.shape)}, {csr.n_out} rows, {csr.nnz} events)"
        )
    LAUNCHES["segsum"] += 1
    return out
