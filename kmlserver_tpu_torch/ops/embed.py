"""The embedding lookup: cosine top-k over the item factors.

Counterpart of ``kmlserver_tpu/ops/embed.py::_embed_topk_impl``
(``:46-87``), which the reference leaves to XLA. The seeds' unit item
vectors are scored against every item by dot product (cosine similarity:
the factors are row-normalized at publication), max-merged over the seed
slots, the seeds themselves masked out, and the top k extracted:

- ``-1``-padded seed slots contribute nothing; a row with no valid seed
  returns all ``-1``;
- ties keep the lowest index first, as ``jax.lax.top_k`` does. Ties are
  common: tracks with identical membership columns solve to
  bitwise-identical factor rows.

:func:`embed_topk` is the one entry point. A CUDA tensor launches the
hand-written kernel ``ops/csrc/embed_topk.cu`` or raises: one scoring pass
that scores only the valid seeds, max-merges and masks in registers and
keeps each block's best k, then a merge pass to the row's k; no (B, V)
score matrix in device memory. A ``k_best`` above :data:`TOPK_CAPACITY`
(only the eval and serving k knobs ask for one) takes the sort route
instead: the same scoring pass writes the masked (B, V) scores and a
stable sort selects (:func:`topk_route`). A CPU tensor takes
:func:`embed_topk_plain`, the torch-op version. Calls count in
``LAUNCHES``: ``embed_topk`` every kernel call, ``embed_topk_sort_route``
those that took the sort route.

Full fp32 on both: the kernel's multiply-adds run on the CUDA cores, the
plain version's products with TF32 off (PyTorch's default for ``matmul``);
TF32 would move the similarities by about 1e-3. The two sum in another
order: their similarities agree within :data:`SIM_TOL`, and where the
scores agree bit for bit (dyadic factors) so do the ids, tie order
included.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# large-but-finite floor instead of -inf: masked lanes stay out of every
# max without breeding NaNs (the kernel's kNeg)
NEG = -3.0e38

# the kernel against the plain version: fp32 sums of R products in another
# order, for unit vectors
SIM_TOL = 1e-6

# the largest k_best of the fused selection (the kernel's kCapacity): each
# scoring block keeps a k-long list a row and the merge takes k rounds
TOPK_CAPACITY = 128

# the largest rank the kernel holds in registers (the kernel's RP)
MAX_RANK = 128

# kernel calls, counted by the wrapper where it launches
LAUNCHES = {"embed_topk": 0, "embed_topk_sort_route": 0}


def topk_route(k_best: int) -> str:
    """The kernel's route for ``k_best``: ``"fused"`` (selection on the
    card) up to :data:`TOPK_CAPACITY`, ``"sort"`` above it."""
    return "fused" if k_best <= TOPK_CAPACITY else "sort"


def _select_sorted(scores: torch.Tensor, k_best: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked ``(B, V)`` scores → the top ``k_best`` by a stable descending
    sort (``torch.topk`` promises no tie order), ``-1`` / ``0`` past the
    valid scores."""
    v = scores.shape[1]
    k = min(k_best, v)
    top_sims, top_ids = torch.sort(scores, dim=1, descending=True, stable=True)
    top_sims, top_ids = top_sims[:, :k], top_ids[:, :k].to(torch.int32)
    valid = top_sims > NEG / 2
    top_ids = torch.where(valid, top_ids, torch.full_like(top_ids, -1))
    top_sims = torch.where(valid, top_sims, torch.zeros_like(top_sims))
    if k < k_best:  # callers always see k_best columns
        pad = k_best - k
        top_ids = torch.nn.functional.pad(top_ids, (0, pad), value=-1)
        top_sims = torch.nn.functional.pad(top_sims, (0, pad), value=0.0)
    return top_ids, top_sims


def embed_topk_plain(
    item_factors: torch.Tensor, seed_ids: torch.Tensor, *, k_best: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version in torch ops: per seed slot a ``(B, R) @ (R, V)``
    product and a running max (live memory O(B·V), never O(B·L·V)), the
    seeds masked through a spill column V as in the reference, then
    :func:`_select_sorted`."""
    v = item_factors.shape[0]
    b = seed_ids.shape[0]
    seeds = seed_ids.to(torch.int64)
    valid_seed = seeds >= 0
    safe = torch.where(valid_seed, seeds, torch.zeros_like(seeds))
    # NEG enters as a Python scalar or a fill, never as torch.tensor(...,
    # device=...): that copy from pageable host memory would synchronize
    # the host with the card on every dispatch
    running = torch.full((b, v), NEG, dtype=item_factors.dtype, device=item_factors.device)
    factors_t = item_factors.t()
    for slot in range(seeds.shape[1]):
        sims = item_factors[safe[:, slot]] @ factors_t  # (B, V)
        sims = torch.where(valid_seed[:, slot, None], sims, NEG)
        torch.maximum(running, sims, out=running)
    # mask the seeds out of their own candidates; padding lands in column V
    pad = torch.full((b, 1), NEG, dtype=item_factors.dtype, device=item_factors.device)
    scores = torch.cat([running, pad], dim=1)
    targets = torch.where(valid_seed, seeds, torch.full_like(seeds, v))
    scores.scatter_(1, targets, NEG)
    return _select_sorted(scores[:, :v], k_best)


def kernel_lib() -> ctypes.CDLL:
    from . import cuda_build

    lib = cuda_build.load("embed_topk")
    if lib.kmls_embed_topk.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.kmls_embed_topk.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32,
                                        i32, ptr]
        lib.kmls_embed_topk.restype = ctypes.c_int
        lib.kmls_embed_topk_plan.argtypes = [i64, i32, ctypes.POINTER(ctypes.c_int)]
        lib.kmls_embed_topk_plan.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def kernel_plan(v: int, rank: int) -> dict:
    """The kernel's plan for ``v`` items of rank ``rank``, as
    ``kmls_embed_topk_plan`` reports it: the padded rank, the items a
    scoring block's tile holds, the scoring blocks (the merge's lists)
    and the fused route's largest k."""
    plan = (ctypes.c_int * 4)()
    rc = kernel_lib().kmls_embed_topk_plan(v, rank, plan)
    if rc != 0:
        raise RuntimeError(f"kmls_embed_topk_plan failed: CUDA error {rc} (v {v}, rank {rank})")
    out = dict(zip(("padded_rank", "tile", "lists", "capacity"), plan))
    if out["capacity"] != TOPK_CAPACITY:
        raise RuntimeError(f"kernel capacity {out['capacity']} != TOPK_CAPACITY {TOPK_CAPACITY}")
    return out


def _embed_topk_cuda(
    item_factors: torch.Tensor, seed_ids: torch.Tensor, k_best: int
) -> tuple[torch.Tensor, torch.Tensor]:
    v, rank = item_factors.shape
    b, length = seed_ids.shape
    dev = item_factors.device
    if rank > MAX_RANK:
        raise ValueError(f"rank {rank} above the kernel's {MAX_RANK}")
    if b == 0 or k_best == 0 or v == 0 or length == 0:
        return (torch.full((b, k_best), -1, dtype=torch.int32, device=dev),
                torch.zeros((b, k_best), dtype=torch.float32, device=dev))
    plan = kernel_plan(v, rank)
    lib = kernel_lib()
    sort = topk_route(k_best) == "sort"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if sort:
            scores = torch.empty((b, v), dtype=torch.float32, device=dev)
            rc = lib.kmls_embed_topk(item_factors.data_ptr(), seed_ids.data_ptr(), None,
                                     scores.data_ptr(), None, None, v, rank, b, length, k_best,
                                     plan["lists"], stream)
        else:
            cand = torch.empty((b, plan["lists"], k_best), dtype=torch.int64, device=dev)
            top_ids = torch.empty((b, k_best), dtype=torch.int32, device=dev)
            top_sims = torch.empty((b, k_best), dtype=torch.float32, device=dev)
            rc = lib.kmls_embed_topk(item_factors.data_ptr(), seed_ids.data_ptr(),
                                     cand.data_ptr(), None, top_ids.data_ptr(),
                                     top_sims.data_ptr(), v, rank, b, length, k_best,
                                     plan["lists"], stream)
    if rc != 0:
        raise RuntimeError(
            f"embed_topk kernel launch failed: CUDA error {rc} "
            f"(factors {tuple(item_factors.shape)}, seeds {tuple(seed_ids.shape)}, k {k_best})"
        )
    LAUNCHES["embed_topk"] += 1
    if sort:
        LAUNCHES["embed_topk_sort_route"] += 1
        return _select_sorted(scores, k_best)
    return top_ids, top_sims


def embed_topk(
    item_factors: torch.Tensor, seed_ids: torch.Tensor, *, k_best: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``item_factors`` f32 (V, R) contiguous, ``seed_ids`` int32 (B, L)
    contiguous with -1 padding, on one device → ``(top_ids int32
    (B, k_best) -1-padded, top_sims f32 (B, k_best) 0-padded)``. A CUDA
    tensor launches the kernel (seed ids outside ``[0, V)`` count as
    padding there), a CPU tensor runs :func:`embed_topk_plain`."""
    if item_factors.dim() != 2 or seed_ids.dim() != 2:
        raise ValueError(f"factors {tuple(item_factors.shape)} must be (V, R) and seeds "
                         f"{tuple(seed_ids.shape)} (B, L)")
    if seed_ids.device != item_factors.device:
        raise ValueError(f"seeds on {seed_ids.device}, factors on {item_factors.device}")
    if item_factors.dtype != torch.float32:
        raise TypeError(f"item_factors must be float32, got {item_factors.dtype}")
    if seed_ids.dtype != torch.int32:
        raise TypeError(f"seed_ids must be int32, got {seed_ids.dtype}")
    if not (item_factors.is_contiguous() and seed_ids.is_contiguous()):
        raise ValueError("item_factors and seed_ids must be contiguous")
    if k_best < 0:
        raise ValueError(f"k_best {k_best} < 0")
    if item_factors.device.type == "cpu":
        return embed_topk_plain(item_factors, seed_ids, k_best=k_best)
    if item_factors.device.type != "cuda":
        raise ValueError(f"no embed_topk kernel for device {item_factors.device}")
    return _embed_topk_cuda(item_factors, seed_ids, k_best)
