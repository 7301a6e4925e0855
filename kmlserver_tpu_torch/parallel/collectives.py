"""The collectives of one mesh axis, on the tensors' own device.

The reference's ``shard_map`` programs use ``psum``, ``all_gather`` and
``ppermute`` over a mesh axis (``kmlserver_tpu/parallel/support.py:73-118``,
``kmlserver_tpu/mining/als.py:258-323``). Here an axis is a
:class:`~.mesh.Axis`: its ranks in grid order and their process group.

The backend of the axis's group decides where the bytes travel, never a
caught error. The all-reduce takes CUDA tensors under both backends (gloo
reduces them itself). NCCL takes CUDA tensors for every collective; gloo
has no send, receive or all-gather of CUDA tensors, so under gloo those
stage a CUDA tensor through a host copy and copy the result back, in
pieces of at most :data:`GLOO_PIECE` elements (gloo's buffers are sized
in 32-bit counts in places, and a vocab block at the scale shape holds
4·10⁹ bytes). A one-rank axis runs no collective at all.

Every gather returns the blocks in the axis's grid order (torch numbers a
group's ranks in ascending order, which a hybrid mesh's column need not
follow). :func:`sum_in_order` adds floats in that order on every rank, so
each rank holds the same bits whatever the backend's reduction order.
"""

from __future__ import annotations

import torch

from .mesh import Axis

# elements per gloo call when a host tensor is staged
GLOO_PIECE = 1 << 28


def _dist():
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh axis of several ranks needs the distributed runtime "
            "(parallel.distributed.maybe_initialize)"
        )
    return dist


def staged(t: torch.Tensor, axis: Axis) -> bool:
    """True when ``t`` travels through the host for a gather, send or
    receive: a CUDA tensor over gloo."""
    return t.is_cuda and _dist().get_backend(axis.group) == "gloo"


def _pieces(n: int):
    return ((lo, min(lo + GLOO_PIECE, n)) for lo in range(0, n, GLOO_PIECE))


def all_reduce_sum_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``t`` over the axis in place (exact for integer counts): the
    reference's ``psum``, and the bit-packed count's sum over the
    flattened mesh."""
    if axis.size == 1:
        return t
    dist = _dist()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
    return t


def all_gather_cat(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all) joined along dim 0 in grid
    order, on ``t``'s device: the reference's tiled ``all_gather``."""
    if axis.size == 1:
        return t
    dist = _dist()
    t = t.contiguous()
    n = axis.size
    order = sorted(axis.ranks)
    if staged(t, axis) or not t.is_cuda:
        flat = t.cpu().view(-1)
        out = torch.empty((n, flat.numel()), dtype=t.dtype)
        for lo, hi in _pieces(flat.numel()):
            dist.all_gather([out[i, lo:hi] for i in range(n)], flat[lo:hi], group=axis.group)
        out = out.view(n * t.shape[0], *t.shape[1:])
    else:
        out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=axis.group)
    if order != list(axis.ranks):
        blocks = out.chunk(n)
        out = torch.cat([blocks[order.index(r)] for r in axis.ranks])
    return out.to(t.device)


def shift(block: torch.Tensor, out: torch.Tensor, axis: Axis) -> torch.Tensor:
    """One step of the ring (the reference's ``ppermute`` ``j → j+1``):
    send ``block`` to the next rank of the axis and receive the previous
    rank's into ``out``. Ranks at even positions send first and ranks at
    odd ones receive first, so the blocking pairs never wait on each other
    in a cycle, for any axis size and either backend."""
    dist = _dist()
    me = axis.ranks.index(dist.get_rank())
    nxt = axis.ranks[(me + 1) % axis.size]
    prev = axis.ranks[(me - 1) % axis.size]
    via_host = staged(block, axis) or not block.is_cuda
    send = block.cpu().contiguous() if via_host else block.contiguous()
    recv = torch.empty(out.shape, dtype=out.dtype) if via_host else out
    pieces = list(_pieces(send.numel())) if via_host else [(0, send.numel())]
    send, recv_flat = send.view(-1), recv.view(-1)
    for lo, hi in pieces:
        if me % 2 == 0:
            dist.send(send[lo:hi], nxt, group=axis.group)
            dist.recv(recv_flat[lo:hi], prev, group=axis.group)
        else:
            dist.recv(recv_flat[lo:hi], prev, group=axis.group)
            dist.send(send[lo:hi], nxt, group=axis.group)
    if recv is not out:
        out.copy_(recv)
    return out


def add_in_order(parts) -> torch.Tensor:
    """``parts`` summed one after another, first to last."""
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    return total


def sum_in_order(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The axis's ``t`` summed in grid order, the same bits on every rank:
    the float reduction of the sharded ALS sweep."""
    if axis.size == 1:
        return t
    return add_in_order(all_gather_cat(t.unsqueeze(0), axis))
