"""The rank mesh — counterpart of ``kmlserver_tpu/parallel/mesh.py:22-57``.

The reference lays its JAX devices out on a 2-D ``(dp, tp)`` ``Mesh``. The
port runs one process per GPU, so its mesh is a ``(dp, tp)`` grid of the
world's RANKS with the reference's axis names, plus the process groups the
collectives of each axis run over:

- ``dp`` — data parallelism over the playlist axis: each rank counts its
  rows of baskets and the partial counts are summed with ``all_reduce``
  over its grid column (:meth:`RankMesh.axis` ``"dp"``);
- ``tp`` — the vocabulary axis: each rank of a grid row holds a block of
  the vocabulary's columns, which the dense sharded counts exchange with
  an all-gather or a ring of sends (``parallel/support.py``) and the
  vocab-sharded emission and ALS sweep split their rows over.

The bit-packed count shards the word axis over ``dp`` only and flattens
``tp`` onto ``dp`` (:meth:`RankMesh.flattened`, reference
``mining/miner.py:216-219``).
"""

from __future__ import annotations

import dataclasses

AXIS_DP = "dp"
AXIS_TP = "tp"


def parse_mesh_shape(shape: str) -> tuple[int, int]:
    """Parse ``"4x2"`` → ``(4, 2)`` = (dp, tp)."""
    parts = shape.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"mesh shape must be 'DPxTP', got {shape!r}")
    return int(parts[0]), int(parts[1])


@dataclasses.dataclass(frozen=True)
class Axis:
    """The ranks of one grid row (``tp``) or column (``dp``), in grid
    order, and their process group (None = the default group, or none
    needed: a one-rank axis runs no collective)."""

    ranks: tuple[int, ...]
    group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A ``(dp, tp)`` grid of ranks. ``group`` is the process group over
    the mesh's ranks that the flattened ``dp`` all-reduce uses (None = the
    default group, or no group at all in a single process); ``tp_groups``
    holds one group per grid row and ``dp_groups`` one per grid column
    (empty: none made, as for a mesh built by hand in one process)."""

    grid: tuple[tuple[int, ...], ...]
    group: object = None
    tp_groups: tuple = ()
    dp_groups: tuple = ()

    @property
    def shape(self) -> dict[str, int]:
        return {AXIS_DP: len(self.grid), AXIS_TP: len(self.grid[0])}

    @property
    def size(self) -> int:
        return len(self.grid) * len(self.grid[0])

    def ranks(self) -> list[int]:
        """The ranks in row-major (dp-major) order."""
        return [r for row in self.grid for r in row]

    def flattened(self) -> "RankMesh":
        """Every rank on ``dp`` (an ``Nx1`` mesh), in the grid's order; its
        ``dp`` axis runs over the mesh's ``group``."""
        return RankMesh(grid=tuple((r,) for r in self.ranks()), group=self.group,
                        dp_groups=(self.group,))

    def position(self, rank: int) -> tuple[int, int]:
        """``(d, t)``: the grid row and column of ``rank``."""
        for d, row in enumerate(self.grid):
            if rank in row:
                return d, row.index(rank)
        raise ValueError(f"rank {rank} is not on the mesh {self.grid}")

    def axis(self, name: str, rank: int | None = None) -> Axis:
        """The ``tp`` row or ``dp`` column through ``rank`` (default: this
        process's rank)."""
        d, t = self.position(this_rank() if rank is None else rank)
        if name == AXIS_TP:
            return Axis(self.grid[d], self.tp_groups[d] if self.tp_groups else None)
        if name == AXIS_DP:
            return Axis(tuple(row[t] for row in self.grid),
                        self.dp_groups[t] if self.dp_groups else None)
        raise ValueError(f"axis must be {AXIS_DP!r} or {AXIS_TP!r}, got {name!r}")


def world_ranks() -> list[int]:
    """``[0, ..., world_size - 1]``; ``[0]`` in a single process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


def this_rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def make_mesh(
    shape: str | tuple[int, int] = "auto",
    ranks: list[int] | None = None,
    group=None,
) -> RankMesh:
    """Build a ``(dp, tp)`` mesh over ``ranks`` (default: the world's).
    ``"auto"`` puts every rank on ``dp``. ``group`` defaults to the group
    ``parallel.distributed`` chose for the collective. Every rank of the
    runtime must build the same meshes in the same order: each axis's
    group is made on first use, and a group that one rank makes alone
    hangs the others."""
    ranks = ranks if ranks is not None else world_ranks()
    if shape == "auto":
        dp, tp = len(ranks), 1
    elif isinstance(shape, str):
        dp, tp = parse_mesh_shape(shape)
    else:
        dp, tp = shape
    if dp * tp != len(ranks):
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, have {len(ranks)}")
    from .distributed import collective_group, subgroup

    if group is None:
        group = collective_group()
    grid = tuple(tuple(ranks[i * tp:(i + 1) * tp]) for i in range(dp))
    tp_groups = tuple(subgroup(row) for row in grid)
    dp_groups = tuple(subgroup(tuple(row[t] for row in grid)) for t in range(tp))
    return RankMesh(grid=grid, group=group, tp_groups=tp_groups, dp_groups=dp_groups)


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
