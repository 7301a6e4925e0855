"""The rank mesh — counterpart of ``kmlserver_tpu/parallel/mesh.py:22-57``.

The reference lays its JAX devices out on a 2-D ``(dp, tp)`` ``Mesh``. The
port runs one process per GPU, so its mesh is a ``(dp, tp)`` grid of the
world's RANKS with the reference's axis names, plus the process group the
``dp`` all-reduce runs over:

- ``dp`` — data parallelism over the playlist (word) axis; each rank
  counts its slab and the partial counts are summed with ``all_reduce``;
- ``tp`` — the vocabulary axis. The reference's vocab-sharded dense
  routes are not ported; the bit-packed count flattens ``tp`` onto ``dp``
  (reference ``mining/miner.py:216-219``), as this port always does.
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
class RankMesh:
    """A ``(dp, tp)`` grid of ranks. ``group`` is the process group over
    the mesh's ranks that the ``dp`` all-reduce uses (None = the default
    group, or no group at all in a single process)."""

    grid: tuple[tuple[int, ...], ...]
    group: object = None

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
        """Every rank on ``dp`` (an ``Nx1`` mesh), in the grid's order."""
        return RankMesh(grid=tuple((r,) for r in self.ranks()), group=self.group)


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
    ``parallel.distributed`` chose for the collective."""
    ranks = ranks if ranks is not None else world_ranks()
    if shape == "auto":
        dp, tp = len(ranks), 1
    elif isinstance(shape, str):
        dp, tp = parse_mesh_shape(shape)
    else:
        dp, tp = shape
    if dp * tp != len(ranks):
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, have {len(ranks)}")
    if group is None:
        from .distributed import collective_group

        group = collective_group()
    grid = tuple(tuple(ranks[i * tp:(i + 1) * tp]) for i in range(dp))
    return RankMesh(grid=grid, group=group)


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
