"""Model-layout resolution — counterpart of
``kmlserver_tpu/parallel/layout.py:33-151``, with rank counts in place of
JAX device counts.

- ``KMLS_MODEL_LAYOUT=replicated`` — the default.
- ``KMLS_MODEL_LAYOUT=sharded`` — the reference lays the counts and the
  rule emission out along the vocabulary (``tp``) axis of the mesh.
- ``KMLS_MODEL_LAYOUT=auto`` — shard when the measured tensor bytes exceed
  the per-device budget.

Serving resolves through :func:`resolve_serve_span`: an armed serve gang
is the ``mesh`` layout, else ``sharded`` spreads the rule tensors over the
serve cards in one process. Under ``sharded`` on a mesh with a vocab axis
the miner takes the vocab-sharded count and emission
(``parallel/support.py``) and the ALS trainer the vocab-sharded sweep
(``mining/als.py``), as the reference's do.
"""

from __future__ import annotations

import logging

from .mesh import AXIS_TP

LAYOUTS = ("replicated", "sharded", "auto")

logger = logging.getLogger("kmlserver_tpu_torch.layout")


def validate_layout(layout: str) -> str:
    """Normalize a layout knob value; an unrecognized spelling fails SAFE
    to ``replicated`` with a loud warning."""
    word = (layout or "").strip().lower()
    if word in LAYOUTS:
        return word
    logger.warning(
        "KMLS_MODEL_LAYOUT=%r is not one of %s; using 'replicated'",
        layout, "/".join(LAYOUTS),
    )
    return "replicated"


def resolve_layout(layout: str, tensor_bytes: int, budget_bytes: int, n_ranks: int) -> str:
    """→ ``"replicated"`` or ``"sharded"``, from the knob, the measured
    tensor bytes, the per-rank budget (``<= 0`` disables the auto trigger)
    and the ranks available."""
    word = validate_layout(layout)
    if n_ranks <= 1:
        if word == "sharded":
            logger.warning(
                "KMLS_MODEL_LAYOUT=sharded with a single rank: nothing to "
                "shard across — replicated"
            )
        return "replicated"
    if word == "sharded":
        return "sharded"
    if word == "auto" and budget_bytes > 0 and tensor_bytes > budget_bytes:
        logger.info(
            "auto layout: tensors (%d bytes) exceed the %d-byte budget — "
            "sharding across %d ranks", tensor_bytes, budget_bytes, n_ranks,
        )
        return "sharded"
    return "replicated"


def resolve_serve_span(
    layout: str, tensor_bytes: int, budget_bytes: int, n_devices: int,
    gang_size: int = 1,
) -> str:
    """→ ``"mesh"``, ``"sharded"`` or ``"replicated"``: the serving
    engine's layout decision (reference ``:79-100``). An armed serve gang
    (``KMLS_SERVE_GANG_SIZE`` > 1) is decisive — each member holds only its
    own vocab slab; otherwise :func:`resolve_layout` over the serve
    cards."""
    if gang_size > 1:
        return "mesh"
    return resolve_layout(layout, tensor_bytes, budget_bytes, n_devices)


def mining_mesh(cfg, mesh):
    """The mining mesh under the layout knob. The reference rewrites a
    single host's devices into a vocab-major ``1xN`` mesh under
    ``sharded`` and never rewrites a mesh that spans processes. Here every
    rank is a process of its own, so the mesh always stands as given."""
    validate_layout(getattr(cfg, "model_layout", "replicated"))
    return mesh


def wants_sharded_mining(cfg, mesh) -> bool:
    """True where the reference would take the vocab-sharded count+emit
    route: the mesh spans the vocab axis and the layout is not
    ``replicated``."""
    if mesh is None or mesh.shape.get(AXIS_TP, 1) <= 1:
        return False
    return validate_layout(getattr(cfg, "model_layout", "replicated")) != "replicated"
