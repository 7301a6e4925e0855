"""The check that a run loaded neither JAX nor the JAX package.

Module names are compared by their whole top-level name (the part before
the first dot): the port, ``kmlserver_tpu_torch``, begins with the JAX
package's name and is not it.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kmlserver_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in list(names)} & FORBIDDEN)
