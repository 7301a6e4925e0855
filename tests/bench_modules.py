"""The benchmark package ``kmls_bench`` for the tests that hold the port
against the benchmark's plain reference.

``tests/test_bench.py`` binds the name ``kmls_bench`` to the repository's
``bench.py`` (another program's benchmark script) when it is collected, and
every pytest worker collects every file. :func:`load` imports the package's
modules under their own names all the same, then gives the bare name back
to whatever held it (or to nothing), so the two bindings never meet.
"""

import importlib
import sys

# the modules the tests and the code they call reach, imported together
# while the package holds its own name
PRELOAD = ("kmls_bench.run", "kmls_bench.cells", "kmls_bench.cells.embed", "kmls_bench.trace",
           "kmls_bench.program_spans", "kmls_bench.kernel_spans", "kmls_bench.roofline",
           "kmls_bench.readers", "kmls_bench.reference.embed", "kmls_bench.control_embed")

_MISSING = object()


def load(*names: str):
    """The modules ``names`` of the ``kmls_bench`` package (a list)."""
    held = sys.modules.pop("kmls_bench", _MISSING)
    try:
        for name in PRELOAD:
            importlib.import_module(name)
        return [importlib.import_module(n) for n in names]
    finally:
        if held is _MISSING:
            sys.modules.pop("kmls_bench", None)
        else:
            sys.modules["kmls_bench"] = held
