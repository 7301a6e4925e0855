"""``normals_roofline``: the init's normals kernels (``normals_count`` and
``normals_write``) against their roofline (``roofline/normals.py``): the
device time of their launches inside the program's ``kmls:als.init``
spans, against the least time of each init they drew (the span's field:
values)."""

from kmls_bench.kernel_spans import roofline
from kmls_bench.program_spans import named


def _dims(span):
    f = span.fields
    if "values" not in f:
        return None
    return {"values": int(f["values"])}


def read(ctx):
    return roofline(ctx, named(ctx, "als.init"), "normals", "normals", _dims)
