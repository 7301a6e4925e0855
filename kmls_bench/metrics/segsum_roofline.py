"""``segsum_roofline``: the segment-sum kernel's share of its roofline
(``roofline/segsum.py``) in the ALS half-sweeps of the traced window: the
device time of the ``segsum_kernel`` launches inside the program's
``kmls:als.users`` and ``kmls:als.items`` spans, against the least time of
each launch's sum (the span's fields: rows, gather rows, events, longest
row, rank)."""

from kmls_bench.kernel_spans import roofline
from kmls_bench.program_spans import named


def _dims(span):
    f = span.fields
    return {"n_in": int(f["n_in"]), "n_out": int(f["rows"]), "nnz": int(f["events"]),
            "r": int(f["r"]), "longest": int(f["longest"])}


def read(ctx):
    spans = sorted(named(ctx, "als.users") + named(ctx, "als.items"), key=lambda s: s.t0)
    return roofline(ctx, spans, "segsum_kernel", "segsum", _dims)
