"""``idle_in_spans.closed``: the share (%) of the traced window's idle
device time whose middle falls inside one of the program's ``kmls:``
spans on some thread (``program_spans.idle_by_span``): how much of the
card's idleness the program's own spans name. Nothing without them."""

from kmls_bench.program_spans import idle_by_span, program_spans


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not program_spans(tr):
        return None
    idle = idle_by_span(tr)
    total = sum(idle.values())
    if total <= 0.0:
        return None
    return 100.0 * (total - idle.get("", 0.0)) / total
