"""``tail_events_roofline``: the tail's geometric-gap kernel
(``tail_events``: its count and write passes) against its roofline
(``roofline/tail_events.py``): the device time of its launches inside the
program's ``kmls:gen.tail`` spans, against the least time of each list it
wrote (the write span's fields: tracks, events)."""

from kmls_bench.kernel_spans import roofline
from kmls_bench.program_spans import named


def _dims(span):
    f = span.fields
    if "events" not in f:
        return None
    return {"tracks": int(f["tracks"]), "events": int(f["events"])}


def read(ctx):
    return roofline(ctx, named(ctx, "gen.tail"), "tail_events", "tail_events", _dims)
