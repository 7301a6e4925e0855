"""``bitset_events_roofline``: the head's compaction kernel
(``bitset_events``: its count and write passes) against its roofline
(``roofline/bitset_events.py``): the device time of its launches inside
the program's ``kmls:gen.compact`` spans, against the least time of each
list it wrote (the write span's fields: rows, words, events)."""

from kmls_bench.kernel_spans import roofline
from kmls_bench.program_spans import named


def _dims(span):
    f = span.fields
    if "events" not in f:
        return None
    return {"rows": int(f["rows"]), "words": int(f["words"]), "events": int(f["events"])}


def read(ctx):
    return roofline(ctx, named(ctx, "gen.compact"), "bitset_events", "bitset_events", _dims)
