"""``front_ms.closed``: host milliseconds a request spends in the
transport, the program's ``kmls:http.parse`` spans (framing, and the
body's JSON to its seed list) and ``kmls:http.respond`` spans (the
answer's encoding and write), over the traced window's answers (one
``kmls:http.respond`` each)."""

from kmls_bench.program_spans import named


def read(ctx):
    answers = named(ctx, "http.respond")
    if not answers:
        return None
    spent = sum(s.seconds for s in named(ctx, "http.parse")) + sum(s.seconds for s in answers)
    return 1e3 * spent / len(answers)
