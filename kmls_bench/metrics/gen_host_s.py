"""``gen_host_s``: seconds a mine spends in the generation's host part,
the program's ``kmls:gen.host`` spans (q over the catalog, the candidate
cut and the padding), over the window's generation calls (``kmls:gen``)."""

from kmls_bench.program_spans import named


def read(ctx):
    mines = named(ctx, "gen")
    return sum(s.seconds for s in named(ctx, "gen.host")) / len(mines) if mines else None
