"""``csr_s``: seconds a training spends in the program's
``kmls:als.csr`` spans, over the traced window's trainings
(``kmls:als.train``)."""

from kmls_bench.program_spans import named


def read(ctx):
    trainings = named(ctx, "als.train")
    return sum(s.seconds for s in named(ctx, "als.csr")) / len(trainings) if trainings else None
