"""``als_init_s``: seconds a training spends in the program's
``kmls:als.init`` spans, over the traced window's trainings
(``kmls:als.train``)."""

from kmls_bench.program_spans import named


def read(ctx):
    trainings = named(ctx, "als.train")
    return sum(s.seconds for s in named(ctx, "als.init")) / len(trainings) if trainings else None
