"""``compose_ms.closed``: host milliseconds a dispatch spends composing its
answers, the program's ``kmls:compose`` spans, the mean over the traced
window's dispatches."""

from kmls_bench.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "compose")
