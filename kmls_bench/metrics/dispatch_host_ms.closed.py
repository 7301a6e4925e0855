"""``dispatch_host_ms.closed``: host milliseconds a dispatch spends in the
program's ``kmls:dispatch`` span (the seeds' staging and both lookups'
launches), the mean over the traced window's dispatches."""

from kmls_bench.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "dispatch")
