"""The share (%) of the traced window in which no operation ran on the
card (``torch.profiler``'s device trace)."""

from kmls_bench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
