"""``gen_roofline``: the device-born workload's share of its roofline
(``roofline/bernoulli_bits.py``): every kernel launched inside the
generation call (the draw-limit elementwise work and the
``bernoulli_bits`` kernel) in the traced window."""

from kmls_bench.readers import roofline_share


def read(ctx):
    dims = ctx["spans"]["mine_dims"][0]
    return roofline_share(ctx, "gen", "bernoulli_bits", lambda s: dims)
