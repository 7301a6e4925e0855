"""``count_roofline``: the pair-count kernel's share of its int8 roofline
(``roofline/popcount_pairs.py``) in the mines of the traced window."""

from kmls_bench.readers import roofline_share


def read(ctx):
    dims = ctx["spans"]["mine_dims"][0]
    return roofline_share(ctx, "count", "popcount_pairs", lambda s: dims)
