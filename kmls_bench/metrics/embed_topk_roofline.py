"""``embed_topk_roofline``: the embedding lookup's share of its roofline
(``roofline/embed_topk.py``, the work of the batch's valid seeds): the
device time of every kernel and copy the engine's ``_launch_embed``
enqueued in the traced window, against the least time of that work."""

from kmls_bench.readers import roofline_share


def _dims(span):
    f = span.fields
    return {"valid_seeds": int(f["valid"]), "rows": int(f["rows"]), "v": int(f["v"]),
            "r": int(f["r"]), "k": int(f["k"])}


def read(ctx):
    return roofline_share(ctx, "embed_topk", "embed_topk", _dims)
