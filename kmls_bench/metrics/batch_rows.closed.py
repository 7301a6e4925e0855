"""``batch_rows.closed``: requests per device dispatch, the mean over the
engine's dispatches (``recommend_many_async``) in the traced window."""


def read(ctx):
    tr = ctx.get("trace")
    rows = [s.fields["rows"] for s in tr.spans_named("dispatch")] if tr is not None else []
    return sum(rows) / len(rows) if rows else None
