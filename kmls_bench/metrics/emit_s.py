"""``emit_s``: seconds a mine spends in the emission
(``ops/rules.mine_rules_from_counts``), by the host's clock around
synchronized work, the mean over the window's mines."""


def read(ctx):
    times = ctx["spans"].get("emit_s") or []
    return sum(times) / len(times) if times else None
