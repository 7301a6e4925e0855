"""The head's event list from its bitset: ``rows`` rows of ``words``
words read once, one popcount a word, and ``events`` events of two int32
columns written once. Bound by the bytes."""


def work(*, rows: int, words: int, events: int) -> tuple[float, float, str]:
    return float(rows) * words, 4.0 * rows * words + 8.0 * events, "int32_lane_ops_per_s"
