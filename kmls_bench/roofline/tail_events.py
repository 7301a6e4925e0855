"""The tail's event list by geometric gaps: each of ``tracks`` tracks draws
once per event and once more (the draw that passes the last playlist), a
threefry2x32 call a draw (20 rounds of an add, a rotation and an xor: 60
lane operations); its ``events`` events of two int32 columns are written
once and each track's float64 probability read once. The float64 gap (a
logarithm and a divide) is left out, so this is the least work."""

OPS_PER_DRAW = 20 * 3


def work(*, tracks: int, events: int) -> tuple[float, float, str]:
    draws = float(events) + tracks
    return draws * OPS_PER_DRAW, 8.0 * events + 8.0 * tracks, "int32_lane_ops_per_s"
