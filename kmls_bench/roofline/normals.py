"""The ALS init's standard normals on the card: ``values`` float32 values
written once, each from at least one raw of PCG64, a raw a 128-bit
multiply-add and the XSL-RR output (16 partial products of 32-bit limbs,
4 adds of the increment, a 64-bit xor and a rotation: 26 lane
operations). The ziggurat's compare and multiply, the raws the wedge and
tail attempts add (about 0.7 %), the barrier windows and the second pass
are left out, so this is the least work."""

OPS_PER_DRAW = 16 + 4 + 2 + 4


def work(*, values: int) -> tuple[float, float, str]:
    return float(values) * OPS_PER_DRAW, 4.0 * values, "int32_lane_ops_per_s"
