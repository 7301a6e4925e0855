"""The device-born bitset: one Bernoulli draw per (candidate track,
playlist), ``f · p`` draws. Counted from the algorithm, not from any
compiled form: a threefry-2x32 call is 20 rounds of an add, a rotation
and an xor (60 operations) and yields two 32-bit draws, so 30 a draw;
one compare decides the bit. Key injections and the packing of 32 bits
into a word are left out (a kernel can fold them into other
instructions), so this is the least work. The bytes are the bitset
written once. Integer operations are bound by the lane-issue rate."""

OPS_PER_DRAW = 20 * 3 / 2 + 1


def work(*, f: int, p: int) -> tuple[float, float, str]:
    return f * p * OPS_PER_DRAW, f * (-(-p // 32)) * 4.0, "int32_lane_ops_per_s"
