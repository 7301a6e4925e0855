"""The pair count ``C[i, j] = Σ_p B[i, p] · B[j, p]`` over ``f`` candidate
tracks and ``p`` playlists: one triangle of the symmetric result with its
diagonal, ``f (f + 1) / 2`` dot products of ``p`` AND-counts, two
operations each, bound by the int8 tensor cores. The bytes are the
bit-packed operand read once and the ``f x f`` int32 counts written once."""


def work(*, f: int, p: int) -> tuple[float, float, str]:
    ops = f * (f + 1) / 2 * p * 2.0
    nbytes = f * (-(-p // 32)) * 4.0 + f * f * 4.0
    return ops, nbytes, "int8_ops_per_s"
