"""The embedding lookup of a batch: each valid seed scores every item of
the ``v x r`` float32 factors, ``2 · v · r`` operations a seed, in float32
outside the tensor cores (TF32 is off). The bytes are the factors read
once and each row's ``k`` ids and scores written once."""


def work(*, valid_seeds: int, rows: int, v: int, r: int, k: int) -> tuple[float, float, str]:
    ops = 2.0 * v * r * valid_seeds
    nbytes = v * r * 4.0 + rows * k * 8.0
    return ops, nbytes, "fp32_flops_per_s"
