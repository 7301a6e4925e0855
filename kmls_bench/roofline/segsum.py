"""One segment sum ``out[s] = Σ_{e in row s} mat[gidx[e]]`` (the ALS
half-sweep's ``X F`` or ``Xᵀ U``): ``n_out`` rows of ``r`` float32 columns
over ``nnz`` events gathering from an ``n_in x r`` matrix. The least time
is the largest of three terms (``chip_smoke.py::segsum_bound``):

- bytes: the matrix, the offsets and the indices read once, the output
  written once;
- the ``nnz · r`` float32 adds over the float32 peak, which counts two
  operations a lane a clock (a fused multiply-add): ``nnz · r / 2`` at
  the lane rate;
- the longest row's chain of dependent adds (each column's sum is one
  chain in event order, which no schedule may split): ``longest`` adds at
  4 cycles each, at the clock the lane rate implies (132 SMs x 128 lanes),
  counted as ``longest · 4 · 132 · 128`` lane operations.
"""

LANES = 132 * 128
ADD_CYCLES = 4


def work(*, n_in: int, n_out: int, nnz: int, r: int, longest: int) -> tuple[float, float, str]:
    ops = max(nnz * r / 2.0, float(longest) * ADD_CYCLES * LANES)
    nbytes = 4.0 * n_in * r + 8.0 * (n_out + 1) + 4.0 * nnz + 4.0 * n_out * r
    return ops, nbytes, "int32_lane_ops_per_s"
