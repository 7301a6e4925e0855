"""The roofline counts' arithmetic and the peak table."""

import pytest

from kmls_bench import roofline
from kmls_bench.roofline import bernoulli_bits, embed_topk, popcount_pairs

H100 = "NVIDIA H100 80GB HBM3"


def test_pair_count_is_one_triangle_of_and_counts():
    ops, nbytes, key = popcount_pairs.work(f=3, p=64)
    assert ops == 6 * 64 * 2  # 3·4/2 pairs, 64 playlists, an AND and an add
    assert nbytes == 3 * 2 * 4 + 9 * 4 and key == "int8_ops_per_s"


def test_pair_count_at_config_4_is_compute_bound():
    least = roofline.least_seconds("popcount_pairs", H100, f=7834, p=10_000_000)
    assert least == pytest.approx(7834 * 7835 / 2 * 1e7 * 2 / 1.979e15)
    assert 0.30 < least < 0.32


def test_generator_counts_the_rounds_and_the_compare():
    assert bernoulli_bits.OPS_PER_DRAW == 31
    ops, nbytes, key = bernoulli_bits.work(f=2, p=33)
    assert ops == 2 * 33 * 31 and nbytes == 2 * 2 * 4 and key == "int32_lane_ops_per_s"


def test_embedding_lookup_counts_valid_seeds_only():
    ops, nbytes, key = embed_topk.work(valid_seeds=3, rows=2, v=10, r=4, k=5)
    assert ops == 2 * 10 * 4 * 3 and nbytes == 10 * 4 * 4 + 2 * 5 * 8 and key == "fp32_flops_per_s"
    least = roofline.least_seconds("embed_topk", H100, valid_seeds=1000, rows=32, v=1_000_000, r=32, k=10)
    assert least == pytest.approx(2 * 1_000_000 * 32 * 1000 / 6.7e13)


def test_a_card_outside_the_table_has_no_roofline():
    assert roofline.peaks_for("some other card") is None
    assert roofline.least_seconds("popcount_pairs", "some other card", f=2, p=2) is None


def test_lane_issue_rate_is_the_float32_peaks_half():
    peaks = roofline.peaks_for(H100)
    assert peaks["int32_lane_ops_per_s"] == pytest.approx(peaks["fp32_flops_per_s"] / 2, rel=0.01)
