"""The controls come out as not correct: the reference one step below the
stated precision, read by each cell's check."""

import pytest

from kmls_bench import control, run


def test_mine_control_fails_the_check(tiny):
    spec = tiny("config4_job.mine")
    out = control.mine_control(spec["config"], spec["traffic"], 2**31 + 5, "cpu")
    assert out["bitset_words_differ"] > spec["config"]["limits"]["bitset_words_differ"]


@pytest.mark.cuda
def test_mine_control_fails_at_the_cells_size(cuda):
    spec = run.load_cell("config4_job.mine")
    out = control.mine_control(spec["config"], spec["traffic"], 3_000_000_007, cuda)
    assert out["bitset_words_differ"] > spec["config"]["limits"]["bitset_words_differ"]


@pytest.mark.cuda
def test_serve_control_fails_at_the_cells_size(cuda):
    spec = run.load_cell("config4_serve.closed")
    out = control.serve_control(spec["config"], spec["traffic"], 3_000_000_009, cuda,
                                requests=int(spec["traffic"]["check_sample"]))
    limits = spec["config"]["limits"]
    assert (out["score_gap"] > limits["score_gap"]
            or out["exact_mismatches"] > limits["exact_mismatches"]), out
