"""Whole runs of each cell on the CPU at a tiny size (the look for a card
skipped), sound and with the timed path broken underneath: a sound run
comes out correct, each fault the cell can have comes out not correct."""

import time

import pytest
import torch

from kmls_bench import run


def _run(spec, seconds=1.5, **kw):
    return run.run_cell(spec, seed=2**31 + 99, seconds=seconds, trace=False, device="cpu",
                        t_start=time.perf_counter(), **kw)


def test_sound_mine_is_correct(tiny):
    res = _run(tiny("config4_job.mine"))
    assert res["correct"] and res["attempted"] >= 2
    assert list(res["checks"]) == ["bitset_words_differ", "block_entries_differ", "count_entries_differ",
                                   "rule_entries_differ"]


def _altered_answer(monkeypatch):
    from kmlserver_tpu_torch.ops import rules

    emit = rules.emit_rule_tensors

    def altered(counts, min_count, **kw):
        ids, cnt, valid = emit(counts, min_count, **kw)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % counts.shape[0]
        return ids, cnt, valid

    monkeypatch.setattr(rules, "emit_rule_tensors", altered)


def _half_the_words(monkeypatch):
    from kmlserver_tpu_torch.ops import popcount

    def half(bt, **kw):
        w = bt.shape[1] // 2
        return popcount.popcount_pair_counts_plain(bt[:, :w].contiguous()) * 2

    monkeypatch.setattr(popcount, "popcount_pair_counts_padded", half)


def _state_unchanged(monkeypatch):
    from kmlserver_tpu_torch.data import device_synthetic

    draw, first = device_synthetic.device_synthetic_bitset, []

    def stale(*a, **kw):
        if not first:
            first.append(draw(*a, **kw))
        return first[0]

    monkeypatch.setattr(device_synthetic, "device_synthetic_bitset", stale)


def _bit_flipped(monkeypatch):
    from kmlserver_tpu_torch.data import device_synthetic

    draw = device_synthetic.device_synthetic_bitset

    def flipped(*a, **kw):
        bits, f, info = draw(*a, **kw)
        bits = bits.clone()
        bits[0, 0] ^= torch.tensor(1 << 4, dtype=torch.int32)
        return bits, f, info

    monkeypatch.setattr(device_synthetic, "device_synthetic_bitset", flipped)


@pytest.mark.parametrize("fault", [_altered_answer, _half_the_words, _state_unchanged, _bit_flipped])
def test_broken_mine_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(tiny("config4_job.mine"))
    assert res["correct"] is False


@pytest.mark.parametrize("mix", [("config4_serve.closed",), ("config4_serve", "open_poisson")])
def test_sound_serving_is_correct(tiny, mix):
    res = _run(tiny(*mix), seconds=3.0)
    assert res["correct"], res["checks"]
    assert list(res["checks"]) == ["score_gap", "exact_mismatches", "error_answers",
                                   "not_full_share"]


@pytest.mark.parametrize("fault", ["answer", "half", "raise"])
def test_broken_serving_is_not_correct(tiny, fault):
    res = _run(tiny("config4_serve.closed"), seconds=3.0, fault=fault)
    assert res["correct"] is False, (res["attempted"], res["failed"], res["checks"])
