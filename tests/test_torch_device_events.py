"""The device-born catalog as an event list
(``kmlserver_tpu_torch/data/device_synthetic.device_synthetic_events``,
``ops/events.py``, ``ops/csrc/events.cu``) against the benchmark's plain
reference (``kmls_bench/reference/embed.py``).

On the CPU: every track's events equal the reference's ``event_tracks``
exactly; the head equals the set bits of ``device_synthetic_bitset`` under
the same seed; the list is ordered by (track, playlist) with no pair twice;
``log_basic`` and the tail's key are the reference's bit for bit; the
tail's counts follow the model. On the card (``cuda`` marker): both
kernels' lists equal the plain versions' bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from kmlserver_tpu_torch.data import device_synthetic as ds
from kmlserver_tpu_torch.ops import events
from kmlserver_tpu_torch.ops.support import min_count_for

from .bench_modules import load

(ref,) = load("kmls_bench.reference.embed")

SEEDS = [0, 7, 2**31 - 1]
# (playlists, tracks, rows, min_support): a head the bitset covers and a
# tail past it; the first has a track at q = 1
SHAPES = [(4_000, 400, 40_000, 0.05), (3_000, 500, 30_000, 0.05)]


def _cfg(p, v, rows, min_support):
    return {"playlists": p, "tracks": v, "rows": rows, "zipf_s": 1.0, "min_support": min_support}


def _events(p, v, rows, min_support, seed):
    return ds.device_synthetic_events(p, v, rows, min_count_for(min_support, p), seed=seed,
                                      device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_every_track_equals_the_reference(seed, shape):
    p, v = shape[0], shape[1]
    rows, tracks = _events(*shape, seed)
    want = ref.event_tracks(seed, range(v), ref.workload(_cfg(*shape)))
    bounds = torch.searchsorted(tracks, torch.arange(v + 1, dtype=torch.int32)).tolist()
    for t in range(v):
        got = rows[bounds[t]:bounds[t + 1]].long()
        assert torch.equal(got, want[t]), t
    assert bounds[-1] == rows.shape[0]
    assert rows.dtype == tracks.dtype == torch.int32
    assert int(rows.min()) >= 0 and int(rows.max()) < p


@pytest.mark.parametrize("seed", SEEDS)
def test_ordered_by_track_then_playlist_each_pair_once(seed):
    p = SHAPES[0][0]
    rows, tracks = _events(*SHAPES[0], seed)
    key = tracks.long() * p + rows.long()
    assert bool((key[1:] > key[:-1]).all())


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_head_is_the_bitsets_set_bits(seed):
    p, v, n_rows, ms = SHAPES[0]
    bitset, f, _ = ds.device_synthetic_bitset(p, v, n_rows, min_count_for(ms, p), seed=seed,
                                              device="cpu")
    rows, tracks = _events(*SHAPES[0], seed)
    head = tracks < f
    words = bitset[tracks[head].long(), (rows[head] // 32).long()].long() & 0xFFFFFFFF
    assert bool((((words >> (rows[head].long() % 32)) & 1) == 1).all())
    bit = torch.arange(32, dtype=torch.int64)
    popcount = int(((bitset[:f].long()[:, :, None] >> bit) & 1).sum())
    assert int(head.sum()) == popcount
    # a track at q = 1 holds every playlist
    q = ds.zipf_bit_probs(v, p, n_rows)
    assert q[0] == 1.0 and int((tracks == 0).sum()) == p


def test_tail_counts_follow_the_model():
    p, v, n_rows, ms = 100_000, 10_000, 1_000_000, 0.01
    rows, tracks = _events(p, v, n_rows, ms, 11)
    q = ds.zipf_bit_probs(v, p, n_rows)
    f = ds.candidate_frequent_count(q, p, min_count_for(ms, p))
    got = int((tracks >= f).sum())
    expected = p * q[f:].sum()
    assert abs(got - expected) < 5 * math.sqrt(expected), (got, expected)


def test_log_basic_and_key_are_the_references():
    gen = torch.Generator().manual_seed(0)
    x = torch.cat([torch.rand(50_000, dtype=torch.float64, generator=gen) + 2.0 ** -53,
                   torch.tensor([2.0 ** -53, 0.5, 1.0, 1.0 - 2.0 ** -53, math.sqrt(0.5)],
                                dtype=torch.float64)])
    a, b = events.log_basic(x), ref.log_basic(x)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    want = torch.from_numpy(np.log(x.numpy()))
    assert float(((a - want).abs() / want.abs().clamp(min=1e-300))[:-3].max()) < 1e-15
    assert float(events.log_basic(torch.ones(1, dtype=torch.float64))) == 0.0
    for seed in SEEDS:
        assert events.tail_key(seed) == ref.tail_key(seed)


def test_plain_tail_matches_a_track_by_track_walk():
    key = events.tail_key(5)
    q = torch.tensor([0.3, 0.0, 1.0, 0.001, 0.05], dtype=torch.float64)
    pl, tr = events.tail_events_plain(q, 40, 300, key)
    for i in range(q.shape[0]):
        want = ref._tail_track(key, 40 + i, float(q[i]), 300, "cpu")
        assert torch.equal(pl[tr == 40 + i].long(), want)
    assert int((tr == 42).sum()) == 300 and int((tr == 41).sum()) == 0


@pytest.mark.cuda
class TestKernels:
    """On the card: the kernels' lists against the plain versions."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (runs on the GPU machine)")

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("shape", SHAPES + [(300_000, 40_000, 6_000_000, 0.005)])
    def test_card_list_equals_the_plain_list(self, seed, shape):
        p, v, n_rows, ms = shape
        before = dict(events.LAUNCHES)
        got = ds.device_synthetic_events(p, v, n_rows, min_count_for(ms, p), seed=seed,
                                         device="cuda")
        want = _events(*shape, seed)
        assert events.LAUNCHES == {k: n + 2 for k, n in before.items()}
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])

    def test_write_refuses_a_column_of_another_length(self):
        counted = events.count_bitset(torch.ones((1, 4), dtype=torch.int32, device="cuda"), 1,
                                      128)
        short = torch.empty(3, dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError):
            events.write(counted, short, short)

    def test_bitset_kernel_on_ragged_words(self):
        rng = np.random.default_rng(3)
        bits = torch.as_tensor(rng.integers(-2**31, 2**31, (5, 2100), dtype=np.int64)
                               .astype(np.int32))
        for p in (1, 31, 33, 32 * 1024, 32 * 2050 + 7):
            counted = events.count_bitset(bits.cuda(), 4, p)
            n = int(counted.total)
            pl = torch.empty(n, dtype=torch.int32, device="cuda")
            tr = torch.empty(n, dtype=torch.int32, device="cuda")
            events.write(counted, pl, tr)
            want = events.bitset_events_plain(bits, 4, p)
            assert torch.equal(pl.cpu(), want[0]) and torch.equal(tr.cpu(), want[1]), p
