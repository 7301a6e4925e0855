"""The port's sparse count family (kmlserver_tpu_torch/ops/sparse.py)
against the JAX package's on the same numpy inputs: the plan-time event
count, the host counts and fully sparse emission (copies of the
reference's), and the device scatter-add on torch-CPU, with and without
long baskets, and one rank's rows of it (the sparse-sharded route's slab,
its long-basket block cut into tiles). Integer counts: every comparison is
exact. The
``cuda``-marked twin runs the long-basket block through the popcount
kernel on the card and skips here.
"""

import numpy as np
import pytest
import torch

from kmlserver_tpu.ops import sparse as ref_sparse
from kmlserver_tpu_torch.ops import popcount as pc
from kmlserver_tpu_torch.ops import sparse


def _baskets(n_playlists, n_tracks, mean_len, seed, long_baskets=0, long_len=40, shuffle=False):
    """Deduplicated membership pairs with Poisson basket lengths; a few
    baskets far longer when asked."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.poisson(mean_len, size=n_playlists), n_tracks)
    if long_baskets:
        lengths[rng.choice(n_playlists, long_baskets, replace=False)] = min(long_len, n_tracks)
    rows, tids = [], []
    for p, k in enumerate(lengths):
        rows.append(np.full(k, p, np.int32))
        tids.append(np.sort(rng.choice(n_tracks, k, replace=False)).astype(np.int32))
    rows, tids = np.concatenate(rows), np.concatenate(tids)
    if shuffle:
        order = rng.permutation(len(rows))
        rows, tids = rows[order], tids[order]
    return rows, tids


CASES = {
    "short": dict(n_playlists=300, n_tracks=80, mean_len=6, seed=1),
    "long": dict(n_playlists=300, n_tracks=80, mean_len=6, seed=2, long_baskets=5),
    "unsorted_long": dict(n_playlists=200, n_tracks=50, mean_len=5, seed=3, long_baskets=3,
                          shuffle=True),
    "wide": dict(n_playlists=60, n_tracks=3000, mean_len=4, seed=4),  # sort-unique accumulator
    "empty_baskets": dict(n_playlists=50, n_tracks=20, mean_len=0.3, seed=5),
}


def _case(name):
    kw = dict(CASES[name])
    p, v = kw["n_playlists"], kw["n_tracks"]
    rows, tids = _baskets(**kw)
    return rows, tids, p, v


@pytest.mark.parametrize("threshold", [None, 2, 8, 30, 1000])
@pytest.mark.parametrize("name", list(CASES))
def test_pair_event_count_equals_jax(name, threshold):
    rows, _, p, _ = _case(name)
    assert sparse.pair_event_count(rows, p, threshold) == ref_sparse.pair_event_count(rows, p, threshold)


def test_long_basket_knob_is_read_lazily(monkeypatch):
    monkeypatch.delenv("KMLS_SPARSE_LONG_BASKET", raising=False)
    assert sparse.resolve_long_basket() == ref_sparse.resolve_long_basket() == 256
    monkeypatch.setenv("KMLS_SPARSE_LONG_BASKET", "1")
    assert sparse.resolve_long_basket() == ref_sparse.resolve_long_basket() == 2
    assert sparse.resolve_long_basket(17) == ref_sparse.resolve_long_basket(17) == 17


@pytest.mark.parametrize("threshold", [None, 10, 30])
@pytest.mark.parametrize("name", list(CASES))
def test_sparse_pair_counts_np_equals_jax(name, threshold):
    rows, tids, p, v = _case(name)
    kw = dict(n_playlists=p, n_tracks=v, long_basket_threshold=threshold, event_chunk=500)
    got = sparse.sparse_pair_counts_np(rows, tids, **kw)
    np.testing.assert_array_equal(got, ref_sparse.sparse_pair_counts_np(rows, tids, **kw))


@pytest.mark.parametrize("threshold", [None, 10])
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("min_count,k_max", [(1, 4), (2, 64)])
def test_sparse_rule_rows_equals_jax(name, threshold, min_count, k_max):
    rows, tids, p, v = _case(name)
    kw = dict(n_playlists=p, n_tracks=v, min_count=min_count, k_max=k_max,
              long_basket_threshold=threshold)
    got = sparse.sparse_rule_rows(rows, tids, **kw)
    want = ref_sparse.sparse_rule_rows(rows, tids, **kw)
    assert (got is None) == (want is None)
    if want is not None:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("threshold", [None, 10, 30])
@pytest.mark.parametrize("name", list(CASES))
def test_sparse_pair_counts_device_on_cpu_equals_jax(name, threshold):
    """The scatter-add twin on torch-CPU against the reference's device
    twin and its host counts, in small event chunks."""
    rows, tids, p, v = _case(name)
    kw = dict(n_playlists=p, n_tracks=v, long_basket_threshold=threshold)
    got = sparse.sparse_pair_counts_device(rows, tids, event_chunk=333, device="cpu", **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (v, v)
    want = np.asarray(ref_sparse.sparse_pair_counts_device(rows, tids, event_chunk=333, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref_sparse.sparse_pair_counts_np(rows, tids, **kw))


def test_sparse_counts_of_nothing():
    empty = np.zeros(0, np.int32)
    assert not sparse.sparse_pair_counts_np(empty, empty, n_playlists=3, n_tracks=4).any()
    assert not sparse.sparse_pair_counts_device(
        empty, empty, n_playlists=3, n_tracks=4, device="cpu").any()


@pytest.mark.parametrize("name", ["long", "unsorted_long"])
def test_long_block_on_cpu_equals_jax(name):
    """The long-basket block alone: the float64 contraction on the CPU,
    the same function as the reference's (native or float64)."""
    rows, tids, _, v = _case(name)
    lengths = np.bincount(rows)
    sel = lengths[rows] > 10
    got = sparse._count_long_dense(rows[sel], tids[sel], v)
    np.testing.assert_array_equal(got.numpy(), ref_sparse._count_long_dense(rows[sel], tids[sel], v))
    before = dict(pc.LAUNCHES)
    sparse.sparse_pair_counts_device(rows, tids, n_playlists=len(lengths), n_tracks=v,
                                     long_basket_threshold=10, device="cpu")
    assert pc.LAUNCHES == before  # the CPU path launches nothing


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["long", "unsorted_long"])
def test_cuda_long_block_launches_the_popcount_kernel(name):
    """On the card: the long-basket block goes through the tensor-core
    popcount kernel (its counter moves) and equals the CPU's float64 block;
    the whole device count equals the host counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    rows, tids, p, v = _case(name)
    lengths = np.bincount(rows, minlength=p)
    sel = lengths[rows] > 10
    before = pc.LAUNCHES["popcount_pairs"]
    got = sparse._count_long_dense(rows[sel], tids[sel], v, "cuda")
    torch.cuda.synchronize()
    assert pc.LAUNCHES["popcount_pairs"] == before + 1
    assert torch.equal(got.cpu(), sparse._count_long_dense(rows[sel], tids[sel], v))
    full = sparse.sparse_pair_counts_device(rows, tids, n_playlists=p, n_tracks=v,
                                            long_basket_threshold=10, device="cuda")
    np.testing.assert_array_equal(
        full.cpu().numpy(),
        sparse.sparse_pair_counts_np(rows, tids, n_playlists=p, n_tracks=v, long_basket_threshold=10),
    )


def _row_blocks(tp: int, v: int):
    """``(lo, n_rows, n_cols)`` of each of ``tp`` ranks' row slabs."""
    v_loc = -(-v // tp)
    return [(t * v_loc, v_loc, v_loc * tp) for t in range(tp)]


@pytest.mark.parametrize("tp", [1, 2, 3, 4])
@pytest.mark.parametrize("threshold", [None, 10])
@pytest.mark.parametrize("name", list(CASES))
def test_pair_count_rows_equal_the_rows_of_jax_counts(name, threshold, tp):
    """One rank's rows of the sparse count (the sparse-sharded route): each
    slab equals its rows of the reference's host counts, zero past V, on
    torch-CPU in small event chunks; the CPU path launches nothing."""
    rows, tids, p, v = _case(name)
    want = ref_sparse.sparse_pair_counts_np(rows, tids, n_playlists=p, n_tracks=v,
                                            long_basket_threshold=threshold)
    before = dict(pc.LAUNCHES)
    for lo, n_rows, n_cols in _row_blocks(tp, v):
        got = sparse.sparse_pair_count_rows(rows, tids, n_tracks=v, lo=lo, n_rows=n_rows,
                                            n_cols=n_cols, long_basket_threshold=threshold,
                                            event_chunk=333, device="cpu")
        assert got.dtype == torch.int32 and tuple(got.shape) == (n_rows, n_cols)
        real = min(n_rows, v - lo)
        np.testing.assert_array_equal(got[:real, :v].numpy(), want[lo:lo + real])
        assert not got[real:].any() and not got[:, v:].any()
    assert pc.LAUNCHES == before


def test_pair_count_rows_cut_the_long_block_into_tiles():
    """A slab wider than two of the popcount kernel's vocab tiles: the long
    baskets' block is counted tile pair by tile pair (several row and
    column tiles), and the rows still equal the whole count's."""
    rows, tids = _baskets(n_playlists=120, n_tracks=700, mean_len=6, seed=6, long_baskets=8,
                          long_len=300)
    want = sparse.sparse_pair_counts_np(rows, tids, n_playlists=120, n_tracks=700,
                                        long_basket_threshold=20)
    assert -(-700 // 2) > 2 * pc.v_tile()
    for lo, n_rows, n_cols in _row_blocks(1, 700) + _row_blocks(2, 700):
        got = sparse.sparse_pair_count_rows(rows, tids, n_tracks=700, lo=lo, n_rows=n_rows,
                                            n_cols=n_cols, long_basket_threshold=20,
                                            device="cpu")
        real = min(n_rows, 700 - lo)
        np.testing.assert_array_equal(got[:real, :700].numpy(), want[lo:lo + real])


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_cuda_pair_count_rows_launch_the_popcount_kernel(tp):
    """On the card: each rank's slab counts its long-basket tiles with the
    popcount kernel (its counter moves) and equals the CPU slab."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    rows, tids = _baskets(n_playlists=120, n_tracks=700, mean_len=6, seed=6, long_baskets=8,
                          long_len=300)
    for lo, n_rows, n_cols in _row_blocks(tp, 700):
        kw = dict(n_tracks=700, lo=lo, n_rows=n_rows, n_cols=n_cols, long_basket_threshold=20)
        before = pc.LAUNCHES["popcount_pairs"]
        got = sparse.sparse_pair_count_rows(rows, tids, device="cuda", **kw)
        torch.cuda.synchronize()
        assert pc.LAUNCHES["popcount_pairs"] > before
        assert torch.equal(got.cpu(), sparse.sparse_pair_count_rows(rows, tids, device="cpu", **kw))
