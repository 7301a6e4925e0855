"""The dense count family of the port (kmlserver_tpu_torch/ops/encode.py
``onehot_matrix``, ops/support.py, the fused emission and the
multi-antecedent merge of ops/rules.py, the extensions and census of
mining/miner.py) against the JAX package on the same numpy inputs.

Counts are integers and confidences host float64, so every comparison is
exact, array order included. The int8 products run through
``torch._int_mm`` on the CPU too, with the zero padding the card needs, so
these tests cover the shapes the card sees; the ``cuda``-marked twins run
the product on the card and skip here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmlserver_tpu.mining import miner as ref_miner
from kmlserver_tpu.ops import encode as ref_encode
from kmlserver_tpu.ops import rules as ref_rules
from kmlserver_tpu.ops import support as ref_support
from kmlserver_tpu_torch.mining import miner
from kmlserver_tpu_torch.ops import encode, rules, support


def _pairs(rng, n_playlists, n_tracks, n):
    key = np.unique(rng.integers(0, n_playlists * n_tracks, size=n))
    return (key // n_tracks).astype(np.int32), (key % n_tracks).astype(np.int32)


def _onehots(p, v, n, seed):
    rng = np.random.default_rng(seed)
    rows, tids = _pairs(rng, p, v, n)
    x = encode.onehot_matrix(
        torch.from_numpy(rows), torch.from_numpy(tids), n_playlists=p, n_tracks=v
    )
    ref_x = ref_encode.onehot_matrix(
        jnp.asarray(rows), jnp.asarray(tids), n_playlists=p, n_tracks=v
    )
    return rows, tids, x, ref_x


SHAPES = [(5, 3, 10), (40, 33, 600), (100, 64, 3000), (257, 95, 9000), (64, 1, 30), (1, 9, 5)]


@pytest.mark.parametrize("p,v,n", SHAPES)
def test_onehot_matrix_equals_jax(p, v, n):
    _, _, x, ref_x = _onehots(p, v, n, seed=p + v)
    assert x.dtype == torch.int8 and tuple(x.shape) == (p, v)
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref_x))


@pytest.mark.parametrize("m,k,n", [
    (1, 1, 1), (3, 5, 7), (16, 8, 8), (17, 9, 15), (40, 24, 32), (300, 2246, 129),
    (0, 4, 4), (4, 0, 4),
])
def test_int8_gram_equals_plain(m, k, n):
    """Ragged shapes: padded to what ``_int_mm`` takes on the card, sliced
    back; equal to the int32 product."""
    rng = np.random.default_rng(m * 31 + k * 7 + n)
    a = torch.from_numpy(rng.integers(0, 2, size=(m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(0, 2, size=(n, k)).astype(np.int8))
    got = support.int8_gram(a, b)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, support.int8_gram_plain(a, b))


def test_int8_gram_refuses_other_types():
    with pytest.raises(TypeError):
        support.int8_gram(torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 2), dtype=torch.int8))
    with pytest.raises(ValueError):
        support.int8_gram(torch.zeros((2, 3), dtype=torch.int8), torch.zeros((2, 2), dtype=torch.int8))


@pytest.mark.parametrize("p,v,n", SHAPES)
def test_pair_and_item_counts_equal_jax(p, v, n):
    _, _, x, ref_x = _onehots(p, v, n, seed=p * v)
    got = support.pair_counts(x)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_support.pair_counts(ref_x)))
    np.testing.assert_array_equal(
        support.item_counts(x).numpy(), np.asarray(ref_support.item_counts(ref_x))
    )


def _tie_heavy_counts(rng, v, p):
    c = rng.choice([0, 1, 2, 3, 5, 5, 5, 8], size=(v, v)).astype(np.int32)
    c = np.triu(c, 1)
    c = c + c.T
    np.fill_diagonal(c, rng.integers(0, p, size=v))
    return c


@pytest.mark.parametrize("v,capacity", [(7, 3), (7, 64), (50, 8), (50, 1000), (130, 4096), (1, 4), (3, 1)])
@pytest.mark.parametrize("min_count", [1, 3, 5, 9])
def test_frequent_pairs_equal_jax_with_ties(v, capacity, min_count):
    """Arrays equal the reference's, order and padding included."""
    counts = _tie_heavy_counts(np.random.default_rng(v + capacity + min_count), v, 40)
    got = support.frequent_pairs(torch.from_numpy(counts), min_count, capacity=capacity)
    want = ref_support.frequent_pairs(jnp.asarray(counts), jnp.int32(min_count), capacity=capacity)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32 and len(g) == capacity
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3] == int(want[3])


@pytest.mark.parametrize("p,v,n", SHAPES[1:4])
def test_triple_and_quad_counts_equal_jax(p, v, n):
    rng = np.random.default_rng(p)
    _, _, x, ref_x = _onehots(p, v, n, seed=v)
    i, j, k = (rng.integers(0, v, size=37).astype(np.int32) for _ in range(3))
    got = support.triple_counts(x, torch.from_numpy(i), torch.from_numpy(j))
    want = ref_support.triple_counts(ref_x, jnp.asarray(i), jnp.asarray(j))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = support.quad_counts(x, *(torch.from_numpy(a) for a in (i, j, k)))
    want = ref_support.quad_counts(ref_x, *(jnp.asarray(a) for a in (i, j, k)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p,v,n,k_max", [
    (40, 33, 600, 8), (257, 95, 9000, 256), (100, 64, 3000, 4), (40000, 5, 60000, 3),
])
@pytest.mark.parametrize("min_count", [1, 4])
def test_fused_dense_rule_tensors_equal_jax(p, v, n, k_max, min_count):
    """Values and the compacted dtypes (int16 ids/row sizes when V fits,
    int16 counts when P fits, else int32)."""
    rows, tids, _, _ = _onehots(p, v, n, seed=n)
    got = rules.fused_dense_rule_tensors(
        torch.from_numpy(rows), torch.from_numpy(tids), min_count,
        n_playlists=p, n_tracks=v, k_max=k_max,
    )
    want = ref_rules.fused_dense_rule_tensors(
        jnp.asarray(rows), jnp.asarray(tids), jnp.int32(min_count),
        n_playlists=p, n_tracks=v, k_max=k_max,
    )
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def _rule_tensors(mod, rng, v, k_max, p=60):
    counts = _tie_heavy_counts(rng, v, p)
    return mod.mine_rules_from_counts_np(
        counts.copy(), n_playlists=p, min_support=0.03, k_max=k_max,
        mode="confidence", min_confidence=0.02,
    )


@pytest.mark.parametrize("v,k_max", [(12, 4), (40, 8), (40, 64)])
def test_mine_rules_from_counts_np_equals_jax(v, k_max):
    got = _rule_tensors(rules, np.random.default_rng(v), v, k_max)
    want = _rule_tensors(ref_rules, np.random.default_rng(v), v, k_max)
    for key in ("rule_ids", "rule_counts", "rule_confs", "item_counts", "row_valid_counts"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert (got.overflow_rows, got.n_frequent_items) == (want.overflow_rows, want.n_frequent_items)


@pytest.mark.parametrize("v,k_max,members", [(12, 4, 2), (40, 8, 2), (40, 64, 3), (30, 3, 3)])
def test_antecedent_merge_equals_jax(v, k_max, members):
    """Contributions and the merged tensors (ids, zeroed counts, float64
    and float32 confidences, overflow) equal the reference's."""
    rng = np.random.default_rng(v * members)
    base = _rule_tensors(rules, np.random.default_rng(v), v, k_max)
    ref_base = _rule_tensors(ref_rules, np.random.default_rng(v), v, k_max)
    e = 25
    mem = tuple(rng.integers(-1 if m == 0 else 0, v, size=e).astype(np.int32) for m in range(members))
    ant = rng.integers(0, 20, size=e).astype(np.int32)
    ext = rng.integers(0, 12, size=(e, v)).astype(np.int32)
    kw = dict(min_count=2, min_confidence=0.1)
    got_c = rules.antecedent_contributions(mem, ant, ext, **kw)
    want_c = ref_rules.antecedent_contributions(mem, ant, ext, **kw)
    for g, w in zip(got_c, want_c):
        np.testing.assert_array_equal(g, w)
    got = rules.merge_confidence_contributions(base, [got_c], k_max=k_max)
    want = ref_rules.merge_confidence_contributions(ref_base, [want_c], k_max=k_max)
    for key in ("rule_ids", "rule_counts", "rule_confs", "rule_confs64"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert got.overflow_rows == want.overflow_rows
    assert not got.rule_counts.any()


@pytest.fixture(scope="module")
def extension_inputs():
    rows, tids, x, ref_x = _onehots(120, 40, 2400, seed=3)
    counts = support.pair_counts(x)
    return x, ref_x, counts, ref_support.pair_counts(ref_x)


@pytest.mark.parametrize("min_count", [6, 12, 20])
def test_extensions_and_census_equal_jax(min_count, extension_inputs):
    """The port extends only the frequent prefix of the reference's
    capacity-padded pair (triple) arrays: that prefix is equal, and so are
    the triples, quads and census derived from it."""
    x, ref_x, counts, ref_counts = extension_inputs
    got = miner.compute_triple_extension(x, counts, min_count)
    want = ref_miner.compute_triple_extension(ref_x, ref_counts, min_count)
    n = got[4]
    assert n == want[4]
    for g, w in zip(got[:4], want[:4]):
        assert len(g) == n
        np.testing.assert_array_equal(g, np.asarray(w)[:n])
    for g, w in zip(miner.frequent_triples_from_extension(got, min_count),
                    ref_miner.frequent_triples_from_extension(want, min_count)):
        np.testing.assert_array_equal(g, w)
    got_q = miner.compute_quad_extension(x, got, min_count)
    want_q = ref_miner.compute_quad_extension(ref_x, want, min_count)
    m = len(got_q[0])
    assert m == int((want_q[0] >= 0).sum())
    for g, w in zip(got_q, want_q):
        np.testing.assert_array_equal(g, np.asarray(w)[:m])
    for max_len in (1, 2, 3, 4, 5):
        assert miner._itemset_census(counts, min_count, max_len, got, n, got_q) == \
            ref_miner._itemset_census(ref_counts, min_count, max_len, want, n, want_q)
        assert miner._itemset_census(counts, min_count, max_len, None, None) == \
            ref_miner._itemset_census(ref_counts, min_count, max_len, None, None)


def test_extension_capacities_match_jax(extension_inputs):
    x, ref_x, counts, ref_counts = extension_inputs
    assert miner.compute_triple_extension(x, counts, 6, pair_capacity=3) is None
    assert ref_miner.compute_triple_extension(ref_x, ref_counts, 6, pair_capacity=3) is None
    got = miner.compute_triple_extension(x, counts, 6)
    want = ref_miner.compute_triple_extension(ref_x, ref_counts, 6)
    assert miner.compute_quad_extension(x, got, 6, capacity=2) is None
    assert ref_miner.compute_quad_extension(ref_x, want, 6, capacity=2) is None
    empty = miner.compute_quad_extension(x, got, 10**6)
    assert len(empty[0]) == 0 and empty[4].shape == (0, 40)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(424, 2246, 424), (1084, 2246, 1084), (3, 5, 7), (17, 9, 15)])
def test_cuda_int8_gram_equals_plain(m, k, n):
    """On the card: the padded ``torch._int_mm`` product against the plain
    one (float64 there), at the ds2 mine's shapes and ragged small ones."""
    _needs_card()
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(0, 2, size=(m, k)).astype(np.int8)).cuda()
    b = torch.from_numpy(rng.integers(0, 2, size=(n, k)).astype(np.int8)).cuda()
    got = support.int8_gram(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, support.int8_gram_plain(a, b))
    assert torch.equal(got.cpu(), support.int8_gram_plain(a.cpu(), b.cpu()))


@pytest.mark.cuda
def test_cuda_dense_counts_and_fused_emission_equal_cpu():
    _needs_card()
    rows, tids, x, _ = _onehots(2246, 424, 60000, seed=7)
    got = support.pair_counts(x.cuda())
    assert torch.equal(got.cpu(), support.pair_counts(x))
    args = (torch.from_numpy(rows), torch.from_numpy(tids), 5)
    kw = dict(n_playlists=2246, n_tracks=424, k_max=256)
    on_card = rules.fused_dense_rule_tensors(*(a.cuda() for a in args[:2]), 5, **kw)
    on_cpu = rules.fused_dense_rule_tensors(*args, **kw)
    for g, w in zip(on_card, on_cpu):
        assert torch.equal(g.cpu(), w)
