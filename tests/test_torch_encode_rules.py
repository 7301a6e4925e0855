"""The port's encoding and rule emission (kmlserver_tpu_torch/ops/encode.py,
rules.py, support.py) against the JAX package's on the same numpy inputs.
Counts are integers and confidences are host float64 → float32 in both
packages, so every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmlserver_tpu.ops import encode as ref_encode
from kmlserver_tpu.ops import rules as ref_rules
from kmlserver_tpu.ops import support as ref_support
from kmlserver_tpu_torch.ops import encode, rules, support


def _pairs(rng, n_playlists, n_tracks, n):
    key = np.unique(rng.integers(0, n_playlists * n_tracks, size=n))
    return (key // n_tracks).astype(np.int32), (key % n_tracks).astype(np.int32)


@pytest.mark.parametrize(
    "p,v", [(5, 3), (40, 33), (100, 64), (257, 95), (64, 1)]
)
def test_bitpack_matrix_bit_equal_to_jax(p, v):
    rng = np.random.default_rng(p + v)
    rows, tids = _pairs(rng, p, v, p * v // 2 + 1)
    # every bit position including 31 (the int32 sign bit) is exercised
    got = encode.bitpack_matrix(
        torch.from_numpy(rows), torch.from_numpy(tids), n_playlists=p, n_tracks=v
    )
    want = np.asarray(
        ref_encode.bitpack_matrix(
            jnp.asarray(rows), jnp.asarray(tids), n_playlists=p, n_tracks=v
        )
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


def test_bitpack_sign_bit_wraps():
    got = encode.bitpack_matrix(
        torch.tensor([0, 0]), torch.tensor([31, 0]), n_playlists=1, n_tracks=32
    )
    assert got.numpy().view(np.uint32)[0, 0] == 0x80000001


def _tie_heavy_counts(rng, v, p):
    """A symmetric count matrix drawn from very few distinct values, so
    almost every row has long runs of equal counts."""
    c = rng.choice([0, 1, 2, 3, 5, 5, 5, 8], size=(v, v)).astype(np.int32)
    c = np.triu(c, 1)
    c = c + c.T
    np.fill_diagonal(c, rng.integers(0, p, size=v))
    return c


@pytest.mark.parametrize("v,k_max", [(7, 3), (50, 8), (50, 64), (130, 256), (1, 4)])
@pytest.mark.parametrize("min_count", [1, 3, 5])
def test_emit_rule_tensors_matches_jax_and_numpy(v, k_max, min_count):
    rng = np.random.default_rng(v * 31 + k_max + min_count)
    counts = _tie_heavy_counts(rng, v, 20)
    got = [
        t.numpy()
        for t in rules.emit_rule_tensors(torch.from_numpy(counts), min_count, k_max=k_max)
    ]
    want = [
        np.asarray(t)
        for t in ref_rules.emit_rule_tensors(
            jnp.asarray(counts), jnp.int32(min_count), k_max=k_max
        )
    ]
    np_twin = ref_rules.emit_rule_tensors_np(counts, min_count, k_max=k_max)
    port_twin = rules.emit_rule_tensors_np(counts, min_count, k_max=k_max)
    for g, w, n, t in zip(got, want, np_twin, port_twin):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, n)
        np.testing.assert_array_equal(t, n)


@pytest.mark.parametrize("mode", ["support", "confidence"])
@pytest.mark.parametrize("k_max", [4, 300])
def test_mine_rules_from_counts_matches_jax(mode, k_max):
    rng = np.random.default_rng(7)
    p, v = 40, 120
    counts = _tie_heavy_counts(rng, v, p)
    kw = dict(
        n_playlists=p, min_support=0.05, k_max=k_max, mode=mode,
        min_confidence=0.1, n_total_songs=v + 17,
    )
    got = rules.mine_rules_from_counts(torch.from_numpy(counts), **kw)
    want = ref_rules.mine_rules_from_counts(jnp.asarray(counts), **kw)
    for field in (
        "rule_ids", "rule_counts", "rule_confs", "item_counts", "row_valid_counts"
    ):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    for field in (
        "n_playlists", "min_support", "min_count", "mode", "min_confidence",
        "n_frequent_items", "n_songs_missing", "overflow_rows",
    ):
        assert getattr(got, field) == getattr(want, field), field
    names = [f"Track {i:03d}" for i in range(v)]
    assert got.to_rules_dict(names) == want.to_rules_dict(names)


def test_derive_confs_and_expand_match_jax():
    rng = np.random.default_rng(11)
    rc = rng.integers(0, 1000, size=(30, 6)).astype(np.int32)
    ic = rng.integers(0, 1000, size=30).astype(np.int32)
    ids = np.where(rc > 100, rng.integers(0, 30, size=(30, 6)), -1).astype(np.int32)
    for mode in ("support", "confidence"):
        np.testing.assert_array_equal(
            rules.derive_confs(rc, ic, 2246, mode),
            ref_rules.derive_confs(rc, ic, 2246, mode),
        )
        names = [f"t{i}" for i in range(30)]
        kw = dict(n_playlists=2246, min_support=0.2, mode=mode)
        assert rules.expand_rules_dict(names, ids, rc, ic, **kw) == (
            ref_rules.expand_rules_dict(names, ids, rc, ic, **kw)
        )


def test_min_count_for_float_edges():
    """The float64 threshold edges tests/test_ops.py pins: c/P >= s iff
    c >= min_count_for(s, P), and the port agrees with the reference."""
    for p in (1, 3, 5, 7, 20, 100, 2246):
        for s in (0.01, 0.05, 0.1, 1 / 3, 0.5, 0.2):
            mc = support.min_count_for(s, p)
            assert mc == ref_support.min_count_for(s, p)
            for c in range(0, p + 1):
                assert (c / p >= s) == (c >= mc), (p, s, c, mc)
    assert support.min_count_for(0.0, 10) == 1
    assert support.min_count_for(5e-4, 1_000_000) == 500
