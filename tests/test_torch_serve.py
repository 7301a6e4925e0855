"""The port's serving lookup (kmlserver_tpu_torch/ops/serve.py) against the
JAX package's ``recommend_batch`` on the same numpy inputs: exact ids and
float32 confidences, including equal scores (lowest id first), dead lanes
(-1 seeds, -1 rule ids), ``k_best > V`` and B, L > 1."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmlserver_tpu.ops.serve import recommend_batch as ref_recommend_batch
from kmlserver_tpu_torch.ops.serve import recommend_batch


def _rules(rng, v, k, levels):
    """Rule rows whose confidences come from a handful of float32 levels
    (so merged scores tie constantly), trailing -1 padding and some empty
    rows, like emitted rule tensors."""
    ids = np.full((v, k), -1, dtype=np.int32)
    confs = np.zeros((v, k), dtype=np.float32)
    for i in range(v):
        n = int(rng.integers(0, k + 1))
        others = np.setdiff1d(np.arange(v), [i])
        row = rng.choice(others, size=min(n, len(others)), replace=False)
        c = np.sort(rng.choice(levels, size=len(row)))[::-1]
        ids[i, : len(row)] = row
        confs[i, : len(row)] = c
    return ids, confs


def _seeds(rng, b, l, v):
    seeds = rng.integers(-1, v, size=(b, l)).astype(np.int32)
    seeds[0, :] = -1  # an all-dead row
    if l > 1:
        seeds[-1, 1:] = seeds[-1, 0]  # repeated seeds
    return seeds


def _compare(rule_ids, rule_confs, seeds, k_best):
    got_ids, got_confs = recommend_batch(
        torch.from_numpy(rule_ids), torch.from_numpy(rule_confs),
        torch.from_numpy(seeds), k_best=k_best,
    )
    want_ids, want_confs = ref_recommend_batch(
        jnp.asarray(rule_ids), jnp.asarray(rule_confs), jnp.asarray(seeds),
        k_best=k_best,
    )
    assert got_ids.dtype == torch.int32 and got_confs.dtype == torch.float32
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_confs.numpy(), np.asarray(want_confs))


LEVELS = np.float32([0.5, 0.25, 0.125, 0.0625, np.float32(1) / 3])


@pytest.mark.parametrize(
    "v,k,b,l,k_best",
    [
        (12, 4, 1, 1, 10),
        (12, 4, 6, 3, 10),
        (40, 8, 5, 7, 10),
        (40, 8, 9, 16, 64),  # k_best > V
        (300, 32, 4, 128, 10),
        (7, 6, 3, 4, 3),
    ],
)
def test_recommend_batch_matches_jax(v, k, b, l, k_best):
    rng = np.random.default_rng(v * 7 + b * 3 + l)
    ids, confs = _rules(rng, v, k, LEVELS)
    _compare(ids, confs, _seeds(rng, b, l, v), k_best)


def test_all_equal_scores_rank_by_id():
    """Every candidate scores the same: the answer is the lowest ids."""
    v, k = 30, 29
    ids = np.array([[j for j in range(v) if j != i] for i in range(v)], dtype=np.int32)
    confs = np.full((v, k), 0.25, dtype=np.float32)
    seeds = np.array([[5, 17], [29, -1]], dtype=np.int32)
    _compare(ids, confs, seeds, 10)
    got, _ = recommend_batch(
        torch.from_numpy(ids), torch.from_numpy(confs), torch.from_numpy(seeds),
        k_best=10,
    )
    assert got[0].tolist() == list(range(10))


def test_dead_lanes_and_mid_row_holes():
    """-1 rule ids in the middle of a row and zero confidences are dead
    lanes in both packages; no-candidate rows come back all -1."""
    ids = np.array([[1, -1, 2], [0, 2, -1], [-1, -1, -1]], dtype=np.int32)
    confs = np.array([[0.5, 0.9, 0.0], [0.25, 0.25, 0.0], [0, 0, 0]], dtype=np.float32)
    seeds = np.array([[0, -1], [2, 2], [-1, -1], [1, 0]], dtype=np.int32)
    _compare(ids, confs, seeds, 5)
