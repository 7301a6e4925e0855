"""The plain reference against known answers and against the port's own
plain versions, at small sizes on the CPU."""

import numpy as np
import pytest
import torch

from kmls_bench.reference import mine as ref_mine
from kmls_bench.reference import serve as ref_serve
from kmls_bench.reference import threefry


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, ctr, want):
    """Random123's Threefry-2x32 (20 rounds) test vectors."""
    a, b = threefry.threefry2x32(key[0], key[1], torch.tensor([ctr[0]]), torch.tensor([ctr[1]]))
    assert (int(a), int(b)) == want


def _shape():
    cfg = {"playlists": 1000, "tracks": 200, "rows": 20000, "zipf_s": 1.0,
           "min_support": 0.02, "k_max": 8}
    return cfg, ref_mine.workload(cfg)


def test_bitset_rows_equal_the_ports_generator():
    from kmlserver_tpu_torch.data.device_synthetic import device_synthetic_bitset

    cfg, shape = _shape()
    bits, f, info = device_synthetic_bitset(1000, 200, 20000, shape["min_count"], seed=77, device="cpu")
    assert f == shape["candidates"] and tuple(bits.shape) == (shape["v_pad"], shape["w_pad"])
    rows = np.array([0, 1, 5, f - 1])
    assert torch.equal(ref_mine.bitset_rows(77, rows, shape), bits[rows])


def test_a_lower_precision_compare_changes_the_bitset():
    _, shape = _shape()
    rows = np.arange(8)
    a = ref_mine.bitset_rows(3, rows, shape)
    b = ref_mine.bitset_rows(3, rows, shape, compare_dtype=torch.bfloat16)
    assert (a != b).any()


def test_count_rows_are_the_plain_pair_counts():
    rng = np.random.default_rng(0)
    dense = rng.random((40, 300)) < 0.3  # 40 tracks x 300 playlists
    words = np.zeros((40, 10), dtype=np.int64)
    for t, p in zip(*np.nonzero(dense)):
        words[t, p // 32] |= 1 << (p % 32)
    bitset = torch.as_tensor(np.where(words >= 1 << 31, words - (1 << 32), words).astype(np.int32))
    rows = np.array([0, 7, 39])
    want = dense[rows].astype(np.int64) @ dense.T.astype(np.int64)
    assert np.array_equal(ref_mine.count_rows(bitset, rows, word_chunk=3).numpy(), want)


def test_emit_rows_rank_by_count_then_id():
    counts = np.array([[9, 5, 7, 5, 1, 7]])
    out = ref_mine.emit_rows(counts, [0], min_count=5, k_max=4, n_playlists=10)
    assert out["rule_ids"].tolist() == [[2, 5, 1, 3]]
    assert out["rule_counts"].tolist() == [[7, 7, 5, 5]]
    assert out["item_counts"].tolist() == [9] and out["row_valid"].tolist() == [4]
    assert out["rule_confs"].dtype == np.float32


def test_emit_rows_equal_the_ports_emission():
    from kmlserver_tpu_torch.ops.rules import emit_rule_tensors_np

    rng = np.random.default_rng(1)
    c = rng.integers(0, 20, size=(30, 30))
    c = c + c.T
    ids, cnt, valid = emit_rule_tensors_np(c.astype(np.int32), 12, k_max=6)
    rows = np.arange(30)
    out = ref_mine.emit_rows(c, rows, min_count=12, k_max=6, n_playlists=100)
    assert np.array_equal(out["rule_ids"], ids) and np.array_equal(out["rule_counts"], cnt)
    assert np.array_equal(out["row_valid"], valid)


def _pub(v=500, f=60, k=6, seed=0):
    rng = np.random.default_rng(seed)
    factors = rng.standard_normal((v, 8)).astype(np.float32)
    factors /= np.linalg.norm(factors, axis=1, keepdims=True)
    rule_ids = np.full((f, k), -1)
    rule_counts = np.zeros((f, k), dtype=np.int64)
    for t in range(40):
        ids = rng.choice(f, size=k, replace=False)
        cnt = rng.integers(1, 100, size=k)
        o = np.lexsort((ids, -cnt))
        rule_ids[t], rule_counts[t] = ids[o], cnt[o]
    item = np.full(f, 100)
    item[40:] = 3
    names = [f"n{i:04d}" for i in range(v)]
    return {"names": names, "rule_ids": rule_ids, "rule_counts": rule_counts, "item_counts": item,
            "min_count": 10, "factors": factors, "best_names": names[:50]}


def test_rule_lookup_equals_the_ports():
    from kmlserver_tpu_torch.ops.serve import recommend_batch

    pub = _pub()
    ref = ref_serve.Reference(pub, k_best=5, weight=0.5, max_seeds=128, tol=1e-6)
    confs = torch.as_tensor(ref_serve.confidences(pub))
    seeds = [3, 17, 22]
    ids, _ = recommend_batch(torch.as_tensor(pub["rule_ids"], dtype=torch.int32), confs,
                             torch.tensor([seeds]), k_best=5)
    assert [j for j, _ in ref.rules_top(seeds)] == [int(i) for i in ids[0] if i >= 0]


def test_embedding_top_k_equals_the_ports():
    from kmlserver_tpu_torch.ops.embed import embed_topk

    pub = _pub()
    ref = ref_serve.Reference(pub, k_best=7, weight=0.5, max_seeds=128, tol=1e-6)
    seeds = [5, 90, 401]
    ids, _ = embed_topk(torch.as_tensor(pub["factors"]), torch.tensor([seeds + [-1]]), k_best=7)
    assert [j for j, _ in ref.emb_top(ref.sims(seeds))] == ids[0].tolist()


def test_fallback_equals_the_ports():
    from kmlserver_tpu_torch.serving.engine import stable_seed

    seeds = ["x", "a", "q"]
    assert ref_serve.stable_seed(seeds) == stable_seed(seeds)
    pub = _pub()
    ref = ref_serve.Reference(pub, k_best=5, weight=0.5, max_seeds=128, tol=1e-6)
    ans = ref.answer(["unknown-1"])
    assert ans["kind"] == "fallback" and ans["names"] == ref_serve.fallback(["unknown-1"], pub["best_names"], 5)


def test_blend_answers_and_what_the_judge_catches():
    pub = _pub()
    ref = ref_serve.Reference(pub, k_best=6, weight=0.5, max_seeds=128, tol=1e-6)
    ans = ref.answer(["n0003", "n0100"])  # a rule key and a catalog track
    assert ans["kind"] == "hybrid"
    assert ref_serve.judge(ans, ans["names"]) == (0.0, False)
    gap, _ = ref_serve.judge(ans, list(reversed(ans["names"])))
    assert gap > 1e-3
    assert ref_serve.judge(ans, ans["names"][:-1])[1]
    assert ref_serve.judge(ans, ans["names"][:-1] + ["nobody"])[1]
    emb = ref.answer(["n0300"])
    assert emb["kind"] == "embed" and ref_serve.judge(emb, emb["names"]) == (0.0, False)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -1.0 - 2 ** -11])
    assert ref_serve.to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -1.0 - 2 ** -10]
