"""Model-parallel serving in the port (X9, ``ops/serve.py``'s vocab-sharded
lookup halves, and the ``sharded`` layout of ``serving/engine.py``) held
against the JAX package on the same seeded inputs.

- X9: each slab's partial, the cross-slab merge and the whole sharded
  lookup equal the reference's jitted ``shard_partial_topk`` /
  ``merge_partial_topk`` / ``sharded_recommend_fn`` (on the virtual CPU
  devices ``tests/conftest.py`` forces) and the replicated lookups of both
  packages, exactly (tolerance 0), at S ∈ {1, 2, 3, 4} shards: V no
  multiple of S, ``k_best`` above V, all-``-1`` rows and equal confidences.
- Layout resolution: ``resolve_serve_span`` and the layout spellings give
  the reference's answers (``tests/test_shard_layout.py:118-150``,
  ``tests/test_mesh.py:76``).
- The sharded engine on ``[cpu] * S`` answers as the reference's engines do
  on the same PVC, across epochs, with zero unwarmed dispatches; ``auto``
  shards only past the budget; hybrid embeddings ride the sharded layout;
  the per-shard dispatch series render (the cases of
  ``tests/test_shard_layout.py:154-298`` but the native-serve bypass: both
  packages run with ``native_serve=False``).

The ``cuda`` twin runs the same lookups on the card.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmlserver_tpu.data.synthetic import synthetic_baskets as ref_synthetic_baskets
from kmlserver_tpu.mining.pipeline import run_mining_job as ref_run_mining_job
from kmlserver_tpu.ops import serve as ref_serve
from kmlserver_tpu.parallel import layout as ref_layout
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu_torch.config import MiningConfig
from kmlserver_tpu_torch.data.csv import TrackTable, write_tracks_csv
from kmlserver_tpu_torch.io import registry
from kmlserver_tpu_torch.ops import serve
from kmlserver_tpu_torch.parallel import layout
from kmlserver_tpu_torch.serving.app import RecommendApp
from kmlserver_tpu_torch.serving.engine import RecommendEngine
from kmlserver_tpu_torch.serving.metrics import ServingMetrics

from .torch_chaos_util import (  # noqa: F401  (clean_chaos_state: autouse)
    clean_chaos_state,
    port_serving_cfg,
    ref_mining_cfg,
    ref_serving_cfg,
    serving_pvc,
)

LEVELS = np.linspace(0.1, 1.0, 7).astype(np.float32)

# name → (V, K, k_best, B, L)
CASES = {
    "random": (53, 7, 10, 6, 4),
    "k_best_over_v": (5, 3, 10, 2, 3),
    "ties": (37, 9, 12, 5, 6),
    "empty_rows": (22, 4, 6, 4, 5),
}


def _rule_tensors(name: str, seed: int):
    """Rule tensors with confidence TIES (the tie order is half the
    contract) and trailing -1 padding; ``empty_rows`` leaves every other
    row all ``-1``, ``ties`` draws every confidence from two levels."""
    v, k, k_best, b, length = CASES[name]
    rng = np.random.default_rng(seed)
    levels = LEVELS[:2] if name == "ties" else LEVELS
    ids = np.full((v, k), -1, np.int32)
    confs = np.zeros((v, k), np.float32)
    for i in range(v):
        if name == "empty_rows" and i % 2:
            continue
        n = int(rng.integers(0, k + 1))
        ids[i, :n] = rng.choice(v, size=n, replace=False)
        confs[i, :n] = np.sort(rng.choice(levels, size=n))[::-1]
    seeds = rng.integers(-1, v, size=(b, length)).astype(np.int32)
    seeds[0] = -1  # an all-dead row
    return ids, confs, seeds, k_best


def _slabs(ids, confs, n_shards):
    ids_p, confs_p, v_loc = serve.split_vocab(ids, confs, n_shards)
    return ([torch.from_numpy(ids_p[s * v_loc:(s + 1) * v_loc]) for s in range(n_shards)],
            [torch.from_numpy(confs_p[s * v_loc:(s + 1) * v_loc]) for s in range(n_shards)],
            ids_p, confs_p, v_loc)


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_x9_halves_and_lookup_equal_the_references(n_shards, name):
    """Per slab, the partial; over the slabs, the merge; end to end, the
    sharded lookup — each equal to the reference's, and the whole equal to
    the replicated lookup of both packages."""
    ids, confs, seeds, k_best = _rule_tensors(name, seed=n_shards)
    slab_ids, slab_confs, ids_p, confs_p, v_loc = _slabs(ids, confs, n_shards)
    v = v_loc * n_shards
    parts, ref_parts = [], []
    for s in range(n_shards):
        got = serve.shard_partial_topk(slab_ids[s], slab_confs[s], torch.from_numpy(seeds),
                                       s * v_loc, v=v, k_best=k_best)
        want = ref_serve.shard_partial_topk(
            jnp.asarray(ids_p[s * v_loc:(s + 1) * v_loc]),
            jnp.asarray(confs_p[s * v_loc:(s + 1) * v_loc]),
            jnp.asarray(seeds), jnp.int32(s * v_loc), v=v, k_best=k_best)
        _equal(got, want)
        parts.append(got)
        ref_parts.append(want)
    merged = serve.merge_partial_topk(torch.stack([p[0] for p in parts]),
                                      torch.stack([p[1] for p in parts]), v=v, k_best=k_best)
    _equal(merged, ref_serve.merge_partial_topk(
        jnp.stack([p[0] for p in ref_parts]), jnp.stack([p[1] for p in ref_parts]),
        v=v, k_best=k_best))
    whole = serve.sharded_recommend(slab_ids, slab_confs, torch.from_numpy(seeds), k_best=k_best)
    _equal(whole, merged)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    mesh = Mesh(np.asarray(jax.devices()[:n_shards]), ("shard",))
    spec = NamedSharding(mesh, PartitionSpec("shard", None))
    fn = ref_serve.sharded_recommend_fn(mesh, k_best)
    _equal(whole, fn(jax.device_put(ids_p, spec), jax.device_put(confs_p, spec), seeds))
    _equal(whole, serve.recommend_batch(torch.from_numpy(ids), torch.from_numpy(confs),
                                        torch.from_numpy(seeds), k_best=k_best))
    _equal(whole, ref_serve.recommend_batch(jnp.asarray(ids), jnp.asarray(confs),
                                            jnp.asarray(seeds), k_best=k_best))
    assert whole[0].dtype == torch.int32 and whole[1].dtype == torch.float32


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_merge_without_a_dropped_rank_equals_the_references(n_shards):
    """A rank left out of the merge (the gang's straggler drop) is a slot
    of ``-inf`` confidences: both packages merge the others alone."""
    ids, confs, seeds, k_best = _rule_tensors("random", seed=7)
    slab_ids, slab_confs, _, _, v_loc = _slabs(ids, confs, n_shards)
    v = v_loc * n_shards
    parts = [serve.shard_partial_topk(slab_ids[s], slab_confs[s], torch.from_numpy(seeds),
                                      s * v_loc, v=v, k_best=k_best) for s in range(n_shards)]
    all_ids = torch.stack([p[0] for p in parts])
    all_confs = torch.stack([p[1] for p in parts])
    all_ids[1] = 0
    all_confs[1] = float("-inf")
    got = serve.merge_partial_topk(all_ids, all_confs, v=v, k_best=k_best)
    _equal(got, ref_serve.merge_partial_topk(jnp.asarray(all_ids.numpy()),
                                             jnp.asarray(all_confs.numpy()), v=v, k_best=k_best))
    keep = [s for s in range(n_shards) if s != 1]
    _equal(got, serve.merge_partial_topk(all_ids[keep], all_confs[keep], v=v, k_best=k_best))


@pytest.mark.parametrize("n_shards", [2, 3])
def test_split_vocab_pads_with_empty_rows(n_shards):
    ids, confs, _, _ = _rule_tensors("random", seed=3)
    ids_p, confs_p, v_loc = serve.split_vocab(ids, confs, n_shards)
    v = ids.shape[0]
    assert v_loc * n_shards >= v > (v_loc - 1) * n_shards
    np.testing.assert_array_equal(ids_p[:v], ids)
    assert (ids_p[v:] == -1).all() and (confs_p[v:] == 0).all()


@pytest.mark.parametrize("args", [
    ("replicated", 10**12, 1, 8, 1), ("sharded", 1, 10**12, 8, 1), ("sharded", 10**12, 1, 1, 1),
    ("auto", 100, 1000, 8, 1), ("auto", 1001, 1000, 8, 1), ("auto", 10**12, 0, 8, 1),
    ("shard-it-all", 10**12, 1, 8, 1), ("AUTO ", 1001, 1000, 2, 1),
    ("replicated", 10, 5, 4, 2), ("sharded", 10, 5, 4, 2), ("auto", 10, 5, 4, 2),
    ("replicated", 10, 5, 4, 1), ("auto", 10, 5, 4, 1), ("sharded", 10, 5, 1, 3),
])
def test_resolve_serve_span_is_the_references(args):
    """An armed gang is decisive (``mesh``); otherwise the single-process
    decision — the knob, the measured bytes against the budget, the
    devices — as the reference resolves it."""
    lay, nbytes, budget, n, gang = args
    assert layout.resolve_serve_span(lay, nbytes, budget, n, gang_size=gang) == (
        ref_layout.resolve_serve_span(lay, nbytes, budget, n, gang_size=gang))
    assert layout.validate_layout(lay) == ref_layout.validate_layout(lay)


# ---------------------------------------------------------------------------
# the sharded engine against the reference's engines on one PVC
# ---------------------------------------------------------------------------


@pytest.fixture
def pvc(tmp_path):
    base = str(tmp_path / "pvc")
    return base, serving_pvc(base)


def _known(bundle) -> list[str]:
    return [s for s in bundle.vocab if bundle.known_mask[bundle.index[s]]]


def _sets(bundle) -> list[list[str]]:
    seeds = _known(bundle)
    return [[seeds[0]], [seeds[1], seeds[2]], ["unknown-zz"], seeds[:4], ["loner"],
            seeds[-3:] + ["unknown-zz"]]


def _many(engine, sets, width: int = 4):
    return [a for i in range(0, len(sets), width) for a in engine.recommend_many(sets[i:i + width])]


def _sharded(base, n_shards, **knobs) -> RecommendEngine:
    return RecommendEngine(port_serving_cfg(base, model_layout="sharded", serve_devices=n_shards,
                                            **knobs), device="cpu")


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_sharded_engine_answers_as_the_references_across_epochs(pvc, n_shards):
    """One logical replica of S slabs answers every request as the
    reference's replicated and sharded engines do, and again after a new
    publication (epoch 2)."""
    base, mining_cfg = pvc
    shd = _sharded(base, n_shards)
    ref = RefEngine(ref_serving_cfg(base))
    ref_shd = RefEngine(ref_serving_cfg(base, model_layout="sharded", serve_devices=n_shards))
    assert shd.load() and ref.load() and ref_shd.load()
    assert shd.model_layout == "sharded" == ref_shd.model_layout
    assert shd.n_shards == n_shards and shd.n_replicas == 1
    assert shd.bundle.shard_size == ref_shd.bundle.shard_size
    sets = _sets(shd.bundle)
    want = _many(ref, sets)
    assert _many(shd, sets) == want == _many(ref_shd, sets)
    assert [shd.recommend(s) for s in sets] == [ref.recommend(s) for s in sets]
    registry.append_history_and_invalidate(mining_cfg, 1, "ds1")
    assert shd.load() and ref.load()
    assert shd.bundle_epoch == 2 and shd.n_shards == n_shards
    assert _many(shd, sets) == _many(ref, sets)
    assert shd.unwarmed_dispatches == 0


def test_zero_unwarmed_dispatches_on_every_sharded_bucket(pvc):
    """Every (batch, length) bucket ran through the sharded lookup before
    publication: dispatching each moves neither the unwarmed counter nor
    the cost model's ``serve_sharded`` compile watch."""
    base, _ = pvc
    engine = _sharded(base, 3)
    assert engine.load()
    bundle = engine.bundle
    assert {(b, n) for b in engine._batch_buckets() for n in engine._len_buckets()} <= (
        bundle.warmed_shapes)
    seeds = _known(bundle)
    for b in engine._batch_buckets():
        for n in engine._len_buckets():
            sets = [[seeds[(i + j) % len(seeds)] for j in range(n)] for i in range(b)]
            assert len(engine.recommend_many(sets)) == b
    assert engine.unwarmed_dispatches == 0
    assert engine.cost_model.compiles_post_publish().get("serve_sharded", 0) == 0
    assert engine.cost_model.n_shards == 3


def test_auto_layout_shards_only_past_the_budget(pvc):
    base, _ = pvc
    tight = RecommendEngine(port_serving_cfg(base, model_layout="auto", device_budget_bytes=64,
                                             serve_devices=4), device="cpu")
    assert tight.load()
    assert tight.bundle.layout == "sharded" and tight.n_shards == 4
    roomy = RecommendEngine(port_serving_cfg(base, model_layout="auto",
                                             device_budget_bytes=1 << 40, serve_devices=4),
                            device="cpu")
    assert roomy.load()
    assert roomy.bundle.layout == "replicated" and len(roomy.replicas) == 4
    ref_tight = RefEngine(ref_serving_cfg(base, model_layout="auto", device_budget_bytes=64,
                                          serve_devices=4))
    assert ref_tight.load() and ref_tight.bundle.layout == "sharded"
    sets = _sets(tight.bundle)
    assert _many(tight, sets) == _many(roomy, sets) == _many(ref_tight, sets)


def test_hybrid_embeddings_ride_the_sharded_layout(tmp_path):
    """With embeddings published (a PVC the reference mined), a sharded
    engine answers as the reference's replicated one: only the rule
    tensors are sharded, the embedding lookup keeps the first slab's
    device, and neither lookup dispatches an unwarmed shape. Dyadic-free
    factors come from the reference's own training, so both packages read
    the same bytes."""
    base = str(tmp_path)
    ds_dir = os.path.join(base, "datasets")
    os.makedirs(ds_dir)
    b = ref_synthetic_baskets(60, 24, 300, seed=2)
    write_tracks_csv(os.path.join(ds_dir, "2023_spotify_ds1.csv"), TrackTable(
        pid=b.playlist_rows.astype(np.int64),
        track_name=np.asarray([b.vocab.names[int(t)] for t in b.track_ids], dtype=object)))
    ref_run_mining_job(dataclasses.replace(
        ref_mining_cfg(base), min_support=0.12, k_max_consequents=16,
        top_tracks_save_percentile=0.3, embed_enabled=True, als_rank=8, als_iters=3))
    shd = _sharded(base, 2, hybrid_mode="blend")
    ref = RefEngine(ref_serving_cfg(base, hybrid_mode="blend"))
    assert shd.load() and ref.load()
    assert shd.embedding_active and shd.bundle.layout == "sharded"
    bundle = shd.bundle
    cold = [n for n in bundle.emb_vocab
            if n not in bundle.index or not bundle.known_mask[bundle.index[n]]]
    sets = [_known(bundle)[:2], ["unknown-zz"], cold[:1] or [bundle.emb_vocab[0]],
            _known(bundle)[2:3] + cold[1:2]]
    got = _many(shd, sets)
    assert got == _many(ref, sets)
    assert shd.unwarmed_dispatches == 0 and shd.unwarmed_embed_dispatches == 0
    assert {source for _songs, source in got} >= {"hybrid", "fallback"}


def test_shard_dispatch_series_render(pvc):
    """Seed ids dispatched per shard: counted by the engine, rendered by the
    metrics and by the app's /metrics, with ``kmls_model_shards``."""
    base, _ = pvc
    engine = _sharded(base, 4)
    assert engine.load()
    seeds = _known(engine.bundle)
    engine.recommend_many([[s] for s in seeds[:4]])
    counts = engine.shard_dispatch_counts
    assert len(counts) == 4 and sum(counts) == 4
    text = ServingMetrics().render(engine.reload_counter, True, shard_counts=counts)
    assert 'kmls_shard_dispatch_total{shard="0"}' in text
    app = RecommendApp(engine.cfg, engine=engine, device="cpu")
    try:
        status, _, body = app.handle("GET", "/metrics", None)
        assert status == 200
        text = body.decode()
        assert "kmls_model_shards 4" in text
        for shard, count in enumerate(counts):
            assert f'kmls_shard_dispatch_total{{shard="{shard}"}} {count}' in text
        assert "kmls_serve_mesh_shards" not in text  # not a gang member
    finally:
        app.close()


def test_replicated_engine_exports_no_shard_series(pvc):
    base, _ = pvc
    engine = RecommendEngine(port_serving_cfg(base), device="cpu")
    assert engine.load()
    engine.recommend(_known(engine.bundle)[:1])
    assert engine.model_layout == "replicated" and engine.n_shards == 1
    assert engine.shard_dispatch_counts == []


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n_shards", [2, 4])
def test_x9_on_the_card_equals_the_cpu_run(n_shards, name):
    ids, confs, seeds, k_best = _rule_tensors(name, seed=n_shards)
    slab_ids, slab_confs, *_ = _slabs(ids, confs, n_shards)
    want = serve.sharded_recommend(slab_ids, slab_confs, torch.from_numpy(seeds), k_best=k_best)
    got = serve.sharded_recommend([t.cuda() for t in slab_ids], [t.cuda() for t in slab_confs],
                                  torch.from_numpy(seeds).cuda(), k_best=k_best)
    _equal((got[0].cpu(), got[1].cpu()), want)
