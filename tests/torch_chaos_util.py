"""Shared pieces of the port's chaos twins
(``tests/test_torch_{mining_,storage_,}chaos.py``): fault state cleared
around every test in both packages, a check that no ``kmls-*`` thread of
the port outlives its test, and small PVCs mined by either package on the
CPU from a seeded numpy generator."""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

from kmlserver_tpu import faults as ref_faults
from kmlserver_tpu.config import MiningConfig as RefMiningConfig
from kmlserver_tpu.data.csv import write_tracks_csv
from kmlserver_tpu.io import iohealth as ref_iohealth
from kmlserver_tpu_torch import faults
from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
from kmlserver_tpu_torch.io import iohealth

from .oracle import random_baskets
from .test_pipeline import table_with_metadata

DATASET = "2023_spotify_ds1.csv"
# the reference's serving knobs for these PVCs, cut so the warm-up grid
# (lengths x batches) stays small in both packages
SERVE_KNOBS = dict(k_best_tracks=5, max_seed_tracks=8, batch_max_size=8)


def _owned_by_reference(thread: threading.Thread) -> bool:
    """True for a thread whose target is the JAX package's (its batchers
    have no close(), so their parked threads outlive the tests that hold
    the two packages side by side)."""
    target = getattr(thread, "_target", None)
    owner = getattr(target, "__self__", None)
    module = type(owner).__module__ if owner is not None else getattr(target, "__module__", "")
    return (module or "").startswith("kmlserver_tpu.")


@pytest.fixture(autouse=True)
def clean_chaos_state():
    """Faults and IO-health state cleared around every test (both
    packages), and no ``kmls-*`` thread the test started left running:
    lease heartbeats, watchdogs, batcher threads and read-deadline workers
    are stopped (the last exit once their stalled read ends)."""
    for mod in (faults, ref_faults):
        mod.clear()
    for monitor in (iohealth.MONITOR, ref_iohealth.MONITOR):
        monitor.reset()
    before = set(threading.enumerate())
    yield
    for mod in (faults, ref_faults):
        mod.clear()
    for monitor in (iohealth.MONITOR, ref_iohealth.MONITOR):
        monitor.reset()
    deadline = time.monotonic() + 10.0
    for thread in set(threading.enumerate()) - before:
        if thread.name.startswith("kmls-") and not _owned_by_reference(thread):
            thread.join(max(deadline - time.monotonic(), 0.0))
    leaked = sorted(
        t.name for t in set(threading.enumerate()) - before
        if t.name.startswith("kmls-") and t.is_alive() and not _owned_by_reference(t)
    )
    assert not leaked, f"threads outlived the test: {leaked}"


def write_dataset(base: str, seed: int = 0, n_playlists: int = 40, n_tracks: int = 16,
                  extra=()) -> str:
    """A PVC directory with one CSV of seeded random baskets → datasets dir."""
    rng = np.random.default_rng(seed)
    ds_dir = os.path.join(base, "datasets")
    os.makedirs(ds_dir, exist_ok=True)
    baskets = random_baskets(rng, n_playlists=n_playlists, n_tracks=n_tracks, mean_len=5)
    write_tracks_csv(os.path.join(ds_dir, DATASET), table_with_metadata(baskets + list(extra)))
    return ds_dir


def mining_knobs(**overrides) -> dict:
    """The reference chaos suite's mining settings (embed/eval off)."""
    return {**dict(min_support=0.1, k_max_consequents=32, top_tracks_save_percentile=0.25,
                   lease_ttl_s=5.0), **overrides}


def port_mining_cfg(base: str, **overrides) -> MiningConfig:
    return MiningConfig(base_dir=base, datasets_dir=os.path.join(base, "datasets"),
                        **mining_knobs(**overrides))


def ref_mining_cfg(base: str, **overrides) -> RefMiningConfig:
    # the reference's native CPU counter is not ported
    return RefMiningConfig(base_dir=base, datasets_dir=os.path.join(base, "datasets"),
                           native_cpu_pair_counts=False, **mining_knobs(**overrides))


def serving_pvc(base: str) -> MiningConfig:
    """The reference serving suite's PVC (60 random playlists plus six
    singleton playlists of a track that co-occurs with nothing), mined by
    the port on the CPU → its mining config."""
    from kmlserver_tpu_torch.mining.pipeline import run_mining_job

    write_dataset(base, seed=0, n_playlists=60, n_tracks=18, extra=[["loner"]] * 6)
    cfg = MiningConfig(base_dir=base, datasets_dir=os.path.join(base, "datasets"),
                       min_support=0.08, k_max_consequents=32,
                       top_tracks_save_percentile=0.5)
    run_mining_job(cfg, device="cpu")
    return cfg


def port_serving_cfg(base: str, **knobs) -> ServingConfig:
    return ServingConfig(base_dir=base, polling_wait_in_minutes=0.001, **{**SERVE_KNOBS, **knobs})


def ref_serving_cfg(base: str, **knobs):
    from kmlserver_tpu.config import ServingConfig as RefServingConfig

    # the reference's native host kernel is not ported: its device path
    return RefServingConfig(base_dir=base, polling_wait_in_minutes=0.001, native_serve=False,
                            **{**SERVE_KNOBS, **knobs})
