"""Shared pieces of the serving front end's parity tests
(``tests/test_torch_{cache,batcher,app,replay}.py``): one small PVC mined
by the port on the CPU, matching serving configs for the port and the JAX
package, seed sets, an engine wrapper that slows or fails batches, the port's two
transports started on a thread, and the JAX package's test classes rebound
to the port's objects."""

from __future__ import annotations

import asyncio
import os
import threading
import time

import numpy as np
import pytest

from kmlserver_tpu.config import ServingConfig as RefServingConfig
from kmlserver_tpu.data.synthetic import synthetic_table
from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
from kmlserver_tpu_torch.data.csv import write_tracks_csv
from kmlserver_tpu_torch.io import artifacts
from kmlserver_tpu_torch.mining.pipeline import run_mining_job

# small knobs keep the warm-up grid (lengths x batches) cheap in both
# packages: lengths {1, 8}, batches {1, 2, 4, 8}
KNOBS = dict(max_seed_tracks=8, batch_max_size=8, k_best_tracks=10)


def mine_pvc(root) -> str:
    """A PVC published by the port's mining job on the CPU → its base dir."""
    base = os.path.join(str(root), "pvc")
    os.makedirs(os.path.join(base, "datasets"))
    write_tracks_csv(
        os.path.join(base, "datasets", "2023_spotify_ds_synth.csv"),
        synthetic_table(n_playlists=300, n_tracks=800, target_rows=6000, seed=5),
    )
    run_mining_job(
        MiningConfig(base_dir=base, datasets_dir=os.path.join(base, "datasets")), device="cpu"
    )
    return base


def port_cfg(base: str, **knobs) -> ServingConfig:
    # both sides on their device lookups (the native host lookup has its own
    # tests, test_torch_native.py)
    return ServingConfig(
        base_dir=base, polling_wait_in_minutes=5.0, **{"native_serve": False, **KNOBS, **knobs}
    )


def ref_cfg(base: str, **knobs) -> RefServingConfig:
    return RefServingConfig(
        base_dir=base, polling_wait_in_minutes=5.0, native_serve=False, **{**KNOBS, **knobs}
    )


def seed_sets(base: str, n: int, seed: int = 0) -> list[list[str]]:
    """``n`` distinct seed sets over the PVC's vocabulary: mostly 1-5 rule
    keys, some with an unknown track, some of unknown tracks only, some
    longer than the seed cap."""
    loaded = artifacts.load_rule_tensors(
        os.path.join(base, "pickles", "recommendations.pickle.tensors.npz")
    )
    vocab = [str(v) for v in loaded["vocab"]]
    rng = np.random.default_rng(seed)
    out, seen = [], set()
    while len(out) < n:
        k = int(rng.integers(1, 6)) if len(out) % 10 else int(rng.integers(9, 14))
        picks = [vocab[int(i)] for i in rng.choice(len(vocab), size=k, replace=False)]
        if len(out) % 7 == 3:
            picks.append(f"No Such Track {len(out)}")
        elif len(out) % 11 == 5:
            picks = [f"No Such Track {len(out)}"]  # the popularity fallback
        key = tuple(picks)
        if key not in seen:
            seen.add(key)
            out.append(picks)
    return out


def wrap_engine(engine, *, delay_s: float = 0.0, fail: bool = False) -> None:
    """Make ``engine``'s batches slow (their finish() sleeps ``delay_s``)
    or fail (dispatch raises) — in either package."""
    real = engine.recommend_many_async

    # deadline: the reference's batcher passes it when the wrapped engine
    # takes it (detected when its app was built); the local path ignores it
    def recommend_many_async(seed_sets, replica=None, deadline=None):
        if fail:
            raise RuntimeError("injected replica failure")
        finish = real(seed_sets) if replica is None else real(seed_sets, replica=replica)

        def slow_finish():
            time.sleep(delay_s)
            return finish()

        return slow_finish

    engine.recommend_many_async = recommend_many_async


class ServerThread:
    """One of the port's transports serving ``app`` on a thread (port 0):
    ``.port``, ``.drain()``, ``.join()`` → the transport's exit code."""

    def __init__(self, app, transport: str):
        from kmlserver_tpu_torch.serving.aioserver import run_async
        from kmlserver_tpu_torch.serving.server import serve_threaded

        self.port = None
        self._drain = None
        self.code = None
        bound = threading.Event()

        def ready(port, drain):
            self.port, self._drain = port, drain
            bound.set()

        def run():
            if transport == "async":
                self.code = asyncio.run(run_async(app, 0, ready=ready))
            else:
                self.code = serve_threaded(app, 0, ready=ready)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert bound.wait(30), "server never bound"

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def drain(self) -> None:
        self._drain()

    def join(self, timeout: float = 20.0):
        self.thread.join(timeout)
        assert not self.thread.is_alive(), "server did not exit after the drain"
        return self.code


def rebound_class(cls, **names):
    """``cls`` (a test class of the JAX package's suite) with every method
    re-created over its module's globals with ``names`` replaced — the
    same case bodies, run against the port's objects of those names."""
    import types

    members = {}
    for key, value in vars(cls).items():
        if isinstance(value, types.FunctionType):
            value = types.FunctionType(
                value.__code__, {**value.__globals__, **names}, value.__name__,
                value.__defaults__, value.__closure__,
            )
        members[key] = value
    return type(cls.__name__, cls.__bases__, members)


def reference_cases(*classes) -> list:
    """``(class, test name)`` for every test method of ``classes``."""
    return [
        pytest.param(cls, name, id=f"{cls.__name__}.{name}")
        for cls in classes for name in sorted(vars(cls)) if name.startswith("test_")
    ]
