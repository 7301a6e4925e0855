"""One member of a collective serve gang on the CPU, for
``tests/test_torch_mesh_collective.py``: joins the gang's torch.distributed
world (gloo), serves through ``RecommendEngine(..., gang_transport=
"collective")`` and records, per batch, the staged seeds, the merged ids and
confidences, the answers and the milliseconds — or the rank a
``MeshShardUnavailable`` named. Imports only the port.

    python tests/torch_gang_worker.py <spec.json>

The spec names the PVC, the gang's triple, the heartbeat bound, the batches
of each submitting thread, where the results go, a directory of barrier
files, and what the member does once its batches are answered
(``after``): ``close`` (once every member is done), ``close_now``,
``stay`` (until a peer ends it) or ``submit_forever``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from kmlserver_tpu_torch.config import ServingConfig  # noqa: E402
from kmlserver_tpu_torch.parallel import distributed  # noqa: E402
from kmlserver_tpu_torch.serving.app import RecommendApp  # noqa: E402
from kmlserver_tpu_torch.serving.engine import RecommendEngine  # noqa: E402
from kmlserver_tpu_torch.serving.mesh import MeshShardUnavailable  # noqa: E402

STAY_S = 120.0  # the longest a member waits for a peer to end it


def wait_files(directory: str, prefix: str, count: int, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while sum(n.startswith(prefix) for n in os.listdir(directory)) < count:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{count} {prefix}* files never appeared in {directory}")
        time.sleep(0.01)


def touch(directory: str, name: str) -> None:
    with open(os.path.join(directory, name), "w", encoding="utf-8") as fh:
        fh.write(repr(time.time()))


def capture(engine) -> threading.local:
    """Record each thread's last staged seeds and merged (ids, confs)."""
    seen = threading.local()
    stage, merge = engine._stage_seeds, engine._merge_on_device

    def stage_seeds(*args, **kwargs):
        seeds, known = stage(*args, **kwargs)
        seen.seeds = seeds.numpy().copy()
        return seeds, known

    def merge_on_device(*args, **kwargs):
        ids, confs = merge(*args, **kwargs)
        seen.ids, seen.confs = ids.copy(), confs.copy()
        return ids, confs

    engine._stage_seeds = stage_seeds
    engine._merge_on_device = merge_on_device
    return seen


def serve(engine, seen, batches: list, rows: list) -> None:
    for batch in batches:
        t0 = time.perf_counter()
        try:
            answers = engine.recommend_many(batch)
        except MeshShardUnavailable as exc:
            rows.append({"batch": batch, "error_rank": exc.rank, "reason": exc.reason})
            continue
        rows.append({
            "batch": batch, "answers": answers, "ms": 1e3 * (time.perf_counter() - t0),
            "seeds": seen.seeds.tolist(), "ids": seen.ids.tolist(),
            "confs_bits": seen.confs.view("uint32").tolist(),
        })


def main(spec_path: str) -> int:
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    rank, size, barrier = spec["rank"], spec["size"], spec["barrier_dir"]
    joined = distributed.maybe_initialize_serve_gang(
        spec["coordinator"], size, rank, "cpu", heartbeat_timeout_s=spec["heartbeat_timeout_s"])
    cfg = ServingConfig(
        base_dir=spec["base_dir"], polling_wait_in_minutes=0.001, native_serve=False,
        serve_gang_coordinator=spec["coordinator"], serve_gang_size=size, serve_gang_rank=rank,
        **spec["knobs"])
    # the engine's own call is the latch's second: a no-op
    engine = RecommendEngine(cfg, device="cpu", gang_transport="collective")
    assert joined and engine.load(), "the member did not join or load"
    gang = engine.mesh_coordinator
    deadline = time.monotonic() + 60
    while not (gang.formed or spec.get("expect_missing")) and time.monotonic() < deadline:
        time.sleep(0.005)
    touch(barrier, f"ready.{rank}")
    wait_files(barrier, "ready.", size, 60)
    seen = capture(engine)
    per_thread = [[] for _ in spec["threads"]]
    threads = [threading.Thread(target=serve, args=(engine, seen, batches, rows))
               for batches, rows in zip(spec["threads"], per_thread)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    app = RecommendApp(cfg, engine=engine, device="cpu", defer_batcher=True)
    _, _, metrics = app.handle("GET", "/metrics", None)
    ready_status, _, ready = app.handle("GET", "/readyz", None)
    result = {
        "rank": rank, "threads": per_thread, "unwarmed": engine.unwarmed_dispatches,
        "missing": engine.mesh_missing_shards(), "stats": gang.stats(),
        "transport": engine.gang_transport,
        "metrics": [ln for ln in metrics.decode().splitlines() if ln.startswith("kmls_serve_mesh")
                    or ln.startswith("kmls_model_shards")],
        "readyz": [ready_status, json.loads(ready)],
    }
    tmp = spec["out"] + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(result, fh)
    os.replace(tmp, spec["out"])
    touch(barrier, f"done.{rank}")
    print(f"DONE rank {rank}", flush=True)
    after = spec["after"]
    if after == "close":
        wait_files(barrier, "done.", size, 60)
        engine.close()
        print("CLOSED", flush=True)
        return 0
    if after == "close_now":
        wait_files(barrier, "done.", size, 60)
        touch(barrier, f"closing.{rank}")
        engine.close()
        print("CLOSED", flush=True)
        return 0
    if after == "submit_forever":
        batch = spec["threads"][0][0]
        end = time.monotonic() + STAY_S
        while time.monotonic() < end:
            try:
                engine.recommend_many(batch)
            except MeshShardUnavailable:
                pass
        return 3
    time.sleep(STAY_S)
    return 3


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
