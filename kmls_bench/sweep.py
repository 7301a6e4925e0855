"""Sweeps of a serving mix on one server, to set a cell's load.

    python3 -m kmls_bench.sweep --config <serving config> --traffic <mix> --seed <n> \
        --seconds <s> --loads l1,l2,...

The loads are an open mix's offered rates (requests a second) or a closed
mix's client counts. One server over the configuration's publication
serves every load in turn, each a window of its own with fresh requests
of the mix; one JSON line per window: the load, the requests and the
rate achieved, the outcomes by kind, the latency p50 / p95 (from the due
time, over the answers in full), and the answers in full per device
dispatch of the engine (cache hits included).

The knee of an open mix is the highest offered rate at which the server
answers at least 95 % of it with no 5xx, no shed and no degraded answer;
an open cell's rate is set below it, and a closed cell's client count
where no answer degrades, and written into the mix's file.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

from . import loadgen, traffic as traffic_gen
from .cells import serve, subseed
from .run import HERE


def dispatches(before: dict, after: dict) -> float:
    """The engine's device dispatches (over every device) between two
    ``/metrics`` readings."""
    def total(m: dict) -> float:
        return sum(v for k, v in m.items() if k.split("{")[0] == "kmls_device_dispatch_total")

    return total(after) - total(before)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m kmls_bench.sweep")
    parser.add_argument("--config", required=True)
    parser.add_argument("--traffic", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=15.0)
    parser.add_argument("--loads", required=True)
    args = parser.parse_args(argv)
    config = json.loads((HERE / "configs" / f"{args.config}.json").read_text())
    mix = json.loads((HERE / "traffic" / f"{args.traffic}.json").read_text())
    work = tempfile.mkdtemp(prefix="kmls_bench_sweep_")
    server = None
    try:
        pub = serve.publish(config, args.seed, work)
        server = serve.start(config, "cuda", work)
        warm, _, _ = traffic_gen.window_requests(mix, pub["names"], args.seed, 0.0)
        serve.warm_up(server, warm, int(mix.get("clients", 8)))
        for k, load in enumerate(float(x) for x in args.loads.split(",")):
            if mix["kind"] == "open":
                mix["rate_per_s"] = load
            else:
                mix["clients"] = int(load)
            _, arrivals, payloads = traffic_gen.window_requests(
                mix, pub["names"], subseed(args.seed, "sweep", k), args.seconds)
            before = serve.parse_metrics(server.get("/metrics"))
            if mix["kind"] == "open":
                rec, t0 = loadgen.open_loop(server.port, payloads, arrivals,
                                            connections=int(mix["connections"]),
                                            pipeline=int(mix["pipeline"]))
                n = len(payloads)
            else:
                rec, t0, n = loadgen.closed_loop(server.port, payloads, clients=int(load),
                                                 seconds=args.seconds)
            after = serve.parse_metrics(server.get("/metrics"))
            ok, _, kinds = serve.tally(rec, n)
            in_window = sum(1 for i in ok if rec.done[i] <= t0 + args.seconds)
            lat = sorted((rec.done[i] - rec.due[i]) * 1e3 for i in ok)
            print(json.dumps({
                "load": load, "kind": mix["kind"], "requests": n,
                "answered_in_full_per_s": in_window / args.seconds,
                "outcomes": kinds,
                "p50_ms": serve._percentile(lat, 0.5) if lat else None,
                "p95_ms": serve._percentile(lat, 0.95) if lat else None,
                "answers_per_dispatch": len(ok) / max(dispatches(before, after), 1.0),
            }), flush=True)
            time.sleep(2.0)
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
