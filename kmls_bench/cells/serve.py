"""The serving cells: the port's server (``python -m
kmlserver_tpu_torch.serving.server``, through :mod:`kmls_bench.serve_child`)
as a child process over a publication drawn from the seed, loaded over
HTTP by the benchmark's one asyncio loop.

Set-up draws the publication, writes it through the port's writer into a
directory under ``TMPDIR``, starts the server with its default knobs
(every length and batch bucket is warmed by its own load), waits for
``/readyz``, and sends ``warm_requests`` requests drawn apart from the
window's. The window starts at ``POST /metrics/reset`` and runs the mix
for ``seconds``: an open mix offers its arrivals on schedule, a closed mix
runs its clients. Then ``/metrics`` and the card's memory are read, the
server is drained with SIGTERM, and the check runs the reference on the
card over a sample of the answered requests, drawn from the seed, with the
longest request in it, holds every answer the admission ladder degraded
to the popularity fallback, and counts the requests not answered in full
(:func:`check`).

Untraced runs report the latency percentiles (``serve_p50_ms``,
``serve_p95_ms``; a request that failed counts as missing every limit) or
the answers a second (200 answers that are not degraded, completed in
the window). Traced runs trace the last ``trace_seconds`` of the window
in the server process, and write the trace once the window is over.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np

from .. import loadgen, publication, traffic as traffic_gen
from ..reference import serve as ref_serve
from . import subseed

ROOT = Path(__file__).resolve().parents[2]
READY_TIMEOUT_S = 600.0


def _percentile(sorted_ms: list[float], q: float) -> float:
    """The replay's percentile: the value at index ``floor(q·n)``."""
    return sorted_ms[min(int(q * len(sorted_ms)), len(sorted_ms) - 1)]


class Server:
    """The server child: started, awaited, drained, its output kept."""

    def __init__(self, base_dir: str, work: str, device: str, serving: dict,
                 trace_dir: str | None, fault: str | None):
        env = dict(os.environ)
        env.update({
            "BASE_DIR": base_dir, "KMLS_PORT": "0", "KMLS_TORCH_DEVICE": device,
            "POLLING_WAIT_IN_MINUTES": "600", "PYTHONUNBUFFERED": "1",
            "KMLS_HYBRID_MODE": serving["hybrid_mode"],
            "KMLS_HYBRID_BLEND_WEIGHT": str(serving["blend_weight"]),
            "K_BEST_TRACKS": str(serving["k_best"]),
            "KMLS_MAX_SEED_TRACKS": str(serving["max_seed_tracks"]),
            "KMLS_BATCH_MAX_SIZE": str(serving["batch_max_size"]),
        })
        env.pop("KMLS_BENCH_TRACE_DIR", None)
        env.pop("KMLS_BENCH_FAULT", None)
        if trace_dir:
            env["KMLS_BENCH_TRACE_DIR"] = trace_dir
        if fault:
            env["KMLS_BENCH_FAULT"] = fault
        self.log_path = os.path.join(work, "server.log")
        self.log = open(self.log_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kmls_bench.serve_child"], cwd=str(ROOT), env=env,
            stdout=self.log, stderr=subprocess.STDOUT)
        self.port = None

    def text(self) -> str:
        with open(self.log_path, "rb") as fh:
            return fh.read().decode("utf-8", "replace")

    def wait_ready(self) -> None:
        deadline = time.monotonic() + READY_TIMEOUT_S
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"the server exited {self.proc.returncode}:\n{self.text()[-4000:]}")
            if self.port is None:
                m = re.search(r"serving on [^:\s]+:(\d+)", self.text())
                if m:
                    self.port = int(m.group(1))
            if self.port is not None:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/readyz", timeout=5) as r:
                        if r.status == 200:
                            return
                except OSError:
                    pass
            time.sleep(0.1)
        raise RuntimeError(f"the server was not ready in {READY_TIMEOUT_S:.0f} s")

    def get(self, path: str) -> str:
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}", timeout=30) as r:
            return r.read().decode()

    def post(self, path: str) -> None:
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            r.read()

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()
        return self.proc.returncode


def parse_metrics(text: str) -> dict:
    """Prometheus text → ``{series with labels: value}``."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            try:
                out[name] = float(value)
            except ValueError:
                continue
    return out


def tally(rec, n: int) -> tuple[list[int], list[int], dict]:
    """The first ``n`` requests of ``rec`` → (the answered in full: 200
    and not degraded; the answered from the fallback by the admission
    ladder: 200 with ``X-KMLS-Degraded: overload``; every other outcome
    counted by kind: the ladder's 429, other statuses, other degrade
    reasons, unanswered)."""
    ok, overload, kinds = [], [], {}
    for i in range(n):
        if rec.status[i] is None:
            kind = "unanswered"
        elif rec.status[i] != 200:
            kind = str(rec.status[i])
        elif b"x-kmls-degraded" in rec.head[i]:
            kind = "degraded:" + re.search(rb"x-kmls-degraded: *([^\r]*)", rec.head[i]).group(1).decode()
            if kind == "degraded:overload":
                overload.append(i)
        else:
            ok.append(i)
            continue
        kinds[kind] = kinds.get(kind, 0) + 1
    return ok, overload, kinds


SHED_KINDS = ("degraded:overload", "429")  # the admission ladder's two answers under load


def card_memory_bytes() -> int:
    """The card's used memory as ``nvidia-smi`` reads it (the server is the
    only process on it during the window)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30, check=True).stdout
    return int(float(out.split()[0]) * (1 << 20))


def publish(config: dict, seed: int, work: str) -> dict:
    """Draw the configuration's publication from the seed and write it
    through the port's writer under ``work`` → the publication."""
    pub = publication.draw(config, subseed(seed, "publication"))
    publication.write(pub, os.path.join(work, "pvc"))
    return pub


def start(config: dict, device: str, work: str, *, trace_dir: str | None = None,
          fault: str | None = None) -> Server:
    """Start the server over the publication under ``work`` (it loads
    while the caller draws its requests)."""
    return Server(os.path.join(work, "pvc"), work, device, config["serving"], trace_dir, fault)


def warm_up(server: Server, warm: list[list[str]], clients: int) -> None:
    """Wait for ``/readyz``, then send the payloads ``warm`` from
    ``clients`` closed-loop clients."""
    server.wait_ready()
    loadgen.closed_loop(server.port, warm, clients=min(len(warm), clients), seconds=3600.0)


def run(*, config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, fault: str | None = None) -> dict:
    work = tempfile.mkdtemp(prefix="kmls_bench_serve_")
    server = None
    try:
        trace_dir = os.path.join(work, "trace") if trace else None
        if trace_dir:
            os.makedirs(trace_dir)
        pub = publish(config, seed, work)
        server = start(config, device, work, trace_dir=trace_dir, fault=fault)
        warm, arrivals, load = traffic_gen.window_requests(traffic, pub["names"], seed, seconds)
        warm_up(server, warm, int(traffic.get("clients", 8)))
        setup_s = time.perf_counter() - t_start

        timers = []
        if trace_dir:
            timers = [(max(0.0, seconds - float(traffic["trace_seconds"])),
                       lambda: Path(trace_dir, "start").touch()),
                      (seconds, lambda: Path(trace_dir, "stop").touch())]
        mem = [card_memory_bytes()] if device == "cuda" else [0]

        def reset_window():
            server.post("/metrics/reset")

        before = parse_metrics(server.get("/metrics"))
        if traffic["kind"] == "open":
            rec, t0 = loadgen.open_loop(server.port, load, arrivals,
                                        connections=int(traffic["connections"]),
                                        pipeline=int(traffic["pipeline"]), on_start=reset_window,
                                        timers=timers)
            n = len(load)
        else:
            rec, t0, n = loadgen.closed_loop(server.port, load, clients=int(traffic["clients"]),
                                             seconds=seconds, on_start=reset_window, timers=timers)
        after = parse_metrics(server.get("/metrics"))
        if device == "cuda":
            mem.append(card_memory_bytes())
        trace_obj = None
        if trace_dir:
            Path(trace_dir, "export").touch()
            trace_obj = _await_trace(trace_dir)
        code = server.stop()
        if code != 0:
            raise RuntimeError(f"the server exited {code}:\n{server.text()[-4000:]}")
        log = server.text()
        unwarmed = log.count("unwarmed")

        ok, overload, kinds = tally(rec, n)
        failed = n - len(ok)
        e2e = {"setup_s": setup_s}
        if traffic["kind"] == "open":
            lat = sorted([(rec.done[i] - rec.due[i]) * 1e3 for i in ok] + [math.inf] * failed)
            p95 = _percentile(lat, 0.95)
            if math.isinf(p95):
                raise RuntimeError(f"{failed} of {n} requests failed: the p95 falls on a failure")
            e2e.update(serve_p50_ms=_percentile(lat, 0.50), serve_p95_ms=p95)
        else:
            in_window = sum(1 for i in ok if rec.done[i] <= t0 + seconds)
            e2e["answers_per_s"] = in_window / seconds
        checks = check(config, traffic, seed, pub, [(load[i], rec.body[i]) for i in ok],
                       [(load[i], rec.body[i]) for i in overload], kinds, n, device)
        info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": _device_name() if device == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": max(mem)}
        return {
            "attempted": n, "failed": failed, "e2e": e2e, "device": info, "checks": checks,
            "layer": {"trace": trace_obj, "metrics_before": before, "metrics_after": after,
                      "device_kind": info["kind"]},
            "notes": {"unwarmed_log_lines": unwarmed, "failures": kinds,
                      "pool_ran_out": traffic["kind"] == "closed" and n >= len(load),
                      "late_s": max((rec.done[i] - rec.due[i] for i in ok), default=0.0)},
        }
    finally:
        if server is not None and server.proc.poll() is None:
            server.stop()
        shutil.rmtree(work, ignore_errors=True)


def _device_name() -> str:
    import torch

    return torch.cuda.get_device_name(0)


def _await_trace(trace_dir: str):
    from ..trace import Trace

    path = os.path.join(trace_dir, "trace.json")
    deadline = time.monotonic() + 180
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise RuntimeError("the server wrote no trace")
        time.sleep(0.2)
    return Trace.load(path)


def check(config: dict, traffic: dict, seed: int, pub: dict, answered, overload, kinds: dict,
          n: int, device: str) -> dict:
    """Hold the run's answers to the reference → ``{name: (value, limit)}``:

    - ``score_gap``, ``exact_mismatches``: a sample of the answers in full
      (drawn from the seed, the longest request in it) against the
      reference's, and every answer the admission ladder degraded against
      the popularity fallback (the seeds' sample, or past the fallback's
      deadline the head of the list);
    - ``error_answers``: requests answered neither in full nor by the
      ladder (unanswered, a 5xx, another degrade reason);
    - ``not_full_share``: the share of requests not answered in full.
    """
    serving = config["serving"]
    rng = np.random.default_rng(subseed(seed, "check"))
    m = min(int(traffic["check_sample"]), len(answered))
    pick = set(rng.choice(len(answered), size=m, replace=False).tolist()) if answered else set()
    if answered:
        pick.add(max(range(len(answered)), key=lambda i: len(answered[i][0])))
    limits = config["limits"]
    reference = ref_serve.Reference(pub, k_best=int(serving["k_best"]), weight=float(serving["blend_weight"]),
                                    max_seeds=int(serving["max_seed_tracks"]),
                                    tol=float(config["check"]["tie_tolerance"]),
                                    device=device)
    gap, exact = 0.0, 0
    for i in sorted(pick):
        seeds, body = answered[i]
        served = json.loads(body)["songs"]
        g, mismatch = ref_serve.judge(reference.answer(seeds), served)
        gap = max(gap, g)
        exact += int(mismatch)
    head = reference.best[: reference.k]
    for seeds, body in overload:
        served = json.loads(body)["songs"]
        exact += int(served not in (ref_serve.fallback(seeds, reference.best, reference.k), head))
    errors = sum(v for kind, v in kinds.items() if kind not in SHED_KINDS)
    return {"score_gap": (gap, limits["score_gap"]),
            "exact_mismatches": (exact, limits["exact_mismatches"]),
            "error_answers": (errors, limits["error_answers"]),
            "not_full_share": ((n - len(answered)) / max(n, 1), limits["not_full_share"])}
