"""The serving cells' server process: the port's own entry point
(``kmlserver_tpu_torch.serving.server.main``), with the benchmark's
instrumentation around it when asked.

``python3 -m kmls_bench.serve_child`` with the server's environment, plus:

- ``KMLS_BENCH_TRACE_DIR``: a traced run. The profiler is started and
  stopped once before the server starts (its first start initialises
  CUPTI, which takes seconds), the engine's dispatch and embedding lookup
  are wrapped in ``kmls_bench:`` spans (rows, valid seeds and shape in the
  span's name, read from the host-side staging, so nothing synchronizes
  with the card), and a thread waits for the file ``start`` in that
  directory, traces every thread until the file ``stop`` appears, and
  once the file ``export`` appears (after the window: writing the trace
  holds the interpreter for seconds) writes ``trace.json`` there.
- ``KMLS_BENCH_FAULT`` (the harness's own tests): breaks the timed path
  underneath, so that the check must fail: ``answer`` reverses every
  answer's list where the engine composes it; ``half`` has both lookups
  compute only the first half of each batch's rows and hand those results
  to the other half too; ``raise`` has the engine raise on every batch.

When the server has drained, the process exits 9 if it loaded JAX or the
JAX package (compared by whole top-level module names), naming them.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from .isolation import forbidden_modules


def _profiler(torch):
    from torch._C._profiler import _ExperimentalConfig

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts, experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _install_spans(torch, engine) -> None:
    cls = engine.RecommendEngine
    dispatch, launch_embed = cls.recommend_many_async, cls._launch_embed

    def recommend_many_async(self, seed_sets, replica=None):
        with torch.profiler.record_function(f"kmls_bench:dispatch:rows={len(seed_sets)}"):
            return dispatch(self, seed_sets, replica)

    def _launch_embed(self, bundle, seeds):
        staged = seeds.numpy()
        v, r = bundle.emb_factors.shape
        name = (f"kmls_bench:embed_topk:valid={int((staged >= 0).sum())}:rows={staged.shape[0]}"
                f":len={staged.shape[1]}:v={v}:r={r}:k={self.cfg.k_best_tracks}")
        with torch.profiler.record_function(name):
            return launch_embed(self, bundle, seeds)

    cls.recommend_many_async = recommend_many_async
    cls._launch_embed = _launch_embed


def _trace_thread(torch, trace_dir: str) -> threading.Thread:
    def run() -> None:
        while not os.path.exists(os.path.join(trace_dir, "start")):
            time.sleep(0.002)
        prof = _profiler(torch)
        prof.start()
        with torch.profiler.record_function("kmls_bench:window"):
            while not os.path.exists(os.path.join(trace_dir, "stop")):
                time.sleep(0.002)
        prof.stop()
        while not os.path.exists(os.path.join(trace_dir, "export")):
            time.sleep(0.01)
        tmp = os.path.join(trace_dir, "trace.json.tmp")
        prof.export_chrome_trace(tmp)
        os.replace(tmp, os.path.join(trace_dir, "trace.json"))

    thread = threading.Thread(target=run, name="kmls-bench-trace", daemon=True)
    thread.start()
    return thread


def _install_fault(torch, engine, fault: str) -> None:
    cls = engine.RecommendEngine
    if fault == "answer":
        compose = cls._compose_answer

        def _compose_answer(self, *args, **kwargs):
            songs, source = compose(self, *args, **kwargs)
            return list(reversed(songs)), source

        cls._compose_answer = _compose_answer
    elif fault == "half":
        def first_half(lookup):
            def run(*args, k_best):
                *tables, seeds = args
                h = (seeds.shape[0] + 1) // 2
                ids, scores = lookup(*tables, seeds[:h], k_best=k_best)
                rows = torch.arange(seeds.shape[0], device=ids.device) % h
                return ids[rows], scores[rows]

            return run

        engine.recommend_batch = first_half(engine.recommend_batch)
        engine.embed_topk = first_half(engine.embed_topk)
    elif fault == "raise":
        def recommend_many_async(self, seed_sets, replica=None):
            raise RuntimeError("KMLS_BENCH_FAULT=raise: the engine fails every batch")

        cls.recommend_many_async = recommend_many_async
    else:
        raise ValueError(f"unknown KMLS_BENCH_FAULT {fault!r}")


def main() -> int:
    import torch

    from kmlserver_tpu_torch.serving import engine, server

    trace_dir = os.environ.get("KMLS_BENCH_TRACE_DIR")
    if trace_dir:
        prof = _profiler(torch)
        prof.start()
        prof.stop()
        _install_spans(torch, engine)
        _trace_thread(torch, trace_dir)
    fault = os.environ.get("KMLS_BENCH_FAULT")
    if fault:
        _install_fault(torch, engine, fault)
    code = server.main()
    bad = forbidden_modules()
    if bad:
        print(f"the server loaded {', '.join(bad)}", file=sys.stderr, flush=True)
        return 9
    return code


if __name__ == "__main__":
    sys.exit(main())
