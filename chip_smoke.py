"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kmlserver_tpu_torch`` (and nothing of the JAX package) through its
main loop on the card and fails loudly on any mismatch:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles every CUDA kernel of the path from ``ops/csrc``;
3. kernel against plain: the popcount kernel against its plain PyTorch
   version at several padded shapes (default and non-default tiles, ragged
   V and P before padding, ``swar`` on and off) — exact equality;
4. end to end: writes a ds2-shaped synthetic CSV, runs
   ``python -m kmlserver_tpu_torch.mining.job`` on the card, checks its
   artifacts against the same job on the CPU, starts
   ``python -m kmlserver_tpu_torch.serving.server`` and holds every HTTP
   answer against the engine run on the CPU over the same PVC;
5. scale mine: Zipf baskets at 1M playlists x 1M tracks x 50M rows
   (BASELINE config 4's shape cut to one card), mined in process through
   ``mining.miner.mine`` with the launch counters reset just before and
   read just after; counts checked against exact numpy set intersections;
   then the kernel, its plain version and the ``torch._int_mm`` yardstick
   are timed at that shape and the kernels line is printed.

The last two lines of standard output are the card's
``nvidia-smi --query-gpu=name,power.limit`` line and the result JSON. Exits
non-zero, printing no result, without CUDA or outside a checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published HBM3 rate (NVIDIA data sheet). The pair count's binding
# unit is the popcount: compute capability 9.0 issues 16 popcounts per clock
# per SM (CUDA C++ Programming Guide, arithmetic instruction throughput),
# against 64 per clock for the AND and the add, so the popcounts alone take
# twice as long as those two together
PEAK_BYTES_PER_S = 3.35e12
POPC_PER_CLOCK_PER_SM = 16

SCALE = dict(n_playlists=1_000_000, n_tracks=1_000_000, target_rows=50_000_000)
SCALE_MIN_SUPPORT = 5e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def nvidia_smi_query(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def subproc_env(**extra: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


# ---------------------------------------------------------------- phase 3


def phase_kernel_vs_plain() -> int:
    import torch

    from kmlserver_tpu_torch.ops import popcount as pc

    rng = np.random.default_rng(0)
    max_err = 0
    # (n_tracks, n_playlists) before padding, tile knobs, swar
    cases = [
        (429, 2246, (32, 128, 512), False),  # the ds2 mine's shape
        (429, 2246, (32, 128, 512), True),
        (1000, 5000, (16, 64, 128), False),  # non-default tiles
        (300, 777, (64, 64, 256), True),
        (129, 257, (8, 24, 8), False),  # ragged V and P, tiny tiles
        (700, 3000, (6, 10, 64), True),  # knobs that don't fit: fallback block
    ]
    for n_tracks, n_playlists, (ti, tj, wk), swar in cases:
        os.environ.update(
            KMLS_POPCOUNT_TILE_I=str(ti), KMLS_POPCOUNT_TILE_J=str(tj),
            KMLS_POPCOUNT_WORD_CHUNK=str(wk),
        )
        v_pad, w_pad = pc.padded_shape(n_tracks, n_playlists)
        words = rng.integers(0, 2**32, size=(v_pad, w_pad), dtype=np.uint64)
        words[n_tracks:] = 0  # padded rows/bits are zero, as the packer leaves them
        tail = n_playlists % 32
        last = n_playlists // 32
        if tail:
            words[:, last] &= (1 << tail) - 1
        words[:, last + (1 if tail else 0):] = 0
        bt = torch.as_tensor(words.astype(np.uint32).view(np.int32), device="cuda")
        before = pc.LAUNCHES["popcount_pairs"]
        got = pc.popcount_pair_counts_padded(bt, swar=swar)
        torch.cuda.synchronize()
        if pc.LAUNCHES["popcount_pairs"] != before + 1:
            fail("popcount launch counter did not move")
        want = pc.popcount_pair_counts_plain(bt)
        torch.cuda.synchronize()
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"popcount kernel != plain at {tuple(bt.shape)} tiles "
                 f"{ti}x{tj}x{wk} swar={swar}: {bad} cells differ")
        log(f"kernel == plain: bt {tuple(bt.shape)} tiles {ti}x{tj}x{wk} "
            f"block {pc.block_shape(ti, tj)} swar={swar} (exact)")
    for key in ("KMLS_POPCOUNT_TILE_I", "KMLS_POPCOUNT_TILE_J", "KMLS_POPCOUNT_WORD_CHUNK"):
        os.environ.pop(key)
    return max_err


# ---------------------------------------------------------------- phase 4


def post(url: str, payload) -> tuple[int, bytes, float]:
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"}, method="POST"
    )
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), time.perf_counter() - t0


def wait_ready(base: str, proc: subprocess.Popen, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            fail(f"server exited early with {proc.returncode}")
        try:
            with urllib.request.urlopen(base + "/readyz", timeout=5) as resp:
                if resp.status == 200:
                    return
        except (urllib.error.URLError, ConnectionError):
            pass
        time.sleep(0.2)
    fail("server never became ready")


def phase_end_to_end(work: str) -> dict:
    from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
    from kmlserver_tpu_torch.data.csv import write_tracks_csv
    from kmlserver_tpu_torch.data.synthetic import DS2_SHAPE, synthetic_table
    from kmlserver_tpu_torch.io import artifacts
    from kmlserver_tpu_torch.mining.pipeline import run_mining_job
    from kmlserver_tpu_torch.serving.engine import RecommendEngine

    pvc = os.path.join(work, "pvc")
    os.makedirs(os.path.join(pvc, "datasets"))
    csv_path = os.path.join(pvc, "datasets", "2023_spotify_ds2_synthetic.csv")
    write_tracks_csv(csv_path, synthetic_table(**DS2_SHAPE, seed=7))

    t0 = time.perf_counter()
    job = subprocess.run(
        [sys.executable, "-m", "kmlserver_tpu_torch.mining.job"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=subproc_env(BASE_DIR=pvc, DATASETS_DIR=os.path.join(pvc, "datasets")),
    )
    job_s = time.perf_counter() - t0
    for line in job.stdout.splitlines():
        log(f"  job | {line}")
    if job.returncode != 0:
        log(job.stderr[-4000:])
        fail(f"mining job exited {job.returncode}")
    if "Pair-count path: bitpack-cuda" not in job.stdout:
        fail("job log does not show 'Pair-count path: bitpack-cuda'")
    launches = [
        int(line.rsplit(":", 1)[1]) for line in job.stdout.splitlines()
        if line.startswith("Popcount kernel launches:")
    ]
    if not launches or launches[0] < 1:
        fail(f"job launched the popcount kernel {launches} times")
    log(f"mining job (ds2, on the card): {job_s:.3f} s wall, "
        f"{launches[0]} popcount launch(es)")

    # the same job on the CPU, into a second PVC: published artifacts equal
    cpu_pvc = os.path.join(work, "pvc_cpu")
    os.makedirs(os.path.join(cpu_pvc, "datasets"))
    shutil.copy(csv_path, os.path.join(cpu_pvc, "datasets"))
    run_mining_job(
        MiningConfig(base_dir=cpu_pvc, datasets_dir=os.path.join(cpu_pvc, "datasets")),
        device="cpu",
    )
    cfg = MiningConfig(base_dir=pvc)
    for name in (cfg.recommendations_file, cfg.best_tracks_file,
                 cfg.artists_mapping_file, cfg.track_info_file):
        a = artifacts.load_pickle(os.path.join(cfg.pickles_dir, name))
        b = artifacts.load_pickle(os.path.join(cpu_pvc, "pickles", name))
        if a != b:
            fail(f"{name} from the card differs from the CPU run")
    npz = cfg.recommendations_file + artifacts.TENSOR_ARTIFACT_SUFFIX
    a = np.load(os.path.join(cfg.pickles_dir, npz), allow_pickle=True)
    b = np.load(os.path.join(cpu_pvc, "pickles", npz), allow_pickle=True)
    if a.files != b.files or not all(np.array_equal(a[k], b[k]) for k in a.files):
        fail("rule-tensor npz from the card differs from the CPU run")
    n_rules = int((a["rule_ids"] >= 0).sum())
    log(f"published artifacts equal the CPU run's ({len(a['vocab'])} frequent "
        f"tracks, {n_rules} rules)")

    # serve from the card; hold every answer against the CPU engine
    cpu_engine = RecommendEngine(ServingConfig(base_dir=pvc), device="cpu")
    if not cpu_engine.load():
        fail("CPU engine could not load the PVC")
    best = [b["track_name"] for b in artifacts.load_pickle(
        os.path.join(cfg.pickles_dir, cfg.best_tracks_file))]
    vocab = [str(name) for name in a["vocab"]]
    requests = [best[i:i + 1 + i % 4] for i in range(8)]
    # known, mixed known/unknown, and more seeds than KMLS_MAX_SEED_TRACKS
    requests += [vocab[-3:], [vocab[5], "No Such Track"], vocab[:200]]
    server = subprocess.Popen(
        [sys.executable, "-m", "kmlserver_tpu_torch.serving.server"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=subproc_env(BASE_DIR=pvc, KMLS_PORT="0"),
    )
    lines: list[str] = []
    port: list[int] = []
    ready = threading.Event()

    def pump() -> None:
        for line in server.stdout:
            lines.append(line.rstrip())
            if "serving on" in line and not port:
                port.append(int(line.split("serving on", 1)[1].split()[0].rsplit(":", 1)[1]))
                ready.set()

    threading.Thread(target=pump, daemon=True).start()
    try:
        if not ready.wait(120):
            fail("server never logged its port:\n" + "\n".join(lines[-40:]))
        base = f"http://127.0.0.1:{port[0]}"
        wait_ready(base, server, 120)
        latencies = []
        for seeds in requests:
            status, body, dt = post(base + "/api/recommend/", {"songs": seeds})
            latencies.append(dt)
            songs, source = cpu_engine.recommend(seeds)
            want = {"songs": songs, "model_date": cpu_engine.cache_value, "version": "V1.1"}
            if status != 200 or json.loads(body) != want:
                fail(f"HTTP answer for {seeds[:3]}... != CPU engine: {status} {body[:300]!r}")
        status, body, _ = post(base + "/api/recommend/", {"songs": ["Unknown A", "Unknown B"]})
        songs, source = cpu_engine.recommend(["Unknown A", "Unknown B"])
        if status != 200 or source != "fallback" or json.loads(body)["songs"] != songs:
            fail(f"fallback answer differs: {status} {body[:300]!r}")
        status, _, _ = post(base + "/api/recommend/", {"songs": []})
        if status != 400:
            fail(f"empty request answered {status}, want 400")
        status, _, _ = post(base + "/api/recommend/", b"{not json")
        if status != 422:
            fail(f"malformed request answered {status}, want 422")
    finally:
        server.terminate()
        try:
            server.wait(timeout=20)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
    lat = sorted(latencies)
    log(f"served {len(requests)} rule answers + fallback from the card, all equal "
        f"to the CPU engine; client latency ms: p50 {1e3 * lat[len(lat) // 2]:.3f} "
        f"max {1e3 * lat[-1]:.3f} (first {1e3 * latencies[0]:.3f})")
    return {"job_launches": launches[0], "job_s": job_s}


# ---------------------------------------------------------------- phase 5


def check_rows(tensors, baskets, rows: np.ndarray, k_max: int) -> None:
    """Each checked row of the mined rule tensors equals the top-k of its
    exact pair counts, computed by numpy set intersections."""
    pr, tid = baskets.playlist_rows, baskets.track_ids
    v = baskets.n_tracks
    order = np.argsort(tid, kind="stable")
    starts = np.searchsorted(tid[order], np.arange(v + 1))
    for i in rows:
        members = pr[order[starts[i]:starts[i + 1]]]
        in_row = np.zeros(baskets.n_playlists, dtype=bool)
        in_row[members] = True
        exact = np.bincount(tid[in_row[pr]], minlength=v)
        if exact[i] != len(members):
            fail(f"row {i}: self count {exact[i]} != {len(members)}")
        cand = np.flatnonzero(exact >= tensors.min_count)
        cand = cand[cand != i]
        ranked = cand[np.lexsort((cand, -exact[cand]))][:k_max]
        got_ids = tensors.rule_ids[i][tensors.rule_ids[i] >= 0]
        if not np.array_equal(got_ids, ranked):
            fail(f"row {i}: rule ids differ from exact set intersections")
        if not np.array_equal(tensors.rule_counts[i][: len(ranked)], exact[ranked]):
            fail(f"row {i}: rule counts differ from exact set intersections")


def phase_scale(seed: int) -> dict:
    import torch

    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.data.synthetic import synthetic_baskets
    from kmlserver_tpu_torch.mining.miner import mine, prune_infrequent
    from kmlserver_tpu_torch.ops import popcount as pc

    t0 = time.perf_counter()
    baskets = synthetic_baskets(**SCALE, seed=seed)
    log(f"scale data: {SCALE['n_playlists']} playlists x {SCALE['n_tracks']} "
        f"tracks, {len(baskets.track_ids)} memberships (Zipf 1.0, seed {seed}) "
        f"generated in {time.perf_counter() - t0:.3f} s")
    cfg = MiningConfig(min_support=SCALE_MIN_SUPPORT)

    # ---- the main path: counters to 0, mine, read counters
    for key in pc.LAUNCHES:
        pc.LAUNCHES[key] = 0
    torch.cuda.reset_peak_memory_stats()
    result = mine(baskets, cfg, device="cuda")
    launches = dict(pc.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches["popcount_pairs"] < 1 or result.count_path != "bitpack-cuda":
        fail(f"scale mine did not run the popcount kernel: {launches} {result.count_path}")
    phases = result.phase_timings
    share = phases["pair_counts"] / result.duration_s
    log(f"scale mine: {result.duration_s:.3f} s bracket, pruned "
        f"{result.n_tracks} -> {result.pruned_vocab} tracks, "
        + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
        + f"; popcount kernel phase share {share:.3f}; launches {launches}; "
        f"peak device memory {peak_gib:.3f} GiB")

    tensors = result.tensors
    reduced, _ = prune_infrequent(baskets, tensors.min_count)
    diag = np.bincount(reduced.track_ids, minlength=reduced.n_tracks)
    if not np.array_equal(diag, tensors.item_counts):
        fail("scale mine: item counts differ from np.bincount")
    rows = np.random.default_rng(seed).choice(reduced.n_tracks, 64, replace=False)
    rows = np.concatenate([[0, 1, reduced.n_tracks - 1], rows])
    check_rows(tensors, reduced, rows, cfg.k_max_consequents)
    log(f"scale mine checks: diagonal == np.bincount, {len(rows)} rows == exact "
        f"set intersections (ids and counts)")

    # ---- timings at the scale shape
    v_pad, w_pad = pc.padded_shape(reduced.n_tracks, reduced.n_playlists)
    bt = pc.bitpack_by_track(
        reduced.playlist_rows, reduced.track_ids,
        n_playlists=reduced.n_playlists, n_tracks=reduced.n_tracks,
        v_pad=v_pad, w_pad=w_pad, device="cuda",
    )
    del baskets, reduced
    got = pc.popcount_pair_counts_padded(bt)  # warm
    torch.cuda.synchronize()
    kernel_ms = cuda_ms(lambda: pc.popcount_pair_counts_padded(bt), 5)
    swar_ms = cuda_ms(lambda: pc.popcount_pair_counts_padded(bt, swar=True), 2)
    t0 = time.perf_counter()
    plain = pc.popcount_pair_counts_plain(bt)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    max_err = int((plain.long() - got.long()).abs().max())
    if not torch.equal(plain, got):
        fail(f"scale shape {tuple(bt.shape)}: kernel != plain")
    del plain
    log(f"scale shape bt {tuple(bt.shape)}: kernel == plain (exact); kernel "
        f"{kernel_ms:.3f} ms, swar kernel {swar_ms:.3f} ms, plain {plain_ms:.3f} ms")

    unpacked = torch.empty((v_pad, w_pad * 32), dtype=torch.int8, device="cuda")
    shifts = torch.arange(32, dtype=torch.int32, device="cuda")
    step = 1024
    for w0 in range(0, w_pad, step):
        w1 = min(w0 + step, w_pad)
        unpacked[:, w0 * 32:w1 * 32] = (
            (bt[:, w0:w1, None] >> shifts) & 1
        ).to(torch.int8).reshape(v_pad, -1)
    lib_out = torch._int_mm(unpacked, unpacked.t())
    torch.cuda.synchronize()
    if not torch.equal(lib_out, got):
        fail("torch._int_mm yardstick disagrees with the kernel")
    library_ms = cuda_ms(lambda: torch._int_mm(unpacked, unpacked.t()), 3)
    del unpacked, lib_out
    log(f"yardstick torch._int_mm on the unpacked int8 operand "
        f"({v_pad} x {w_pad * 32}): {library_ms:.3f} ms (unpack not timed)")

    # C is symmetric, so the function needs one popcount per word of each
    # unordered row pair, the diagonal included
    nbytes = 4 * v_pad * w_pad + 4 * v_pad * v_pad
    popcounts = v_pad * (v_pad + 1) // 2 * w_pad
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = 1e6 * float(nvidia_smi_query("clocks.max.sm").split()[0])
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * popcounts / (POPC_PER_CLOCK_PER_SM * sms * clock_hz)
    log(f"bound: {popcounts} popcounts at {POPC_PER_CLOCK_PER_SM}/clock x {sms} "
        f"SMs x {clock_hz / 1e6:.0f} MHz = {t_ops:.3f} ms; {nbytes} bytes at "
        f"{PEAK_BYTES_PER_S:.3g} B/s = {t_bytes:.3f} ms")
    return {
        "name": "popcount_pairs",
        "route": "cuda",
        "source": "kmlserver_tpu_torch/ops/csrc/popcount.cu",
        "replaces": "kmlserver_tpu/ops/popcount.py:267",
        "launches": launches["popcount_pairs"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "shape": [v_pad, w_pad],
        "swar_ms": swar_ms,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from kmlserver_tpu_torch.ops import cuda_build
    except ImportError as exc:
        print(f"FAIL: the port is not beside this script: {exc}", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    smi = nvidia_smi_query("name,power.limit")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)} ({smi})")

    t0 = time.perf_counter()
    cuda_build.build("popcount")
    log(f"build: popcount.cu in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {cuda_build.BUILD_LOG['popcount']['seconds']:.3f} s)")
    for line in cuda_build.BUILD_LOG["popcount"]["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas | {line.strip()}")

    small_err = phase_kernel_vs_plain()
    work = tempfile.mkdtemp(prefix="kmls_smoke_")
    try:
        e2e = phase_end_to_end(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernel = phase_scale(seed=2024)
    kernel["launches_job"] = e2e["job_launches"]
    kernel["max_abs_err"] = max(kernel["max_abs_err"], small_err)
    log(f"total smoke time {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
