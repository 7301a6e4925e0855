"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kmlserver_tpu_torch`` (and nothing of the JAX package) through its
main loop on the card and fails loudly on any mismatch:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles every CUDA kernel of the path from ``ops/csrc`` and logs
   ptxas's registers and spills;
3. kernels against plain: the tensor-core kernel and the SWAR kernel
   (``swar=True``) against their plain PyTorch version at several padded
   shapes — default and non-default tiles, ragged V and P before padding,
   all-ones rows, words with bit 31 set, a V_pad that is no multiple of the
   128-row tile with a W_pad that is no multiple of 4, a base pointer off a
   16-byte boundary, a lone diagonal tile — exact equality, each launch
   moving its own counter;
4. end to end: writes a ds2-shaped synthetic CSV, runs
   ``python -m kmlserver_tpu_torch.mining.job`` on the card, checks its
   artifacts against the same job on the CPU, starts
   ``python -m kmlserver_tpu_torch.serving.server`` and holds every HTTP
   answer against the engine run on the CPU over the same PVC;
5. scale mine: Zipf baskets at 1M playlists x 1M tracks x 50M rows
   (BASELINE config 4's shape cut to one card), mined in process through
   ``mining.miner.mine`` with the launch counters reset just before and
   read just after; counts checked against exact numpy set intersections;
   then the kernel, the SWAR kernel, its plain version (computed slab by
   slab over the two dp slabs of phase 6) and the ``torch._int_mm``
   yardstick are timed at that shape, and the kernel's time is set beside
   its bound (:func:`popcount_bound`);
6. ranks on the card (``parallel/``): two ranks, bootstrapped by the env
   triple, sharing the card over gloo (one card per rank over NCCL when
   the machine has two): (a) each rank's kernel on its slab of the ds2
   bitset against the plain version, and the all-reduced sum against the
   single-card kernel; (b) two ranks of ``python -m
   kmlserver_tpu_torch.mining.job`` on phase 4's CSV, whose rank-0
   publication must equal phase 4's; (c) the scale mine at dp = 2 from
   phase 5's baskets, whose rule tensors must equal phase 5's exactly,
   each rank timing its slab kernel and the all-reduce; then the kernels
   line is printed.

``--quick`` runs the same phases with the scale shape cut to 100k x 100k x
5M rows (a shorter check; prints a ``reduced`` line). The script starts
itself with ``--rank-worker`` for the ranks of phase 6.

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

# H100 SXM published rates (NVIDIA data sheet, dense, 700 W): HBM3 bytes
# and int8 tensor-core operations (a multiply-add counts as two). Two units
# can compute the pair count: the int8 tensor cores, on the 0/1 bytes of the
# unpacked bitset, and the popcount unit, on the packed words, which issues
# 16 popcounts per clock per SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput)
PEAK_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
POPC_PER_CLOCK_PER_SM = 16

KERNEL_DESIGN = ("int8 wgmma m64n128k32, bits unpacked in the operand load (A in "
                 "registers, B by a producer warpgroup into shared memory), upper "
                 "triangle of 128 x 128 tiles, mbarrier stage ring")

SCALE = dict(n_playlists=1_000_000, n_tracks=1_000_000, target_rows=50_000_000)
QUICK_SCALE = dict(n_playlists=100_000, n_tracks=100_000, target_rows=5_000_000)
SCALE_MIN_SUPPORT = 5e-4
DS2_MIN_SUPPORT = 0.05  # the job's default MIN_SUPPORT

RANKS = 2  # phase 6's dp


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


def popcount_bound(v_pad: int, w: int) -> dict:
    """The least time the card could take for the pair count over a
    ``(v_pad, w)`` bitset: the larger of its bytes over the memory rate and
    its operations over the fastest unit that can do them. C is symmetric,
    so the function needs each unordered row pair once, the diagonal
    included: 32·w int8 multiply-adds on the tensor cores, or w popcounts on
    the popcount unit. Bytes are the bitset read once and C written once.
    A kernel measured faster than ``ms`` means this count is wrong, not that
    the kernel beat the card: :func:`check_share` fails the smoke on it."""
    import torch

    pairs = v_pad * (v_pad + 1) // 2
    nbytes = 4 * v_pad * w + 4 * v_pad * v_pad
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = 1e6 * float(nvidia_smi_query("clocks.max.sm").split()[0])
    units = {
        "int8 tensor cores": 1e3 * 2 * pairs * 32 * w / INT8_TC_OPS_PER_S,
        "popcount unit": 1e3 * pairs * w / (POPC_PER_CLOCK_PER_SM * sms * clock_hz),
    }
    unit = min(units, key=units.get)
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = units[unit] >= t_bytes
    return {
        "ms": max(units[unit], t_bytes),
        "bound_by": "operations" if by_ops else "bytes",
        "unit": unit if by_ops else "HBM3",
        "units_ms": units,
        "bytes_ms": t_bytes,
        "bytes": nbytes,
        "int8_ops": 2 * pairs * 32 * w,
        "clock_hz": clock_hz,
    }


def check_share(name: str, ms: float, bound: dict) -> float:
    """→ the kernel's share of its bound; fails the smoke above 100 %."""
    share = bound["ms"] / ms
    if share > 1.0:
        fail(f"{name}: {ms:.3f} ms is below its bound {bound['ms']:.3f} ms "
             f"({bound['unit']}): the bound's count is wrong")
    return share


def ptxas_registers(log: str) -> dict[str, int]:
    """Registers per kernel entry from nvcc's ``-Xptxas=-v`` report, keyed
    ``popcount_pairs_tc_kernel<true>`` and the like."""
    regs: dict[str, int] = {}
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            entry = next((k for k in ("popcount_pairs_tc_kernel", "popcount_pairs_swar_kernel")
                          if k in mangled), mangled)
            if "ILb1E" in mangled:
                entry += "<true>"
            elif "ILb0E" in mangled:
                entry += "<false>"
        elif entry and "Used" in line and "registers" in line:
            regs[entry] = int(line.split("Used", 1)[1].split()[0])
            entry = None
    return regs


def int_mm_ms(bt, want) -> float:
    """``torch._int_mm`` on the unpacked int8 operand of ``bt`` (the
    yardstick: one library call for the same function), checked against
    ``want`` and timed by CUDA events; the unpack is not timed."""
    import torch

    v_pad, w = bt.shape
    unpacked = torch.empty((v_pad, w * 32), dtype=torch.int8, device="cuda")
    shifts = torch.arange(32, dtype=torch.int32, device="cuda")
    step = 1024
    for w0 in range(0, w, step):
        w1 = min(w0 + step, w)
        unpacked[:, w0 * 32:w1 * 32] = (
            (bt[:, w0:w1, None] >> shifts) & 1
        ).to(torch.int8).reshape(v_pad, -1)
    lib_out = torch._int_mm(unpacked, unpacked.t())
    torch.cuda.synchronize()
    if not torch.equal(lib_out, want):
        fail(f"torch._int_mm yardstick disagrees with the kernel at {tuple(bt.shape)}")
    del lib_out
    ms = cuda_ms(lambda: torch._int_mm(unpacked, unpacked.t()), 3)
    del unpacked
    return ms


def run_ranks(argvs: list[list[str]], envs: list[dict], timeout_s: float, label: str) -> list[str]:
    """Start one process per rank and wait for all of them. A rank that
    exits non-zero, or a group that outlives ``timeout_s``, kills the
    group and fails the smoke. → each rank's output."""
    procs = [
        subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for argv, env in zip(argvs, envs)
    ]
    outs: list[list[str]] = [[] for _ in procs]

    def pump(i: int) -> None:
        for line in procs[i].stdout:
            outs[i].append(line.rstrip())

    threads = [threading.Thread(target=pump, args=(i,), daemon=True) for i in range(len(procs))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                i = bad[0]
                fail(f"{label}: rank {i} exited {codes[i]}:\n" + "\n".join(outs[i][-60:]))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                fail(f"{label}: ranks still running after {timeout_s:.0f} s:\n"
                     + "\n".join(f"rank {i}: {o[-5:]}" for i, o in enumerate(outs)))
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in threads:
            t.join(timeout=10)
    return ["\n".join(o) for o in outs]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_envs(port: int, **extra: str) -> list[dict]:
    return [
        subproc_env(KMLS_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                    KMLS_NUM_PROCESSES=str(RANKS), KMLS_PROCESS_ID=str(r), **extra)
        for r in range(RANKS)
    ]


# ---------------------------------------------------------------- phase 3


def edge_bitset(rng, n_tracks: int, n_playlists: int, fill: str):
    """A padded bitset for phase 3 as a numpy uint32 array: random words
    (``fill="random"``), every word's bit 31 set on every other row
    (``"bit31"``) or every bit of every word set (``"ones"``). Rows and bits
    past the unpadded shape are zero, as the packer leaves them, except for
    ``"ones"``, which fills the whole padded array."""
    from kmlserver_tpu_torch.ops import popcount as pc

    v_pad, w_pad = pc.padded_shape(n_tracks, n_playlists)
    if fill == "ones":
        return np.full((v_pad, w_pad), 0xFFFFFFFF, dtype=np.uint32)
    words = rng.integers(0, 2**32, size=(v_pad, w_pad), dtype=np.uint64)
    if fill == "bit31":
        words[::2] |= 1 << 31
    words[n_tracks:] = 0
    tail = n_playlists % 32
    last = n_playlists // 32
    if tail:
        words[:, last] &= (1 << tail) - 1
    words[:, last + (1 if tail else 0):] = 0
    return words.astype(np.uint32)


def phase_kernel_vs_plain() -> int:
    """Phase 3: both kernels against the plain version on every case,
    exact; each launch moves its own counter and only that one."""
    import torch

    from kmlserver_tpu_torch.ops import popcount as pc

    rng = np.random.default_rng(0)
    max_err = 0
    # (n_tracks, n_playlists) before padding, tile knobs, words, base offset
    # in int32 elements (1: a base pointer off a 16-byte boundary)
    cases = [
        (429, 2246, (32, 128, 512), "random", 0),  # the ds2 mine's shape
        (1000, 5000, (16, 64, 128), "random", 0),  # non-default tiles
        (300, 777, (64, 64, 256), "random", 0),
        (129, 257, (8, 24, 8), "random", 0),  # ragged V and P, tiny tiles
        (700, 3000, (6, 10, 64), "random", 0),  # knobs the SWAR block can't take
        (256, 16384, (32, 128, 512), "ones", 0),  # every cell 32·W_pad
        (500, 9000, (32, 128, 128), "bit31", 0),  # words with bit 31 set
        # V_pad 144 is not a multiple of the 128 tile, W_pad 10 not of 4
        (129, 257, (8, 24, 5), "random", 0),
        (600, 4000, (32, 128, 128), "random", 1),  # unaligned base
        (100, 3000, (32, 128, 512), "random", 0),  # one tile: a lone diagonal
    ]
    for n_tracks, n_playlists, (ti, tj, wk), fill, offset in cases:
        os.environ.update(
            KMLS_POPCOUNT_TILE_I=str(ti), KMLS_POPCOUNT_TILE_J=str(tj),
            KMLS_POPCOUNT_WORD_CHUNK=str(wk),
        )
        words = edge_bitset(rng, n_tracks, n_playlists, fill).view(np.int32)
        flat = torch.zeros(words.size + offset, dtype=torch.int32, device="cuda")
        bt = flat[offset:].view(words.shape)
        bt.copy_(torch.as_tensor(words, device="cuda"))
        want = pc.popcount_pair_counts_plain(bt)
        if fill == "ones" and not bool((want == 32 * bt.shape[1]).all()):
            fail(f"plain version on all-ones rows {tuple(bt.shape)} is not 32·W_pad")
        for name, swar in (("popcount_pairs", False), ("popcount_pairs_swar", True)):
            before = dict(pc.LAUNCHES)
            got = pc.popcount_pair_counts_padded(bt, swar=swar)
            torch.cuda.synchronize()
            moved = {k: pc.LAUNCHES[k] - before[k] for k in before}
            if moved != {k: int(k == name) for k in before}:
                fail(f"{name}: launch counters moved by {moved}")
            max_err = max(max_err, int((got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                fail(f"{name} != plain at {tuple(bt.shape)} tiles {ti}x{tj}x{wk} "
                     f"{fill} words, base offset {4 * offset} B: {bad} cells differ")
        log(f"both kernels == plain: bt {tuple(bt.shape)} tiles {ti}x{tj}x{wk}, "
            f"{fill} words, base offset {4 * offset} B, SWAR block "
            f"{pc.block_shape(ti, tj)} (exact)")
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


def phase_scale(seed: int, work: str, shape: dict) -> dict:
    """Phase 5. Saves the basket arrays into ``work`` for phase 6's ranks and
    returns the kernel line's entry plus what phase 6 is held against."""
    import torch

    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.data.synthetic import synthetic_baskets
    from kmlserver_tpu_torch.mining.miner import mine, prune_infrequent
    from kmlserver_tpu_torch.ops import popcount as pc
    from kmlserver_tpu_torch.parallel import support

    t0 = time.perf_counter()
    baskets = synthetic_baskets(**shape, seed=seed)
    log(f"scale data: {shape['n_playlists']} playlists x {shape['n_tracks']} "
        f"tracks, {len(baskets.track_ids)} memberships (Zipf 1.0, seed {seed}) "
        f"generated in {time.perf_counter() - t0:.3f} s")
    np.save(os.path.join(work, "scale_rows.npy"), baskets.playlist_rows)
    np.save(os.path.join(work, "scale_tids.npy"), baskets.track_ids)
    with open(os.path.join(work, "scale_shape.json"), "w") as fh:
        json.dump({"n_playlists": baskets.n_playlists, "n_tracks": baskets.n_tracks}, fh)
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
    # phase 6's dp slabs of the same memberships: the plain version is
    # computed slab by slab, so one pass of it checks the whole-bitset
    # kernel here and each slab's kernel in phase 6
    _, w_total = support.sharded_padded_shape(reduced.n_tracks, reduced.n_playlists, RANKS)
    slabs = [
        pc.bitpack_slab_by_track(
            reduced.playlist_rows, reduced.track_ids,
            n_playlists=reduced.n_playlists, n_tracks=reduced.n_tracks,
            v_pad=v_pad, w_total=w_total, dp=RANKS, rank=r, device="cuda",
        )
        for r in range(RANKS)
    ]
    del baskets, reduced
    got = pc.popcount_pair_counts_padded(bt)  # warm
    torch.cuda.synchronize()
    kernel_ms = cuda_ms(lambda: pc.popcount_pair_counts_padded(bt), 5)
    if not torch.equal(pc.popcount_pair_counts_padded(bt, swar=True), got):
        fail(f"scale shape {tuple(bt.shape)}: SWAR kernel != tensor-core kernel")
    swar_ms = cuda_ms(lambda: pc.popcount_pair_counts_padded(bt, swar=True), 2)
    slab_plain, slab_plain_ms = [], []
    for slab in slabs:
        t0 = time.perf_counter()
        slab_plain.append(pc.popcount_pair_counts_plain(slab))
        torch.cuda.synchronize()
        slab_plain_ms.append(1e3 * (time.perf_counter() - t0))
    plain = slab_plain[0] + slab_plain[1]
    plain_ms = sum(slab_plain_ms)
    max_err = int((plain.long() - got.long()).abs().max())
    if not torch.equal(plain, got):
        fail(f"scale shape {tuple(bt.shape)}: kernel != plain")
    del plain
    log(f"scale shape bt {tuple(bt.shape)}: kernel == plain (exact; plain summed "
        f"over {RANKS} slabs {tuple(slabs[0].shape)}: "
        + ", ".join(f"{ms:.3f}" for ms in slab_plain_ms)
        + f" ms); kernel {kernel_ms:.3f} ms, swar kernel {swar_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")

    library_ms = int_mm_ms(bt, got)
    log(f"yardstick torch._int_mm on the unpacked int8 operand "
        f"({v_pad} x {w_pad * 32}): {library_ms:.3f} ms (unpack not timed)")

    bound = popcount_bound(v_pad, w_pad)
    share = check_share("popcount_pairs", kernel_ms, bound)
    log(f"bound: {bound['int8_ops']} int8 operations (one triangle) at "
        f"{INT8_TC_OPS_PER_S:.4g}/s = {bound['units_ms']['int8 tensor cores']:.3f} ms; "
        f"the popcount unit at {POPC_PER_CLOCK_PER_SM}/clock/SM x "
        f"{bound['clock_hz'] / 1e6:.0f} MHz = {bound['units_ms']['popcount unit']:.3f} ms; "
        f"{bound['bytes']} bytes at {PEAK_BYTES_PER_S:.3g} B/s = {bound['bytes_ms']:.3f} ms "
        f"-> {bound['ms']:.3f} ms ({bound['unit']}); the kernel at {100 * share:.1f} %, "
        f"torch._int_mm (both triangles) at {100 * bound['ms'] / library_ms:.1f} %")
    kernel = {
        "name": "popcount_pairs",
        "route": "cuda",
        "source": "kmlserver_tpu_torch/ops/csrc/popcount.cu",
        "replaces": "kmlserver_tpu/ops/popcount.py:267",
        "launches": launches["popcount_pairs"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["ms"],
        "bound_by": bound["bound_by"],
        "bound_unit": bound["unit"],
        "library_ms": library_ms,
        "shape": [v_pad, w_pad],
        "swar_ms": swar_ms,
        "design": KERNEL_DESIGN,
    }
    del bt, got
    return {
        "kernel": kernel,
        "tensors": tensors,
        "slabs": slabs,
        "slab_plain": slab_plain,
        "slab_plain_ms": slab_plain_ms,
    }


# ---------------------------------------------------------------- phase 6


def predicted_backend() -> str:
    import torch

    # rank r takes cuda:(r % device_count); NCCL needs a card per rank
    return "nccl" if torch.cuda.device_count() >= RANKS else "gloo"


def backend_of(out: str, rank: int) -> str:
    line = next((l for l in out.splitlines() if l.startswith("Distributed runtime:")), "")
    if f"rank {rank}/{RANKS}" not in line or "backend " not in line:
        fail(f"rank {rank} printed no backend line")
    return line.split("backend ", 1)[1].split()[0]


def rank_result(out: str, rank: int) -> dict:
    for line in out.splitlines():
        if line.startswith("RANK_RESULT "):
            return json.loads(line[len("RANK_RESULT "):])
    fail(f"rank {rank} printed no result")


def phase_ranks(work: str, scale: dict) -> dict:
    """Phase 6: ranks on the card."""
    import torch

    from kmlserver_tpu_torch.io import artifacts
    from kmlserver_tpu_torch.ops import popcount as pc

    want_backend = predicted_backend()
    case = (f"{RANKS} ranks, one card each over nccl" if want_backend == "nccl"
            else f"{RANKS} ranks sharing cuda:0 over gloo")
    log(f"phase 6 case: {case} ({torch.cuda.device_count()} card(s) visible)")
    worker = [sys.executable, os.path.abspath(__file__), "--rank-worker"]

    # ---- (a) each rank's slab kernel against plain; the sum against one card
    t0 = time.perf_counter()
    outs = run_ranks(
        [worker + ["slabs", work] for _ in range(RANKS)], rank_envs(free_port()), 300,
        "slab check",
    )
    slab_err = 0
    for r, out in enumerate(outs):
        if backend_of(out, r) != want_backend:
            fail(f"rank {r} ran backend {backend_of(out, r)}, the rule says {want_backend}")
        res = rank_result(out, r)
        for c in res["cases"]:
            for key in ("launched", "kernel_eq_plain", "slab_eq_block", "sum_eq_single"):
                if not c[key]:
                    fail(f"slab check, rank {r}, word chunk {c['word_chunk']}: {key} failed: {c}")
            slab_err = max(slab_err, c["max_abs_err"])
            log(f"  rank {r} slab {c['shape']} (word chunk {c['word_chunk']}, "
                f"{c['nonzero_words']} nonzero words): kernel == plain, slab == the "
                f"whole bitset's block, all-reduced sum == single-card kernel (exact)")
        if not all(c["nonzero_words"] > 0 for c in res["cases"] if c["word_chunk"] == 32):
            fail(f"rank {r}: the small-chunk case left its slab empty")
    log(f"slab check: {time.perf_counter() - t0:.3f} s wall")

    # ---- (b) the job's entry point on phase 4's CSV
    pvc, ranks_pvc = os.path.join(work, "pvc"), os.path.join(work, "pvc_ranks")
    os.makedirs(os.path.join(ranks_pvc, "datasets"))
    for name in os.listdir(os.path.join(pvc, "datasets")):
        shutil.copy(os.path.join(pvc, "datasets", name), os.path.join(ranks_pvc, "datasets"))
    t0 = time.perf_counter()
    outs = run_ranks(
        [[sys.executable, "-m", "kmlserver_tpu_torch.mining.job"] for _ in range(RANKS)],
        rank_envs(free_port(), BASE_DIR=ranks_pvc,
                  DATASETS_DIR=os.path.join(ranks_pvc, "datasets")),
        300, "job ranks",
    )
    job_s = time.perf_counter() - t0
    job_launches = []
    for r, out in enumerate(outs):
        for line in out.splitlines():
            log(f"  job rank {r} | {line}")
        if backend_of(out, r) != want_backend:
            fail(f"job rank {r} ran backend {backend_of(out, r)}, the rule says {want_backend}")
        if "Pair-count path: sharded-bitpack-cuda" not in out:
            fail(f"job rank {r} did not log 'Pair-count path: sharded-bitpack-cuda'")
        n = [int(l.rsplit(":", 1)[1]) for l in out.splitlines()
             if l.startswith("Popcount kernel launches:")]
        if not n or n[0] < 1:
            fail(f"job rank {r} launched the popcount kernel {n} times")
        job_launches.append(n[0])
        if (r == 0) == ("not the writer" in out):
            fail(f"job rank {r}: wrong writer role")
    history = artifacts.read_text(os.path.join(ranks_pvc, "dataset_history.csv"))
    if len(history.splitlines()) != 2:
        fail(f"the ranks' history has {len(history.splitlines()) - 1} runs, want 1")
    for name in sorted(os.listdir(os.path.join(pvc, "pickles"))):
        a, b = os.path.join(pvc, "pickles", name), os.path.join(ranks_pvc, "pickles", name)
        if name.endswith(".pickle") and artifacts.load_pickle(a) != artifacts.load_pickle(b):
            fail(f"{name} from the ranks differs from phase 4's")
        if name.endswith(".npz"):
            x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
            if x.files != y.files or not all(np.array_equal(x[k], y[k]) for k in x.files):
                fail(f"{name} from the ranks differs from phase 4's")
    log(f"job ranks: {job_s:.3f} s wall, launches {job_launches}; only rank 0 "
        f"published, and its pickles and npz equal phase 4's single-card run")

    # ---- (c) the scale mine at dp = RANKS: the main path of this phase
    t0 = time.perf_counter()
    outs = run_ranks(
        [worker + ["scale", work] for _ in range(RANKS)], rank_envs(free_port()), 900,
        "scale ranks",
    )
    results = [rank_result(out, r) for r, out in enumerate(outs)]
    for r, res in enumerate(results):
        if res["backend"] != want_backend:
            fail(f"scale rank {r} ran backend {res['backend']}, the rule says {want_backend}")
        if res["count_path"] != "sharded-bitpack-cuda" or res["launches"] < 1:
            fail(f"scale rank {r} did not run the kernel: {res}")
        log(f"  scale rank {r}: mine bracket {res['bracket_s']:.3f} s ("
            + ", ".join(f"{k} {v:.3f} s" for k, v in res["phases"].items())
            + f"); launches {res['launches']}; slab {res['slab_shape']} kernel "
            f"{res['slab_ms']:.3f} ms (CUDA events); all-reduce {res['all_reduce_ms']:.3f} "
            f"ms over {res['backend']}; peak device memory {res['peak_gib']:.3f} GiB")
    got = np.load(os.path.join(work, "ranks_tensors.npz"))
    want = scale["tensors"]
    for key in got.files:
        if not np.array_equal(got[key], getattr(want, key)):
            fail(f"dp={RANKS} scale mine: {key} differs from phase 5's single-card mine")
    log(f"scale ranks: {time.perf_counter() - t0:.3f} s wall; rank 0's rule tensors "
        f"({', '.join(got.files)}) == phase 5's exactly")

    # ---- the slab kernel at the scale slab shape, held against plain
    slabs = scale["slabs"]
    max_err = slab_err
    for r, (slab, plain) in enumerate(zip(slabs, scale["slab_plain"])):
        part = pc.popcount_pair_counts_padded(slab)
        torch.cuda.synchronize()
        max_err = max(max_err, int((part.long() - plain.long()).abs().max()))
        if not torch.equal(part, plain):
            fail(f"scale slab {r} {tuple(slab.shape)}: kernel != plain")
    v_pad, w_slab = slabs[0].shape
    part = pc.popcount_pair_counts_padded(slabs[0])
    if not torch.equal(pc.popcount_pair_counts_padded(slabs[0], swar=True), part):
        fail(f"scale slab 0 {tuple(slabs[0].shape)}: SWAR kernel != tensor-core kernel")
    swar_ms = cuda_ms(lambda: pc.popcount_pair_counts_padded(slabs[0], swar=True), 2)
    library_ms = int_mm_ms(slabs[0], part)
    del part
    bound = popcount_bound(v_pad, w_slab)
    ms = max(res["slab_ms"] for res in results)
    share = check_share("popcount_pairs_sharded", ms, bound)
    log(f"scale slabs {tuple(slabs[0].shape)}: kernel == plain on each (exact); "
        f"bound {bound['ms']:.3f} ms ({bound['unit']}, {bound['int8_ops']} int8 "
        f"operations), the slowest rank's kernel at {100 * share:.1f} %; SWAR kernel "
        f"{swar_ms:.3f} ms; torch._int_mm on the unpacked slab {library_ms:.3f} ms")
    return {
        "launches_job": job_launches,
        "kernel": {
            "name": "popcount_pairs_sharded",
            "route": "cuda",
            "source": "kmlserver_tpu_torch/ops/csrc/popcount.cu",
            "call_site": "kmlserver_tpu_torch/parallel/support.py",
            "replaces": "kmlserver_tpu/parallel/support.py:214",
            "launches": sum(res["launches"] for res in results),
            "launches_per_rank": [res["launches"] for res in results],
            "launches_job": sum(job_launches),
            "max_abs_err": max_err,
            "ms": ms,
            "ms_per_rank": [res["slab_ms"] for res in results],
            "plain_ms": scale["slab_plain_ms"][0],
            "bound_ms": bound["ms"],
            "bound_by": bound["bound_by"],
            "bound_unit": bound["unit"],
            "library_ms": library_ms,
            "swar_ms": swar_ms,
            "design": KERNEL_DESIGN,
            "all_reduce_ms": max(res["all_reduce_ms"] for res in results),
            "backend": want_backend,
            "dp": RANKS,
            "shape": [v_pad, w_slab],
            "mine_bracket_s": [res["bracket_s"] for res in results],
        },
    }


def rank_worker(task: str, work: str) -> int:
    """One rank of phase 6, started by :func:`phase_ranks` with the env
    triple; prints ``RANK_RESULT <json>``."""
    sys.path.insert(0, ROOT)
    from kmlserver_tpu_torch.parallel import distributed

    distributed.maybe_initialize(device="cuda", timeout_s=600)
    mesh = distributed.resolve_mesh("auto", distributed=True).flattened()
    out = {"rank": distributed.runtime().rank, "backend": distributed.runtime().backend}
    out.update((worker_slabs if task == "slabs" else worker_scale)(mesh, work))
    print("RANK_RESULT " + json.dumps(out), flush=True)
    distributed.shutdown()
    return 0


def worker_slabs(mesh, work: str) -> dict:
    import torch

    from kmlserver_tpu_torch.data.csv import read_tracks
    from kmlserver_tpu_torch.mining.miner import prune_infrequent
    from kmlserver_tpu_torch.mining.vocab import build_baskets
    from kmlserver_tpu_torch.ops import popcount as pc
    from kmlserver_tpu_torch.ops.support import min_count_for
    from kmlserver_tpu_torch.parallel import support
    from kmlserver_tpu_torch.parallel.mesh import this_rank

    datasets = os.path.join(work, "pvc", "datasets")
    baskets = build_baskets(read_tracks(os.path.join(datasets, os.listdir(datasets)[0])))
    reduced, _ = prune_infrequent(baskets, min_count_for(DS2_MIN_SUPPORT, baskets.n_playlists))
    cases = []
    # the job's word chunk (the data fills the first slab), then a small
    # one that puts the ds2 playlists into every slab
    for chunk in (None, 32):
        if chunk is None:
            os.environ.pop("KMLS_POPCOUNT_WORD_CHUNK", None)
        else:
            os.environ["KMLS_POPCOUNT_WORD_CHUNK"] = str(chunk)
        slab = support.pack_rank_slab(reduced, mesh, "cuda")
        before = pc.LAUNCHES["popcount_pairs"]
        part = pc.popcount_pair_counts_padded(slab)
        torch.cuda.synchronize()
        launched = pc.LAUNCHES["popcount_pairs"] == before + 1
        plain = pc.popcount_pair_counts_plain(slab)
        err = int((part.long() - plain.long()).abs().max())
        total = support.reduce_counts(part.clone(), mesh)
        v_pad, w_total = support.sharded_padded_shape(
            reduced.n_tracks, reduced.n_playlists, mesh.shape["dp"]
        )
        whole = pc.bitpack_by_track(
            reduced.playlist_rows, reduced.track_ids, n_playlists=reduced.n_playlists,
            n_tracks=reduced.n_tracks, v_pad=v_pad, w_pad=w_total, device="cuda",
        )
        s = slab.shape[1]
        i = mesh.ranks().index(this_rank())
        single = pc.popcount_pair_counts_padded(whole)
        torch.cuda.synchronize()
        cases.append({
            "word_chunk": chunk or pc.word_chunk(),
            "shape": list(slab.shape),
            "nonzero_words": int(slab.count_nonzero()),
            "launched": launched,
            "kernel_eq_plain": bool(torch.equal(part, plain)),
            "max_abs_err": err,
            "slab_eq_block": bool(torch.equal(whole[:, i * s:(i + 1) * s], slab)),
            "sum_eq_single": bool(torch.equal(total, single)),
        })
    os.environ.pop("KMLS_POPCOUNT_WORD_CHUNK", None)
    return {"cases": cases}


def worker_scale(mesh, work: str) -> dict:
    import torch

    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.mining.miner import mine, prune_infrequent
    from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
    from kmlserver_tpu_torch.ops import popcount as pc
    from kmlserver_tpu_torch.parallel import distributed, support

    with open(os.path.join(work, "scale_shape.json")) as fh:
        shape = json.load(fh)
    names = [f"Track {i:07d}" for i in range(shape["n_tracks"])]
    baskets = Baskets(
        playlist_rows=np.load(os.path.join(work, "scale_rows.npy")),
        track_ids=np.load(os.path.join(work, "scale_tids.npy")),
        n_playlists=shape["n_playlists"],
        vocab=Vocab(names=names, index={n: i for i, n in enumerate(names)}),
    )
    cfg = MiningConfig(min_support=SCALE_MIN_SUPPORT)
    # the job's mesh: "auto" over the world, flattened onto dp by the miner
    job_mesh = distributed.resolve_mesh("auto", distributed=True)

    # ---- the main path: counters to 0, mine, read counters
    for key in pc.LAUNCHES:
        pc.LAUNCHES[key] = 0
    torch.cuda.reset_peak_memory_stats()
    result = mine(baskets, cfg, device="cuda", mesh=job_mesh)
    launches = pc.LAUNCHES["popcount_pairs"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if distributed.runtime().rank == 0:
        t = result.tensors
        np.savez(os.path.join(work, "ranks_tensors.npz"), rule_ids=t.rule_ids,
                 rule_counts=t.rule_counts, rule_confs=t.rule_confs,
                 item_counts=t.item_counts, row_valid_counts=t.row_valid_counts)

    # ---- timings after the mine: this rank's slab kernel, ranks in turn
    reduced, _ = prune_infrequent(baskets, result.tensors.min_count)
    slab = support.pack_rank_slab(reduced, mesh, "cuda")
    pc.popcount_pair_counts_padded(slab)  # warm
    torch.cuda.synchronize()
    slab_ms = None
    for turn in mesh.ranks():
        distributed.barrier()
        if turn == distributed.runtime().rank:
            slab_ms = cuda_ms(lambda: pc.popcount_pair_counts_padded(slab), 3)
    distributed.barrier()
    counts = torch.ones((slab.shape[0], slab.shape[0]), dtype=torch.int32, device="cuda")
    support.reduce_counts(counts, mesh)  # warm
    torch.cuda.synchronize()
    distributed.barrier()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        support.reduce_counts(counts, mesh)
    torch.cuda.synchronize()
    all_reduce_ms = 1e3 * (time.perf_counter() - t0) / reps
    return {
        "count_path": result.count_path,
        "launches": launches,
        "bracket_s": result.duration_s,
        "phases": result.phase_timings,
        "slab_shape": list(slab.shape),
        "slab_ms": slab_ms,
        "all_reduce_ms": all_reduce_ms,
        "peak_gib": peak_gib,
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
    quick = "--quick" in sys.argv[1:]
    t_all = time.perf_counter()
    smi = nvidia_smi_query("name,power.limit")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)} ({smi})")
    if quick:
        log(f"reduced: --quick cuts the scale shape from {SCALE} to {QUICK_SCALE}")

    t0 = time.perf_counter()
    cuda_build.build("popcount")
    log(f"build: popcount.cu in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {cuda_build.BUILD_LOG['popcount']['seconds']:.3f} s)")
    ptxas = cuda_build.BUILD_LOG["popcount"]["ptxas"]
    for line in ptxas.splitlines():
        if any(k in line for k in ("registers", "spill", "entry function", "C7513")):
            log(f"  ptxas | {line.strip()}")
    registers = ptxas_registers(ptxas)

    small_err = phase_kernel_vs_plain()
    work = tempfile.mkdtemp(prefix="kmls_smoke_")
    try:
        e2e = phase_end_to_end(work)
        scale = phase_scale(2024, work, QUICK_SCALE if quick else SCALE)
        ranks = phase_ranks(work, scale)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernel = scale["kernel"]
    kernel["launches_job"] = e2e["job_launches"]
    kernel["launches_sharded"] = ranks["kernel"]["launches"] + sum(ranks["launches_job"])
    kernel["max_abs_err"] = max(kernel["max_abs_err"], small_err)
    for entry in (kernel, ranks["kernel"]):
        entry["ptxas_registers"] = registers
    log(f"total smoke time {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": [kernel, ranks["kernel"]]}))
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
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(*sys.argv[2:4]))
    sys.exit(main())
