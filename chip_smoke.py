"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kmlserver_tpu_torch`` (and nothing of the JAX package) through its
main loop on the card and fails loudly on any mismatch:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles every CUDA kernel of the path from ``ops/csrc``
   (``popcount.cu``, ``segsum.cu``; one ``nvcc`` each, all started
   together) and logs ptxas's registers and spills;
3. kernels against plain: the tensor-core kernel and the SWAR kernel
   (``swar=True``) against their plain PyTorch version at several padded
   shapes — default and non-default tiles, ragged V and P before padding,
   all-ones rows, words with bit 31 set, a V_pad that is no multiple of the
   128-row tile with a W_pad that is no multiple of 4, a base pointer off a
   16-byte boundary, a lone diagonal tile — exact equality, each launch
   moving its own counter;
4. end to end: writes a ds2-shaped synthetic CSV, runs
   ``python -m kmlserver_tpu_torch.mining.job`` on the card twice — with
   the default dispatch (it must take ``dense-fused``) and with
   ``KMLS_COUNT_PATH=bitpack`` (``bitpack-cuda``, the popcount kernel) —
   checks both publications against each other and the same job on the
   CPU, starts ``python -m kmlserver_tpu_torch.serving.server`` and holds
   every HTTP answer against the engine run on the CPU over the same PVC;
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
   each rank timing its slab kernel and the all-reduce;
7. count routes and census (``mining/dispatch.py``, ``ops/support.py``,
   ``ops/sparse.py``): the ds2 baskets mined in process through
   ``mining.miner.mine`` on the card and on the CPU at every case of
   :data:`ROUTE_CASES` — the auto dispatch, each family pinned, the sparse
   route with a long-basket threshold that sends baskets through the
   popcount kernel, confidence mode at ``max_itemset_len`` 3 and 4, the
   census in support mode — with the counters reset before each card mine;
   rule tensors, ``rule_confs64``, census and merge flag must equal the CPU
   run's, and in support mode every route's; then the dense products and
   the long-basket block are held against their plain versions and timed;
8. serving front end (``serving/``, run right after phase 4 on its PVC;
   alone: ``python -c "import chip_smoke as c; c.phase_serving()"``, which
   mines its own): both micro-batchers on the card with four batches in
   flight, hammered with 2,000 distinct seed sets from 64 threads; the
   server with each transport under 256 concurrent posts; on the async
   server with default knobs BASELINE config 5's replay — 1,000 warm-up
   requests, then 3 × 8,000 at 1,000 QPS over 48 connections with
   ``/metrics/reset`` between runs — and 8,000 distinct requests at
   10,000 QPS; ``recommend_batch`` timed at every (batch, length) bucket
   beside its byte bound. Every answer is held against the engine on the
   CPU; a 5xx, a differing answer, an unwarmed dispatch, a drain that does
   not exit 0 or a config 5 run under 95 % of its offered QPS fails.
9. crash-safety (``faults.py``, ``mining/checkpoint.py``, the engine's
   manifest check; run right after phase 8 on phase 4's CSV; alone:
   ``python -c "import chip_smoke as c; c.phase_resume()"``): the job
   in process on the card with ``KMLS_COUNT_PATH=bitpack``, uninterrupted
   (checkpoints off, then on), then killed by ``mine.crash.<phase>`` after
   each of encode, mine and rules and resumed on the card — the pickles,
   npz and manifest files equal the uninterrupted run's byte for byte, and
   the resume launches the popcount kernel once after encode, never after
   mine or rules; the mine case again with the default dispatch; a crash
   on the card resumed on the CPU and one on the CPU resumed on the card;
   then the engine on the card against the corrupt-artifact ladder (a
   flipped npz byte, a truncated pickle, the quarantine and the recovery,
   an npz with rule ids >= V under verification off), every answer held
   against the CPU engine; checkpoint save/load seconds and bytes logged;
   (e) the job with ``KMLS_EMBED_ENABLED=1`` and ``KMLS_ALS_SPARSE=always``
   (the segsum kernel, 16 launches) killed after ``embed`` and resumed on
   the card: the same bytes, embeddings.npz included, with no ALS sweep and
   no segsum launch.
10. observability (``observability/``, ``utils/profiling.py``; run right
   after phase 9 on phase 4's PVC; alone: ``python -c "import chip_smoke
   as c; c.phase_observability()"``): (a) the async server with
   ``KMLS_TRACE_SAMPLE=1.0`` under 2,000 distinct config-5 seed sets at
   1,000 QPS with a ``ClientTraceLog`` — every answer equal to the CPU
   engine's, every retained trace holding queue + device + compose spans
   that sum within its server time, ``tracejoin`` joining ≥ 95 % of the
   client records, the span split's p50/p99 logged; (b) in process, the
   serving loop stalled 200 ms: every follow-up request degraded or shed,
   no 5xx, ``kmls_loop_lag_ms`` above 100; (c) ``/metrics`` after (a):
   ``kmls_kernel_device_seconds{serve_rules}`` > 0, ``kmls_mfu`` in (0, 1],
   the peak source naming the card, ``kmls_device_bytes_in_use`` present,
   ``kmls_compiles_total{serve_rules}`` 0 like the unwarmed dispatches;
   (d) the job with ``KMLS_COUNT_PATH=bitpack`` and ``KMLS_PROFILE_DIR``:
   ``job_metrics.prom`` phases encode / mine / rules, count path
   ``bitpack-cuda``, the mine's flops equal to ``phase_cost``, and the
   profiler's CUDA time of the popcount launch within 20 % of a CUDA-event
   timing of the same launch; (e) ``/debug/profile?seconds=2`` under load
   writes a trace naming the lookup's kernels.
11. embeddings (``mining/als.py``, ``ops/segsum.py`` + ``csrc/segsum.cu``,
   ``ops/embed.py``, the engine's hybrid serving; run last, on phase 4's
   CSV and phase 5's scale baskets; alone: ``python -c "import chip_smoke
   as c; c.phase_embeddings()"``): (a) the ds2 job with
   ``KMLS_EMBED_ENABLED=1`` twice (dense ALS, 2,246 x 2,171, R = 32, 8
   iterations): byte-equal ``embeddings.npz``, the embed phase's flops
   equal to ``phase_cost("als_sweep")``, the card's training against the
   CPU plain run (normalized factors within 1e-4, final loss within 1e-5
   relative); (b) that PVC served in blend mode under 2,000 distinct
   config-5 draws over the embedding vocabulary at 1,000 QPS: every answer
   the CPU engine's except those decided by a near-tie (two candidate
   scores within 1e-6), counted; sources counted; zero 5xx; no unwarmed
   dispatch; (c) sparse ALS on the scale baskets: ``auto`` picks sparse,
   one accumulate each way held bit for bit against the CPU plain version
   and timed beside ``index_add_`` on the card and its bound (bytes,
   operations, or the longest row's chain of dependent adds), the same
   accumulate at every ``LONG_ROW_EVENTS`` candidate (each bit-equal, each
   timed: the measurement the constant is set from), one synthetic row of
   2,000,000 events held against the plain version and timed, two full
   trainings (counters set to 0 just before the first) bit-identical,
   peak device memory, ``embed_topk`` at V = 1M against the CPU.
12. continuous freshness (``freshness/``, ``quality/lifecycle.py``, the
   engine's in-place apply, ``parallel/support.py::restricted_pair_counts``;
   run after phase 11 on phase 4's CSV and phase 5's scale baskets; alone:
   ``python -c "import chip_smoke as c; c.phase_freshness()"``): (a) the
   job with ``KMLS_DELTA_ENABLED=1`` and ``KMLS_DELTA_COMPACT_AFTER=3`` and
   the server with ``KMLS_DELTA_ENABLED=1`` on a ds2 PVC: the full path
   (the job with deltas off + the server's reload) three times, then four
   cycles of the reference bench's append (24 playlists × 90 rows over a
   128-track slice, plus a new track) → the job → applied in the server —
   cycle 1 moves ``min_count`` 113 → 114, cycle 3 compacts the chain and
   the server hot-swaps it under a replay, cycle 4 publishes in the middle
   of config 5's replay (every answer the CPU engine's over the PVC before
   or after it, the post-delta one for every request sent after the
   server showed the apply, zero 5xx); the cache hit ratio around cycle
   2's apply; the job's step split and the apply's ms; no unwarmed
   dispatch; then a full re-mine of the final CSV on the card in a
   pristine PVC, whose npz tensors, rule pickle and answers equal base ∘
   chain's, and a compaction of the chain equal to it too;
   ``fleet_multiplier`` at 3 replicas; (b) the recount's card route at
   phase 5's shape after the prune (1M playlists × 8,124 tracks) for the
   rows of every track in 1,000 new Zipf playlists, equal to the same rows
   of the popcount kernel's C, the product timed beside its bound and
   ``int8_gram_plain``, peak device memory.
Then the kernels line is printed.

Not part of the run: :func:`probe_segsum_ring` builds ``segsum.cu`` with
its adds, its copies or both taken out and times one long row with each
(where a long row's time goes).

``--quick`` runs the same phases with the scale shape cut to 100k x 100k x
5M rows (a shorter check; prints a ``reduced`` line). The script starts
itself with ``--rank-worker`` for the ranks of phase 6.

The last two lines of standard output are the card's
``nvidia-smi --query-gpu=name,power.limit`` line and the result JSON. Exits
non-zero, printing no result, without CUDA or outside a checkout.
"""

from __future__ import annotations

import dataclasses
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

# the hand-written CUDA sources the smoke builds (ops/csrc/<name>.cu)
KERNEL_SOURCES = ("popcount", "segsum")

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


PTXAS_KERNELS = ("popcount_pairs_tc_kernel", "popcount_pairs_swar_kernel", "segsum_kernel")


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Registers and spilled bytes per kernel entry from nvcc's
    ``-Xptxas=-v`` report, keyed ``popcount_pairs_tc_kernel<true>``,
    ``segsum_kernel<false>`` and the like."""
    report: dict[str, dict[str, int]] = {}
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            entry = next((k for k in PTXAS_KERNELS if k in mangled), mangled)
            if "ILb1E" in mangled:
                entry += "<true>"
            elif "ILb0E" in mangled:
                entry += "<false>"
            report[entry] = {}
        elif entry and "spill stores" in line:
            words = line.replace(",", "").split()
            report[entry]["spill_store_bytes"] = int(words[words.index("spill") - 2])
            report[entry]["spill_load_bytes"] = int(words[-4])
        elif entry and "Used" in line and "registers" in line:
            report[entry]["registers"] = int(line.split("Used", 1)[1].split()[0])
            entry = None
    return report


def ptxas_registers(log: str) -> dict[str, int]:
    """Registers per kernel entry (:func:`ptxas_report`)."""
    return {k: r["registers"] for k, r in ptxas_report(log).items() if "registers" in r}


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


def start_server(pvc: str, **extra: str) -> tuple[subprocess.Popen, str, list[str]]:
    """``python -m kmlserver_tpu_torch.serving.server`` on the card over
    ``pvc``, waited on until ``/readyz`` answers 200 → (process, base URL,
    its log lines so far and to come)."""
    server = subprocess.Popen(
        [sys.executable, "-m", "kmlserver_tpu_torch.serving.server"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=subproc_env(BASE_DIR=pvc, KMLS_PORT="0", **extra),
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
    if not ready.wait(120):
        stop_server(server)
        fail("server never logged its port:\n" + "\n".join(lines[-40:]))
    base = f"http://127.0.0.1:{port[0]}"
    try:
        wait_ready(base, server, 120)
    except SystemExit:
        stop_server(server)
        raise
    return server, base, lines


def stop_server(server: subprocess.Popen) -> int:
    """SIGTERM (the drain), then wait; → the exit code (killed after 20 s)."""
    server.terminate()
    try:
        return server.wait(timeout=20)
    except subprocess.TimeoutExpired:
        server.kill()
        server.wait()
        return -9


def job_process(pvc: str, label: str, **extra: str) -> tuple[str, float]:
    """``python -m kmlserver_tpu_torch.mining.job`` on the card over
    ``pvc``; echoes its log and fails on a non-zero exit. → (stdout, wall s)."""
    t0 = time.perf_counter()
    job = subprocess.run(
        [sys.executable, "-m", "kmlserver_tpu_torch.mining.job"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=subproc_env(BASE_DIR=pvc, DATASETS_DIR=os.path.join(pvc, "datasets"), **extra),
    )
    wall = time.perf_counter() - t0
    for line in job.stdout.splitlines():
        log(f"  job {label} | {line}")
    if job.returncode != 0:
        log(job.stderr[-4000:])
        fail(f"mining job ({label}) exited {job.returncode}")
    return job.stdout, wall


def run_job(pvc: str, label: str, **extra: str) -> tuple[str, int, float]:
    """A full mining job (:func:`job_process`) → (stdout, popcount launches
    it logged, wall s)."""
    stdout, wall = job_process(pvc, label, **extra)
    launches = [
        int(line.rsplit(":", 1)[1]) for line in stdout.splitlines()
        if line.startswith("Popcount kernel launches:")
    ]
    if not launches:
        fail(f"job ({label}) logged no popcount launch count")
    return stdout, launches[0], wall


def same_publication(pvc_a: str, pvc_b: str) -> bool:
    """Pickles and the rule-tensor npz of two PVCs are equal."""
    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.io import artifacts

    cfg = MiningConfig()
    for name in (cfg.recommendations_file, cfg.best_tracks_file,
                 cfg.artists_mapping_file, cfg.track_info_file):
        a = artifacts.load_pickle(os.path.join(pvc_a, "pickles", name))
        b = artifacts.load_pickle(os.path.join(pvc_b, "pickles", name))
        if a != b:
            return False
    npz = cfg.recommendations_file + artifacts.TENSOR_ARTIFACT_SUFFIX
    a = np.load(os.path.join(pvc_a, "pickles", npz), allow_pickle=True)
    b = np.load(os.path.join(pvc_b, "pickles", npz), allow_pickle=True)
    return a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)


def phase_end_to_end(work: str) -> dict:
    from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
    from kmlserver_tpu_torch.data.csv import write_tracks_csv
    from kmlserver_tpu_torch.data.synthetic import DS2_SHAPE, synthetic_table
    from kmlserver_tpu_torch.io import artifacts
    from kmlserver_tpu_torch.mining.pipeline import run_mining_job
    from kmlserver_tpu_torch.serving.engine import RecommendEngine

    def new_pvc(name: str) -> str:
        pvc = os.path.join(work, name)
        os.makedirs(os.path.join(pvc, "datasets"))
        return pvc

    pvc = new_pvc("pvc")
    csv_path = os.path.join(pvc, "datasets", "2023_spotify_ds2_synthetic.csv")
    write_tracks_csv(csv_path, synthetic_table(**DS2_SHAPE, seed=7))

    # the default dispatch: dense-fused on the card (no popcount launch)
    out, launches_default, job_s = run_job(pvc, "default")
    if "Pair-count path: dense-fused" not in out:
        fail("default job log does not show 'Pair-count path: dense-fused'")
    log(f"mining job (ds2, on the card, default dispatch): {job_s:.3f} s wall, "
        f"{launches_default} popcount launch(es)")
    # the bit-packed family pinned: the popcount kernel
    bitpack_pvc = new_pvc("pvc_bitpack")
    shutil.copy(csv_path, os.path.join(bitpack_pvc, "datasets"))
    out, launches, bitpack_s = run_job(bitpack_pvc, "bitpack", KMLS_COUNT_PATH="bitpack")
    if "Pair-count path: bitpack-cuda" not in out:
        fail("KMLS_COUNT_PATH=bitpack job log does not show 'Pair-count path: bitpack-cuda'")
    if launches < 1:
        fail(f"KMLS_COUNT_PATH=bitpack job launched the popcount kernel {launches} times")
    log(f"mining job (ds2, on the card, KMLS_COUNT_PATH=bitpack): {bitpack_s:.3f} s "
        f"wall, {launches} popcount launch(es)")

    # the same job on the CPU, into a third PVC: all three publications equal
    cpu_pvc = new_pvc("pvc_cpu")
    shutil.copy(csv_path, os.path.join(cpu_pvc, "datasets"))
    cpu_summary = run_mining_job(
        MiningConfig(base_dir=cpu_pvc, datasets_dir=os.path.join(cpu_pvc, "datasets")),
        device="cpu",
    )
    for other, label in ((bitpack_pvc, "the bitpack job"), (cpu_pvc, "the CPU run")):
        if not same_publication(pvc, other):
            fail(f"the default job's publication differs from {label}'s")
    cfg = MiningConfig(base_dir=pvc)
    npz = cfg.recommendations_file + artifacts.TENSOR_ARTIFACT_SUFFIX
    a = np.load(os.path.join(cfg.pickles_dir, npz), allow_pickle=True)
    n_rules = int((a["rule_ids"] >= 0).sum())
    log(f"published artifacts of the dense-fused and bitpack-cuda jobs equal each "
        f"other and the CPU run's ({cpu_summary.count_path}; {len(a['vocab'])} "
        f"frequent tracks, {n_rules} rules)")

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
    server, base, _ = start_server(pvc)
    try:
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
        stop_server(server)
    lat = sorted(latencies)
    log(f"served {len(requests)} rule answers + fallback from the card, all equal "
        f"to the CPU engine; client latency ms: p50 {1e3 * lat[len(lat) // 2]:.3f} "
        f"max {1e3 * lat[-1]:.3f} (first {1e3 * latencies[0]:.3f})")
    return {"job_launches": launches, "job_launches_default": launches_default,
            "job_s": job_s, "bitpack_job_s": bitpack_s}


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
    mined_p, mined_v = reduced.n_playlists, reduced.n_tracks
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
    # the cost model's support_count formula counts the full 2·p·v²
    # product; the bound above counts one triangle of int8 operations
    from kmlserver_tpu_torch.observability.costmodel import PEAK_TABLE, phase_cost

    support_flops, _ = phase_cost("support_count", p=mined_p, v=mined_v)
    bf16_peak = dict((needle, f) for needle, f, _bw in PEAK_TABLE)["h100"]
    log(f"yardstick: support_count 2·p·v² at (p={mined_p}, v={mined_v}) = "
        f"{support_flops:.6g}, the kernel's triangle {bound['int8_ops']:.6g} int8 ops, ratio "
        f"{support_flops / bound['int8_ops']:.4f}; over the kernel's {kernel_ms:.3f} ms: "
        f"{support_flops / (kernel_ms / 1e3):.6g} FLOP/s = "
        f"{support_flops / (kernel_ms / 1e3) / bf16_peak:.4f}x the bf16 peak "
        f"{bf16_peak:.4g} (kmls_mfu would clamp it at 1.0)")
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


# ---------------------------------------------------------------- phase 7

# (name, knobs, the route the card must take, the census the reference
# prints for these baskets or None): the reference's confserve settings,
# its quad-overflow path and BASELINE config 2's settings among them
ROUTE_CASES = [
    ("auto", {}, "dense-fused", None),
    ("dense", {"KMLS_COUNT_PATH": "dense"}, "dense-fused", None),
    ("bitpack", {"KMLS_COUNT_PATH": "bitpack"}, "bitpack-cuda", None),
    ("sparse", {"KMLS_COUNT_PATH": "sparse"}, "sparse-hybrid", None),
    ("sparse_long", {"KMLS_COUNT_PATH": "sparse", "KMLS_SPARSE_LONG_BASKET": "64"},
     "sparse-hybrid", None),
    ("confserve", {"KMLS_CONFIDENCE_MODE": "confidence", "KMLS_MAX_ITEMSET_LEN": "3",
                   "MIN_SUPPORT": "0.05"}, "dense", {1: 424, 2: 12623, 3: 150547}),
    ("conf_len4", {"KMLS_CONFIDENCE_MODE": "confidence", "KMLS_MAX_ITEMSET_LEN": "4",
                   "MIN_SUPPORT": "0.05"}, "dense", {1: 424, 2: 12623, 3: 150547, 4: -1}),
    ("baseline2", {"KMLS_CONFIDENCE_MODE": "confidence", "KMLS_MAX_ITEMSET_LEN": "4",
                   "MIN_SUPPORT": "0.02"}, "dense", {1: 1084, 2: 43355, 3: 666131, 4: -1}),
    ("census3", {"KMLS_MAX_ITEMSET_LEN": "3"}, "dense", {1: 424, 2: 12623, 3: 150547}),
]

TENSOR_FIELDS = ("rule_ids", "rule_counts", "rule_confs", "item_counts", "row_valid_counts")


def same_tensors(a, b) -> bool:
    if any(not np.array_equal(getattr(a, k), getattr(b, k)) for k in TENSOR_FIELDS):
        return False
    if (a.rule_confs64 is None) != (b.rule_confs64 is None):
        return False
    return a.rule_confs64 is None or np.array_equal(a.rule_confs64, b.rule_confs64)


def config_from_knobs(knobs: dict):
    from kmlserver_tpu_torch.config import MiningConfig

    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        return MiningConfig.from_env(None)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def dense_product_times(baskets, min_support: float) -> dict:
    """The dense route's int8 products at this support's pruned shape, on
    the card by CUDA events: the pair product ``XᵀX`` (and the triple
    product ``YᵀX`` over the frequent pairs), each held against its plain
    version and set beside its int8 tensor-core bound."""
    import torch

    from kmlserver_tpu_torch.mining.miner import prune_infrequent
    from kmlserver_tpu_torch.ops import encode, support

    min_count = support.min_count_for(min_support, baskets.n_playlists)
    reduced, _ = prune_infrequent(baskets, min_count)
    p, v = reduced.n_playlists, reduced.n_tracks
    x = encode.onehot_matrix(
        torch.as_tensor(reduced.playlist_rows, device="cuda"),
        torch.as_tensor(reduced.track_ids, device="cuda"), n_playlists=p, n_tracks=v,
    )
    counts = support.pair_counts(x)
    xt = x.t().contiguous()
    if not torch.equal(counts, support.int8_gram_plain(xt, xt)):
        fail(f"dense pair product != plain at P {p} x V {v}")
    pi, pj, _, n_pairs = support.frequent_pairs(counts, min_count, capacity=1 << 16)
    n_pairs = min(n_pairs, 1 << 16)
    yt = xt[pi[:n_pairs].long()] * xt[pj[:n_pairs].long()]
    triple = support.int8_gram(yt, xt)
    if not torch.equal(triple, support.int8_gram_plain(yt, xt)):
        fail(f"dense triple product != plain at E {n_pairs} x P {p} x V {v}")
    torch.cuda.synchronize()
    pair_ms = cuda_ms(lambda: support.pair_counts(x), 20)
    pair_plain_ms = cuda_ms(lambda: support.int8_gram_plain(xt, xt), 5)
    triple_ms = cuda_ms(lambda: support.triple_counts(x, pi[:n_pairs], pj[:n_pairs]), 5)
    triple_gemm_ms = cuda_ms(lambda: support.int8_gram(yt, xt), 5)
    pair_bound = product_bound(2 * p * v * v, p * v + 4 * v * v)
    triple_bound = product_bound(2 * n_pairs * p * v, n_pairs * p + p * v + 4 * n_pairs * v)
    return {
        "P": p, "V": v, "E": n_pairs,
        "pair_ms": pair_ms, "pair_plain_ms": pair_plain_ms,
        "pair_bound_ms": pair_bound[0], "pair_bound_by": pair_bound[1],
        "triple_ms": triple_ms, "triple_gemm_ms": triple_gemm_ms,
        "triple_bound_ms": triple_bound[0], "triple_bound_by": triple_bound[1],
    }


def product_bound(int8_ops: int, nbytes: int) -> tuple[float, str]:
    """(ms, what binds) for an int8 product: its operations at the int8
    tensor-core rate or its bytes (inputs read once, output written once)
    at the memory rate, whichever takes longer."""
    t_ops = 1e3 * int8_ops / INT8_TC_OPS_PER_S
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def long_block_check(baskets, threshold: int) -> dict:
    """The sparse route's long-basket block at ``threshold``: the popcount
    kernel against its plain version on the block's bitset, and the block
    against the CPU's float64 contraction; the kernel timed beside its
    bound. (These launches are comparisons, made after the counters were
    read.)"""
    import torch

    from kmlserver_tpu_torch.mining.miner import prune_infrequent
    from kmlserver_tpu_torch.ops import popcount as pc
    from kmlserver_tpu_torch.ops import sparse
    from kmlserver_tpu_torch.ops.support import min_count_for

    # the mine's route sees the pruned baskets
    baskets, _ = prune_infrequent(baskets, min_count_for(DS2_MIN_SUPPORT, baskets.n_playlists))
    rows, tids = sparse._sorted_by_playlist(baskets.playlist_rows, baskets.track_ids)
    starts, counts = sparse._segments(rows)
    *_, lrows, ltids = sparse._split_long(rows, tids, starts, counts, threshold)
    v = baskets.n_tracks
    _, compact = np.unique(lrows, return_inverse=True)
    p_long = int(compact.max()) + 1
    v_pad, w_pad = pc.padded_shape(v, p_long)
    bt = pc.bitpack_by_track(compact.astype(np.int32), ltids.astype(np.int32),
                             n_playlists=p_long, n_tracks=v, v_pad=v_pad, w_pad=w_pad,
                             device="cuda")
    got = pc.popcount_pair_counts_padded(bt)
    want = pc.popcount_pair_counts_plain(bt)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        fail(f"sparse long-basket block: kernel != plain at bt {tuple(bt.shape)}")
    block = sparse._count_long_dense(lrows, ltids, v, "cuda")
    if not torch.equal(block.cpu(), sparse._count_long_dense(lrows, ltids, v)):
        fail("sparse long-basket block on the card != the CPU's float64 block")
    ms = cuda_ms(lambda: pc.popcount_pair_counts_padded(bt), 20)
    t0 = time.perf_counter()
    pc.popcount_pair_counts_plain(bt)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    library_ms = int_mm_ms(bt, got)
    bound = popcount_bound(v_pad, w_pad)
    return {"shape": [v_pad, w_pad], "long_playlists": p_long, "long_rows": int(len(lrows)),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["ms"],
            "bound_by": bound["bound_by"], "bound_unit": bound["unit"],
            "library_ms": library_ms}


def phase_routes() -> dict:
    """Phase 7: every count route and the census on the card, each case
    mined in process on the card and on the CPU from the ds2 baskets."""
    import contextlib
    import io

    from kmlserver_tpu_torch.data.synthetic import DS2_SHAPE, synthetic_baskets
    from kmlserver_tpu_torch.mining.miner import mine
    from kmlserver_tpu_torch.ops import popcount as pc

    baskets = synthetic_baskets(**DS2_SHAPE, seed=7)
    support_tensors = None
    cases = {}
    for name, knobs, route, census in ROUTE_CASES:
        cfg = config_from_knobs(knobs)
        # ---- the main path: counters to 0, mine on the card, read counters
        for key in pc.LAUNCHES:
            pc.LAUNCHES[key] = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            card = mine(baskets, cfg, device="cuda")
        launches = dict(pc.LAUNCHES)
        with contextlib.redirect_stdout(io.StringIO()):
            cpu = mine(baskets, cfg, device="cpu")
        for line in out.getvalue().splitlines():
            if line.startswith(("NOTE", "WARNING")):
                log(f"  {name} | {line}")
        if card.count_path != route:
            fail(f"phase 7 {name}: the card took {card.count_path}, want {route}")
        if not same_tensors(card.tensors, cpu.tensors):
            fail(f"phase 7 {name}: rule tensors on the card != the CPU run's ({cpu.count_path})")
        if card.itemset_census != cpu.itemset_census or (census and card.itemset_census != census):
            fail(f"phase 7 {name}: census {card.itemset_census} (CPU {cpu.itemset_census}, "
                 f"want {census})")
        if card.triple_merge_applied != cpu.triple_merge_applied:
            fail(f"phase 7 {name}: merge applied {card.triple_merge_applied} on the card, "
                 f"{cpu.triple_merge_applied} on the CPU")
        if cfg.confidence_mode == "support":
            if support_tensors is None:
                support_tensors = card.tensors
            if not same_tensors(card.tensors, support_tensors):
                fail(f"phase 7 {name}: support-mode tensors differ from the auto route's")
        if name in ("bitpack", "sparse_long"):
            if launches["popcount_pairs"] < 1:
                fail(f"phase 7 {name}: the popcount kernel was not launched ({launches})")
        if name == "conf_len4" and "quad-rule merge skipped" not in out.getvalue():
            fail("phase 7 conf_len4: no quad-overflow WARNING")
        cases[name] = {
            "route": card.count_path, "source": card.count_path_source,
            "cpu_route": cpu.count_path, "bracket_s": card.duration_s,
            "cpu_bracket_s": cpu.duration_s, "phases": card.phase_timings,
            "launches": launches, "census": card.itemset_census,
            "merge": card.triple_merge_applied, "pruned_vocab": card.pruned_vocab,
            "sparse_events": card.sparse_events,
        }
        log(f"phase 7 {name}: {card.count_path} ({card.count_path_source}; CPU "
            f"{cpu.count_path}), bracket {card.duration_s:.3f} s (CPU {cpu.duration_s:.3f} s): "
            + ", ".join(f"{k} {v:.3f} s" for k, v in card.phase_timings.items())
            + f"; launches {launches}; census {card.itemset_census}; merge "
            f"{card.triple_merge_applied}; tensors == CPU run (exact)")
    products = {}
    for min_support in (0.05, 0.02):
        t = dense_product_times(baskets, min_support)
        products[str(min_support)] = t
        log(f"dense products at min_support {min_support} (P {t['P']} x V {t['V']}, "
            f"{t['E']} frequent pairs): XᵀX {t['pair_ms']:.4f} ms (bound "
            f"{t['pair_bound_ms']:.4f} ms by {t['pair_bound_by']}; plain float64 "
            f"{t['pair_plain_ms']:.4f} ms); YᵀX {t['triple_ms']:.4f} ms with the gather, "
            f"{t['triple_gemm_ms']:.4f} ms the product alone (bound "
            f"{t['triple_bound_ms']:.4f} ms by {t['triple_bound_by']}); both == plain (exact)")
    long_block = long_block_check(baskets, 64)
    log(f"sparse long-basket block (threshold 64): bt {tuple(long_block['shape'])} from "
        f"{long_block['long_playlists']} playlists; kernel == plain (exact), == the CPU "
        f"float64 block; kernel {long_block['ms']:.4f} ms, plain {long_block['plain_ms']:.3f} "
        f"ms, torch._int_mm on the unpacked block {long_block['library_ms']:.4f} ms, bound "
        f"{long_block['bound_ms']:.4f} ms ({long_block['bound_unit']})")
    log("PHASE7 " + json.dumps({"cases": cases, "dense_products": products,
                                "long_block": long_block}))
    return {"cases": cases, "long_block": long_block,
            "launches_sparse_long": cases["sparse_long"]["launches"]["popcount_pairs"]}


# ---------------------------------------------------------------- phase 8

# BASELINE config 5 as the reference's bench measures it (bench.py:4484-4700,
# its client at bench.py:3199-3230): 1,000 warm-up requests, then three runs
# of 8,000 at 1,000 QPS over 48 pipelined connections with /metrics/reset
# between runs; then one run at the replay10k rate (bench.py:1316)
CONFIG5_QPS = 1000.0
CONFIG5_WARMUP = 1000
CONFIG5_REQUESTS = 8000
CONFIG5_RUNS = 3
CONFIG5_CONNS = 48
REPLAY10K_QPS = 10000.0
PIPELINE_SETS = 2000  # distinct seed sets per batcher in the staging check
CONCURRENT_POSTS = 256


def ds2_pvc(work: str) -> str:
    """Phase 4's ds2 PVC under ``work``, or — phase 8 alone — a new one:
    the ds2 CSV mined by the job on the card."""
    from kmlserver_tpu_torch.data.csv import write_tracks_csv
    from kmlserver_tpu_torch.data.synthetic import DS2_SHAPE, synthetic_table

    pvc = os.path.join(work, "pvc")
    if not os.path.exists(os.path.join(pvc, "last_execution.txt")):
        os.makedirs(os.path.join(pvc, "datasets"), exist_ok=True)
        write_tracks_csv(os.path.join(pvc, "datasets", "2023_spotify_ds2_synthetic.csv"),
                         synthetic_table(**DS2_SHAPE, seed=7))
        run_job(pvc, "phase 8")
    return pvc


def engine_answers(engine, payloads: list) -> list:
    """The engine's answers, 32 seed sets per call."""
    out = []
    for i in range(0, len(payloads), 32):
        out += engine.recommend_many(payloads[i:i + 32])
    return out


def check_responses(label: str, responses: list, payloads: list, want: list, cpu,
                    allow_drops: bool = False) -> dict:
    """Every HTTP answer against the CPU engine's: a rule, empty or fallback
    body exactly; a degraded body is the popularity fallback; a 5xx or any
    other body fails the smoke, and so does a request the load generator
    left unanswered (the client queue full, a connection lost) unless
    ``allow_drops`` (an overload run). → counts."""
    counts = {"ok": 0, "cached": 0, "degraded": 0, "shed": 0,
              "dropped": len(payloads) - len(responses)}
    if counts["dropped"] and not allow_drops:
        fail(f"{label}: {counts['dropped']} requests got no answer")
    head_k = [b["track_name"] for b in cpu.best_tracks][: cpu.cfg.k_best_tracks]
    for i, status, head, body in responses:
        if status >= 500:
            fail(f"{label}: HTTP {status} for {payloads[i]}: {body[:200]!r}")
        if status == 429:
            counts["shed"] += 1
            continue
        got = json.loads(body)
        if status == 200 and b"x-kmls-degraded:" in head:
            counts["degraded"] += 1
            if got["songs"] not in (cpu.static_recommendation(payloads[i]), head_k):
                fail(f"{label}: degraded answer for {payloads[i]} is not the fallback")
            continue
        expect = {"songs": want[i][0], "model_date": cpu.cache_value, "version": "V1.1"}
        if status != 200 or got != expect:
            fail(f"{label}: answer for {payloads[i]} != the CPU engine's: {status} {body[:300]!r}")
        counts["ok"] += 1
        counts["cached"] += b"x-kmls-cache: hit" in head
    return counts


def scrape_metrics(base: str) -> dict:
    with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
        text = resp.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def server_window(base: str) -> dict:
    """The server's view of the run just replayed, from /metrics."""
    m = scrape_metrics(base)

    def q(name: str, quantile: str, scale: float = 1.0) -> float:
        return scale * m[f'{name}{{quantile="{quantile}"}}']

    return {
        "server_p50_ms": q("kmls_request_latency_seconds", "0.5", 1e3),
        "server_p99_ms": q("kmls_request_latency_seconds", "0.99", 1e3),
        "queue_wait_p50_ms": q("kmls_queue_wait_ms", "0.5"),
        "queue_wait_p99_ms": q("kmls_queue_wait_ms", "0.99"),
        "device_p50_ms": q("kmls_device_ms", "0.5"),
        "device_p99_ms": q("kmls_device_ms", "0.99"),
        "shed_total": m["kmls_requests_shed_total"],
        "degraded_total": m["kmls_degraded_total"],
        "batches_total": sum(v for k, v in m.items() if k.startswith("kmls_device_dispatch_total")),
        "cache_hit_ratio": m.get("kmls_cache_hit_ratio"),
    }


def replay_run(base: str, label: str, payloads: list, want: list, cpu, qps: float,
               allow_drops: bool = False) -> dict:
    """One replay through the port's load generator, every answer checked,
    then the server's window read (reset just before it)."""
    from kmlserver_tpu_torch.serving.replay import replay_async_http

    status, _, _ = post(base + "/metrics/reset", b"")
    if status != 200:
        fail(f"{label}: /metrics/reset answered {status}")
    before = server_window(base)
    responses: list = []
    report = replay_async_http(base, payloads, qps=qps, n_conns=CONFIG5_CONNS,
                               responses=responses)
    counts = check_responses(label, responses, payloads, want, cpu, allow_drops)
    window = server_window(base)
    for key in ("shed_total", "degraded_total", "batches_total"):  # counters: this run's
        window[key] -= before[key]
    row = {"label": label, "qps": qps, "requests": len(payloads),
           "achieved_qps": report.achieved_qps, "p50_ms": report.p50_ms,
           "p95_ms": report.p95_ms, "p99_ms": report.p99_ms, "errors": report.n_errors,
           "client_cache_hit_ratio": report.cache_hit_ratio,
           "uncached_p50_ms": report.uncached_p50_ms, "cached_p50_ms": report.cached_p50_ms,
           **counts, **window}
    log(f"phase 8 {label}: {len(payloads)} requests at {qps:.0f} QPS → achieved "
        f"{report.achieved_qps:.1f} QPS, client p50/p95/p99 {report.p50_ms:.3f}/"
        f"{report.p95_ms:.3f}/{report.p99_ms:.3f} ms, errors {report.n_errors} "
        f"(shed {counts['shed']}, unanswered {counts['dropped']}, degraded "
        f"{counts['degraded']}, cache hits "
        f"{counts['cached']}); server p50/p99 {window['server_p50_ms']:.3f}/"
        f"{window['server_p99_ms']:.3f} ms, queue wait p50/p99 "
        f"{window['queue_wait_p50_ms']:.3f}/{window['queue_wait_p99_ms']:.3f} ms, "
        f"device p50/p99 {window['device_p50_ms']:.3f}/{window['device_p99_ms']:.3f} ms, "
        f"{window['batches_total']:.0f} batches; every answer == the CPU engine's")
    return row


def pipelined_batchers_check(card, cpu, payloads: list, want: list) -> dict:
    """Both batchers on the card, four batches in flight, hammered from 64
    threads: every answer equals the CPU engine's (a staging buffer or a
    copy-back reused too early would differ only under this load)."""
    import asyncio
    from concurrent.futures import ThreadPoolExecutor

    from kmlserver_tpu_torch.serving.batcher import AsyncMicroBatcher, MicroBatcher

    out = {}
    batcher = MicroBatcher(card, max_size=32, window_ms=2.0, max_inflight=4)
    before = sum(card.dispatch_counts)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(64) as pool:
        got = list(pool.map(lambda s: batcher.recommend(s, timeout=120), payloads))
    out["threaded"] = {"s": time.perf_counter() - t0,
                       "batches": sum(card.dispatch_counts) - before}
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        fail(f"phase 8: MicroBatcher on the card: {bad} answers != the CPU engine's")

    async def run_async() -> list:
        abatch = AsyncMicroBatcher(card, max_size=32, window_ms=2.0, max_inflight=4)
        loop = asyncio.get_running_loop()

        async def one(seeds):
            return await abatch.submit(seeds)

        def from_thread(seeds):
            return asyncio.run_coroutine_threadsafe(one(seeds), loop).result(120)

        def hammer():
            with ThreadPoolExecutor(64) as pool:
                return list(pool.map(from_thread, payloads))

        try:
            return await loop.run_in_executor(None, hammer)
        finally:
            abatch.close()

    before = sum(card.dispatch_counts)
    t0 = time.perf_counter()
    got = asyncio.run(run_async())
    out["async"] = {"s": time.perf_counter() - t0, "batches": sum(card.dispatch_counts) - before}
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        fail(f"phase 8: AsyncMicroBatcher on the card: {bad} answers != the CPU engine's")
    for name, r in out.items():
        log(f"phase 8 staging check ({name} batcher, 4 in flight, 64 threads): "
            f"{len(payloads)} distinct seed sets in {r['s']:.3f} s, {r['batches']} batches "
            f"(mean {len(payloads) / max(r['batches'], 1):.1f} rows); every answer == CPU")
    return out


def serve_bucket_times(card) -> list[dict]:
    """``recommend_batch`` at every (batch, length) bucket on the ds2 rule
    tensors, by CUDA events, each beside its bound: the bytes it must move
    (the seeds, the rule rows of the distinct seeds, the top-k out) over
    the memory rate. Also the host wall time of one whole dispatch →
    finish (staging, launches, copy back, event wait)."""
    import torch

    from kmlserver_tpu_torch.ops.serve import recommend_batch

    bundle = card.bundle
    k_best = card.cfg.k_best_tracks
    k_max = bundle.rule_ids.shape[1]
    known = torch.nonzero(torch.as_tensor(bundle.known_mask)).flatten()
    gen = torch.Generator().manual_seed(8)
    rows = []
    for length in card._len_buckets():
        for batch in card._batch_buckets():
            seeds_host = known[torch.randint(len(known), (batch, length), generator=gen)]
            seeds = seeds_host.to(torch.int32).cuda()

            def fn(seeds=seeds):
                return recommend_batch(bundle.rule_ids, bundle.rule_confs, seeds, k_best=k_best)

            fn()
            torch.cuda.synchronize()
            ms = cuda_ms(fn, 50)
            staged = card._staging((batch, length), bundle.device)
            staged.copy_(seeds_host.to(torch.int32))
            walls = []
            for _ in range(20):
                t0 = time.perf_counter()
                card._launch(bundle, staged)()
                walls.append(1e3 * (time.perf_counter() - t0))
            uniq = int(torch.unique(seeds).numel())
            nbytes = 4 * batch * length + 8 * uniq * k_max + 8 * batch * k_best
            rows.append({"batch": batch, "length": length, "ms": ms,
                         "dispatch_ms": sorted(walls)[len(walls) // 2],
                         "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
                         "bytes": nbytes})
    log("phase 8 serve lookup per bucket (recommend_batch, CUDA events; bound = "
        "bytes / 3.35 TB/s; dispatch = host wall of stage → launch → copy back → wait): "
        + "; ".join(f"{r['batch']}x{r['length']} {r['ms']:.4f} ms (dispatch "
                    f"{r['dispatch_ms']:.4f}, bound {r['bound_ms']:.6f})" for r in rows))
    return rows


def phase_serving(work: str | None = None) -> dict:
    """Phase 8: the serving front end on the card over the ds2 PVC — the
    staging check of both batchers, both transports under 256 concurrent
    posts, BASELINE config 5's replay on the async server with default
    knobs, one run at 10,000 QPS, and the serve lookup per bucket. Every
    answer is held against the engine on the CPU."""
    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.io import artifacts
    from kmlserver_tpu_torch.serving.engine import RecommendEngine
    from kmlserver_tpu_torch.serving.replay import replay_async_http, sample_seed_sets

    own = work is None
    work = work or tempfile.mkdtemp(prefix="kmls_smoke8_")
    try:
        pvc = ds2_pvc(work)
        cfg = ServingConfig(base_dir=pvc)
        cpu = RecommendEngine(cfg, device="cpu")
        card = RecommendEngine(cfg, device="cuda")
        t0 = time.perf_counter()
        if not card.load():
            fail("phase 8: the card engine could not load the PVC")
        load_s = time.perf_counter() - t0
        if not cpu.load():
            fail("phase 8: the CPU engine could not load the PVC")
        log(f"phase 8: engine loaded and warmed {len(card.bundle.warmed_shapes)} buckets on "
            f"{card.device} in {load_s:.3f} s ({len(card.replicas)} replica(s))")
        # the config-5 client's vocabulary: the rule dict's keys
        keys = sorted(artifacts.load_pickle(os.path.join(cfg.pickles_dir, cfg.recommendations_file)))
        distinct = list({tuple(s): s for s in sample_seed_sets(
            keys, PIPELINE_SETS + 400, rng_seed=3)}.values())[:PIPELINE_SETS]
        staging = pipelined_batchers_check(card, cpu, distinct, engine_answers(cpu, distinct))
        buckets = serve_bucket_times(card)
        if card.unwarmed_dispatches:
            fail(f"phase 8: {card.unwarmed_dispatches} unwarmed dispatches in process")

        transports = {}
        config5_payloads = sample_seed_sets(keys, CONFIG5_REQUESTS)
        config5_want = engine_answers(cpu, config5_payloads)
        fast_payloads = sample_seed_sets(keys, CONFIG5_REQUESTS, rng_seed=11)
        fast_want = engine_answers(cpu, fast_payloads)
        concurrent_payloads = distinct[:CONCURRENT_POSTS]
        concurrent_want = engine_answers(cpu, concurrent_payloads)
        runs: list[dict] = []
        for impl in ("threaded", "async"):
            t0 = time.perf_counter()
            server, base, lines = start_server(pvc, KMLS_HTTP_IMPL=impl)
            start_s = time.perf_counter() - t0
            try:
                responses: list = []
                t0 = time.perf_counter()
                replay_async_http(base, concurrent_payloads, qps=1e6, n_conns=64, pipeline=4,
                                  responses=responses)
                counts = check_responses(f"{impl} transport", responses, concurrent_payloads,
                                         concurrent_want, cpu)
                transports[impl] = {"start_s": start_s, "s": time.perf_counter() - t0, **counts}
                log(f"phase 8 {impl} transport: ready in {start_s:.3f} s; {CONCURRENT_POSTS} "
                    f"concurrent posts answered in {transports[impl]['s']:.3f} s, every answer "
                    f"== the CPU engine's ({counts})")
                if impl == "async":
                    warm = sample_seed_sets(keys, CONFIG5_WARMUP)
                    replay_async_http(base, warm, qps=CONFIG5_QPS, n_conns=CONFIG5_CONNS)
                    for i in range(CONFIG5_RUNS):
                        row = replay_run(base, f"config 5 run {i + 1}", config5_payloads,
                                         config5_want, cpu, CONFIG5_QPS)
                        if row["achieved_qps"] < 0.95 * CONFIG5_QPS:
                            fail(f"phase 8 config 5 run {i + 1}: achieved "
                                 f"{row['achieved_qps']:.1f} QPS < 95 % of {CONFIG5_QPS:.0f}")
                        runs.append(row)
                    runs.append(replay_run(base, "10k QPS", fast_payloads, fast_want, cpu,
                                           REPLAY10K_QPS, allow_drops=True))
            finally:
                code = stop_server(server)
            unwarmed = sum("unwarmed seed shape" in line for line in lines)
            transports[impl].update(exit_code=code, unwarmed_dispatches=unwarmed)
            if unwarmed:
                fail(f"phase 8 {impl} server: {unwarmed} unwarmed dispatches")
            if code != 0:
                fail(f"phase 8 {impl} server: exit {code} after SIGTERM (the drain)")
        result = {"staging": staging, "buckets": buckets, "transports": transports,
                  "runs": runs, "load_s": load_s}
        log("PHASE8 " + json.dumps(result))
        return result
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 9

RESUME_PHASES = ("encode", "mine", "rules")
# popcount launches of a resumed KMLS_COUNT_PATH=bitpack job, by crash phase:
# the resume after encode mines once, the later ones mine nothing
RESUME_LAUNCHES = {"encode": 1, "mine": 0, "rules": 0}
LADDER_SEEDS = 300  # seed sets held against the CPU engine per rung


def publication(pvc: str) -> dict:
    """The published bytes a resumed job must reproduce: every pickle, the
    npz twin, and the manifest's ``files`` (size + sha256 per artifact)."""
    from kmlserver_tpu_torch.io import artifacts

    pickles = os.path.join(pvc, "pickles")
    out = {}
    for name in sorted(os.listdir(pickles)):
        if name.endswith((".pickle", ".npz")):
            with open(os.path.join(pickles, name), "rb") as fh:
                out[name] = fh.read()
    manifest = artifacts.load_manifest(pickles)
    out["manifest files"] = json.dumps(manifest["files"], sort_keys=True) if manifest else None
    return out


class CheckpointLog:
    """Times every CheckpointStore save and load of phase 9 (seconds,
    bytes), by wrapping the two methods for the phase's duration."""

    def __init__(self):
        from kmlserver_tpu_torch.mining import checkpoint as ckpt_mod

        self.mod = ckpt_mod
        self.real = (ckpt_mod.CheckpointStore.save, ckpt_mod.CheckpointStore.load)
        self.saves: dict[str, list] = {}
        self.loads: dict[str, list] = {}

    def __enter__(self):
        real_save, real_load = self.real
        log_ = self

        def save(store, phase, payload, duration_s=None):
            t0 = time.perf_counter()
            path = real_save(store, phase, payload, duration_s=duration_s)
            if path is not None:
                log_.saves.setdefault(phase, []).append(
                    (time.perf_counter() - t0, os.path.getsize(path)))
            return path

        def load(store, phase, require=()):
            t0 = time.perf_counter()
            payload = real_load(store, phase, require)
            if payload is not None:
                log_.loads.setdefault(phase, []).append(
                    (time.perf_counter() - t0, store._state["phases"][phase]["bytes"]))
            return payload

        self.mod.CheckpointStore.save, self.mod.CheckpointStore.load = save, load
        return self

    def __exit__(self, *exc):
        self.mod.CheckpointStore.save, self.mod.CheckpointStore.load = self.real
        return False


def phase_resume(work: str | None = None) -> dict:
    """Phase 9: crash-safety on the card, in process, on phase 4's ds2 CSV.
    (a) a job killed after each checkpointed phase resumes on the card and
    publishes the uninterrupted job's bytes, launching the popcount kernel
    once when resumed after ``encode`` and never when resumed later; (b)
    resumes across devices; (c) the engine on the card against the
    corrupt-artifact ladder; (d) checkpoint save/load costs and the job's
    wall clock with checkpointing on and off."""
    import contextlib
    import dataclasses
    import io

    import torch

    from kmlserver_tpu_torch import faults
    from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
    from kmlserver_tpu_torch.data.csv import write_tracks_csv
    from kmlserver_tpu_torch.data.synthetic import DS2_SHAPE, synthetic_table
    from kmlserver_tpu_torch.io import artifacts, registry
    from kmlserver_tpu_torch.mining import als
    from kmlserver_tpu_torch.mining.pipeline import run_mining_job
    from kmlserver_tpu_torch.ops import popcount as pc
    from kmlserver_tpu_torch.ops import segsum
    from kmlserver_tpu_torch.serving.engine import RecommendEngine

    own = work is None
    work = work or tempfile.mkdtemp(prefix="kmls_smoke9_")
    root = os.path.join(work, "phase9")
    csv_path = os.path.join(root, "2023_spotify_ds2_synthetic.csv")
    os.makedirs(root)
    phase4_csv = os.path.join(work, "pvc", "datasets", "2023_spotify_ds2_synthetic.csv")
    if os.path.exists(phase4_csv):
        shutil.copy(phase4_csv, csv_path)
    else:
        write_tracks_csv(csv_path, synthetic_table(**DS2_SHAPE, seed=7))

    def new_pvc(name: str, **knobs) -> MiningConfig:
        pvc = os.path.join(root, name)
        os.makedirs(os.path.join(pvc, "datasets"))
        shutil.copy(csv_path, os.path.join(pvc, "datasets"))
        return MiningConfig(base_dir=pvc, datasets_dir=os.path.join(pvc, "datasets"), **knobs)

    def job(cfg, device="cuda"):
        """→ (summary, popcount launches, wall s, log); the counters are
        set to 0 just before and read just after."""
        for key in pc.LAUNCHES:
            pc.LAUNCHES[key] = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            summary = run_mining_job(cfg, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return summary, sum(pc.LAUNCHES.values()), time.perf_counter() - t0, out.getvalue()

    def crash(cfg, phase, device="cuda"):
        faults.clear()
        faults.inject(f"mine.crash.{phase}", times=1)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                run_mining_job(cfg, device=device)
        except faults.FaultInjected:
            pass
        else:
            fail(f"phase 9: the injected crash after {phase!r} did not fire")
        fired = faults.fired_counts().get((f"mine.crash.{phase}", None), 0)
        faults.clear()
        if fired != 1:
            fail(f"phase 9: mine.crash.{phase} fired {fired} times")
        if os.path.exists(os.path.join(cfg.pickles_dir, cfg.recommendations_file)):
            fail(f"phase 9: the job killed after {phase!r} published")

    def check_resume(label, summary, want_phases, base_bytes):
        if summary.resumed_phases != want_phases:
            fail(f"phase 9 {label}: resumed {summary.resumed_phases}, want {want_phases}")
        got = publication(summary_pvc(summary))
        if got != base_bytes:
            bad = sorted(k for k in base_bytes if got.get(k) != base_bytes[k])
            fail(f"phase 9 {label}: published bytes differ from the baseline's: {bad}")

    def summary_pvc(summary):
        return os.path.dirname(os.path.dirname(summary.artifact_paths["recommendations"]))

    bitpack = dict(count_path="bitpack")
    try:
        with CheckpointLog() as ckpt_log:
            # ---- (d) the uninterrupted job: a first run (it pays the
            # process's first mine on the card, and the kernel's build when
            # this phase runs alone), then checkpoints on, off, off, on
            first, _, first_s, _ = job(new_pvc("first", checkpoint_enabled=False, **bitpack))
            base_cfg = new_pvc("baseline", **bitpack)
            base, base_launches, on_s, _ = job(base_cfg)
            if base.count_path != "bitpack-cuda" or base_launches < 1:
                fail(f"phase 9 baseline: {base.count_path}, {base_launches} popcount launches")
            base_bytes = publication(base_cfg.base_dir)
            walls = {"on": [on_s], "off": []}
            for i, knob in enumerate(("off", "off", "on")):
                summary, _, wall, _ = job(new_pvc(f"{knob}{i}", checkpoint_enabled=knob == "on",
                                                  **bitpack))
                walls[knob].append(wall)
                if publication(summary_pvc(summary)) != base_bytes:
                    fail(f"phase 9: the job with checkpoints {knob} published other bytes")
            if publication(summary_pvc(first)) != base_bytes:
                fail("phase 9: the first job published other bytes")
            on_s, off_s = (sum(walls[k]) / len(walls[k]) for k in ("on", "off"))
            log(f"phase 9 baseline (ds2, KMLS_COUNT_PATH=bitpack, on the card, in process): "
                f"job wall {on_s:.3f} s with checkpoints ({', '.join(f'{w:.3f}' for w in walls['on'])}),"
                f" {off_s:.3f} s without ({', '.join(f'{w:.3f}' for w in walls['off'])}); "
                f"first run {first_s:.3f} s; {base_launches} popcount launch(es)")

            # ---- (a) kill after each phase, resume on the card
            resumes = {}
            for phase in RESUME_PHASES:
                cfg = new_pvc(f"crash_{phase}", **bitpack)
                crash(cfg, phase)
                summary, launches, wall, _ = job(cfg)
                want = RESUME_PHASES[: RESUME_PHASES.index(phase) + 1]
                check_resume(f"resume after {phase}", summary, want, base_bytes)
                if launches != RESUME_LAUNCHES[phase] or summary.kernel_launches != launches:
                    fail(f"phase 9 resume after {phase}: {launches} popcount launches "
                         f"(summary {summary.kernel_launches}), want {RESUME_LAUNCHES[phase]}")
                resumes[phase] = {"wall_s": wall, "launches": launches}
                log(f"phase 9 (a) killed after {phase!r}, resumed on the card: "
                    f"{summary.resumed_phases}, {launches} popcount launch(es), {wall:.3f} s "
                    f"wall; pickles, npz and manifest files == the baseline's")
            cfg = new_pvc("crash_mine_default")
            crash(cfg, "mine")
            summary, launches, wall, _ = job(cfg)
            check_resume("default dispatch", summary, ("encode", "mine"), base_bytes)
            if launches != 0 or summary.count_path != "dense-fused":
                fail(f"phase 9 default dispatch: {summary.count_path}, {launches} launches")
            log(f"phase 9 (a) default dispatch (dense-fused) killed after 'mine', resumed: "
                f"{wall:.3f} s wall, 0 launches, the baseline's bytes")

            # ---- (b) across devices
            cfg = new_pvc("card_to_cpu", **bitpack)
            crash(cfg, "mine", device="cuda")
            summary, _, wall_cpu, _ = job(cfg, device="cpu")
            check_resume("card -> CPU", summary, ("encode", "mine"), base_bytes)
            cfg = new_pvc("cpu_to_card", **bitpack)
            crash(cfg, "encode", device="cpu")
            summary, launches, wall_card, _ = job(cfg)
            check_resume("CPU -> card", summary, ("encode",), base_bytes)
            if launches != 1:
                fail(f"phase 9 CPU -> card: {launches} popcount launches, want 1")
            log(f"phase 9 (b) killed after 'mine' on the card, resumed on the CPU "
                f"({wall_cpu:.3f} s); killed after 'encode' on the CPU, resumed on the card "
                f"({wall_card:.3f} s, 1 launch): both publish the baseline's bytes")

            # ---- (e) the embed phase (sparse storage pinned, so the
            # uninterrupted job runs the segsum kernel): killed after
            # 'embed', resumed on the card with no ALS sweep
            embed_knobs = dict(embed_enabled=True, als_sparse="always")
            emb_cfg = new_pvc("embed_baseline", **embed_knobs)
            segsum.LAUNCHES["segsum"] = 0
            _, _, emb_wall, _ = job(emb_cfg)
            emb_base_launches = segsum.LAUNCHES["segsum"]
            emb_bytes = publication(emb_cfg.base_dir)
            if "embeddings.npz" not in emb_bytes or emb_base_launches != 2 * emb_cfg.als_iters:
                fail(f"phase 9 (e) baseline: {emb_base_launches} segsum launches, published "
                     f"{sorted(emb_bytes)}")
            cfg = new_pvc("crash_embed", **embed_knobs)
            crash(cfg, "embed")
            sweeps = []
            real_sweeps = (als._als_sweep, als._sparse_als_sweep)

            def counted(fn):
                def sweep(*args):
                    sweeps.append(1)
                    return fn(*args)
                return sweep

            als._als_sweep, als._sparse_als_sweep = (counted(f) for f in real_sweeps)
            segsum.LAUNCHES["segsum"] = 0
            try:
                summary, _, emb_resume_s, _ = job(cfg)
            finally:
                als._als_sweep, als._sparse_als_sweep = real_sweeps
            check_resume("resume after embed", summary, ("encode", "mine", "rules", "embed"),
                         emb_bytes)
            if sweeps or segsum.LAUNCHES["segsum"]:
                fail(f"phase 9 (e): the resume after 'embed' ran {len(sweeps)} ALS sweeps, "
                     f"{segsum.LAUNCHES['segsum']} segsum launches")
            embed_case = {"baseline_wall_s": emb_wall, "wall_s": emb_resume_s,
                          "baseline_segsum_launches": emb_base_launches,
                          "segsum_launches": segsum.LAUNCHES["segsum"], "sweeps": len(sweeps)}
            log(f"phase 9 (e) KMLS_EMBED_ENABLED=1, KMLS_ALS_SPARSE=always: the job "
                f"{emb_wall:.3f} s with {emb_base_launches} segsum launches; killed after "
                f"'embed', resumed on the card in {emb_resume_s:.3f} s: 0 ALS sweeps, 0 segsum "
                f"launches, the baseline's bytes (embeddings.npz included)")
        ckpt = {
            phase: {
                "save_s": ckpt_log.saves[phase][0][0], "bytes": ckpt_log.saves[phase][0][1],
                "load_s": min(t for t, _ in ckpt_log.loads.get(phase, [(float("nan"), 0)])),
            }
            for phase in RESUME_PHASES
        }
        log("phase 9 (d) checkpoints (first save; fastest verified load): " + "; ".join(
            f"{p} {c['bytes']} bytes saved in {c['save_s']:.4f} s, loaded in {c['load_s']:.4f} s"
            for p, c in ckpt.items()))

        # ---- (c) the engine on the card against the corrupt-artifact ladder
        ladder = os.path.join(root, "ladder")
        shutil.copytree(base_cfg.base_dir, ladder)
        pickles = os.path.join(ladder, "pickles")
        rec = os.path.join(pickles, "recommendations.pickle")
        npz = artifacts.tensor_artifact_path(rec)
        scfg = ServingConfig(base_dir=ladder, quarantine_after_failures=2,
                             reload_backoff_base_s=0.0)

        def invalidate():
            registry.append_history_and_invalidate(MiningConfig(base_dir=ladder), 1, "ladder")

        def seed_sets(vocab):
            rng = np.random.default_rng(9)
            return [[vocab[int(i)] for i in rng.choice(len(vocab), int(rng.integers(1, 6)))]
                    for _ in range(LADDER_SEEDS)] + [["No Such Track"]]

        def same_answers(label, card, cpu):
            sets = seed_sets(card.bundle.vocab)
            got, want = engine_answers(card, sets), engine_answers(cpu, sets)
            if got != want:
                bad = sum(g != w for g, w in zip(got, want))
                fail(f"phase 9 (c) {label}: {bad} of {len(sets)} answers != the CPU engine's")

        faults.flip_byte(npz)
        if artifacts.verify_files(pickles, [os.path.basename(npz)]) != [npz]:
            fail("phase 9 (c): the flipped npz byte passed its manifest")
        card = RecommendEngine(scfg, device="cuda")
        cpu = RecommendEngine(scfg, device="cpu")
        t0 = time.perf_counter()
        if not card.load():
            fail("phase 9 (c): the card engine refused a PVC whose pickle is whole")
        verify_load_s = time.perf_counter() - t0
        if not cpu.load() or card.consecutive_reload_failures:
            fail("phase 9 (c): the flipped npz did not fall back to the pickle")
        same_answers("flipped npz byte", card, cpu)
        good, token = card.bundle, card.cache_value
        faults.truncate_file(rec, keep_fraction=0.4)
        invalidate()
        if card.load() is not False or card.bundle is not good or card.cache_value != token:
            fail("phase 9 (c): a truncated pickle did not leave the last good bundle serving")
        if card._backoff_until <= 0.0 or card.reload_failures != 1:
            fail("phase 9 (c): the failed reload armed no backoff")
        same_answers("last good bundle", card, cpu)
        if card.load() is not False or card.artifact_quarantines < 1 or os.path.exists(rec):
            fail("phase 9 (c): the second failed reload quarantined nothing")
        quarantined = sorted(os.listdir(os.path.join(pickles, artifacts.QUARANTINE_DIRNAME)))
        with contextlib.redirect_stdout(io.StringIO()):
            run_mining_job(MiningConfig(base_dir=ladder,
                                        datasets_dir=os.path.join(ladder, "datasets")),
                           device="cuda")
        card._backoff_until = 0.0
        card.reload_if_required()
        if card.consecutive_reload_failures or card.cache_value == token:
            fail("phase 9 (c): the engine did not recover after the republication")
        cpu = RecommendEngine(scfg, device="cpu")
        cpu.load()
        same_answers("recovered", card, cpu)
        log(f"phase 9 (c) engine on the card: flipped npz byte → pickle fallback (load "
            f"{verify_load_s:.3f} s), answers == CPU; truncated pickle → last good bundle, "
            f"token kept, backoff armed; quarantined {quarantined} after 2 failures; "
            f"recovered after the republication")

        # ids >= V in an npz that parses cleanly, verification off
        loaded = artifacts.load_rule_tensors(npz)
        ids = loaded["rule_ids"].copy()
        v = len(loaded["vocab"])
        filled = np.argwhere(ids >= 0)
        ids[tuple(filled[::7].T)] = v
        ids[tuple(filled[3::11].T)] = v + 1000
        artifacts.save_rule_tensors(
            npz, vocab=loaded["vocab"], rule_ids=ids, rule_counts=loaded["rule_counts"],
            item_counts=loaded["item_counts"], n_playlists=loaded["n_playlists"],
            min_support=loaded["min_support"], mode=loaded["mode"],
            min_confidence=loaded["min_confidence"], rule_confs64=loaded["rule_confs64"])
        invalidate()
        ocfg = dataclasses.replace(scfg, verify_manifest=False)
        card = RecommendEngine(ocfg, device="cuda")
        cpu = RecommendEngine(ocfg, device="cpu")
        if not card.load() or not cpu.load():
            fail("phase 9 (c): the npz with ids >= V did not publish")
        same_answers("ids >= V", card, cpu)
        torch.cuda.synchronize()
        same_answers("a later lookup (the CUDA context lives)", card, cpu)
        log(f"phase 9 (c) npz with {int((ids >= v).sum())} rule ids >= V ({v}), "
            f"KMLS_VERIFY_MANIFEST=0: published on the card, answers == CPU, and a later "
            f"lookup on the same process succeeds")
        return {"resumes": resumes, "embed": embed_case, "checkpoints": ckpt,
                "job_s_checkpoints_on": on_s, "job_s_checkpoints_off": off_s}
    finally:
        faults.clear()
        if own:
            shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 10

TRACED_REQUESTS = 2000  # distinct config-5 seed sets replayed with tracing on
TRACED_QPS = 1000.0
STALL_S = 0.2  # the event-loop stall of check (b)
STALL_BUDGET_MS = 100.0  # (b)'s shed budget: the stall is twice it
STALL_FOLLOW_UPS = 10
PROFILE_SECONDS = 2.0  # (e)'s /debug/profile window


def distinct_sets(keys: list, n: int, seed: int) -> list:
    """``n`` config-5 seed sets (``sample_seed_sets``) of which no two hold
    the same tracks: each one misses the answer cache and reaches the card."""
    from kmlserver_tpu_torch.serving.replay import sample_seed_sets

    drawn = sample_seed_sets(keys, 2 * n + 100, rng_seed=seed)
    return list({tuple(sorted(s)): s for s in drawn}.values())[:n]


def quantiles(values: list) -> tuple[float, float]:
    """(p50, p99) of ``values`` (nan when empty)."""
    if not values:
        return float("nan"), float("nan")
    v = sorted(values)
    return v[len(v) // 2], v[min(int(0.99 * len(v)), len(v) - 1)]


def trace_kernels(path: str) -> dict[str, list[float]]:
    """Kernel name → CUDA durations (ms) of every kernel event in a
    ``torch.profiler`` Chrome trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    out: dict[str, list[float]] = {}
    for ev in events:
        if ev.get("cat") == "kernel" and "dur" in ev:
            out.setdefault(ev["name"], []).append(float(ev["dur"]) / 1e3)
    return out


def wait_for_trace(directory: str, timeout_s: float) -> str:
    """The one ``*.pt.trace.json`` a capture writes under ``directory``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if os.path.isdir(directory):
            files = [f for f in os.listdir(directory) if f.endswith(".pt.trace.json")]
            if files:
                path = os.path.join(directory, files[0])
                try:
                    with open(path) as fh:
                        json.load(fh)
                    return path
                except ValueError:
                    pass  # still being written
        time.sleep(0.2)
    fail(f"no profiler trace appeared under {directory} within {timeout_s:.0f} s")


def post_with_headers(port: int, seeds: list) -> tuple[int, dict]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/api/recommend/", json.dumps({"songs": seeds}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()


def traced_replay(base: str, server_lines: list, keys: list, cpu, work: str) -> dict:
    """(a) and (c): BASELINE config 5's seed sets with every request traced,
    the trace join, the span split, and the cost-model gauges."""
    from kmlserver_tpu_torch.serving.replay import ClientTraceLog, replay_async_http

    payloads = distinct_sets(keys, TRACED_REQUESTS, 29)
    want = engine_answers(cpu, payloads)
    trace_log = ClientTraceLog()
    responses: list = []
    report = replay_async_http(base, payloads, qps=TRACED_QPS, n_conns=CONFIG5_CONNS,
                               responses=responses, trace_log=trace_log)
    counts = check_responses("phase 10 (a)", responses, payloads, want, cpu)
    if counts["ok"] != len(payloads) or counts["cached"]:
        fail(f"phase 10 (a): {counts}: every distinct request must reach the card")
    with urllib.request.urlopen(base + "/debug/traces", timeout=30) as resp:
        debug = json.loads(resp.read())
    traces = debug["traces"]
    if len(traces) != len(payloads):
        fail(f"phase 10 (a): {len(traces)} retained traces for {len(payloads)} requests")
    spans: dict[str, list] = {}
    for t in traces:
        names = {s["name"]: s["duration_ms"] for s in t["spans"]}
        for need in ("queue", "device", "compose"):
            if need not in names:
                fail(f"phase 10 (a): trace {t['trace_id']} has no {need} span: {t}")
        total = sum(s["duration_ms"] for s in t["spans"])
        if total > t["duration_ms"] + 0.001 * len(t["spans"]):
            fail(f"phase 10 (a): trace {t['trace_id']}'s spans sum to {total} ms, over "
                 f"its {t['duration_ms']} ms")
        for name, ms in names.items():
            spans.setdefault(name, []).append(ms)
        spans.setdefault("server", []).append(t["duration_ms"])
        spans.setdefault("unspanned", []).append(t["duration_ms"] - total)
    client_path = os.path.join(work, "client_traces.jsonl")
    traces_path = os.path.join(work, "debug_traces.json")
    trace_log.write_jsonl(client_path)
    with open(traces_path, "w") as fh:
        json.dump(debug, fh)
    join = subprocess.run(
        [sys.executable, "-m", "kmlserver_tpu_torch.observability.tracejoin",
         "--client", client_path, "--traces", traces_path],
        cwd=ROOT, env=subproc_env(), capture_output=True, text=True, timeout=120)
    joined = [json.loads(line) for line in join.stdout.splitlines() if line.strip()]
    n_client = len(trace_log.entries())
    if join.returncode != 0 or n_client != len(payloads) or len(joined) < 0.95 * n_client:
        fail(f"phase 10 (a): tracejoin joined {len(joined)} of {n_client} client records "
             f"(exit {join.returncode}): {join.stderr[-500:]}")
    spans["client_minus_server"] = [r["client_overhead_ms"] for r in joined]
    split = {name: quantiles(v) for name, v in spans.items()}
    log(f"phase 10 (a): {len(payloads)} distinct config-5 seed sets at {TRACED_QPS:.0f} QPS "
        f"with KMLS_TRACE_SAMPLE=1.0 → achieved {report.achieved_qps:.1f} QPS, client p50/p99 "
        f"{report.p50_ms:.3f}/{report.p99_ms:.3f} ms, every answer == the CPU engine's; "
        f"{len(traces)} traces retained, each with queue + device + compose summing within "
        f"its server time; tracejoin joined {len(joined)}/{n_client} client records")
    log("phase 10 (a) span split p50/p99 ms: " + ", ".join(
        f"{name} {p50:.4f}/{p99:.4f}" for name, (p50, p99) in split.items()))

    # (c) the cost model's gauges after the traced run
    m = scrape_metrics(base)
    unwarmed = sum("unwarmed seed shape" in line for line in server_lines)
    device_s = m.get('kmls_kernel_device_seconds{kernel="serve_rules"}', 0.0)
    mfu = m.get('kmls_mfu{kernel="serve_rules"}', 0.0)
    compiles = m.get('kmls_compiles_total{kernel="serve_rules"}')
    in_use = {k: v for k, v in m.items() if k.startswith("kmls_device_bytes_in_use")}
    if device_s <= 0.0:
        fail(f"phase 10 (c): kmls_kernel_device_seconds{{serve_rules}} = {device_s}")
    if not 0.0 < mfu <= 1.0:
        fail(f"phase 10 (c): kmls_mfu{{serve_rules}} = {mfu}, not in (0, 1]")
    if not in_use:
        fail("phase 10 (c): no kmls_device_bytes_in_use series on the card")
    if compiles != 0 or unwarmed != 0:
        fail(f"phase 10 (c): kmls_compiles_total{{serve_rules}} = {compiles}, "
             f"unwarmed dispatches logged {unwarmed}")
    dispatches = m['kmls_kernel_dispatches_total{kernel="serve_rules"}']
    cost = {"device_s": device_s, "dispatches": dispatches, "mfu": mfu,
            "flops_per_s": m['kmls_kernel_flops_per_second{kernel="serve_rules"}'],
            "bytes_per_s": m['kmls_kernel_bytes_per_second{kernel="serve_rules"}'],
            "compute_bound": m['kmls_kernel_compute_bound{kernel="serve_rules"}'],
            "compiles": compiles, "device_bytes_in_use": in_use,
            "tensor_bytes": {k: v for k, v in m.items() if k.startswith("kmls_model_tensor")},
            "slo_burn": {k: v for k, v in m.items() if k.startswith("kmls_slo_burn_rate")}}
    log(f"phase 10 (c) /metrics: serve_rules {dispatches:.0f} dispatches, "
        f"{device_s:.6f} device s ({1e3 * device_s / max(dispatches, 1):.4f} ms each), "
        f"{cost['flops_per_s']:.6g} FLOP/s, {cost['bytes_per_s']:.6g} B/s, kmls_mfu {mfu:.6g}, "
        f"compute-bound {cost['compute_bound']:.0f}; kmls_compiles_total 0 == unwarmed "
        f"dispatches; device bytes in use {in_use}")
    return {"report": {"achieved_qps": report.achieved_qps, "p50_ms": report.p50_ms,
                       "p99_ms": report.p99_ms}, "split": split, "joined": len(joined),
            "client_records": n_client, "cost": cost}


def profile_under_load(base: str, keys: list, cpu) -> dict:
    """(e): GET /debug/profile?seconds=N while distinct requests reach the
    card — replayed a second at a time until the capture's trace is
    written; the trace must name the lookup's CUDA kernels."""
    from kmlserver_tpu_torch.serving.replay import replay_async_http

    t0 = time.perf_counter()
    with urllib.request.urlopen(base + f"/debug/profile?seconds={PROFILE_SECONDS}",
                                timeout=30) as resp:
        doc = json.loads(resp.read())
        if resp.status != 202:
            fail(f"phase 10 (e): /debug/profile answered {resp.status}: {doc}")
    n_sent = 0
    totals: dict[str, int] = {}
    chunk = int(TRACED_QPS)
    for seed in range(41, 71):
        payloads = distinct_sets(keys, chunk, seed)
        responses: list = []
        replay_async_http(base, payloads, qps=TRACED_QPS, n_conns=CONFIG5_CONNS,
                          responses=responses)
        counts = check_responses("phase 10 (e)", responses, payloads,
                                 engine_answers(cpu, payloads), cpu, allow_drops=True)
        for key, value in counts.items():
            totals[key] = totals.get(key, 0) + value
        n_sent += len(payloads)
        if os.path.isdir(doc["dir"]) and os.listdir(doc["dir"]):
            break
    path = wait_for_trace(doc["dir"], 60)
    kernels = trace_kernels(path)
    lookup = {name: v for name, v in kernels.items() if "scatter" in name}
    if not lookup:
        fail(f"phase 10 (e): the /debug/profile trace names no scatter kernel of the "
             f"lookup: {sorted(kernels)[:20]}")
    top = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:8]
    log(f"phase 10 (e): /debug/profile?seconds={PROFILE_SECONDS:g} under {n_sent} distinct "
        f"requests at {TRACED_QPS:.0f} QPS ({totals}) wrote {os.path.basename(path)} "
        f"{time.perf_counter() - t0:.3f} s after the request, with "
        f"{sum(len(v) for v in kernels.values())} kernel events; top by CUDA time: "
        + "; ".join(f"{name[:70]} x{len(v)} {sum(v):.3f} ms" for name, v in top))
    return {"kernel_events": sum(len(v) for v in kernels.values()),
            "scatter_launches": sum(len(v) for v in lookup.values()), "requests": n_sent,
            "answers": totals, "top": [(name, len(v), sum(v)) for name, v in top]}


def stalled_loop(pvc: str, keys: list) -> dict:
    """(b): in process on the card, the async server's loop stalls for
    ``STALL_S``; the requests after it are degraded or shed, none 5xx, and
    ``kmls_loop_lag_ms`` reads above 100."""
    import asyncio

    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.serving.aioserver import run_async
    import torch

    from kmlserver_tpu_torch.serving.app import RecommendApp

    cfg = ServingConfig(base_dir=pvc, shed_queue_budget_ms=STALL_BUDGET_MS)
    app = RecommendApp(cfg, device="cuda", defer_batcher=True)
    if not app.engine.load():
        fail("phase 10 (b): the card engine could not load the PVC")
    peak_source = app.engine.cost_model.peak_source
    if torch.cuda.get_device_name(0) not in peak_source:
        fail(f"phase 10 (c): the cost model's peak source {peak_source!r} does not name "
             f"the card {torch.cuda.get_device_name(0)!r}")
    bound: dict = {}
    ready = threading.Event()

    def on_ready(port, drain):
        bound.update(port=port, drain=drain, loop=asyncio.get_running_loop())
        ready.set()

    result: dict = {}
    thread = threading.Thread(
        target=lambda: result.update(code=asyncio.run(run_async(app, 0, ready=on_ready))),
        daemon=True)
    thread.start()
    if not ready.wait(60):
        fail("phase 10 (b): the in-process server never bound")
    port = bound["port"]
    sets = distinct_sets(keys, 5 + STALL_FOLLOW_UPS, 37)
    try:
        for seeds in sets[:5]:  # warm: the tick is armed and the loop healthy
            status, _ = post_with_headers(port, seeds)
            if status != 200:
                fail(f"phase 10 (b): a warm-up request answered {status}")
        time.sleep(0.3)
        before = app.loop_lag.lag_s() * 1e3
        bound["loop"].call_soon_threadsafe(time.sleep, STALL_S)
        time.sleep(STALL_S + 0.1)  # the stall, then the overdue tick notes it
        m = scrape_metrics(f"http://127.0.0.1:{port}")
        lag_ms = m["kmls_loop_lag_ms"]
        outcomes = [post_with_headers(port, seeds) for seeds in sets[5:5 + STALL_FOLLOW_UPS]]
    finally:
        bound["drain"]()
        thread.join(30)
        app.close()
    if result.get("code") != 0:
        fail(f"phase 10 (b): the in-process server's drain returned {result.get('code')}")
    codes = [status for status, _ in outcomes]
    degraded = sum(1 for status, h in outcomes if status == 200 and "x-kmls-degraded" in h)
    shed = codes.count(429)
    if any(code >= 500 for code in codes):
        fail(f"phase 10 (b): a 5xx after the stall: {codes}")
    if degraded + shed != len(outcomes):
        fail(f"phase 10 (b): {len(outcomes) - degraded - shed} of {len(outcomes)} follow-up "
             f"requests answered normally after a {STALL_S * 1e3:.0f} ms stall: {outcomes}")
    if lag_ms <= 100.0:
        fail(f"phase 10 (b): kmls_loop_lag_ms {lag_ms} after a {STALL_S * 1e3:.0f} ms stall")
    log(f"phase 10 (b): loop stalled {STALL_S * 1e3:.0f} ms in process on the card "
        f"(shed budget {STALL_BUDGET_MS:.0f} ms): kmls_loop_lag_ms {before:.3f} → "
        f"{lag_ms:.3f}; {len(outcomes)} follow-up requests: {degraded} degraded, {shed} "
        f"shed, 0 5xx; cost model peak source {peak_source!r}")
    return {"lag_ms": lag_ms, "lag_ms_before": before, "degraded": degraded, "shed": shed,
            "peak_source": peak_source}


def profiled_job(work: str, pvc: str) -> dict:
    """(d): the job on the card with ``KMLS_COUNT_PATH=bitpack`` and
    ``KMLS_PROFILE_DIR`` set; its ``job_metrics.prom`` and its profiler
    trace, the popcount kernel's CUDA time there beside a CUDA-event timing
    of the same launch in process, and the support-count yardstick."""
    import torch

    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.data.csv import read_tracks
    from kmlserver_tpu_torch.mining import vocab as vocab_mod
    from kmlserver_tpu_torch.mining.miner import prune_infrequent
    from kmlserver_tpu_torch.observability.costmodel import PEAK_TABLE, phase_cost
    from kmlserver_tpu_torch.ops import popcount as pc
    from kmlserver_tpu_torch.ops.support import min_count_for

    job_pvc = os.path.join(work, "pvc_observability")
    os.makedirs(os.path.join(job_pvc, "datasets"))
    csv = [f for f in os.listdir(os.path.join(pvc, "datasets")) if f.endswith(".csv")][0]
    shutil.copy(os.path.join(pvc, "datasets", csv), os.path.join(job_pvc, "datasets"))
    profile_root = os.path.join(work, "profile_job")
    out, launches, wall = run_job(job_pvc, "profiled", KMLS_COUNT_PATH="bitpack",
                                  KMLS_PROFILE_DIR=profile_root)
    if launches != 1:
        fail(f"phase 10 (d): the profiled job launched the popcount kernel {launches} times")
    with open(os.path.join(job_pvc, "pickles", "job_metrics.prom")) as fh:
        text = fh.read()
    prom = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            prom[key] = float(value)
    phases = sorted(k.split('"')[1] for k in prom if k.startswith("kmls_job_phase_duration"))
    if phases != ["encode", "mine", "rules"]:
        fail(f"phase 10 (d): job_metrics.prom phases {phases}")
    paths = [k for k in prom if k.startswith("kmls_job_count_path")]
    if len(paths) != 1 or 'path="bitpack-cuda"' not in paths[0]:
        fail(f"phase 10 (d): job_metrics.prom count path {paths}")
    p, v_all = int(prom["kmls_job_playlists"]), int(prom["kmls_job_tracks"])
    flops, _ = phase_cost("support_count", p=p, v=v_all)
    mine_flops = prom['kmls_job_phase_flops{phase="mine"}']
    if mine_flops != flops:
        fail(f"phase 10 (d): mine flops {mine_flops} != phase_cost('support_count', "
             f"p={p}, v={v_all}) = {flops}")
    if prom["kmls_job_success"] != 1:
        fail("phase 10 (d): kmls_job_success is not 1")
    trace = wait_for_trace(os.path.join(profile_root, "mine"), 30)
    kernels = trace_kernels(trace)
    job_kernel = [ms for name, v in kernels.items() if "popcount_pairs_tc_kernel" in name
                  for ms in v]
    if len(job_kernel) != 1:
        fail(f"phase 10 (d): the job's trace holds {len(job_kernel)} popcount kernel events: "
             f"{sorted(kernels)}")

    # the same launch in process: the mined baskets' bitset, by CUDA events
    table = read_tracks(os.path.join(job_pvc, "datasets", csv), 1.0)
    baskets = vocab_mod.build_baskets(table)
    mined, _ = prune_infrequent(baskets, min_count_for(DS2_MIN_SUPPORT, baskets.n_playlists))
    v_pad, w_pad = pc.padded_shape(mined.n_tracks, mined.n_playlists)
    bt = pc.bitpack_by_track(mined.playlist_rows, mined.track_ids,
                             n_playlists=mined.n_playlists, n_tracks=mined.n_tracks,
                             v_pad=v_pad, w_pad=w_pad, device="cuda")
    for _ in range(5):
        pc.popcount_pair_counts_padded(bt)
    torch.cuda.synchronize()
    event_ms = cuda_ms(lambda: pc.popcount_pair_counts_padded(bt), 200)
    job_ms = job_kernel[0]
    if abs(job_ms - event_ms) > 0.2 * event_ms:
        fail(f"phase 10 (d): the profiler's CUDA time of the job's popcount launch "
             f"{job_ms:.4f} ms is not within 20 % of the CUDA-event timing {event_ms:.4f} ms "
             f"at ({v_pad}, {w_pad})")
    phase_s = {k.split('"')[1]: v for k, v in prom.items()
               if k.startswith("kmls_job_phase_duration")}
    # the same split from the unprofiled job that published ``pvc``
    with open(os.path.join(pvc, "pickles", "job_metrics.prom")) as fh:
        plain_s = {line.split('"')[1]: float(line.rsplit(" ", 1)[1]) for line in fh
                   if line.startswith("kmls_job_phase_duration")}
    log("phase 10 (d): job_metrics.prom of the unprofiled job that published the ds2 PVC "
        "(default dispatch): " + ", ".join(f"{k} {v:.4f} s" for k, v in sorted(plain_s.items())))
    # the yardstick A.10 needs: support_count's full 2·p·v² product against
    # the one triangle of int8 operations the kernel's bound counts
    bound = popcount_bound(v_pad, w_pad)
    kernel_flops, _ = phase_cost("support_count", p=mined.n_playlists, v=mined.n_tracks)
    bf16_peak = dict((needle, f) for needle, f, _bw in PEAK_TABLE)["h100"]
    log(f"phase 10 (d): job with KMLS_COUNT_PATH=bitpack, KMLS_PROFILE_DIR set: {wall:.3f} s "
        f"wall; job_metrics.prom phases " + ", ".join(f"{k} {v:.4f} s" for k, v in
                                                     sorted(phase_s.items()))
        + f", count path bitpack-cuda ({paths[0].split('source=')[1][1:-2]}), mine flops "
        f"{flops:.6g} == phase_cost('support_count', p={p}, v={v_all}); profiler CUDA time of "
        f"the job's popcount launch {job_ms:.4f} ms vs CUDA events {event_ms:.4f} ms in "
        f"process at ({v_pad}, {w_pad}) ({100 * (job_ms / event_ms - 1):+.1f} %)")
    log(f"phase 10 (d) yardstick at the ds2 mine shape (p={mined.n_playlists}, "
        f"v={mined.n_tracks}): support_count 2·p·v² = {kernel_flops:.6g}, the kernel's "
        f"triangle {bound['int8_ops']:.6g} int8 ops at ({v_pad}, {w_pad}), ratio "
        f"{kernel_flops / bound['int8_ops']:.4f}; over {event_ms:.4f} ms: "
        f"{kernel_flops / (event_ms / 1e3):.6g} FLOP/s = "
        f"{kernel_flops / (event_ms / 1e3) / bf16_peak:.4f} of the bf16 peak; job_metrics "
        f"attributes v={v_all} (unpruned): {flops:.6g}")
    return {"wall_s": wall, "phases_s": phase_s, "plain_phases_s": plain_s, "flops": flops,
            "job_kernel_ms": job_ms,
            "event_ms": event_ms, "shape": [v_pad, w_pad],
            "yardstick": {"support_count": kernel_flops, "triangle_int8_ops": bound["int8_ops"],
                          "ratio": kernel_flops / bound["int8_ops"]}}


def phase_observability(work: str | None = None) -> dict:
    """Phase 10: the observability package on the card over the ds2 PVC —
    (a) a traced config-5 replay joined with tracejoin, (b) a stalled loop
    escalating the admission ladder, (c) the cost model's gauges, (d) the
    job's job_metrics.prom and profiler trace, (e) /debug/profile under
    load."""
    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.io import artifacts
    from kmlserver_tpu_torch.serving.engine import RecommendEngine

    own = work is None
    work = work or tempfile.mkdtemp(prefix="kmls_smoke10_")
    t_phase = time.perf_counter()
    try:
        pvc = ds2_pvc(work)
        cfg = ServingConfig(base_dir=pvc)
        cpu = RecommendEngine(cfg, device="cpu")
        if not cpu.load():
            fail("phase 10: the CPU engine could not load the PVC")
        keys = sorted(artifacts.load_pickle(os.path.join(cfg.pickles_dir,
                                                         cfg.recommendations_file)))
        obs_work = os.path.join(work, "observability")
        os.makedirs(obs_work)
        profile_root = os.path.join(obs_work, "profile_serve")
        server, base, lines = start_server(
            pvc, KMLS_TRACE_SAMPLE="1.0", KMLS_TRACE_BUFFER=str(2 * TRACED_REQUESTS),
            KMLS_PROFILE_DIR=profile_root)
        try:
            traced = traced_replay(base, lines, keys, cpu, obs_work)
            profiled = profile_under_load(base, keys, cpu)
        finally:
            code = stop_server(server)
        if code != 0:
            fail(f"phase 10: the traced server exited {code} after SIGTERM")
        stall = stalled_loop(pvc, keys)
        job = profiled_job(obs_work, pvc)
        result = {"traced": traced, "stall": stall, "job": job, "profile": profiled,
                  "s": time.perf_counter() - t_phase}
        log(f"phase 10: {result['s']:.3f} s")
        log("PHASE10 " + json.dumps(result))
        return result
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 11

EMBED_REQUESTS = 2000  # distinct config-5 draws over the embedding vocabulary
EMBED_QPS = 1000.0
NEAR_TIE = 1e-6  # a score gap at most this wide may order two packages' floats apart
# card vs CPU plain run of the same ALS training: the products sum in
# another order, and each sweep's solve carries the difference forward
ALS_FACTOR_TOL = 1e-4  # max |Δ| of the normalized factors
ALS_LOSS_RTOL = 1e-5  # relative difference of the final loss
EMBED_SIM_TOL = 1e-6  # embed_topk similarities, card vs CPU
EMBED_TOPK_SHAPES = ((1, 8), (32, 8))  # (batch, seed slots) buckets timed at V = 1M
FP32_PEAK_OPS = 67e12  # H100 SXM, fp32 outside the tensor cores (data sheet)
# cycles from one dependent fp32 add to the next on one lane (the segsum
# kernel's chain; Hopper's fp32 pipeline latency)
SEGSUM_ADD_CYCLES = 4
# the threshold sweep of phase 11 (c): LONG_ROW_EVENTS candidates
SEGSUM_THRESHOLDS = (128, 256, 512, 1024, 2048, 4096, 16384, 1 << 62)
SEGSUM_LONG_ROW = 2_000_000  # phase 11 (c)'s one synthetic row


def decisive_near_tie(engine, seeds: list, eps: float = NEAR_TIE) -> bool:
    """True when the answer the engine composes for ``seeds`` rests on two
    candidate scores within ``eps`` of each other: the embedding top-(k+1)
    similarities, or the blended scores of the union. Another package or
    device may order such a pair the other way and answer differently."""
    import torch

    from kmlserver_tpu_torch.ops.embed import embed_topk
    from kmlserver_tpu_torch.ops.serve import recommend_batch

    bundle = engine.bundle
    k, cap = engine.cfg.k_best_tracks, engine.cfg.max_seed_tracks
    emb = [bundle.emb_index[s] for s in seeds if s in (bundle.emb_index or {})][:cap]
    if bundle.emb_factors is None or not emb:
        return False
    ids, sims = embed_topk(bundle.emb_factors, torch.tensor([emb], dtype=torch.int32),
                           k_best=k + 1)
    live = sims[0][ids[0] >= 0].tolist()
    if any(a - b <= eps for a, b in zip(live, live[1:])):
        return True
    rule = [bundle.index[s] for s in seeds
            if s in bundle.index and bundle.known_mask[bundle.index[s]]][:cap]
    if not rule or engine.cfg.hybrid_mode != "blend":
        return False
    r_ids, r_confs = recommend_batch(bundle.rule_ids, bundle.rule_confs,
                                     torch.tensor([rule], dtype=torch.int32), k_best=k)
    w = min(max(engine.blend_weight, 0.0), 1.0)
    scores: dict = {}
    for i, c in zip(r_ids[0].tolist(), r_confs[0].tolist()):
        if i >= 0:
            scores[bundle.vocab[i]] = (1.0 - w) * c
    for i, s in zip(ids[0][:k].tolist(), sims[0][:k].tolist()):
        if i >= 0:
            scores[bundle.emb_vocab[i]] = scores.get(bundle.emb_vocab[i], 0.0) + w * s
    ranked = sorted(scores.values(), reverse=True)[: k + 1]
    return any(a - b <= eps for a, b in zip(ranked, ranked[1:]))


def als_check(label: str, got: dict, want: dict) -> dict:
    """Two ``train_embeddings`` payloads (card, CPU plain) within the stated
    tolerances → the differences."""
    d_factors = float(np.abs(got["item_factors"] - want["item_factors"]).max())
    d_loss = abs(got["final_loss"] - want["final_loss"]) / abs(want["final_loss"])
    if d_factors > ALS_FACTOR_TOL or d_loss > ALS_LOSS_RTOL:
        fail(f"phase 11 {label}: card vs CPU plain run: factors max |Δ| {d_factors:.3g} "
             f"(limit {ALS_FACTOR_TOL}), loss relative {d_loss:.3g} (limit {ALS_LOSS_RTOL})")
    return {"factors_max_abs": d_factors, "loss_rel": d_loss}


def embed_job(pvc: str, label: str) -> tuple[float, float]:
    """The ds2 job with ``KMLS_EMBED_ENABLED=1`` on the card → (its wall s,
    the embed phase's training s from its log)."""
    out, _, wall = run_job(pvc, label, KMLS_EMBED_ENABLED="1")
    trained = [line for line in out.splitlines() if line.startswith("ALS embeddings trained:")]
    if not trained or "rank 32, 8 iters" not in trained[0]:
        fail(f"phase 11 (a) {label}: no 'ALS embeddings trained: rank 32, 8 iters' line")
    return wall, float(trained[0].rsplit("(", 1)[1].rstrip("s)"))


def phase_embed_ds2(work: str) -> dict:
    """Phase 11 (a) and (b): the ds2 job with the embed phase, twice, the
    embeddings held byte for byte and against the CPU plain run; then the
    PVC served in blend mode under 2,000 distinct config-5 draws."""
    import torch

    from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
    from kmlserver_tpu_torch.data.csv import read_tracks
    from kmlserver_tpu_torch.io import artifacts
    from kmlserver_tpu_torch.mining import als
    from kmlserver_tpu_torch.mining.vocab import build_baskets
    from kmlserver_tpu_torch.observability.costmodel import phase_cost
    from kmlserver_tpu_torch.ops.embed import embed_topk
    from kmlserver_tpu_torch.serving.engine import RecommendEngine
    from kmlserver_tpu_torch.serving.replay import replay_async_http

    csv_src = os.path.join(ds2_pvc(work), "datasets", "2023_spotify_ds2_synthetic.csv")
    pvcs = []
    for name in ("pvc_embed", "pvc_embed_again"):
        pvc = os.path.join(work, name)
        os.makedirs(os.path.join(pvc, "datasets"))
        shutil.copy(csv_src, os.path.join(pvc, "datasets"))
        pvcs.append(pvc)
    (wall_a, train_a), (wall_b, train_b) = (embed_job(p, f"embed {i + 1}") for i, p in enumerate(pvcs))
    emb_bytes = []
    for pvc in pvcs:
        with open(artifacts.embeddings_artifact_path(os.path.join(pvc, "pickles")), "rb") as fh:
            emb_bytes.append(fh.read())
    if emb_bytes[0] != emb_bytes[1]:
        fail("phase 11 (a): two card jobs published different embeddings.npz bytes")
    pickles = os.path.join(pvcs[0], "pickles")
    prom = {}
    with open(os.path.join(pickles, "job_metrics.prom")) as fh:
        for line in fh:
            if line and not line.startswith("#"):
                key, _, value = line.rpartition(" ")
                prom[key] = float(value)
    baskets = build_baskets(read_tracks(csv_src))
    p, v = baskets.n_playlists, baskets.n_tracks
    flops, _ = phase_cost("als_sweep", p=p, v=v, r=32, iters=8)
    if prom.get('kmls_job_phase_flops{phase="embed"}') != flops:
        fail(f"phase 11 (a): embed flops {prom.get('kmls_job_phase_flops{phase=\"embed\"}')} "
             f"!= phase_cost('als_sweep') {flops} (the dense storage)")
    # in process: the card's training (warm) against the CPU plain run
    cfg = MiningConfig(embed_enabled=True)
    als.train_embeddings(baskets, cfg, device="cuda")  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = als.train_embeddings(baskets, cfg, device="cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_run = als.train_embeddings(baskets, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    if card["storage"] != "dense" or cpu_run["storage"] != "dense":
        fail(f"phase 11 (a): ds2 storage {card['storage']}/{cpu_run['storage']}, want dense")
    published = artifacts.load_embeddings(artifacts.embeddings_artifact_path(pickles))
    if not np.array_equal(published["item_factors"], card["item_factors"]):
        fail("phase 11 (a): the job's factors differ from an in-process card training")
    diff = als_check("(a) ds2 dense", card, cpu_run)
    dense_bound = als_dense_bound(p, v, 32, 8)
    log(f"phase 11 (a) dense ALS training bound (the _als_sweep / _als_loss row): "
        f"{dense_bound['ms']:.4f} ms ({dense_bound['bound_by']}: operations "
        f"{dense_bound['operations_ms']:.4f} ms = {dense_bound['operations']:.4g} fp32 operations "
        f"at {FP32_PEAK_OPS:.3g}/s, bytes {dense_bound['bytes_ms']:.4f} ms) against "
        f"{1e3 * card_s:.3f} ms warm on the card")
    log(f"phase 11 (a) ds2 (P={p}, V={v}, nnz={len(baskets.track_ids)}, R=32, 8 iters, "
        f"dense): jobs {wall_a:.3f} / {wall_b:.3f} s wall, embed phase {train_a:.3f} / "
        f"{train_b:.3f} s (the first pays the process's first solve); embeddings.npz "
        f"byte-equal ({len(emb_bytes[0])} bytes); embed flops == phase_cost('als_sweep'); "
        f"in process warm {card_s:.4f} s on the card, {cpu_s:.3f} s CPU plain; card vs CPU "
        f"factors max |Δ| {diff['factors_max_abs']:.3g}, loss {card['final_loss']:.6f} vs "
        f"{cpu_run['final_loss']:.6f} (relative {diff['loss_rel']:.3g})")

    # ---- (b) blend-mode serving over the embed PVC
    scfg = ServingConfig(base_dir=pvcs[0])
    cpu = RecommendEngine(scfg, device="cpu")
    if not cpu.load() or not cpu.embedding_active:
        fail("phase 11 (b): the CPU engine did not load the embeddings")
    rule_keys = {n for n, k in zip(cpu.bundle.vocab, cpu.bundle.known_mask) if k}
    payloads = distinct_sets(list(cpu.bundle.emb_vocab), EMBED_REQUESTS, 41)
    want = engine_answers(cpu, payloads)
    cold = sum(not any(s in rule_keys for s in p_) for p_ in payloads)
    topk_ms = {}
    for b, length in EMBED_TOPK_SHAPES:
        seeds = torch.randint(0, v, (b, length), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(b)).cuda()
        factors = torch.as_tensor(published["item_factors"], device="cuda")
        embed_topk(factors, seeds, k_best=scfg.k_best_tracks)
        torch.cuda.synchronize()
        topk_ms[f"{b}x{length}"] = {
            "ms": cuda_ms(lambda: embed_topk(factors, seeds, k_best=scfg.k_best_tracks), 50),
            **embed_topk_bound(b, length, v, factors.shape[1], scfg.k_best_tracks)}
    server, base, lines = start_server(pvcs[0])
    try:
        post(base + "/metrics/reset", b"")
        before = scrape_metrics(base)
        if before.get("kmls_embedding_active") != 1.0:
            fail(f"phase 11 (b): kmls_embedding_active {before.get('kmls_embedding_active')}")
        responses: list = []
        report = replay_async_http(base, payloads, qps=EMBED_QPS, n_conns=CONFIG5_CONNS,
                                   responses=responses)
        window = server_window(base)
        after = scrape_metrics(base)
    finally:
        code = stop_server(server)
    if len(responses) != len(payloads):
        fail(f"phase 11 (b): {len(payloads) - len(responses)} requests got no answer")
    near_ties, by_source = 0, {}
    for i, status, head, body in responses:
        if status != 200 or b"x-kmls-degraded:" in head:
            fail(f"phase 11 (b): HTTP {status} for {payloads[i]}: {head[:200]!r} {body[:200]!r}")
        songs, source = want[i]
        by_source[source] = by_source.get(source, 0) + 1
        if json.loads(body)["songs"] != songs:
            if not decisive_near_tie(cpu, payloads[i]):
                fail(f"phase 11 (b): answer for {payloads[i]} != the CPU engine's and no "
                     f"near-tie decides it: {body[:300]!r} vs {songs}")
            near_ties += 1
    served = {s: after.get(f'kmls_requests_by_source{{source="{s}"}}', 0.0)
              - before.get(f'kmls_requests_by_source{{source="{s}"}}', 0.0)
              for s in ("rules", "embed", "hybrid", "fallback", "empty")}
    if not by_source.get("embed") or not by_source.get("hybrid"):
        fail(f"phase 11 (b): the draws exercised {by_source}; want embed and hybrid answers")
    unwarmed = sum("unwarmed" in line for line in lines)
    emb_dispatches = after.get('kmls_kernel_dispatches_total{kernel="embed_topk"}', 0.0)
    emb_device_s = after.get('kmls_kernel_device_seconds{kernel="embed_topk"}', 0.0)
    if (code != 0 or unwarmed or emb_dispatches <= 0
            or after.get('kmls_compiles_total{kernel="embed_topk"}') != 0):
        fail(f"phase 11 (b): exit {code}, {unwarmed} unwarmed dispatches, embed_topk "
             f"dispatches {emb_dispatches}, compiles "
             f"{after.get('kmls_compiles_total{kernel=\"embed_topk\"}')}")
    log(f"phase 11 (b) blend mode: {len(payloads)} distinct config-5 draws over the "
        f"{len(cpu.bundle.emb_vocab)}-track embedding vocabulary ({cold} with no seed in the "
        f"{len(rule_keys)}-track rule vocabulary) at {EMBED_QPS:.0f} QPS → achieved "
        f"{report.achieved_qps:.1f} QPS, client p50/p99 {report.p50_ms:.3f}/{report.p99_ms:.3f} "
        f"ms, server p50/p99 {window['server_p50_ms']:.3f}/{window['server_p99_ms']:.3f} ms, "
        f"device p50/p99 {window['device_p50_ms']:.3f}/{window['device_p99_ms']:.3f} ms; "
        f"0 5xx; sources (CPU engine) {by_source}, served (/metrics) {served}; answers == the "
        f"CPU engine's but {near_ties} decided by a near-tie (|Δ| <= {NEAR_TIE}); embed_topk "
        f"{emb_dispatches:.0f} dispatches, {emb_device_s:.6f} device s; embed_topk at V={v} "
        + ", ".join(f"B x L {k_} {t['ms']:.4f} ms (bound {t['ms_bound']:.6f}, {t['bound_by']})"
                    for k_, t in topk_ms.items()))
    return {"wall_s": [wall_a, wall_b], "embed_phase_s": [train_a, train_b],
            "train_warm_s": card_s, "train_bound": dense_bound, "cpu_train_s": cpu_s, **diff,
            "serve": {"achieved_qps": report.achieved_qps, "p50_ms": report.p50_ms,
                      "p99_ms": report.p99_ms, **window, "sources": by_source,
                      "served": served, "near_ties": near_ties, "cold_draws": cold,
                      "embed_dispatches": emb_dispatches, "embed_device_s": emb_device_s},
            "embed_topk_ms_v_ds2": topk_ms}


class StageTimes:
    """Seconds spent in named functions of ``module`` while the context is
    open, each call fenced by ``torch.cuda.synchronize()`` on both sides
    (so the stages add up to the wall clock; the fences cost a little)."""

    def __init__(self, module, names: tuple[str, ...]):
        self.module, self.names = module, names
        self.seconds = dict.fromkeys(names, 0.0)
        self.calls = dict.fromkeys(names, 0)
        self.real = {n: getattr(module, n) for n in names}

    def __enter__(self):
        import torch

        for name, fn in self.real.items():
            def timed(*args, _fn=fn, _name=name, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.seconds[_name] += time.perf_counter() - t0
                self.calls[_name] += 1
                return out
            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.module, name, fn)
        return False


def embed_topk_bound(b: int, length: int, v: int, rank: int, k: int) -> dict:
    """The least time of one ``embed_topk`` on this card: the factor matrix
    and the seeds read once, the top-k ids and sims written once, over the
    HBM rate; and its B·L·V·R multiply-adds (two operations each) over the
    fp32 peak (the products run outside the tensor cores: TF32 is off)."""
    nbytes = 4 * v * rank + 4 * b * length + 8 * b * k
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * 2 * b * length * v * rank / FP32_PEAK_OPS
    return {"ms_bound": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def als_dense_bound(p: int, v: int, rank: int, iters: int) -> dict:
    """The least time of one dense ALS training (``iters`` sweeps and the
    final loss) on this card: the sweeps' operations as the cost model
    counts them (``phase_cost("als_sweep")``: the two products, Gramians
    and solves per sweep) and the loss's ``U Fᵀ`` product, over the fp32
    peak (TF32 is off, so no tensor cores); or the one-hot X read once and
    both factor matrices read and written once, over the HBM rate."""
    from kmlserver_tpu_torch.observability.costmodel import phase_cost

    flops = phase_cost("als_sweep", p=p, v=v, r=rank, iters=iters)[0] + 2.0 * p * v * rank
    nbytes = 4 * p * v + 2 * 4 * rank * (p + v)
    ops_ms = 1e3 * flops / FP32_PEAK_OPS
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    return {"ms": max(ops_ms, bytes_ms), "operations": flops, "bytes": nbytes,
            "operations_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def segsum_bound(csr, rank: int, clock_hz: float) -> dict:
    """The least time of one accumulate on this card, the largest of three:
    each input read once (the factor matrix, offsets, indices) and the
    output written once, over the HBM rate; its nnz·R fp32 adds over the
    fp32 peak; and the longest row's chain of dependent fp32 adds (each
    column's sum is one chain in event order, which no schedule may split:
    the result would change its bits), ``SEGSUM_ADD_CYCLES`` per event at
    the SM's top clock. ``bound_by`` says bytes or operations (the chain is
    operations: dependent adds), ``bound_term`` which of the three."""
    n_in, n_out, nnz = csr.n_in, csr.n_out, csr.nnz
    nbytes = 4 * n_in * rank + 8 * (n_out + 1) + 4 * nnz + 4 * n_out * rank
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * nnz * rank / FP32_PEAK_OPS
    longest = int((csr.offsets[1:] - csr.offsets[:-1]).max()) if n_out else 0
    chain_ms = 1e3 * longest * SEGSUM_ADD_CYCLES / clock_hz
    gather_ms = 1e3 * (4 * nnz * rank + 4 * nnz + 8 * (n_out + 1) + 4 * n_out * rank) / PEAK_BYTES_PER_S
    terms = {"bytes": bytes_ms, "operations": ops_ms, "chain": chain_ms}
    term = max(terms, key=terms.get)
    return {"bytes": nbytes, "ms": terms[term], "bound_term": term,
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bytes_ms": bytes_ms, "operations_ms": ops_ms, "chain_ms": chain_ms,
            "longest_row": longest, "gathered_rows_ms": gather_ms}


def phase_embed_scale(work: str) -> dict:
    """Phase 11 (c): sparse ALS at phase 5's scale baskets (1M x 1M, ~50M
    memberships), loaded from phase 5's arrays: the storage decision, one
    accumulate each way against the CPU plain version, the kernel and
    ``index_add_`` timed per half-sweep beside the bound, the
    ``LONG_ROW_EVENTS`` sweep, one 2,000,000-event row, two full trainings
    (launch counters set to 0 just before the first, read just after),
    ``embed_topk`` at V = 1M. → the kernels line's segsum entry."""
    import torch

    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.mining import als
    from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
    from kmlserver_tpu_torch.ops import segsum
    from kmlserver_tpu_torch.ops.embed import embed_topk

    with open(os.path.join(work, "scale_shape.json")) as fh:
        shape = json.load(fh)
    rows = np.load(os.path.join(work, "scale_rows.npy"))
    tids = np.load(os.path.join(work, "scale_tids.npy"))
    p, v, nnz = shape["n_playlists"], shape["n_tracks"], len(rows)
    names = [f"Track {i:07d}" for i in range(v)]
    baskets = Baskets(playlist_rows=rows, track_ids=tids, n_playlists=p,
                      vocab=Vocab(names=names, index={}))
    cfg = MiningConfig(embed_enabled=True)
    rank = cfg.als_rank
    dense_b = 5 * p * v + 8 * rank * (p + v)
    sparse_b = als.sparse_als_bytes(nnz, p, v, rank)

    # ---- one accumulate each way at full size, kernel vs the CPU plain version
    rows_d = torch.as_tensor(rows, device="cuda")
    cols_d = torch.as_tensor(tids, device="cuda")
    gen = torch.Generator().manual_seed(5)
    user_h = torch.randn(p, rank, generator=gen) / rank ** 0.5
    item_h = torch.randn(v, rank, generator=gen) / rank ** 0.5
    clock_hz = 1e6 * float(nvidia_smi_query("clocks.max.sm").split()[0])
    plan = segsum.kernel_plan(rank)
    t0 = time.perf_counter()
    by_user = segsum.build_csr(rows_d, cols_d, p, v)
    by_item = segsum.build_csr(cols_d, rows_d, v, p)
    torch.cuda.synchronize()
    csr_s = time.perf_counter() - t0
    # the schedule's share of that build: one stable sort of the row lengths each
    order_s = 0.0
    for csr in (by_user, by_item):
        lengths = csr.offsets[1:] - csr.offsets[:-1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        order = torch.sort(-lengths, stable=True).indices.to(torch.int32)
        torch.cuda.synchronize()
        order_s += time.perf_counter() - t0
        if not torch.equal(order, csr.order):
            fail("phase 11 (c): the CSR's schedule is not the stable sort of its lengths")
    sides = {"X F": (by_user, item_h, rows, tids, p), "Xt U": (by_item, user_h, tids, rows, v)}
    entry_sides, max_err, sweep = {}, 0.0, {}
    for label, (csr, mat_h, seg_h, gidx_h, n_out) in sides.items():
        mat = mat_h.cuda()
        got = segsum.segment_sum(mat, csr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = segsum.segment_sum_plain(mat_h, torch.from_numpy(seg_h), torch.from_numpy(gidx_h),
                                         n_out)
        plain_ms = 1e3 * (time.perf_counter() - t0)
        got_h = got.cpu()
        err = float((got_h - plain).abs().max())
        ulps = int((got_h.view(torch.int32).long() - plain.view(torch.int32).long()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got_h, plain):
            fail(f"phase 11 (c) {label}: kernel != CPU plain version: max |Δ| {err}, "
                 f"{ulps} ulps")
        ms = cuda_ms(lambda: segsum.segment_sum(mat, csr), 10)
        seg_d = (rows_d if label == "X F" else cols_d).long()
        gidx_d = (cols_d if label == "X F" else rows_d).long()
        out = torch.zeros(n_out, rank, device="cuda")

        def library():
            out.zero_()
            out.index_add_(0, seg_d, mat[gidx_d])

        library()
        lib_ms = cuda_ms(library, 10)
        del seg_d, gidx_d, out
        lengths = csr.offsets[1:] - csr.offsets[:-1]
        # LONG_ROW_EVENTS: the same CSR with the long-row count each candidate
        # gives; every one must give the same bits
        sweep[label] = {}
        for threshold in SEGSUM_THRESHOLDS:
            cand = dataclasses.replace(csr, n_long=int((lengths >= threshold).sum()))
            if not torch.equal(segsum.segment_sum(mat, cand), got):
                fail(f"phase 11 (c) {label}: LONG_ROW_EVENTS={threshold} changed the bits")
            sweep[label][threshold] = {"n_long": cand.n_long,
                                       "ms": cuda_ms(lambda: segsum.segment_sum(mat, cand), 5)}
        bound = segsum_bound(csr, rank, clock_hz)
        entry_sides[label] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                              "bound_ms": bound["ms"], "bound_by": bound["bound_by"],
                              "bound_term": bound["bound_term"], "bytes": bound["bytes"],
                              "bytes_ms": bound["bytes_ms"], "chain_ms": bound["chain_ms"],
                              "gathered_rows_ms": bound["gathered_rows_ms"],
                              "max_row_events": bound["longest_row"], "long_rows": csr.n_long,
                              "ulps": ulps}
        log(f"phase 11 (c) accumulate {label} (out {n_out} x {rank}, {nnz} events, longest row "
            f"{bound['longest_row']} events, {csr.n_long} rows of >= {segsum.LONG_ROW_EVENTS} "
            f"through the ring): kernel == CPU plain version bit for bit; kernel {ms:.3f} ms, "
            f"index_add_ on the card {lib_ms:.3f} ms (gather included), CPU plain "
            f"{plain_ms:.1f} ms; bound {bound['ms']:.4f} ms ({bound['bound_term']}: bytes "
            f"{bound['bytes_ms']:.4f}, chain {bound['chain_ms']:.4f} = longest row x "
            f"{SEGSUM_ADD_CYCLES} cycles at {clock_hz / 1e6:.0f} MHz; the gathered rows once "
            f"would be {bound['gathered_rows_ms']:.3f} ms); LONG_ROW_EVENTS sweep (long rows, "
            f"ms): " + ", ".join(f"{t if t < 1 << 40 else 'none'} ({r['n_long']}, "
                                 f"{r['ms']:.3f})" for t, r in sweep[label].items()))
    del rows_d, cols_d, by_user, by_item, sides, csr, mat, got, cand

    # ---- one synthetic row of SEGSUM_LONG_ROW events over the playlist factors
    rng = np.random.default_rng(17)
    one_gidx = rng.integers(0, p, SEGSUM_LONG_ROW)
    one_seg = np.zeros(SEGSUM_LONG_ROW, np.int64)
    one = segsum.build_csr(torch.as_tensor(one_seg, device="cuda"),
                           torch.as_tensor(one_gidx, device="cuda"), 1, p)
    mat = user_h.cuda()
    got = segsum.segment_sum(mat, one)
    torch.cuda.synchronize()
    plain = segsum.segment_sum_plain(user_h, torch.from_numpy(one_seg),
                                     torch.from_numpy(one_gidx), 1)
    if not torch.equal(got.cpu(), plain):
        fail(f"phase 11 (c): the {SEGSUM_LONG_ROW}-event row != CPU plain version: max |Δ| "
             f"{float((got.cpu() - plain).abs().max())}")
    one_ms = cuda_ms(lambda: segsum.segment_sum(mat, one), 5)
    one_bound = segsum_bound(one, rank, clock_hz)
    long_row = {"events": SEGSUM_LONG_ROW, "ms": one_ms, "bound_ms": one_bound["ms"],
                "bound_term": one_bound["bound_term"], "chain_ms": one_bound["chain_ms"],
                "ns_per_event": 1e6 * one_ms / SEGSUM_LONG_ROW}
    log(f"phase 11 (c) one row of {SEGSUM_LONG_ROW} events (uniform over the {p} playlist "
        f"factors, R={rank}): kernel == CPU plain version bit for bit; {one_ms:.3f} ms "
        f"({long_row['ns_per_event']:.3f} ns per event), chain bound {one_bound['chain_ms']:.3f} "
        f"ms, bytes {one_bound['bytes_ms']:.3f} ms; ring {plan['stages']} stages x "
        f"{plan['stage_events']} events, {plan['smem_bytes']} B dynamic shared memory per block, "
        f"{plan['blocks_per_sm']} blocks per SM x {plan['sms']} SMs")
    del mat, got, one

    # ---- the main path: two full sparse trainings, counters set to 0 just before
    segsum.LAUNCHES["segsum"] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = als.train_embeddings(baskets, cfg, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = segsum.LAUNCHES["segsum"]
    peak = torch.cuda.max_memory_allocated()
    # the second training, its stages timed (where the wall clock goes)
    stage_names = ("build_csr", "_sparse_als_sweep", "_sparse_als_loss", "normalize_factors")
    t0 = time.perf_counter()
    with StageTimes(als, stage_names) as stages:
        second = als.train_embeddings(baskets, cfg, device="cuda")
    stages_wall = time.perf_counter() - t0
    if first["storage"] != "sparse" or launches != 2 * cfg.als_iters:
        fail(f"phase 11 (c): storage {first['storage']}, {launches} segsum launches, want "
             f"sparse and {2 * cfg.als_iters}")
    if not np.array_equal(first["item_factors"], second["item_factors"]) or (
            first["final_loss"] != second["final_loss"]):
        fail("phase 11 (c): two sparse trainings on the card gave different factors")
    if not np.isfinite(first["item_factors"]).all():
        fail("phase 11 (c): non-finite factors")
    log(f"phase 11 (c) sparse ALS at {p} x {v}, {nnz} memberships, R={rank}, "
        f"{cfg.als_iters} iters: auto picked {first['storage']} (dense ~{dense_b:.4g} B, "
        f"sparse ~{sparse_b:.4g} B against hbm_budget_bytes {cfg.hbm_budget_bytes}); "
        f"{train_s:.3f} s ({launches} segsum launches), CSR + CSC build {csr_s:.3f} s (their "
        f"schedules' sorts {order_s:.4f} s of it); the "
        f"second training bit-identical (loss {first['final_loss']:.6f}); peak device memory "
        f"{peak} B ({peak / 2**30:.3f} GiB); the second's stages (synchronized, "
        f"{stages_wall:.3f} s): "
        + ", ".join(f"{n} {stages.seconds[n]:.3f} s x{stages.calls[n]}" for n in stage_names)
        + f", the rest (host init, uploads, solves' setup, copy back) "
        f"{stages_wall - sum(stages.seconds.values()):.3f} s")

    # ---- embed_topk at V = 1M, card vs CPU
    factors_h = torch.as_tensor(first["item_factors"])
    factors = factors_h.cuda()
    topk = {}
    for b, length in EMBED_TOPK_SHAPES:
        seeds_h = torch.randint(-1, v, (b, length), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(b))
        seeds = seeds_h.cuda()
        ids, sims = embed_topk(factors, seeds, k_best=10)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: embed_topk(factors, seeds, k_best=10), 20)
        t0 = time.perf_counter()
        c_ids, c_sims = embed_topk(factors_h, seeds_h, k_best=10)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        d_sims = float((sims.cpu() - c_sims).abs().max())
        id_rows = int((ids.cpu() != c_ids).any(dim=1).sum())
        if d_sims > EMBED_SIM_TOL:
            fail(f"phase 11 (c) embed_topk {b}x{length}: sims max |Δ| {d_sims} > {EMBED_SIM_TOL}")
        ties = 0
        for r in range(b):
            if torch.equal(ids[r].cpu(), c_ids[r]):
                continue
            s = c_sims[r].tolist()
            if not any(x - y <= NEAR_TIE for x, y in zip(s, s[1:])):
                ids11, sims11 = embed_topk(factors_h, seeds_h[r:r + 1], k_best=11)
                s = sims11[0].tolist()
                if not any(x - y <= NEAR_TIE for x, y in zip(s, s[1:])):
                    fail(f"phase 11 (c) embed_topk {b}x{length}: row {r} ids differ, no near-tie")
            ties += 1
        bound = embed_topk_bound(b, length, v, rank, 10)
        topk[f"{b}x{length}"] = {"ms": ms, "cpu_ms": cpu_ms, "sims_max_abs": d_sims,
                                 "rows_ids_differ": id_rows, "near_ties": ties, **bound}
        log(f"phase 11 (c) embed_topk B x L = {b} x {length} at V={v}: {ms:.4f} ms on the "
            f"card (bound {bound['ms_bound']:.4f} ms, {bound['bound_by']}), {cpu_ms:.1f} ms CPU "
            f"plain; sims max |Δ| {d_sims:.3g}, {id_rows} rows' ids differ, each at a near-tie")
    one = {k: sum(s[k] for s in entry_sides.values())
           for k in ("ms", "plain_ms", "library_ms", "bound_ms", "gathered_rows_ms", "chain_ms")}
    entry = {
        "name": "segsum",
        "route": "cuda",
        "source": "kmlserver_tpu_torch/ops/csrc/segsum.cu",
        "replaces": "kmlserver_tpu/mining/als.py:158",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": one["ms"],
        "plain_ms": one["plain_ms"],
        "bound_ms": one["bound_ms"],
        "bound_by": "bytes" if all(s["bound_by"] == "bytes" for s in entry_sides.values())
        else "operations",
        "library_ms": one["library_ms"],
        "per_sweep": "X F + Xt U (both accumulates of one sweep)",
        "sides": entry_sides,
        "gathered_rows_ms": one["gathered_rows_ms"],
        "chain_bound_ms": one["chain_ms"],
        "long_rows": {k: s["long_rows"] for k, s in entry_sides.items()},
        "long_row_events": segsum.LONG_ROW_EVENTS,
        "threshold_sweep_ms": {k: {str(t): r["ms"] for t, r in rows_.items()}
                               for k, rows_ in sweep.items()},
        "one_long_row": long_row,
        "smem_bytes_per_block": plan["smem_bytes"],
        "ring": {k: plan[k] for k in ("stages", "stage_events", "consumer_warps",
                                      "producer_warps", "blocks_per_sm", "sms")},
        "shape": [p, v, nnz, rank],
    }
    return {"entry": entry, "train_s": train_s, "csr_s": csr_s, "order_s": order_s,
            "peak_bytes": peak,
            "stages_s": {**stages.seconds, "wall": stages_wall},
            "embed_topk_v1m": topk, "final_loss": first["final_loss"]}


# segsum.cu built with one change each, for probe_segsum_ring: (what it
# shows, [(text in the source, its replacement)])
SEGSUM_PROBES = {
    "as built": [],
    "no adds (the copies alone)": [
        ("acc = w == 32   ? add_full_stage<32>(st, acc)", "acc = true ? acc"),
        ("acc = add_stage(st, w, n, acc);", ";")],
    "no copies (the adds alone)": [
        ("fill_stage<32>(dst0, src0, rank, idx, n, lane);", ";")],
    "neither (the handshake alone)": [
        ("acc = w == 32   ? add_full_stage<32>(st, acc)", "acc = true ? acc"),
        ("acc = add_stage(st, w, n, acc);", ";"),
        ("fill_stage<32>(dst0, src0, rank, idx, n, lane);", ";")],
    "4 blocks per SM, 6 stages": [
        ("constexpr int kMinBlocksPerSm = 3;", "constexpr int kMinBlocksPerSm = 4;"),
        ("constexpr int kStages = 8;", "constexpr int kStages = 6;")],
}


def probe_segsum_ring(events: int = SEGSUM_LONG_ROW, rank: int = 32) -> dict:
    """Where a long row's time goes in the segsum kernel: ``segsum.cu``
    built as it is and with the adds, the copies or both taken out (the
    rest unchanged), and once at 4 blocks per SM; each times one row of
    ``events`` events over a 1M-row factor matrix, its indices uniform
    (DRAM) or within 4,096 rows (L2). Only the build as it is must equal
    the CPU plain version. Not part of ``main``; alone: ``python -c
    "import chip_smoke as c; c.probe_segsum_ring()"``."""
    import ctypes

    import torch

    from kmlserver_tpu_torch.ops import cuda_build, segsum

    src = (cuda_build.CSRC_DIR / "segsum.cu").read_text()
    out_dir = os.path.join(ROOT, "build", "segsum_probe")
    os.makedirs(out_dir, exist_ok=True)
    builds = {}
    for i, (name, edits) in enumerate(SEGSUM_PROBES.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                fail(f"probe_segsum_ring: {old!r} is not in segsum.cu once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"probe{i}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = os.path.join(out_dir, f"libprobe{i}.so")
        builds[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    n_in = 1_000_000
    rng = np.random.default_rng(17)
    mat_h = torch.randn(n_in, rank, generator=torch.Generator().manual_seed(5)) / rank ** 0.5
    mat = mat_h.cuda()
    rows = {"uniform": rng.integers(0, n_in, events), "L2-hot": rng.integers(0, 4096, events)}
    csrs = {k: segsum.build_csr(torch.zeros(events, dtype=torch.int64, device="cuda"),
                                torch.as_tensor(g, device="cuda"), 1, n_in)
            for k, g in rows.items()}
    plain = segsum.segment_sum_plain(
        mat_h, torch.zeros(events, dtype=torch.int64), torch.as_tensor(rows["uniform"]), 1)
    clock_hz = 1e6 * float(nvidia_smi_query("clocks.max.sm").split()[0])
    result = {}
    built = cuda_build._loaded.pop("segsum", None)
    try:
        for name, (so, proc) in builds.items():
            report = proc.communicate()[0]
            if proc.returncode != 0:
                fail(f"probe_segsum_ring: {name} does not build:\n{report}")
            cuda_build._loaded["segsum"] = ctypes.CDLL(so)
            plan = segsum.kernel_plan(rank)
            result[name] = {"blocks_per_sm": plan["blocks_per_sm"],
                            "ptxas": ptxas_report(report)}
            for label, csr in csrs.items():
                got = segsum.segment_sum(mat, csr)
                if name == "as built" and label == "uniform" and not torch.equal(
                        got.cpu(), plain):
                    fail("probe_segsum_ring: the build as it is != CPU plain version")
                ms = cuda_ms(lambda: segsum.segment_sum(mat, csr), 5)
                result[name][label] = {"ms": ms, "ns_per_event": 1e6 * ms / events,
                                       "cycles_per_event": ms * 1e-3 * clock_hz / events}
            log(f"probe segsum ring, {name}: {plan['blocks_per_sm']} blocks per SM; one row of "
                f"{events} events, R={rank}: " + ", ".join(
                    f"{k} {r['ms']:.3f} ms ({r['ns_per_event']:.3f} ns, "
                    f"{r['cycles_per_event']:.2f} cycles at {clock_hz / 1e6:.0f} MHz per event)"
                    for k, r in result[name].items() if isinstance(r, dict) and "ms" in r))
    finally:
        cuda_build._loaded.pop("segsum", None)
        if built is not None:
            cuda_build._loaded["segsum"] = built
    log("PROBE_SEGSUM " + json.dumps(result))
    return result


def phase_embeddings(work: str | None = None, shape: dict | None = None) -> dict:
    """Phase 11 on phase 4's ds2 CSV and phase 5's scale baskets (alone:
    ``python -c "import chip_smoke as c; c.phase_embeddings()"`` mines its
    own ds2 PVC and generates the scale baskets at ``shape``, default the
    full scale shape)."""
    own = work is None
    work = work or tempfile.mkdtemp(prefix="kmls_smoke11_")
    try:
        if not os.path.exists(os.path.join(work, "scale_rows.npy")):
            from kmlserver_tpu_torch.data.synthetic import synthetic_baskets

            shape = shape or SCALE
            baskets = synthetic_baskets(**shape, seed=2024)
            np.save(os.path.join(work, "scale_rows.npy"), baskets.playlist_rows)
            np.save(os.path.join(work, "scale_tids.npy"), baskets.track_ids)
            with open(os.path.join(work, "scale_shape.json"), "w") as fh:
                json.dump({"n_playlists": baskets.n_playlists, "n_tracks": baskets.n_tracks}, fh)
            log(f"phase 11: scale baskets {shape} generated (seed 2024)")
        result = {"ds2": phase_embed_ds2(work), "scale": phase_embed_scale(work)}
        log("PHASE11 " + json.dumps(result))
        return result
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 12

FRESH_CSV = "2023_spotify_ds2_synthetic.csv"
FRESH_COMPACT_AFTER = 3  # KMLS_DELTA_COMPACT_AFTER of the phase's job
FRESH_POLL = "0.0005"  # the server's POLLING_WAIT_IN_MINUTES (the engine polls every 50 ms at least)
FRESH_PROBES = 500  # config-5 draws checked against the CPU engine after an idle cycle
FRESH_HIT_DRAWS = 2000  # Zipf draws replayed around cycle 2's apply (the hit ratio)
FRESH_METRICS_EVERY_S = 0.02  # /metrics scrape period while waiting for an apply
RECOUNT_PLAYLISTS = 1000  # phase 12 (b): the playlists a 0.1 % append adds
RECOUNT_PLAIN_CHUNK = 32768  # playlists per float64 chunk of int8_gram_plain on the card


def append_bench_rows(csv_path: str, rng, first_pid: int, lo: int, new_track: int) -> int:
    """The reference bench's append (``bench.py:1580-1615``): 24 new
    playlists × 90 rows drawn over the 128 tracks from ``lo``, plus one
    brand-new track → rows appended."""
    lines = []
    for p in range(24):
        for t in lo + rng.integers(0, 128, size=90):
            t = int(t)
            lines.append(f"{first_pid + p},Track {t:07d},spotify:track:{t:07d},"
                         f"Artist {t % 997:04d},spotify:artist:{t % 997:04d},Album {t // 12:06d}")
    lines.append(f"{first_pid},Track {new_track:07d},spotify:track:{new_track:07d},"
                 f"Artist 0000,spotify:artist:0000,Album 000000")
    with open(csv_path, "a") as fh:
        fh.write("\n".join(lines) + "\n")
    return len(lines)


def wait_metrics(base: str, ready, timeout_s: float, label: str) -> tuple[dict, float]:
    """Scrape ``/metrics`` every :data:`FRESH_METRICS_EVERY_S` until
    ``ready(metrics)`` → (those metrics, the perf_counter after the scrape
    that showed it)."""
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        m = scrape_metrics(base)
        if ready(m):
            return m, time.perf_counter()
        time.sleep(FRESH_METRICS_EVERY_S)
    fail(f"phase 12 (a): {label} not seen within {timeout_s:.0f} s: {m.get('kmls_delta_seq')}, "
         f"reloads {m.get('kmls_reloads_total')}")


def job_split(out: str, label: str) -> dict:
    """The delta job's step seconds from its ``Delta phase timings:`` line."""
    line = next((ln for ln in out.splitlines() if ln.startswith("Delta phase timings:")), None)
    if line is None:
        fail(f"phase 12 (a) {label}: the job took no delta route")
    return {k: float(v.rstrip("s")) for k, v in
            (part.split() for part in line.split(":", 1)[1].split(","))}


def job_duration_s(pvc: str) -> float:
    """``kmls_job_duration_seconds`` of the job that last wrote the PVC's
    ``job_metrics.prom``: its own run, without the process's start-up."""
    with open(os.path.join(pvc, "pickles", "job_metrics.prom")) as fh:
        for line in fh:
            if line.startswith("kmls_job_duration_seconds "):
                return float(line.split()[1])
    fail(f"phase 12 (a): no kmls_job_duration_seconds in {pvc}'s job_metrics.prom")


def timed_checks(label: str, responses: list, payloads: list, pre: list, post: list,
                 tokens: set, after: float | None, cpu) -> dict:
    """Answers of a replay that ran through an apply or a swap: each is the
    CPU engine's over the PVC before (``pre``) or after (``post``) it, the
    model date one of ``tokens``; a request scheduled after ``after``
    (perf_counter, ``responses`` entries carry their scheduled time) must
    be the post answer. No 5xx, nothing unanswered, a degraded answer the
    popularity fallback (the admission ladder's). → counts."""
    head_k = [b["track_name"] for b in cpu.best_tracks][: cpu.cfg.k_best_tracks]
    counts = {"pre_only": 0, "post": 0, "both": 0, "after_apply": 0, "degraded": 0, "shed": 0,
              "changed_payloads": sum(a[0] != b[0] for a, b in zip(pre, post))}
    if len(responses) != len(payloads):
        fail(f"phase 12 (a) {label}: {len(payloads) - len(responses)} requests got no answer")
    for i, status, head, body, t_sched in responses:
        if status >= 500:
            fail(f"phase 12 (a) {label}: HTTP {status} for {payloads[i]}")
        if status == 429:
            counts["shed"] += 1
            continue
        got = json.loads(body)
        if b"x-kmls-degraded:" in head:
            counts["degraded"] += 1
            if got["songs"] not in (cpu.static_recommendation(payloads[i]), head_k):
                fail(f"phase 12 (a) {label}: degraded answer for {payloads[i]} is not the fallback")
            continue
        if status != 200 or got["model_date"] not in tokens:
            fail(f"phase 12 (a) {label}: {status} {body[:200]!r}")
        is_pre, is_post = got["songs"] == pre[i][0], got["songs"] == post[i][0]
        if not (is_pre or is_post):
            fail(f"phase 12 (a) {label}: answer for {payloads[i]} is neither the pre- nor "
                 f"the post-delta CPU engine's: {body[:300]!r}")
        if after is not None and t_sched >= after:
            counts["after_apply"] += 1
            if not is_post:
                fail(f"phase 12 (a) {label}: a request sent after the apply answered the "
                     f"pre-delta rules for {payloads[i]}")
        key = "both" if is_pre and is_post else ("post" if is_post else "pre_only")
        counts[key] += 1
    return counts


class ScheduledResponses(list):
    """``replay_async_http``'s ``responses`` sink that stamps each answer
    with its request's scheduled send time: the replay's start (taken
    before the call, so no later than the replay's own) plus its arrival
    offset, which ``replay._poisson_arrivals`` draws from a fixed seed."""

    def __init__(self, n: int, qps: float):
        from kmlserver_tpu_torch.serving.replay import _poisson_arrivals

        super().__init__()
        self.arrival = _poisson_arrivals(n, qps)
        self.t0 = time.perf_counter()

    def append(self, item) -> None:
        super().append((*item, self.t0 + float(self.arrival[item[0]])))


def freshness_ds2(work: str) -> dict:
    """Phase 12 (a): the ds2 CSV through both entry points with deltas on —
    the full path three times, then four append → job → applied cycles
    (the third compacts the chain and the server hot-swaps the snapshot
    under a replay; the fourth publishes in the middle of config 5's
    replay), then a full re-mine of the final CSV in a pristine PVC, equal
    to the chain bit for bit."""
    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.data.csv import write_tracks_csv
    from kmlserver_tpu_torch.data.synthetic import DS2_SHAPE, synthetic_table
    from kmlserver_tpu_torch.freshness import delta as delta_mod
    from kmlserver_tpu_torch.freshness.ring import fleet_multiplier, seeds_key
    from kmlserver_tpu_torch.io import artifacts
    from kmlserver_tpu_torch.ops.support import min_count_for
    from kmlserver_tpu_torch.quality import lifecycle
    from kmlserver_tpu_torch.serving.engine import RecommendEngine
    from kmlserver_tpu_torch.serving.replay import replay_async_http, sample_seed_sets

    pvc = os.path.join(work, "pvc_fresh")
    pickles = os.path.join(pvc, "pickles")
    os.makedirs(os.path.join(pvc, "datasets"))
    csv_path = os.path.join(pvc, "datasets", FRESH_CSV)
    src = os.path.join(work, "pvc", "datasets", FRESH_CSV)
    if os.path.exists(src):
        shutil.copy(src, csv_path)  # phase 4's CSV
    else:
        write_tracks_csv(csv_path, synthetic_table(**DS2_SHAPE, seed=7))
    delta_env = dict(KMLS_DELTA_ENABLED="1", KMLS_DELTA_COMPACT_AFTER=str(FRESH_COMPACT_AFTER))
    job_process(pvc, "fresh base", **delta_env)
    cpu = RecommendEngine(ServingConfig(base_dir=pvc, delta_enabled=True), device="cpu")
    if not cpu.load():
        fail("phase 12 (a): the CPU engine could not load the base")
    keys = sorted(n for n, k in zip(cpu.bundle.vocab, cpu.bundle.known_mask) if k)
    probes = sample_seed_sets(keys, FRESH_PROBES, rng_seed=21)
    config5 = sample_seed_sets(keys, CONFIG5_REQUESTS)
    hit_draws = sample_seed_sets(keys, FRESH_HIT_DRAWS, rng_seed=11, zipf_s=1.1)
    rng = np.random.default_rng(7)
    server, base, lines = start_server(pvc, KMLS_DELTA_ENABLED="1",
                                       POLLING_WAIT_IN_MINUTES=FRESH_POLL)

    def probe(label: str) -> None:
        """Every probe answer over HTTP equals the CPU engine's, which
        follows the PVC through its own poll."""
        cpu.reload_if_required()
        responses: list = []
        replay_async_http(base, probes, qps=2000.0, n_conns=16, responses=responses)
        check_responses(f"phase 12 (a) {label}", responses, probes,
                        engine_answers(cpu, probes), cpu)

    def apply_ms(seq: int) -> float:
        """The server's ``delta <seq> applied in place ... in <ms> ms`` line."""
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            found = [ln for ln in lines if f"delta {seq} applied in place" in ln]
            if found:
                return float(found[-1].split(") in ", 1)[1].split(" ms", 1)[0])
            time.sleep(0.05)
        fail(f"phase 12 (a): the server logged no apply of delta {seq}")

    try:
        # ---- the full path: the job with deltas off + the server's reload, x3
        full_runs, full_in_process = [], []
        for i in range(3):
            reloads = scrape_metrics(base)["kmls_reloads_total"]
            t0 = time.perf_counter()
            job_process(pvc, f"full {i + 1}")
            wait_metrics(base, lambda m: m["kmls_reloads_total"] > reloads, 60, "full reload")
            full_runs.append(time.perf_counter() - t0)
            full_in_process.append(job_duration_s(pvc))
        # re-arm: the base state's generation was replaced, so this delta-on
        # run re-mines in full and saves a new base (not timed)
        reloads = scrape_metrics(base)["kmls_reloads_total"]
        out, _ = job_process(pvc, "re-arm", **delta_env)
        if "Freshness base state saved" not in out:
            fail("phase 12 (a): the re-arming job saved no base state")
        wait_metrics(base, lambda m: m["kmls_reloads_total"] > reloads, 60, "re-arm reload")
        probe("base")
        min_counts = [min_count_for(DS2_MIN_SUPPORT, delta_mod.load_base_state(pickles)["n_playlists"])]
        token0 = cpu.cache_value

        cycles: list[dict] = []
        for cycle in range(1, 5):
            compacts = cycle == FRESH_COMPACT_AFTER
            m0 = scrape_metrics(base)
            run: dict = {}

            def publish(cycle=cycle, m0=m0, run=run, compacts=compacts) -> None:
                """Append, run the job, wait until the server serves it;
                a failure is kept for the caller (this may run on a
                thread)."""
                try:
                    t1 = time.perf_counter()
                    append_bench_rows(csv_path, rng, 10_000_000 + cycle * 1_000,
                                      96 + (cycle - 1) * 160, 9_000_000 + cycle)
                    out, run["job_s"] = job_process(pvc, f"delta {cycle}", **delta_env)
                    run["in_process_s"] = job_duration_s(pvc)
                    run["split"] = job_split(out, f"cycle {cycle}")
                    run["log"] = [ln for ln in out.splitlines() if ln.startswith("Delta ")]
                    if compacts:
                        if f"Delta chain compacted: {FRESH_COMPACT_AFTER} bundles" not in out:
                            fail("phase 12 (a): the third delta did not compact the chain")
                        ready = (lambda m: m["kmls_reloads_total"] > m0["kmls_reloads_total"]
                                 and m["kmls_delta_seq"] == 0
                                 and m["kmls_delta_chain_length"] == 0)
                    else:
                        # applied, and the touched seeds invalidated after it
                        ready = (lambda m: m["kmls_delta_seq"] > m0["kmls_delta_seq"]
                                 and m["kmls_cache_selective_invalidations_total"]
                                 > m0["kmls_cache_selective_invalidations_total"])
                    run["metrics"], run["t_seen"] = wait_metrics(base, ready, 60, f"cycle {cycle}")
                    run["applied_s"] = run["t_seen"] - t1
                except BaseException as exc:  # noqa: BLE001  (re-raised by the caller)
                    run["error"] = exc

            if cycle == 2:
                # the Zipf head in the cache, then the hit ratio of the same
                # draws before the apply
                replay_async_http(base, hit_draws, qps=CONFIG5_QPS, n_conns=CONFIG5_CONNS)
                hit_before = replay_async_http(base, hit_draws, qps=CONFIG5_QPS,
                                               n_conns=CONFIG5_CONNS).cache_hit_ratio
                entries_before = scrape_metrics(base)["kmls_cache_entries"]
            if cycle < 3:
                publish()
                if "error" in run:
                    raise run["error"]
            else:
                # under load: cycle 3's compaction swap and cycle 4's apply
                # land mid-replay; the job starts first, the replay so that
                # the publication falls 40 % into it (from earlier jobs' walls)
                payloads = config5 if cycle == 4 else sample_seed_sets(
                    keys, CONFIG5_REQUESTS, rng_seed=33)
                pre, pre_token = engine_answers(cpu, payloads), cpu.cache_value
                job_est = float(np.median([c["job_s"] for c in cycles]))
                lead = max(job_est - 0.4 * CONFIG5_REQUESTS / CONFIG5_QPS, 0.0)
                if post(base + "/metrics/reset", b"")[0] != 200:
                    fail("phase 12 (a): /metrics/reset refused")
                before_replay = scrape_metrics(base)
                publisher = threading.Thread(target=publish, daemon=True)
                publisher.start()
                time.sleep(lead)
                responses = ScheduledResponses(len(payloads), CONFIG5_QPS)
                report = replay_async_http(base, payloads, qps=CONFIG5_QPS,
                                           n_conns=CONFIG5_CONNS, responses=responses)
                t_end = time.perf_counter()
                publisher.join(120)
                if "error" in run:
                    raise run["error"]
                if "t_seen" not in run:
                    fail(f"phase 12 (a): cycle {cycle}'s publication did not finish")
                if not responses.t0 <= run["t_seen"] <= t_end:
                    fail(f"phase 12 (a): cycle {cycle} was served {run['t_seen'] - responses.t0:.3f} "
                         f"s into a {t_end - responses.t0:.3f} s replay, not during it")
                window = server_window(base)
                after_replay = scrape_metrics(base)
                # which rung of the admission ladder degraded or shed, and why
                ladder = {k.split('"')[1]: v - before_replay.get(k, 0.0)
                          for k, v in after_replay.items()
                          if k.startswith("kmls_degraded_by_reason{") and v > before_replay.get(k, 0.0)}
                ladder["shed"] = (after_replay["kmls_requests_shed_total"]
                                  - before_replay["kmls_requests_shed_total"])
                cpu.reload_if_required()
                counts = timed_checks(f"cycle {cycle}", responses, payloads, pre,
                                      engine_answers(cpu, payloads),
                                      {pre_token, cpu.cache_value}, run["t_seen"], cpu)
                if not counts["after_apply"]:
                    fail(f"phase 12 (a): no request of cycle {cycle}'s replay came after it")
                run["replay"] = {"achieved_qps": report.achieved_qps, "p50_ms": report.p50_ms,
                                 "p99_ms": report.p99_ms, "errors": report.n_errors,
                                 "served_at_s": run["t_seen"] - responses.t0, **counts,
                                 "ladder": ladder,
                                 "server_p50_ms": window["server_p50_ms"],
                                 "server_p99_ms": window["server_p99_ms"]}
            probe(f"cycle {cycle}")
            metrics = run.pop("metrics")
            run.pop("t_seen")
            run["delta_seq"] = metrics["kmls_delta_seq"]
            run["apply_ms"] = None if compacts else apply_ms(int(metrics["kmls_delta_seq"]))
            if cycle == 2:
                # selective invalidation at work: the entries of untouched
                # seed sets survive the apply; a wholesale flush would leave
                # the replay only its repeats (1 - distinct / draws)
                touched = delta_mod.touched_names(artifacts.load_delta_bundle(
                    os.path.join(pickles, artifacts.delta_bundle_filename(2))))
                invalidated = (metrics["kmls_cache_invalidated_keys_total"]
                               - m0["kmls_cache_invalidated_keys_total"])
                distinct = len({tuple(sorted(d)) for d in hit_draws})
                run["hit_ratio"] = {
                    "before": hit_before,
                    "after": replay_async_http(base, hit_draws, qps=CONFIG5_QPS,
                                               n_conns=CONFIG5_CONNS).cache_hit_ratio,
                    "after_if_wholesale": 1.0 - distinct / len(hit_draws),
                    "entries_before": entries_before, "entries_invalidated": invalidated,
                    "touched_names": len(touched),
                    "untouched_draws": sum(not set(d) & touched for d in hit_draws) / len(hit_draws)}
            min_counts.append(min_count_for(DS2_MIN_SUPPORT,
                                            delta_mod.load_base_state(pickles)["n_playlists"]))
            log(f"phase 12 (a) cycle {cycle}: append → applied {run['applied_s']:.3f} s (job "
                f"{run['job_s']:.3f} s wall, {run['in_process_s']:.3f} s its own run; split "
                + ", ".join(f"{k} {v:.4f}" for k, v in run["split"].items())
                + f" s); apply {run['apply_ms']} ms; min_count {min_counts[-2]} -> "
                f"{min_counts[-1]}; {' | '.join(run['log'])}"
                + (f"; replay {run['replay']}" if "replay" in run else "")
                + (f"; hit ratio {run['hit_ratio']}" if "hit_ratio" in run else ""))
            cycles.append(run)
        if min_counts[:2] != [113, 114]:
            fail(f"phase 12 (a): cycle 1 moved min_count {min_counts[:2]}, want 113 -> 114")
        final = scrape_metrics(base)
    finally:
        code = stop_server(server)
    unwarmed = sum("unwarmed" in line for line in lines)
    compiles = final.get('kmls_compiles_total{kernel="serve_rules"}')
    if code != 0 or unwarmed or compiles != 0 or final["kmls_delta_rejected_total"] != 0:
        fail(f"phase 12 (a): exit {code}, {unwarmed} unwarmed dispatches, serve_rules "
             f"compiles {compiles}, rejected {final['kmls_delta_rejected_total']}")
    if token0 == cpu.cache_value:
        fail("phase 12 (a): the compaction published no new token")

    # ---- the final check: a pristine full mine of the final CSV on the card
    pristine = os.path.join(work, "pvc_fresh_pristine")
    os.makedirs(os.path.join(pristine, "datasets"))
    shutil.copy(csv_path, os.path.join(pristine, "datasets"))
    run_job(pristine, "pristine")
    npz_name = "recommendations.pickle" + artifacts.TENSOR_ARTIFACT_SUFFIX
    full = artifacts.load_rule_tensors(os.path.join(pristine, "pickles", npz_name))
    chain = artifacts.load_rule_tensors(os.path.join(pickles, npz_name))
    for entry in artifacts.read_delta_state(pickles)["entries"]:
        chain = delta_mod.apply_delta_to_tensors(chain, artifacts.load_delta_bundle(
            os.path.join(pickles, entry["file"]), expect_sha256=entry["sha256"]))
    fields = ("vocab", "rule_ids", "rule_counts", "item_counts", "n_playlists", "min_support",
              "mode", "min_confidence")
    if not all(np.array_equal(np.asarray(chain[k]), np.asarray(full[k])) for k in fields):
        fail("phase 12 (a): base ∘ chain tensors differ from the pristine re-mine")
    full_pickle = artifacts.load_pickle(os.path.join(pristine, "pickles", "recommendations.pickle"))
    if artifacts.rules_dict_from_tensors({**chain, "rule_confs64": None}) != full_pickle:
        fail("phase 12 (a): the chain's rule pickle differs from the pristine re-mine's")
    pristine_engine = RecommendEngine(ServingConfig(base_dir=pristine), device="cuda")
    if not pristine_engine.load():
        fail("phase 12 (a): the card engine could not load the pristine PVC")
    # the live server's answers equalled the CPU engine's over the chain
    # (the probes after cycle 4); that engine's equal the pristine PVC's
    if engine_answers(pristine_engine, config5) != engine_answers(cpu, config5):
        fail("phase 12 (a): the pristine re-mine answers differently from the chain")
    compacted = lifecycle.compact_delta_chain(lifecycle_cfg(pvc))
    snap = artifacts.load_rule_tensors(os.path.join(pickles, npz_name))
    if not all(np.array_equal(np.asarray(snap[k]), np.asarray(full[k])) for k in fields) or (
            artifacts.load_pickle(os.path.join(pickles, "recommendations.pickle")) != full_pickle):
        fail("phase 12 (a): the compacted snapshot differs from the pristine re-mine")
    # the reference bench's stream: Zipf 1.1 draws over a pool of seed sets
    fleet = fleet_multiplier(
        [seeds_key(p) for p in sample_seed_sets(keys, CONFIG5_REQUESTS, rng_seed=11, zipf_s=1.1)],
        n_replicas=3, capacity=512)
    full_s = float(np.median(full_runs))
    delta_s = float(np.median([c["applied_s"] for c in cycles[:3]]))
    # the jobs' own runs (job_metrics.prom), without the process start-up
    full_job_s = float(np.median(full_in_process))
    delta_job_s = float(np.median([c["in_process_s"] for c in cycles[:3]]))
    result = {"full_path_s": full_runs, "full_path_median_s": full_s,
              "delta_path_s": [c["applied_s"] for c in cycles], "delta_path_median_s": delta_s,
              "speedup": full_s / delta_s, "full_job_in_process_s": full_in_process,
              "delta_job_in_process_median_s": delta_job_s,
              "in_process_speedup": full_job_s / delta_job_s,
              "min_counts": min_counts, "cycles": cycles,
              "fleet": fleet, "final_compaction_s": compacted.duration_s, "rule_keys": len(keys),
              "freshness_lag_s": final["kmls_freshness_lag_seconds"]}
    log(f"phase 12 (a) ds2 freshness: full path (job + reload) "
        + ", ".join(f"{x:.3f}" for x in full_runs) + f" s, median {full_s:.3f}; delta path "
        f"(append → applied, cycles 1-3) "
        + ", ".join(f"{c['applied_s']:.3f}" for c in cycles[:3])
        + f" s, median {delta_s:.3f} ({full_s / delta_s:.2f}x); the jobs' own runs (no "
        f"start-up) full {full_job_s:.3f} s vs delta {delta_job_s:.3f} s "
        f"({full_job_s / delta_job_s:.2f}x); cycle 4 (mid-replay) "
        f"{cycles[3]['applied_s']:.3f} s; min_count {min_counts}; 0 5xx through the compaction "
        f"swap and the mid-replay apply; no unwarmed dispatch, serve_rules compiles 0; base ∘ "
        f"chain == compacted snapshot == the pristine card re-mine (npz tensors, rule pickle, "
        f"{len(config5)} answers); fleet_multiplier (3 replicas, 512 entries) {fleet}")
    return result


def lifecycle_cfg(pvc: str):
    from kmlserver_tpu_torch.config import MiningConfig

    return MiningConfig(base_dir=pvc, datasets_dir=os.path.join(pvc, "datasets"),
                        min_support=DS2_MIN_SUPPORT, delta_enabled=True)


def recount_bound(r: int, v: int, p: int) -> dict:
    """The least time for rows ``R`` of ``C = XᵀX`` at (R, V, P): ``2·R·V·P``
    int8 operations at the tensor cores' peak, or the bytes ``(R + V)·P``
    read and ``4·R·V`` written at the memory rate, whichever is larger."""
    ops = 2 * r * v * p
    nbytes = (r + v) * p + 4 * r * v
    t_ops, t_bytes = 1e3 * ops / INT8_TC_OPS_PER_S, 1e3 * nbytes / PEAK_BYTES_PER_S
    return {"ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "operations": ops, "operations_ms": t_ops, "bytes": nbytes, "bytes_ms": t_bytes}


def freshness_scale(work: str) -> dict:
    """Phase 12 (b): the card's restricted recount at phase 5's shape after
    the prune, the rows a 0.1 % append touches, against the popcount
    kernel's full C; timed beside its bound and its plain version."""
    import torch

    from kmlserver_tpu_torch.data.synthetic import synthetic_memberships
    from kmlserver_tpu_torch.mining.miner import prune_infrequent
    from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
    from kmlserver_tpu_torch.ops import encode
    from kmlserver_tpu_torch.ops import popcount as pc
    from kmlserver_tpu_torch.ops.support import int8_gram, int8_gram_plain, min_count_for
    from kmlserver_tpu_torch.parallel import support
    from kmlserver_tpu_torch.parallel.mesh import round_up

    torch.cuda.empty_cache()
    with open(os.path.join(work, "scale_shape.json")) as fh:
        shape = json.load(fh)
    rows = np.load(os.path.join(work, "scale_rows.npy"))
    tids = np.load(os.path.join(work, "scale_tids.npy"))
    n_tracks = shape["n_tracks"]
    names = [f"Track {i:07d}" for i in range(n_tracks)]
    baskets = Baskets(playlist_rows=rows, track_ids=tids, n_playlists=shape["n_playlists"],
                      vocab=Vocab(names=names, index={}))
    reduced, keep_ids = prune_infrequent(baskets, min_count_for(SCALE_MIN_SUPPORT,
                                                                baskets.n_playlists))
    del baskets, rows
    p, v = reduced.n_playlists, reduced.n_tracks
    # the full C by the popcount kernel (a comparison launch)
    v_pad, w_pad = pc.padded_shape(v, p)
    bt = pc.bitpack_by_track(reduced.playlist_rows, reduced.track_ids, n_playlists=p,
                             n_tracks=v, v_pad=v_pad, w_pad=w_pad, device="cuda")
    full = pc.popcount_pair_counts_padded(bt)[:v, :v].contiguous()
    del bt
    # R: the pruned ids of every track in 1,000 new playlists of the same
    # Zipf generator (a new seed), at the same density
    per_playlist = len(tids) / shape["n_playlists"]
    _, new_tids = synthetic_memberships(RECOUNT_PLAYLISTS, n_tracks,
                                        int(round(RECOUNT_PLAYLISTS * per_playlist)), seed=2025)
    del tids
    remap = np.full(n_tracks, -1, dtype=np.int64)
    remap[keep_ids] = np.arange(len(keep_ids))
    r_ids = np.unique(remap[new_tids])
    r_ids = r_ids[r_ids >= 0].astype(np.int32)
    r = len(r_ids)
    log(f"phase 12 (b): R = {r} pruned ids (of {len(np.unique(new_tids))} distinct tracks in "
        f"{RECOUNT_PLAYLISTS} new playlists, seed 2025) x V = {v} x P = {p}: P·V = {p * v:.4g} "
        f"(host threshold {support.HOST_RECOUNT_ELEMS:.4g})")

    # the main path: counters to 0, the recount, the counters read
    support.LAUNCHES["restricted_recount"] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = support.restricted_pair_counts(reduced, r_ids, device="cuda")
    wall_s = time.perf_counter() - t0
    launches = support.LAUNCHES["restricted_recount"]
    peak = torch.cuda.max_memory_allocated()
    want = full[torch.as_tensor(r_ids, device="cuda").long()].cpu().numpy()
    if launches != 1 or not np.array_equal(got, want):
        fail(f"phase 12 (b): {launches} card recounts; rows equal to the kernel's C: "
             f"{np.array_equal(got, want)}")
    # the product alone, and its plain version, on the operands the route builds
    xt = encode.onehot_matrix(torch.as_tensor(reduced.track_ids, device="cuda"),
                              torch.as_tensor(reduced.playlist_rows, device="cuda"),
                              n_playlists=round_up(v, 8), n_tracks=round_up(p, 8))
    a = torch.zeros((round_up(max(r, 17), 8), xt.shape[1]), dtype=torch.int8, device="cuda")
    torch.index_select(xt, 0, torch.as_tensor(r_ids, device="cuda").long(), out=a[:r])
    int8_gram(a, xt)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: int8_gram(a, xt), 3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain = torch.zeros((a.shape[0], xt.shape[0]), dtype=torch.int32, device="cuda")
    for c0 in range(0, xt.shape[1], RECOUNT_PLAIN_CHUNK):
        plain += int8_gram_plain(a[:, c0:c0 + RECOUNT_PLAIN_CHUNK], xt[:, c0:c0 + RECOUNT_PLAIN_CHUNK])
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    max_err = int((plain[:r, :v].cpu().long() - torch.as_tensor(got).long()).abs().max())
    if max_err:
        fail(f"phase 12 (b): int8_gram_plain differs from the recount by {max_err}")
    del xt, a, plain, full
    torch.cuda.empty_cache()
    bound = recount_bound(r, v, p)
    if bound["ms"] > ms:
        fail(f"phase 12 (b): {ms:.3f} ms is below its bound {bound['ms']:.3f} ms")
    result = {"r": r, "v": v, "p": p, "launches": launches, "wall_s": wall_s, "ms": ms,
              "library_ms": ms, "plain_ms": plain_ms, "bound": bound, "max_abs_err": max_err,
              "peak_device_bytes": peak}
    log(f"phase 12 (b) restricted_pair_counts on the card: rows == the popcount kernel's C "
        f"exactly, {launches} card recount; whole call {wall_s:.3f} s wall (one-hot build, "
        f"gather, product, copy back); the product int8_gram(Xᵀ[R], Xᵀ) = torch._int_mm "
        f"{ms:.3f} ms against its bound {bound['ms']:.3f} ms ({bound['bound_by']}: "
        f"{bound['operations']:.4g} int8 operations {bound['operations_ms']:.3f} ms, "
        f"{bound['bytes']:.4g} bytes {bound['bytes_ms']:.3f} ms; {100 * bound['ms'] / ms:.1f} %); "
        f"int8_gram_plain {plain_ms:.3f} ms (float64 over {RECOUNT_PLAIN_CHUNK}-playlist "
        f"chunks, exact); peak device memory {peak} B")
    return result


def phase_freshness(work: str | None = None, shape: dict | None = None) -> dict:
    """Phase 12 on phase 4's ds2 CSV and phase 5's scale baskets (alone:
    ``python -c "import chip_smoke as c; c.phase_freshness()"`` writes its
    own ds2 CSV and generates the scale baskets at ``shape``, default the
    full scale shape)."""
    own = work is None
    work = work or tempfile.mkdtemp(prefix="kmls_smoke12_")
    try:
        if not os.path.exists(os.path.join(work, "scale_rows.npy")):
            from kmlserver_tpu_torch.data.synthetic import synthetic_baskets

            shape = shape or SCALE
            baskets = synthetic_baskets(**shape, seed=2024)
            np.save(os.path.join(work, "scale_rows.npy"), baskets.playlist_rows)
            np.save(os.path.join(work, "scale_tids.npy"), baskets.track_ids)
            with open(os.path.join(work, "scale_shape.json"), "w") as fh:
                json.dump({"n_playlists": baskets.n_playlists, "n_tracks": baskets.n_tracks}, fh)
            log(f"phase 12: scale baskets {shape} generated (seed 2024)")
        result = {"ds2": freshness_ds2(work), "scale": freshness_scale(work)}
        log("PHASE12 " + json.dumps(result))
        return result
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


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

    # every kernel source at once, one nvcc each
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(cuda_build.build, KERNEL_SOURCES))
    log(f"build: {', '.join(f'{n}.cu' for n in KERNEL_SOURCES)} in "
        f"{time.perf_counter() - t0:.3f} s (nvcc "
        + ", ".join(f"{n} {cuda_build.BUILD_LOG[n]['seconds']:.3f} s" for n in KERNEL_SOURCES)
        + ")")
    for name in KERNEL_SOURCES:
        for line in cuda_build.BUILD_LOG[name]["ptxas"].splitlines():
            if any(k in line for k in ("registers", "spill", "entry function", "C7513")):
                log(f"  ptxas {name} | {line.strip()}")
    registers = ptxas_registers(cuda_build.BUILD_LOG["popcount"]["ptxas"])

    small_err = phase_kernel_vs_plain()
    work = tempfile.mkdtemp(prefix="kmls_smoke_")
    try:
        e2e = phase_end_to_end(work)
        phase_serving(work)
        resume = phase_resume(work)
        phase_observability(work)
        scale = phase_scale(2024, work, QUICK_SCALE if quick else SCALE)
        ranks = phase_ranks(work, scale)
        # phase 5's tensors on the card are spent: phase 12 (b) needs the room
        for key in ("slabs", "slab_plain", "tensors"):
            scale.pop(key)
        embed = phase_embeddings(work)
        phase_freshness(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    routes = phase_routes()
    kernel = scale["kernel"]
    kernel["launches_job"] = e2e["job_launches"]
    kernel["launches_resume_after_encode"] = resume["resumes"]["encode"]["launches"]
    kernel["launches_resume_after_mine"] = resume["resumes"]["mine"]["launches"]
    kernel["launches_sparse_long"] = routes["launches_sparse_long"]
    kernel["sparse_long_block"] = routes["long_block"]
    small_err = max(small_err, routes["long_block"]["max_abs_err"])
    kernel["launches_sharded"] = ranks["kernel"]["launches"] + sum(ranks["launches_job"])
    kernel["max_abs_err"] = max(kernel["max_abs_err"], small_err)
    for entry in (kernel, ranks["kernel"]):
        entry["ptxas_registers"] = registers
    log(f"total smoke time {time.perf_counter() - t_all:.3f} s")
    segsum_entry = embed["scale"]["entry"]
    segsum_entry["launches_resume_after_embed"] = resume["embed"]["segsum_launches"]
    segsum_entry["launches_ds2_sparse_job"] = resume["embed"]["baseline_segsum_launches"]
    segsum_ptxas = ptxas_report(cuda_build.BUILD_LOG["segsum"]["ptxas"])
    segsum_entry["ptxas_registers"] = {k: r["registers"] for k, r in segsum_ptxas.items()}
    segsum_entry["ptxas_spill_bytes"] = {
        k: {"stores": r.get("spill_store_bytes"), "loads": r.get("spill_load_bytes")}
        for k, r in segsum_ptxas.items()}
    print(json.dumps({"kernels": [kernel, ranks["kernel"], segsum_entry]}))
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
