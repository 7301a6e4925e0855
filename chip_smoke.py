"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kmlserver_tpu_torch`` (and nothing of the JAX package) through its
main loop on the card and fails loudly on any mismatch:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles every CUDA kernel of the path from ``ops/csrc``
   (``popcount.cu``, ``segsum.cu``, ``bernoulli_bits.cu``; one ``nvcc``
   each, all started together) and logs ptxas's registers and spills;
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
   kmlserver_tpu_torch.mining.job`` on phase 4's CSV with
   ``KMLS_COUNT_PATH=bitpack`` (``sharded-bitpack-cuda``, the slab kernel
   on each rank), whose rank-0 publication must equal phase 4's; (c) the
   scale mine at dp = 2 from
   phase 5's baskets, whose rule tensors must equal phase 5's exactly,
   each rank timing its slab kernel and the all-reduce;
7. count routes and census (``mining/dispatch.py``, ``ops/support.py``,
   ``ops/sparse.py``): the ds2 baskets mined in process through
   ``mining.miner.mine`` on the card and on the CPU at every case of
   :data:`ROUTE_CASES` — the auto dispatch (at the job's support, a cell no
   sweep measured, and at 0.005, a cell of the packaged table's ``gpu``
   backend, whose plan must read ``"source": "table"``), each family
   pinned, the sparse route with a long-basket threshold that sends baskets
   through the
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
   requests, then 2 × 8,000 at 1,000 QPS over 48 connections with
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
   (the segsum kernel, 17 launches) killed after ``embed`` and resumed on
   the card: the same bytes, embeddings.npz included, with no ALS sweep and
   no segsum launch.
10. observability (``observability/``, ``utils/profiling.py``; run right
   after phase 9 on phase 4's PVC; alone: ``python -c "import chip_smoke
   as c; c.phase_observability()"``): (a) the async server with
   ``KMLS_TRACE_SAMPLE=1.0`` under 1,000 distinct config-5 seed sets at
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
   config-5 draws over the embedding vocabulary at 1,000 QPS, the
   admission ladder at its default: every answer the CPU engine's except
   those decided by a near-tie (two candidate scores within 1e-6), counted,
   and those the ladder degraded (``overload`` only, each the popularity
   fallback, the server's ladder lines logged); sources counted; zero 5xx;
   no unwarmed
   dispatch; (c) sparse ALS on the scale baskets: ``auto`` picks sparse,
   one accumulate each way held bit for bit against the CPU plain version
   and timed beside ``index_add_`` on the card and its bound (bytes,
   operations, or the longest row's chain of dependent adds), the same
   accumulate at every ``LONG_ROW_EVENTS`` candidate (each bit-equal, each
   timed: the measurement the constant is set from), one synthetic row of
   2,000,000 events held against the plain version and timed, two full
   trainings (counters set to 0 just before the first) bit-identical,
   peak device memory, ``embed_topk`` at V = 1M against its plain version.
12. continuous freshness (``freshness/``, ``quality/lifecycle.py``, the
   engine's in-place apply, ``parallel/support.py::restricted_pair_counts``;
   run after phase 11 on phase 4's CSV and phase 5's scale baskets; alone:
   ``python -c "import chip_smoke as c; c.phase_freshness()"``): (a) the
   job with ``KMLS_DELTA_ENABLED=1`` and ``KMLS_DELTA_COMPACT_AFTER=3`` and
   the server with ``KMLS_DELTA_ENABLED=1`` on a ds2 PVC: the full path
   (the job with deltas off + the server's reload) twice, then four
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
13. the quality loop (``quality/``, the eval phase, ``/readyz``'s staleness
   bound, the delta route over ranks of one host; run last, on phase 4's
   CSV and phase 12 (a)'s PVC; alone: ``python -c "import chip_smoke as c;
   c.phase_quality()"``): (a) the job with ``KMLS_EVAL_ENABLED=1``,
   ``KMLS_EMBED_ENABLED=1``, ``KMLS_COUNT_PATH=bitpack`` and
   ``KMLS_ALS_SPARSE=always``, its kernel launches counted (2 popcount: the
   job's mine and eval's; 34 segsum: embed's and eval's trainings), its
   ``quality.report.json`` in the manifest and held against the same job on
   the CPU (split, rules and popularity equal; the eval's factors within
   1e-4; on one trained model the card's lookups equal their plain versions
   but at counted near-ties within 1e-6; every metric difference between
   the two jobs' reports explained by counted differing answers); (b) a
   second card run and a job killed after ``eval`` then resumed (0
   launches) publish the same sha256; (c) the server with
   ``KMLS_HYBRID_BLEND_WEIGHT=measured`` serves the report's weight and
   answers 2,000 config-5 draws over the embedding vocabulary as the CPU
   engine does, but at counted near-ties and at counted ``overload``
   answers of the admission ladder (each the fallback, its ladder lines
   logged), with no 5xx; (d) with
   ``KMLS_ARTIFACT_MAX_AGE_S`` below the artifacts' age ``/readyz`` is
   degraded naming each and every ``kmls_artifact_stale`` reads 1, and with
   0 every flag reads 0 and ``/readyz`` is ready; (e) two ranks sharing the
   card over gloo on phase 12 (a)'s PVC after one append publish one delta
   bundle from rank 0, whose members equal a one-rank job's, and neither
   enters the full mine. The phase prints its own seconds.
Then phase 7 runs (it needs no work directory), and last:
14. vocab-sharded mining (``parallel/support.py``'s dense sharded counts,
   slab emission and sparse-sharded route, ``parallel/collectives.py``,
   ``mining/als.py``'s sharded sweep; ranks share the card over gloo, or
   take a card each over NCCL; alone: ``python -c "import chip_smoke as c;
   c.phase_sharded()"``): (a) ``kubernetes/job-multihost.yaml``'s knobs
   (``KMLS_MESH_SHAPE=hybrid``, ``KMLS_MODEL_LAYOUT=sharded``,
   ``KMLS_K_MAX_CONSEQUENTS=256``, ``KMLS_EMBED_ENABLED=1``,
   ``KMLS_CKPT_ENABLED=1``) on two ranks of ``python -m
   kmlserver_tpu_torch.mining.job`` over phase 4's CSV: ``sharded-vocab-gspmd``
   and no ``NOTE:`` on either rank, pickles, npz (member by member) and
   their manifest entries equal to a one-card job with the same knobs,
   factors within the reference's layout bar (rtol 2e-4, atol 2e-5) of its
   dense training, a second run's ``embeddings.npz`` byte-equal, a kill
   after ``mine`` resumed to the same bytes; and two ranks of the job with
   no knob set (the replicated layout): ``sharded-dense-gspmd``, no
   ``NOTE:``, no popcount launch, publication equal to phase 4's; (b) in
   process on ``1x2`` and
   ``2x2`` (four ranks) meshes over the ds2 baskets, every schedule
   (``gspmd``, ``allgather``, ``ring``): counts equal to the one-card C and
   to the plain version, emission equal to the one-card emission; on
   ``2x2`` the staged ``sharded-dense-<impl>`` route at
   ``max_itemset_len=3``; ``sparse-sharded`` with
   ``KMLS_SPARSE_LONG_BASKET=64`` (the popcount kernel's long-basket block
   on every rank, tile pair by tile pair, counted); the sparse-sharded
   count of a 16,384-track vocabulary on ``1x2``, ``2x2`` and ``1x4``: each
   rank's slab equal to its rows of the one-card count, its peak device
   memory below one ``(V, V)`` int32 count and, from ``tp`` 2 to 4, falling
   to at most 0.6 of it; (c) phase 5's pruned scale baskets on ``1x2``:
   ``allgather`` and ``ring`` through ``sharded_rule_tensors``, each equal
   to phase 5's one-card emission, each rank's phases, collective bytes
   and peak memory logged, the local product timed with CUDA events
   beside its bound, ``int8_gram_plain`` and ``torch._int_mm`` over the
   whole one-hot, the emission against its plain version; one
   vocab-sharded dense ALS training (time per sweep, peak memory per rank
   below its X block and two chunks of the loss's residual, the same
   factors on both ranks).
   (c) also recounts phase 12 (b)'s delta rows over the ``1x2`` ranks
   (``restricted_pair_counts`` with the mesh, A.8.2): each rank's rows equal
   to phase 12 (b)'s one-card rows, its product timed beside its int8
   bound, its exchange and its peak memory (below the one-card route's)
   logged;
15. model-parallel serving (``ops/serve.py``'s X9 — a slab's partial top-k
   and the cross-slab merge —, the engine's ``sharded`` and ``mesh``
   layouts, ``serving/mesh.py``; alone: ``python -c "import chip_smoke as
   c; c.phase_model_parallel()"``): phase 4's CSV mined by two ranks under
   ``KMLS_MODEL_LAYOUT=sharded`` on ``1x2`` with deltas armed (the
   publication equal to phase 4's), then (a) X9 on the card at every
   (batch, length) bucket of the ds2 rules, with ``k_best`` above V, and on
   synthetic 1M x 256 rule tensors, at 2, 3 and 4 slabs: bit-identical to
   ``recommend_batch`` on the whole tensors and to the CPU run, timed with
   CUDA events beside the replicated lookup and :func:`serve_shard_bound`;
   (b) the ``sharded`` engine (two slabs, both on cuda:0) under 2,000
   config-5 draws equal to the replicated CPU engine's, no unwarmed
   dispatch, ``kmls_model_shards`` and the per-shard series, and the
   ``auto`` layout flipping at the budget; (c) a gang of two ``python -m
   kmlserver_tpu_torch.serving.server`` (the ``KMLS_SERVE_GANG_*``
   quartet, a probed free port pair) and one replicated server under
   config 5's draws at 500 QPS — every answer the CPU engine's or an
   ``overload`` fallback of the admission ladder (counted, its ladder
   lines logged), none shed, client p50/p99 side by side —, rank 1
   SIGKILLed (200 with ``X-KMLS-Degraded:
   mesh-shard-missing:1``, ``/readyz`` naming it), respawned with
   ``mesh.peer`` armed once (a ``mesh-straggler`` answer), the re-form
   timed, fresh answers identical again; (d) one bench-size append: the
   two-rank sharded delta job (the mesh recount on both ranks), its bundle
   equal to a one-card job's member by member, applied into the (b) engine
   and the gang (still sharded) with answers equal to a pristine full
   re-mine's, and the compaction equal to that re-mine; (e), run before
   (d) on the same publication: the collective gang — two members started
   by :func:`run_ranks` (``--gang-worker``), each a ``RecommendEngine(...,
   gang_transport="collective")`` on cuda:0 in one torch.distributed world
   over gloo (they share the card), answering 1,000 of config 5's draws
   each from two threads, every answer the CPU engine's with no unwarmed
   dispatch; rank 1 then SIGKILLs itself while rank 0 keeps submitting,
   and rank 0 must exit 76 within the heartbeat bound plus 5 s; the round's
   split (header, seeds, partials, all-gather, the merge), a batch's
   latency, bytes a round and an idle member's CPU share are logged.
16. the serving fleet (``freshness/ring.py``'s ``FleetRouter``,
   ``serving/forecast.py``, the app's owner stamping and gang 503,
   ``serving/replay.py``'s fleet client; alone: ``python -c "import
   chip_smoke as c; c.phase_fleet()"``, which mines its own ds2 PVC from
   seed 123 with deltas armed): (a) ``bench.py``'s fleet bracket at its
   defaults — three ``python -m kmlserver_tpu_torch.serving.server`` on the
   card as ``kubernetes/statefulset.yaml``'s ``replica-0..2`` (LRU 512),
   42,000 Zipf 0.9 requests a leg at 10,500 QPS offered, round robin then
   ring-routed with an append + delta job at 30 % and replica-2 SIGKILLed
   at 60 %: zero 5xx and errors, the survivors' delta applied with
   selective invalidations and their probe answers equal to each other and
   to the CPU engine's post-delta ones, the routed window hit ratio above
   the independent one beside ``simulate_fleet``'s prediction, the dead
   context's card memory freed; X1 timed per bucket with the replicas idle
   and under leg A's load; (b) the slow-peer bracket: a two-replica fleet
   whose replica-1 stalls 200 ms on every request (``fleet.peer``),
   control and hedged legs of 300 at 32 QPS (the bracket's 600, cut for
   the time limit; hedged p99 below the
   control's, a slow ejection, every answer the CPU engine's), the
   two-member gang as the one ring peer under a finite ``mesh.peer`` stall,
   then rank 1 SIGKILLed: 503 + ``X-KMLS-Mesh-Unavailable: 1``, spilled by
   the client; (c) the predictive bracket in process: ramp, sine and
   constant at 1,000 QPS, the answer cache off so the forecaster sees the
   traffic, forecaster off then on at equal capacity
   (observations only when on, the led utilization never below the
   reactive, a pre-touch on the ramp, no 5xx), and a delta applied with
   the forecaster armed re-warming its hot seed sets, each equal to the
   CPU engine's post-delta answer. No server outlives the phase.
17. the host-native routes and the measured dispatch (``utils/nativelib.py``,
   ``data/native.py``, ``ops/cpu_popcount.py``, ``serving/native_serve.py``,
   ``mining/sweep.py``; alone: ``python -c "import chip_smoke as c;
   c.phase_native()"``): (a) the three native libraries built from
   ``kmlserver_tpu_torch/native/`` with ``g++`` beside the ``nvcc`` builds
   (seconds, digest, the compiler's version line) and loaded from
   ``build/kmls_torch_native/``, and the host CPU's model; (b) the ds2 job
   on the card, which must read its CSV through the native reader, and the
   native reader beside the stdlib parser on the same file (equal tables);
   (c) the ds2 job on the CPU: ``native-cpu``, no ``NOTE:`` line, the card
   job's publication; (d) config 5's 8,000 draws through a CPU engine's
   native lookup, every answer X1's on the card; (e) ``python -m
   kmlserver_tpu_torch.mining.sweep`` over the reference grid (68 points)
   on the card and on the CPU, the CSVs equal but for the durations; (f)
   the density sweep over the reference grid, best of 5, banked into a
   temporary table: every point identical, a ``gpu`` backend measured on
   the card, the ``cpu`` cells untouched, and the cells whose winner
   differs from the packaged table's logged.
18. BASELINE config 4 born on the card (``data/device_synthetic.py``,
   ``ops/threefry.py``, ``ops/bernoulli.py`` + ``csrc/bernoulli_bits.cu``,
   ``mining/config4.py``; alone: ``python -c "import chip_smoke as c;
   c.phase_config4()"``): (a) the generator kernel against its plain
   version, exact, at a ragged P, row blocks 8, 32 and 64, rows with q 0
   and q 1, a slab past word 0, seeds with bit 31 set and a flat counter
   past 2^32, rows at the integer threshold's edges (q at k * 2^-23 and one
   ulp around it, a subnormal q, q on one of the row's own draws) and the
   real playlists ending inside the word of every lane of a tile, each
   launch counted; (b) ``python -m
   kmlserver_tpu_torch.mining.config4 --device-gen`` at the full shape
   (10M playlists x 1M tracks x 500M rows, ``min_support`` 5e-4, seed 7)
   in a subprocess: one generator launch and two popcount launches (cold
   and warm) in its JSON; then the same bitset drawn here, 16 rows of it
   (the first, the last candidate, a pad row, random ones) equal to the
   plain generator's, the popcount kernel's (7,936, 7,936) counts equal to
   the plain count, every candidate's diagonal within 8 sigma of P·q, 256
   tracks past the candidate cut drawn and none frequent, the emission's
   frequent items, rules and measured rows equal to the runner's; the
   generator and the count timed by CUDA events beside their bounds;
   (c) two ranks sharing the card over gloo run the runner's ``main`` with
   ``--mesh auto`` at phase 5's 1M x 1M x 50M shape: each rank's slab equal
   to the plain sharded generator's (its time beside the kernel's on that
   slab), the all-reduced counts equal to one launch on the gathered slabs.
19. the dispatch held sync-free (``serving/engine.py::recommend_many_async``
   and what it enqueues: ``ops/serve.py``, ``ops/embed.py``; run last, on
   phase 4's ds2 PVC and phase 11's embedding PVC; alone: ``python -c
   "import chip_smoke as c; c.phase_sync_guard()"``): three engines on the
   card with no reload poller and no batcher — the replicated rules
   engine, the blend engine (rules + ALS embeddings) and the ``sharded``
   layout at S = 2 on cuda:0 — each dispatch one batch per warmed (batch,
   length) bucket under ``torch.cuda.set_sync_debug_mode("error")``, which
   raises on any host synchronization, around the dispatch half only
   (``recommend_many_async`` up to its return); then the mode back to
   ``default`` and every ``finish()``; the answers equal the same engine's
   unguarded ones and the CPU engine's (blend: but at counted near-ties);
   no unwarmed dispatch; one ``sync_guard:`` line.
20. config 4's embed phase at its full shape (10M playlists x 1M tracks x
   500M rows, ``min_support`` 5e-4; ``data/device_synthetic.py``,
   ``ops/events.py`` + ``csrc/events.cu``, ``ops/segsum.py``,
   ``mining/als.py``; alone: ``python -c "import chip_smoke as c;
   c.phase_embed_config4()"``): (a) ``device_synthetic_events`` with its
   launches counted around it (a count and a write pass a source); (b) the
   same bitset drawn again: each source's passes timed by CUDA events
   beside a bound from the call's inputs, the whole head's list equal to
   ``bitset_events_plain``'s in chunks of rows and the whole tail's to
   ``tail_events_plain``'s (on the card), bit for bit; (c) ``segment_sum``
   over the two CSRs of that list, each side timed beside
   ``segsum_bound``, chosen rows (the longest of each side, the 10M-event
   tracks among them) equal to the in-order float32 sums bit for bit; (d)
   ``train_embeddings`` over the list: sparse storage, 17 segsum launches.
Then the kernels line is printed (the sharded entry carries the sharded
routes' calls and times under ``x8``, and X9's under ``x9``: library
calls, not kernel launches; the popcount entry its config-4 time under
``config4``).

Not part of the run: :func:`probe_segsum_ring` builds ``segsum.cu`` with
its adds, its copies or both taken out and times one long row with each
(where a long row's time goes).

``--quick`` runs the same phases with the scale shape cut to 100k x 100k x
5M rows and phase 18's config 4 to 1M x 1M x 50M (a shorter check; prints
``reduced`` lines). The script starts
itself with ``--rank-worker`` for the ranks of phases 6 and 14. Phase 12
(b) leaves its recount rows in the work directory for phase 14 (c).

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
KERNEL_SOURCES = ("popcount", "segsum", "bernoulli_bits", "events", "normals")

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


PTXAS_KERNELS = ("popcount_pairs_tc_kernel", "popcount_pairs_swar_kernel", "segsum_kernel",
                 "bernoulli_bits_kernel")


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


def run_ranks(argvs: list[list[str]], envs: list[dict], timeout_s: float, label: str,
              want_exit: int | list[int] = 0, exit_times: dict | None = None) -> list[str]:
    """Start one process per rank and wait for all of them. A rank that
    exits with another code than ``want_exit`` (one for all, or one a
    rank), or a group that outlives ``timeout_s``, kills the group and
    fails the smoke. ``exit_times`` gets each rank's ``time.time()`` when
    its exit was seen (polled every 0.2 s). → each rank's output."""
    wants = want_exit if isinstance(want_exit, list) else [want_exit] * len(argvs)
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
            if exit_times is not None:
                for i, c in enumerate(codes):
                    if c is not None:
                        exit_times.setdefault(i, time.time())
            bad = [i for i, c in enumerate(codes) if c not in (None, wants[i])]
            if bad:
                i = bad[0]
                fail(f"{label}: rank {i} exited {codes[i]}:\n" + "\n".join(outs[i][-60:]))
            if codes == wants:
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


def rank_envs(port: int, world: int = RANKS, **extra: str) -> list[dict]:
    return [
        subproc_env(KMLS_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                    KMLS_NUM_PROCESSES=str(world), KMLS_PROCESS_ID=str(r), **extra)
        for r in range(world)
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


SPAWNED: list[subprocess.Popen] = []  # every server started, for stop_spawned


def spawn_server(pvc: str, **extra: str) -> tuple[subprocess.Popen, list[str], list[int],
                                                   threading.Event]:
    """Start ``python -m kmlserver_tpu_torch.serving.server`` on the card
    over ``pvc`` → (process, its log lines so far and to come, [its port]
    once logged, the event set then)."""
    server = subprocess.Popen(
        [sys.executable, "-m", "kmlserver_tpu_torch.serving.server"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=subproc_env(BASE_DIR=pvc, KMLS_PORT="0", **extra),
    )
    SPAWNED.append(server)
    lines: list[str] = []
    port: list[int] = []
    bound = threading.Event()

    def pump() -> None:
        for line in server.stdout:
            lines.append(line.rstrip())
            if "serving on" in line and not port:
                port.append(int(line.split("serving on", 1)[1].split()[0].rsplit(":", 1)[1]))
                bound.set()

    threading.Thread(target=pump, daemon=True).start()
    return server, lines, port, bound


def await_server(spawned) -> tuple[subprocess.Popen, str, list[str]]:
    """Wait for a :func:`spawn_server` process until ``/readyz`` answers
    200 → (process, base URL, log lines)."""
    server, lines, port, bound = spawned
    if not bound.wait(120):
        stop_server(server)
        fail("server never logged its port:\n" + "\n".join(lines[-40:]))
    base = f"http://127.0.0.1:{port[0]}"
    try:
        wait_ready(base, server, 120)
    except SystemExit:
        stop_server(server)
        raise
    return server, base, lines


def start_server(pvc: str, **extra: str) -> tuple[subprocess.Popen, str, list[str]]:
    """``python -m kmlserver_tpu_torch.serving.server`` on the card over
    ``pvc``, waited on until ``/readyz`` answers 200 → (process, base URL,
    its log lines so far and to come)."""
    return await_server(spawn_server(pvc, **extra))


def stop_server(server: subprocess.Popen) -> int:
    """SIGTERM (the drain), then wait; → the exit code (killed after 20 s)."""
    server.terminate()
    try:
        return server.wait(timeout=20)
    except subprocess.TimeoutExpired:
        server.kill()
        server.wait()
        return -9


def stop_spawned() -> None:
    """Stop every server :func:`spawn_server` started that still runs: a
    failed check leaves none behind."""
    while SPAWNED:
        server = SPAWNED.pop()
        if server.poll() is None:
            stop_server(server)


def job_process(pvc: str, label: str, started: threading.Event | None = None,
                **extra: str) -> tuple[str, float]:
    """``python -m kmlserver_tpu_torch.mining.job`` on the card over
    ``pvc``; echoes its log and fails on a non-zero exit; sets ``started``
    when the job logs ``Job starting at`` (its process start-up done).
    → (stdout, wall s)."""
    t0 = time.perf_counter()
    if started is not None:
        extra = {"PYTHONUNBUFFERED": "1", **extra}  # each line as it is logged
    job = subprocess.Popen(
        [sys.executable, "-m", "kmlserver_tpu_torch.mining.job"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=subproc_env(BASE_DIR=pvc, DATASETS_DIR=os.path.join(pvc, "datasets"), **extra),
    )
    err: list[str] = []
    drain = threading.Thread(target=lambda: err.append(job.stderr.read()), daemon=True)
    drain.start()
    lines = []
    for line in job.stdout:
        lines.append(line)
        if started is not None and line.startswith("Job starting at"):
            started.set()
    try:
        job.wait(timeout=600)
    except subprocess.TimeoutExpired:
        job.kill()
        job.wait()
    drain.join(10)
    wall = time.perf_counter() - t0
    out = "".join(lines)
    for line in out.splitlines():
        log(f"  job {label} | {line}")
    if job.returncode != 0:
        log("".join(err)[-4000:])
        fail(f"mining job ({label}) exited {job.returncode}")
    return out, wall


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
    baskets = synthetic_baskets(**shape, seed=seed, device="cuda")
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
    # the cost model's support_count counts the one triangle of the mined
    # (unpadded) shape; the bound above counts it at the padded shape
    from kmlserver_tpu_torch.observability.costmodel import INT8_PEAK_TABLE, phase_cost

    support_flops, _ = phase_cost("support_count", p=mined_p, v=mined_v)
    int8_peak = dict(INT8_PEAK_TABLE)["h100"]
    log(f"yardstick: support_count (one triangle) at (p={mined_p}, v={mined_v}) = "
        f"{support_flops:.6g}, the kernel's padded triangle {bound['int8_ops']:.6g} int8 ops, "
        f"ratio {support_flops / bound['int8_ops']:.4f}; over the kernel's {kernel_ms:.3f} ms: "
        f"{support_flops / (kernel_ms / 1e3):.6g} op/s = "
        f"{support_flops / (kernel_ms / 1e3) / int8_peak:.4f} of the int8 peak "
        f"{int8_peak:.4g} (kmls_mfu, unclamped)")
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
                  DATASETS_DIR=os.path.join(ranks_pvc, "datasets"), KMLS_COUNT_PATH="bitpack"),
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
    """One rank of phase 6, 14 or 18, started with the env triple; prints
    ``RANK_RESULT <json>``."""
    sys.path.insert(0, ROOT)
    from kmlserver_tpu_torch.parallel import distributed

    distributed.maybe_initialize(device="cuda", timeout_s=600)
    mesh = distributed.resolve_mesh("auto", distributed=True).flattened()
    out = {"rank": distributed.runtime().rank, "backend": distributed.runtime().backend}
    workers = {"slabs": worker_slabs, "scale": worker_scale,
               "sharded": worker_sharded, "sharded_scale": worker_sharded_scale,
               "config4": worker_config4}
    out.update(workers[task](mesh, work))
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
    from kmlserver_tpu_torch.parallel import collectives, support
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
        total = collectives.all_reduce_sum_(part.clone(), mesh.axis("dp"))
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
    from kmlserver_tpu_torch.parallel import collectives, distributed, support

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
    collectives.all_reduce_sum_(counts, mesh.axis("dp"))  # warm
    torch.cuda.synchronize()
    distributed.barrier()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        collectives.all_reduce_sum_(counts, mesh.axis("dp"))
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
    # MIN_SUPPORT 0.005 keeps all 2,171 tracks (density 4.9 %, cell d3:e1):
    # a cell the density sweep measured, so the plan reads the packaged
    # table's gpu cell ("table": the route that cell names)
    ("auto_measured", {"MIN_SUPPORT": "0.005"}, "table", None),
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
    from kmlserver_tpu_torch.mining import dispatch
    from kmlserver_tpu_torch.mining.miner import bitpack_wanted, mine, prune_infrequent
    from kmlserver_tpu_torch.ops import popcount as pc
    from kmlserver_tpu_torch.ops.support import min_count_for

    baskets = synthetic_baskets(**DS2_SHAPE, seed=7)
    support_tensors = {}
    cases = {}
    gpu_cells = (dispatch.load_table() or {}).get("backends", {}).get("gpu", {}).get("cells", {})
    for name, knobs, route, census in ROUTE_CASES:
        cfg = config_from_knobs(knobs)
        if route == "table":
            # the plan the miner makes, on the pruned baskets
            mined, _ = prune_infrequent(baskets, min_count_for(cfg.min_support,
                                                               baskets.n_playlists))
            plan = dispatch.plan_count_path(
                cfg, mined.n_playlists, mined.n_tracks, len(mined.playlist_rows),
                backend="gpu", baskets=mined)
            if plan.cell not in gpu_cells:
                fail(f"phase 7 {name}: cell {plan.cell} has no measured gpu cell")
            route = ROUTE_NAMES[plan.path]
            if plan.path == "bitpack" and not bitpack_wanted(
                    mined.n_playlists, mined.n_tracks, "auto",
                    hbm_budget_bytes=cfg.hbm_budget_bytes, n_rows=len(mined.playlist_rows)):
                # the reference's miner: on one device the staged count
                # re-derives bitpack from the threshold, which keeps dense
                # where the one-hot fits (kmlserver_tpu/mining/miner.py:593-600,
                # :835-837)
                route = "dense"
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
        if name == "auto_measured" and card.count_path_source != "table":
            fail(f"phase 7 {name}: the plan's source is {card.count_path_source}, not the table")
        if not same_tensors(card.tensors, cpu.tensors):
            fail(f"phase 7 {name}: rule tensors on the card != the CPU run's ({cpu.count_path})")
        if card.itemset_census != cpu.itemset_census or (census and card.itemset_census != census):
            fail(f"phase 7 {name}: census {card.itemset_census} (CPU {cpu.itemset_census}, "
                 f"want {census})")
        if card.triple_merge_applied != cpu.triple_merge_applied:
            fail(f"phase 7 {name}: merge applied {card.triple_merge_applied} on the card, "
                 f"{cpu.triple_merge_applied} on the CPU")
        if cfg.confidence_mode == "support":
            first = support_tensors.setdefault(cfg.min_support, card.tensors)
            if not same_tensors(card.tensors, first):
                fail(f"phase 7 {name}: support-mode tensors differ from the first route's "
                     f"at min_support {cfg.min_support}")
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
# 3 before the collective gang's phase 15 (e): runs 2 and 3 are all cache
# hits, and the smoke's time limit pays for (e) with one of them
CONFIG5_RUNS = 2
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


def degraded_reason(head: bytes) -> str | None:
    """The ``X-KMLS-Degraded`` reason of a raw response head, or None."""
    for ln in head.split(b"\r\n"):
        if ln.lower().startswith(b"x-kmls-degraded:"):
            return ln.split(b":", 1)[1].strip().decode()
    return None


def hold_to_fallback(label: str, cpu, payload: list, songs) -> None:
    """A degraded answer must be the popularity fallback: the seeds' static
    recommendation or, past a deadline, the head of the best tracks."""
    head_k = [b["track_name"] for b in cpu.best_tracks][: cpu.cfg.k_best_tracks]
    if songs not in (cpu.static_recommendation(payload), head_k):
        fail(f"{label}: degraded answer for {payload} is not the fallback")


def overload_only(label: str, responses: list, lines: list[str]) -> int:
    """Phases 11 (b), 13 (c), 15 (c) serve with the production admission
    ladder: an answer may be degraded only by it (``overload``), and each
    such run logs the server's ``admission ladder`` lines — the projected
    wait and its device-time parts, the queue-wait EWMA and the loop lag
    that drove it. → the overload answers (held to the fallback by the
    caller)."""
    reasons = [degraded_reason(r[2]) for r in responses]
    other = sorted({r for r in reasons if r not in (None, "overload")})
    if other:
        fail(f"{label}: answers degraded for {other}, not by the admission ladder")
    n = reasons.count("overload")
    if n:
        ladder = [ln for ln in lines if "admission ladder" in ln]
        log(f"{label}: {n} answers degraded by the admission ladder, each the popularity "
            f"fallback; the server's ladder lines ({len(ladder)}):")
        for ln in ladder or ["(none logged)"]:
            log("  " + ln)
    return n


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
    for i, status, head, body in responses:
        if status >= 500:
            fail(f"{label}: HTTP {status} for {payloads[i]}: {body[:200]!r}")
        if status == 429:
            counts["shed"] += 1
            continue
        got = json.loads(body)
        if status == 200 and b"x-kmls-degraded:" in head:
            counts["degraded"] += 1
            hold_to_fallback(label, cpu, payloads[i], got["songs"])
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
               allow_drops: bool = False, phase: str = "phase 8",
               ladder_lines: list[str] | None = None) -> dict:
    """One replay through the port's load generator, every answer checked,
    then the server's window read (reset just before it). With the
    server's ``ladder_lines`` a degraded answer must be the admission
    ladder's (:func:`overload_only`)."""
    from kmlserver_tpu_torch.serving.replay import replay_async_http

    status, _, _ = post(base + "/metrics/reset", b"")
    if status != 200:
        fail(f"{label}: /metrics/reset answered {status}")
    before = server_window(base)
    responses: list = []
    report = replay_async_http(base, payloads, qps=qps, n_conns=CONFIG5_CONNS,
                               responses=responses)
    counts = check_responses(label, responses, payloads, want, cpu, allow_drops)
    if ladder_lines is not None:
        overload_only(f"{phase} {label}", responses, ladder_lines)
    window = server_window(base)
    for key in ("shed_total", "degraded_total", "batches_total"):  # counters: this run's
        window[key] -= before[key]
    row = {"label": label, "qps": qps, "requests": len(payloads),
           "achieved_qps": report.achieved_qps, "p50_ms": report.p50_ms,
           "p95_ms": report.p95_ms, "p99_ms": report.p99_ms, "errors": report.n_errors,
           "client_cache_hit_ratio": report.cache_hit_ratio,
           "uncached_p50_ms": report.uncached_p50_ms, "cached_p50_ms": report.cached_p50_ms,
           **counts, **window}
    log(f"{phase} {label}: {len(payloads)} requests at {qps:.0f} QPS → achieved "
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


def serve_bucket_times(card, label: str = "phase 8", reps: int = 50, walls_n: int = 20,
                       loaded=None) -> list[dict]:
    """``recommend_batch`` at every (batch, length) bucket on the ds2 rule
    tensors, by CUDA events (``reps`` launches), each beside its bound: the
    bytes it must move (the seeds, the rule rows of the distinct seeds, the
    top-k out) over the memory rate. Also the host wall time of one whole
    dispatch → finish (staging, launches, copy back, event wait; median of
    ``walls_n``). ``loaded()``, when given, is read after each bucket and
    kept as its ``loaded`` flag."""
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
            ms = cuda_ms(fn, reps)
            staged = card._staging((batch, length), bundle.device)
            staged.copy_(seeds_host.to(torch.int32))
            walls = []
            for _ in range(walls_n):
                t0 = time.perf_counter()
                card._launch(bundle, staged)()
                walls.append(1e3 * (time.perf_counter() - t0))
            uniq = int(torch.unique(seeds).numel())
            nbytes = 4 * batch * length + 8 * uniq * k_max + 8 * batch * k_best
            rows.append({"batch": batch, "length": length, "ms": ms,
                         "dispatch_ms": sorted(walls)[len(walls) // 2],
                         "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
                         "bytes": nbytes})
            if loaded is not None:
                rows[-1]["loaded"] = loaded()
    log(f"{label} serve lookup per bucket (recommend_batch, CUDA events; bound = "
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
                    log(f"reduced: phase 8 replays config 5 {CONFIG5_RUNS} times, not 3 (the "
                        "later runs are cache hits): the smoke's time limit pays for phase 15 (e)")
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
            want_launches = 2 * emb_cfg.als_iters + 1  # X F, Xᵀ U a sweep; the loss's X F
            if "embeddings.npz" not in emb_bytes or emb_base_launches != want_launches:
                fail(f"phase 9 (e) baseline: {emb_base_launches} segsum launches (want "
                     f"{want_launches}), published {sorted(emb_bytes)}")
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
                f"{emb_wall:.3f} s with {emb_base_launches} segsum launches (2 x "
                f"{emb_cfg.als_iters} sweeps' + the loss's); killed after "
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

TRACED_REQUESTS = 1000  # distinct config-5 seed sets replayed with tracing on (2,000 before 15 (e))
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
    log(f"reduced: phase 10 (a) traces {TRACED_REQUESTS} distinct draws, not 2,000: the smoke's "
        "time limit pays for phase 15 (e)")
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
    from kmlserver_tpu_torch.observability.costmodel import INT8_PEAK_TABLE, phase_cost
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
    # the yardstick A.10 needs: support_count's one triangle of the mined
    # shape against the one triangle of int8 operations the kernel's bound
    # counts at the padded shape
    bound = popcount_bound(v_pad, w_pad)
    kernel_flops, _ = phase_cost("support_count", p=mined.n_playlists, v=mined.n_tracks)
    int8_peak = dict(INT8_PEAK_TABLE)["h100"]
    log(f"phase 10 (d): job with KMLS_COUNT_PATH=bitpack, KMLS_PROFILE_DIR set: {wall:.3f} s "
        f"wall; job_metrics.prom phases " + ", ".join(f"{k} {v:.4f} s" for k, v in
                                                     sorted(phase_s.items()))
        + f", count path bitpack-cuda ({paths[0].split('source=')[1][1:-2]}), mine flops "
        f"{flops:.6g} == phase_cost('support_count', p={p}, v={v_all}); profiler CUDA time of "
        f"the job's popcount launch {job_ms:.4f} ms vs CUDA events {event_ms:.4f} ms in "
        f"process at ({v_pad}, {w_pad}) ({100 * (job_ms / event_ms - 1):+.1f} %)")
    log(f"phase 10 (d) yardstick at the ds2 mine shape (p={mined.n_playlists}, "
        f"v={mined.n_tracks}): support_count (one triangle) = {kernel_flops:.6g}, the "
        f"kernel's triangle {bound['int8_ops']:.6g} int8 ops at ({v_pad}, {w_pad}), ratio "
        f"{kernel_flops / bound['int8_ops']:.4f}; over {event_ms:.4f} ms: "
        f"{kernel_flops / (event_ms / 1e3):.6g} op/s = "
        f"{kernel_flops / (event_ms / 1e3) / int8_peak:.4f} of the int8 peak; job_metrics "
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
EMBED_TOPK_SHAPES = ((8, 128), (32, 128))  # (batch, seed slots) buckets of the main path
# valid seeds a row of a timed embed_topk batch: the serving cell's mean
# request (31.2 seeds, 10 % unknown), the rest of the 128 slots padding
EMBED_VALID_PER_ROW = 28
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
    ids, sims = embed_topk(bundle.emb_factors,
                           torch.tensor([emb], dtype=torch.int32, device=bundle.emb_factors.device),
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
    factors = torch.as_tensor(published["item_factors"], device="cuda")
    topk_ms = {f"{b}x{length}": time_embed_topk(factors, b, length, scfg.k_best_tracks, 50,
                                                f"phase 11 (b) embed_topk {b}x{length}")
               for b, length in EMBED_TOPK_SHAPES}
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
    degraded = overload_only("phase 11 (b)", responses, lines)
    near_ties, by_source = 0, {}
    for i, status, head, body in responses:
        if status != 200:
            fail(f"phase 11 (b): HTTP {status} for {payloads[i]}: {head[:200]!r} {body[:200]!r}")
        songs, source = want[i]
        by_source[source] = by_source.get(source, 0) + 1
        if b"x-kmls-degraded:" in head:
            hold_to_fallback("phase 11 (b)", cpu, payloads[i], json.loads(body)["songs"])
            continue
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
        f"CPU engine's but {degraded} degraded (the fallback) and {near_ties} decided by a near-tie (|Δ| <= {NEAR_TIE}); embed_topk "
        f"{emb_dispatches:.0f} dispatches, {emb_device_s:.6f} device s; embed_topk at V={v} "
        + ", ".join(f"B x L {k_} {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, bound "
                    f"{t['ms_bound']:.6f}, {t['bound_by']})" for k_, t in topk_ms.items()))
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


def embed_topk_bound(valid: int, b: int, length: int, v: int, rank: int, k: int) -> dict:
    """The least time of one ``embed_topk`` on this card: the factor matrix
    and the seeds read once, the top-k ids and sims written once, over the
    HBM rate; and the valid seeds' V·R multiply-adds each (two operations
    each; padding slots need none) over the fp32 peak (the products run
    outside the tensor cores: TF32 is off). The count of
    ``kmls_bench/roofline/embed_topk.py``."""
    nbytes = 4 * v * rank + 4 * b * length + 8 * b * k
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * 2 * valid * v * rank / FP32_PEAK_OPS
    return {"ms_bound": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def serving_seeds(b: int, length: int, v: int, seed: int):
    """A ``(b, length)`` int32 host seed batch as the serving cell stages
    it: :data:`EMBED_VALID_PER_ROW` ids a row (at most ``length``), then
    ``-1`` padding."""
    import torch

    seeds = torch.full((b, length), -1, dtype=torch.int32)
    n = min(EMBED_VALID_PER_ROW, length)
    seeds[:, :n] = torch.randint(0, v, (b, n), dtype=torch.int32,
                                 generator=torch.Generator().manual_seed(seed))
    return seeds


def time_embed_topk(factors, b: int, length: int, k: int, reps: int, label: str) -> dict:
    """``embed_topk`` (the kernel) against ``embed_topk_plain`` on the same
    card at ``(b, length)`` over ``factors``: both timed by CUDA events;
    the similarities within ``SIM_TOL`` and the ids equal but at a near-tie
    of the plain version's top k + 1, else :func:`fail`."""
    import torch

    from kmlserver_tpu_torch.ops.embed import SIM_TOL, embed_topk, embed_topk_plain

    v, rank = factors.shape
    seeds_h = serving_seeds(b, length, v, b * 1000 + length)
    seeds = seeds_h.cuda()
    ids, sims = embed_topk(factors, seeds, k_best=k)
    p_ids, p_sims = embed_topk_plain(factors, seeds, k_best=k)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: embed_topk(factors, seeds, k_best=k), reps)
    plain_ms = cuda_ms(lambda: embed_topk_plain(factors, seeds, k_best=k), max(reps // 10, 3))
    d_sims = float((sims - p_sims).abs().max())
    if d_sims > SIM_TOL:
        fail(f"{label}: sims max |Δ| {d_sims} > {SIM_TOL}")
    ties = 0
    for r in range(b):
        if torch.equal(ids[r], p_ids[r]):
            continue
        _, wide = embed_topk_plain(factors, seeds[r:r + 1], k_best=k + 1)
        s = wide[0].tolist()
        if not any(x - y <= NEAR_TIE for x, y in zip(s, s[1:])):
            fail(f"{label}: row {r} ids differ from the plain version's, no near-tie")
        ties += 1
    valid = int((seeds_h >= 0).sum())
    return {"ms": ms, "plain_ms": plain_ms, "valid_seeds": valid, "sims_max_abs": d_sims,
            "near_ties": ties, **embed_topk_bound(valid, b, length, v, rank, k)}


def probe_embed_topk(v: int = 1 << 20, rank: int = 32, reps: int = 200) -> dict:
    """The X5 row alone (~1 min): builds ``embed_topk.cu`` (its ptxas
    report logged), then times the kernel against the plain version at
    :data:`EMBED_TOPK_SHAPES` over ``v`` unit factors and over ds2's
    2,171: ``python -c "import chip_smoke as c; c.probe_embed_topk()"``."""
    import torch

    from kmlserver_tpu_torch.ops import cuda_build
    from kmlserver_tpu_torch.ops.embed import kernel_plan

    out = {"device": torch.cuda.get_device_name(0),
           "power_limit": nvidia_smi_query("power.limit"), "plan": kernel_plan(v, rank)}
    log(f"probe embed_topk: {out['device']}, power limit {out['power_limit']}, plan "
        f"{out['plan']}; ptxas: {cuda_build.BUILD_LOG['embed_topk']['ptxas'].strip()}")
    g = torch.Generator(device="cuda").manual_seed(rank)
    for n in (v, 2171):
        factors = torch.randn((n, rank), generator=g, device="cuda")
        factors /= factors.norm(dim=1, keepdim=True)
        for b, length in EMBED_TOPK_SHAPES:
            t = time_embed_topk(factors, b, length, 10, reps, f"probe embed_topk {b}x{length}")
            out[f"v{n}_{b}x{length}"] = t
            log(f"probe embed_topk V={n} B x L = {b} x {length} ({t['valid_seeds']} valid "
                f"seeds): {t['ms']:.4f} ms (bound {t['ms_bound']:.4f} ms, {t['bound_by']}: "
                f"{100 * t['ms_bound'] / t['ms']:.1f} %), plain {t['plain_ms']:.4f} ms; sims "
                f"max |Δ| {t['sims_max_abs']:.3g}, {t['near_ties']} rows at a near-tie")
    log("PROBE_EMBED " + json.dumps(out))
    return out


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
    stage_names = ("build_csr", "_sparse_als_sweep", "_sparse_als_loss_rows",
                   "normalize_factors")
    t0 = time.perf_counter()
    with StageTimes(als, stage_names) as stages:
        second = als.train_embeddings(baskets, cfg, device="cuda")
    stages_wall = time.perf_counter() - t0
    if first["storage"] != "sparse" or launches != 2 * cfg.als_iters + 1:
        fail(f"phase 11 (c): storage {first['storage']}, {launches} segsum launches, want "
             f"sparse and {2 * cfg.als_iters + 1}")
    if not np.array_equal(first["item_factors"], second["item_factors"]) or (
            first["final_loss"] != second["final_loss"]):
        fail("phase 11 (c): two sparse trainings on the card gave different factors")
    if not np.isfinite(first["item_factors"]).all():
        fail("phase 11 (c): non-finite factors")
    log(f"phase 11 (c) sparse ALS at {p} x {v}, {nnz} memberships, R={rank}, "
        f"{cfg.als_iters} iters: auto picked {first['storage']} (dense ~{dense_b:.4g} B, "
        f"sparse ~{sparse_b:.4g} B against hbm_budget_bytes {cfg.hbm_budget_bytes}); "
        f"{train_s:.3f} s ({launches} segsum launches: 2 a sweep, 1 the loss's), CSR + CSC "
        f"build {csr_s:.3f} s (their "
        f"schedules' sorts {order_s:.4f} s of it); the "
        f"second training bit-identical (loss {first['final_loss']:.6f}); peak device memory "
        f"{peak} B ({peak / 2**30:.3f} GiB); the second's stages (synchronized, "
        f"{stages_wall:.3f} s): "
        + ", ".join(f"{n} {stages.seconds[n]:.3f} s x{stages.calls[n]}" for n in stage_names)
        + f", the rest (host init, uploads, solves' setup, copy back) "
        f"{stages_wall - sum(stages.seconds.values()):.3f} s")

    # ---- embed_topk at V = 1M, the kernel against the plain version
    factors = torch.as_tensor(first["item_factors"], device="cuda")
    topk = {}
    for b, length in EMBED_TOPK_SHAPES:
        t = time_embed_topk(factors, b, length, 10, 20, f"phase 11 (c) embed_topk {b}x{length}")
        topk[f"{b}x{length}"] = t
        log(f"phase 11 (c) embed_topk B x L = {b} x {length} ({t['valid_seeds']} valid seeds) "
            f"at V={v}: {t['ms']:.4f} ms on the card (bound {t['ms_bound']:.4f} ms, "
            f"{t['bound_by']}), plain {t['plain_ms']:.4f} ms; sims max |Δ| "
            f"{t['sims_max_abs']:.3g}, {t['near_ties']} rows at a near-tie")
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
            baskets = synthetic_baskets(**shape, seed=2024, device="cuda")
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
# the full path's repetitions (job + reload), timed for their median
FRESH_FULL_RUNS = 2
FRESH_HIT_DRAWS = 2000  # Zipf draws replayed around cycle 2's apply (the hit ratio)
FRESH_METRICS_EVERY_S = 0.02  # /metrics scrape period while waiting for an apply
RECOUNT_PLAYLISTS = 1000  # phase 12 (b): the playlists a 0.1 % append adds
RECOUNT_PLAIN_CHUNK = 32768  # playlists per float64 chunk of int8_gram_plain on the card


def track_row(pid: int, t: int) -> str:
    """One CSV row of the synthetic tables' format for track ``t``."""
    return (f"{pid},Track {t:07d},spotify:track:{t:07d},"
            f"Artist {t % 997:04d},spotify:artist:{t % 997:04d},Album {t // 12:06d}")


def append_rows(csv_path: str, lines: list[str]) -> int:
    with open(csv_path, "a") as fh:
        fh.write("\n".join(lines) + "\n")
    return len(lines)


def append_bench_rows(csv_path: str, rng, first_pid: int, lo: int,
                      new_track: int | None) -> int:
    """The reference bench's append (``bench.py:1580-1615``): 24 new
    playlists × 90 rows drawn over the 128 tracks from ``lo``, plus one
    brand-new track unless ``new_track`` is None (the fleet bracket's,
    ``bench.py:2088-2103``) → rows appended."""
    lines = [track_row(first_pid + p, int(t))
             for p in range(24) for t in lo + rng.integers(0, 128, size=90)]
    if new_track is not None:
        lines.append(f"{first_pid},Track {new_track:07d},spotify:track:{new_track:07d},"
                     f"Artist 0000,spotify:artist:0000,Album 000000")
    return append_rows(csv_path, lines)


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
            hold_to_fallback(f"phase 12 (a) {label}", cpu, payloads[i], got["songs"])
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
    the full path twice, then four append → job → applied cycles
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
        # ---- the full path: the job with deltas off + the server's reload
        full_runs, full_in_process = [], []
        for i in range(FRESH_FULL_RUNS):
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

            def publish(cycle=cycle, m0=m0, run=run, compacts=compacts,
                        started: threading.Event | None = None) -> None:
                """Append, run the job, wait until the server serves it;
                a failure is kept for the caller (this may run on a
                thread)."""
                try:
                    t1 = time.perf_counter()
                    append_bench_rows(csv_path, rng, 10_000_000 + cycle * 1_000,
                                      96 + (cycle - 1) * 160, 9_000_000 + cycle)
                    out, run["job_s"] = job_process(pvc, f"delta {cycle}", started, **delta_env)
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
                # land mid-replay; the job starts first, and the replay
                # once the job logs its start: its wall is mostly process
                # start-up, which varies by seconds from host to host (an
                # aim from earlier jobs' walls missed an 8 s replay on both
                # sides), while its own run takes under a second, so the
                # publication falls early in the replay
                payloads = config5 if cycle == 4 else sample_seed_sets(
                    keys, CONFIG5_REQUESTS, rng_seed=33)
                pre, pre_token = engine_answers(cpu, payloads), cpu.cache_value
                if post(base + "/metrics/reset", b"")[0] != 200:
                    fail("phase 12 (a): /metrics/reset refused")
                before_replay = scrape_metrics(base)
                started = threading.Event()
                publisher = threading.Thread(target=publish, kwargs={"started": started},
                                             daemon=True)
                publisher.start()
                started.wait(120)
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
    # phase 14 (c) recounts the same rows over two ranks and is held to these
    np.save(os.path.join(work, "recount_rows.npy"), r_ids)
    np.save(os.path.join(work, "recount_counts.npy"), got)
    with open(os.path.join(work, "recount_peak.json"), "w") as fh:
        json.dump({"peak_device_bytes": peak}, fh)
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
            baskets = synthetic_baskets(**shape, seed=2024, device="cuda")
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


# ---------------------------------------------------------------- phase 13

QUALITY_ENV = dict(KMLS_EVAL_ENABLED="1", KMLS_EMBED_ENABLED="1", KMLS_COUNT_PATH="bitpack",
                   KMLS_ALS_SPARSE="always")
# launches of one quality job: the job's mine and eval's mine (popcount),
# 8 sweeps x 2 sides and the loss's X F, for embed and again for eval's
# training (segsum)
QUALITY_LAUNCHES = {"popcount_pairs": 2, "popcount_pairs_swar": 0, "segsum": 34}
QUALITY_DRAWS = 2000  # (c)'s config-5 draws over the embedding vocabulary
QUALITY_QPS = 1000.0
QUALITY_STALE_S = 1.0  # (d)'s KMLS_ARTIFACT_MAX_AGE_S, below every artifact's age

# the job's entry point as ``python -m`` runs it, with the launch counters
# of both kernels printed after it (they start at 0 in the new process)
_COUNTED_JOB = r"""
import json, runpy, sys
from kmlserver_tpu_torch.ops import popcount, segsum
try:
    runpy.run_module("kmlserver_tpu_torch.mining.job", run_name="__main__")
    code = 0
except SystemExit as exc:
    code = exc.code
print("LAUNCHES " + json.dumps({**popcount.LAUNCHES, **segsum.LAUNCHES}), flush=True)
sys.exit(code)
"""


def counted_job(pvc: str, label: str, want_exit: int = 0, **extra: str) -> tuple[str, dict, float]:
    """``python -m kmlserver_tpu_torch.mining.job`` over ``pvc`` (through
    :data:`_COUNTED_JOB`) → (stdout, kernel launches, wall s); fails unless
    it exits ``want_exit``."""
    t0 = time.perf_counter()
    job = subprocess.run(
        [sys.executable, "-c", _COUNTED_JOB], cwd=ROOT, capture_output=True, text=True,
        timeout=600,
        env=subproc_env(BASE_DIR=pvc, DATASETS_DIR=os.path.join(pvc, "datasets"), **extra),
    )
    wall = time.perf_counter() - t0
    for line in job.stdout.splitlines():
        log(f"  job {label} | {line}")
    if job.returncode != want_exit:
        log(job.stderr[-4000:])
        fail(f"phase 13 {label}: the job exited {job.returncode}, want {want_exit}")
    counts = [json.loads(line[len("LAUNCHES "):]) for line in job.stdout.splitlines()
              if line.startswith("LAUNCHES ")]
    if not counts:
        fail(f"phase 13 {label}: the job printed no launch counts")
    return job.stdout, counts[0], wall


def read_prom(pvc: str) -> dict:
    out = {}
    with open(os.path.join(pvc, "pickles", "job_metrics.prom")) as fh:
        for line in fh:
            if line.strip() and not line.startswith("#"):
                key, _, value = line.rstrip().rpartition(" ")
                out[key] = float(value)
    return out


def report_bytes(pvc: str) -> bytes:
    """The published quality report, checked against the manifest."""
    from kmlserver_tpu_torch.io import artifacts

    pickles = os.path.join(pvc, "pickles")
    path = os.path.join(pickles, artifacts.QUALITY_REPORT_FILENAME)
    if not os.path.exists(path):
        fail(f"phase 13: no {artifacts.QUALITY_REPORT_FILENAME} published in {pvc}")
    manifest = artifacts.load_manifest(pickles) or {}
    listed = manifest.get("files", {}).get(artifacts.QUALITY_REPORT_FILENAME) or {}
    if listed.get("sha256") != artifacts.file_digest(path)["sha256"]:
        fail(f"phase 13: the report is not in the manifest with its sha256: {listed}")
    with open(path, "rb") as fh:
        return fh.read()


def scored(pairs: list, weight: float | None) -> dict:
    """name → the score an answer ranks it by: the family's own score, or
    with ``weight`` the blend's ``(1-w)·conf + w·sim`` over (rule pairs,
    embedding pairs)."""
    if weight is None:
        return dict(pairs)
    rule_pairs, emb_pairs = pairs
    w = min(max(weight, 0.0), 1.0)
    out = {n: (1.0 - w) * c for n, c in rule_pairs}
    for n, s in emb_pairs:
        out[n] = out.get(n, 0.0) + w * s
    return out


def answer_gap(names_a: list, scores_a: dict, names_b: list, scores_b: dict) -> float:
    """The largest difference between two answers' score profiles, rank by
    rank: two answers that differ only by an order of candidates whose
    scores lie within ``g`` of each other have a gap of about ``g``."""
    if len(names_a) != len(names_b):
        return float("inf")
    return max((abs(scores_a[a] - scores_b[b]) for a, b in zip(names_a, names_b)), default=0.0)


def answer_diffs(split, fam_a, cands_a, fam_b, cands_b, k: int) -> dict:
    """Per mode and sweep weight: the evaluated playlists whose answers
    differ between two candidate sets, and the largest score-profile gap
    among them (``compose_answer`` on each side)."""
    from kmlserver_tpu_torch.quality.eval import compose_answer
    from kmlserver_tpu_torch.quality.sweep import DEFAULT_BLEND_WEIGHT, WEIGHT_GRID

    out = {}
    cases = [("rules", None), ("embed", None), ("blend", DEFAULT_BLEND_WEIGHT)]
    cases += [("sweep", w) for w in WEIGHT_GRID]
    for mode, weight in cases:
        differ, gap = 0, 0.0
        for e in range(len(split.eval_rows)):
            real = "blend" if mode == "sweep" else mode
            w = DEFAULT_BLEND_WEIGHT if weight is None else weight
            a, _ = compose_answer(split, fam_a, cands_a, k, real, w, e)
            b, _ = compose_answer(split, fam_b, cands_b, k, real, w, e)
            if a == b:
                continue
            differ += 1
            if real == "rules":
                sa, sb = scored(cands_a.rule_pairs[e], None), scored(cands_b.rule_pairs[e], None)
            elif real == "embed":
                sa, sb = scored(cands_a.emb_pairs[e], None), scored(cands_b.emb_pairs[e], None)
            else:
                sa = scored((cands_a.rule_pairs[e], cands_a.emb_pairs[e]), w)
                sb = scored((cands_b.rule_pairs[e], cands_b.emb_pairs[e]), w)
            if not (set(a) <= set(sa) and set(b) <= set(sb)):
                gap = float("inf")  # a fallback on one side only
            else:
                gap = max(gap, answer_gap(a, sa, b, sb))
        out[f"w={weight}" if mode == "sweep" else mode] = {"differ": differ, "max_gap": gap}
    return out


def metric_deltas(got: dict, want: dict) -> dict:
    """Per mode (and sweep point): the largest |Δ| of recall@k and MRR."""
    out = {m: max(abs(got["modes"][m][f] - want["modes"][m][f]) for f in ("recall_at_k", "mrr"))
           for m in ("rules", "popularity", "embed", "blend")}
    for i, w in enumerate(got["sweep"]["weights"]):
        out[f"w={w}"] = max(abs(got["sweep"][f][i] - want["sweep"][f][i])
                            for f in ("recall_at_k", "mrr"))
    return out


def check_explained(label: str, deltas: dict, diffs: dict, n_eval: int, eps: float | None) -> None:
    """Every metric difference between two reports rests on counted answer
    differences (one playlist moves a mean by at most 1/n_eval), and with
    ``eps`` each of those answers is decided at a score gap of at most
    ``eps``."""
    for key, delta in deltas.items():
        counted = diffs.get(key, {"differ": 0})["differ"]
        if delta > counted / n_eval + 1e-6:
            fail(f"phase 13 (a) {label}: {key} moved by {delta} with {counted} differing "
                 f"answers of {n_eval}")
    if eps is not None:
        bad = {k: d for k, d in diffs.items() if d["differ"] and d["max_gap"] > eps}
        if bad:
            fail(f"phase 13 (a) {label}: answers differ beyond a near-tie (|Δ| > {eps}): {bad}")


def quality_eval(work: str, csv_src: str) -> dict:
    """Phase 13 (a) and (b): the quality job on the card, its launches, its
    report against the CPU job's and the in-process decomposition; two card
    runs and a resume after ``eval`` publish the same bytes."""
    import hashlib

    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.data.csv import read_tracks
    from kmlserver_tpu_torch.mining.vocab import build_baskets
    from kmlserver_tpu_torch.quality import eval as qeval

    def new_pvc(name: str) -> str:
        pvc = os.path.join(work, name)
        os.makedirs(os.path.join(pvc, "datasets"))
        shutil.copy(csv_src, os.path.join(pvc, "datasets"))
        return pvc

    # ---- (a) the job on the card, counted
    pvc = new_pvc("pvc_quality")
    out, launches, wall = counted_job(pvc, "quality 1", **QUALITY_ENV)
    if launches != QUALITY_LAUNCHES:
        fail(f"phase 13 (a): launches {launches}, want {QUALITY_LAUNCHES}")
    card_bytes = report_bytes(pvc)
    report = json.loads(card_bytes)
    prom = read_prom(pvc)
    eval_s = prom.get('kmls_job_phase_duration_seconds{phase="eval"}')
    timings = next((ln for ln in out.splitlines() if ln.startswith("Eval phase timings:")), "")
    lookups = next((ln for ln in out.splitlines() if ln.startswith("Eval lookups:")), "")
    if eval_s is None or not timings:
        fail("phase 13 (a): no eval phase in job_metrics.prom or the job's log")

    # the same job on the CPU, the plain versions
    pvc_cpu = new_pvc("pvc_quality_cpu")
    _, cpu_launches, cpu_wall = counted_job(pvc_cpu, "quality CPU", KMLS_TORCH_DEVICE="cpu",
                                            **QUALITY_ENV)
    if any(cpu_launches.values()):
        fail(f"phase 13 (a): the CPU job launched kernels: {cpu_launches}")
    cpu_report = json.loads(report_bytes(pvc_cpu))
    for key in ("version", "split", "k"):
        if report[key] != cpu_report[key]:
            fail(f"phase 13 (a): {key} {report[key]} != the CPU job's {cpu_report[key]}")
    for mode in ("rules", "popularity"):
        if report["modes"][mode] != cpu_report["modes"][mode]:
            fail(f"phase 13 (a): mode {mode} {report['modes'][mode]} != the CPU job's "
                 f"{cpu_report['modes'][mode]}")

    # in process: the split, both families trained on the card and on the
    # CPU, the lookups of each on both devices
    cfg = MiningConfig(embed_enabled=True, eval_enabled=True, count_path="bitpack",
                       als_sparse="always")
    baskets = build_baskets(read_tracks(csv_src))
    split = qeval.holdout_split(baskets, n_holdout=cfg.eval_holdout_n,
                                max_playlists=cfg.eval_max_playlists)
    k = cfg.eval_k
    fam_card = qeval.train_families(cfg, split, "cuda")
    fam_cpu = qeval.train_families(cfg, split, "cpu")
    train = {"factors_max_abs": float(np.abs(fam_card.emb_factors - fam_cpu.emb_factors).max())}
    if train["factors_max_abs"] > ALS_FACTOR_TOL:
        fail(f"phase 13 (a): eval's factors card vs CPU max |Δ| {train['factors_max_abs']}")
    if not same_tensors(fam_card.result.tensors, fam_cpu.result.tensors):
        fail("phase 13 (a): eval's rule tensors differ between the card and the CPU")
    cands_card = qeval.lookup_candidates(split, fam_card, k, "cuda")
    cands_cpu_same = qeval.lookup_candidates(split, fam_card, k, "cpu")
    cands_cpu = qeval.lookup_candidates(split, fam_cpu, k, "cpu")

    def build(fam, cands) -> dict:
        rep = {**{key: report[key] for key in ("version", "split", "k")}, "modes": {},
               "sweep": None, "measured_blend_weight": None}
        qeval.score_modes(rep, split, fam, cands)
        return rep

    in_process = build(fam_card, cands_card)
    if json.dumps(in_process, indent=1, sort_keys=True).encode() != card_bytes:
        fail("phase 13 (a): the in-process card evaluation differs from the job's report")
    n_eval = report["split"]["n_eval_playlists"]
    # the lookups on the card against their plain versions, one model
    lookup_diffs = answer_diffs(split, fam_card, cands_card, fam_card, cands_cpu_same, k)
    if lookup_diffs["rules"]["differ"]:
        fail(f"phase 13 (a): rule answers differ between the card and the CPU: "
             f"{lookup_diffs['rules']}")
    check_explained("lookups, card vs CPU", metric_deltas(in_process,
                    build(fam_card, cands_cpu_same)), lookup_diffs, n_eval, NEAR_TIE)
    # the CPU job's report: its own training on the CPU
    job_diffs = answer_diffs(split, fam_card, cands_card, fam_cpu, cands_cpu, k)
    job_deltas = metric_deltas(report, cpu_report)
    if build(fam_cpu, cands_cpu) != cpu_report:
        fail("phase 13 (a): the in-process CPU evaluation differs from the CPU job's report")
    check_explained("card job vs CPU job", job_deltas, job_diffs, n_eval, None)
    near = {key: d for key, d in job_diffs.items() if d["differ"]}
    log(f"phase 13 (a) quality job on the card: {wall:.3f} s wall (CPU {cpu_wall:.3f} s), eval "
        f"phase {eval_s:.3f} s (job_metrics.prom); {timings}; {lookups}; launches {launches}; "
        f"split {report['split']}; "
        + "; ".join(f"{m} recall@{k} {s['recall_at_k']}, MRR {s['mrr']}, coverage {s['coverage']}"
                    for m, s in report["modes"].items())
        + f"; measured w={report['measured_blend_weight']}")
    log(f"phase 13 (a) against the CPU: split, k, rules and popularity equal the CPU job's; "
        f"eval's factors card vs CPU max |Δ| {train['factors_max_abs']:.3g}; the lookups on "
        f"one model, card vs plain: answers differing {lookup_diffs} (near-tie bar {NEAR_TIE}); "
        f"card job vs CPU job: metric |Δ| {job_deltas}, answers differing {near}")

    # ---- (b) a second card run, and a kill after eval then the resume
    digest = hashlib.sha256(card_bytes).hexdigest()
    pvc_b = new_pvc("pvc_quality_again")
    _, again_launches, again_wall = counted_job(pvc_b, "quality 2", **QUALITY_ENV)
    pvc_c = new_pvc("pvc_quality_crash")
    counted_job(pvc_c, "quality killed after eval", want_exit=75,
                KMLS_FAULT_MINE_CRASH_PHASE="eval", **QUALITY_ENV)
    if os.path.exists(os.path.join(pvc_c, "pickles", "quality.report.json")):
        fail("phase 13 (b): the job killed after eval published a report")
    resume_out, resume_launches, resume_wall = counted_job(pvc_c, "quality resumed",
                                                           **QUALITY_ENV)
    if "Resumed phase 'eval'" not in resume_out or any(resume_launches.values()):
        fail(f"phase 13 (b): the resume after eval launched {resume_launches}")
    digests = {label: hashlib.sha256(report_bytes(p)).hexdigest()
               for label, p in (("again", pvc_b), ("resumed", pvc_c))}
    if set(digests.values()) != {digest} or again_launches != QUALITY_LAUNCHES:
        fail(f"phase 13 (b): report sha256 {digest} vs {digests}; launches {again_launches}")
    log(f"phase 13 (b) report sha256 {digest}: a second card run ({again_wall:.3f} s, "
        f"launches {again_launches}) and a job killed after 'eval' then resumed "
        f"({resume_wall:.3f} s, launches {resume_launches}) publish the same bytes")
    return {"pvc": pvc, "report": report, "wall_s": wall, "cpu_wall_s": cpu_wall,
            "eval_phase_s": eval_s, "timings": timings, "lookups": lookups,
            "launches": launches, "resume_launches": resume_launches,
            "resume_wall_s": resume_wall, "sha256": digest, **train,
            "lookup_diffs": lookup_diffs, "job_metric_deltas": job_deltas,
            "job_answer_diffs": near}


def quality_serving(pvc: str, report: dict) -> dict:
    """Phase 13 (c) and (d): the server in measured blend mode under 2,000
    config-5 draws, then the staleness bound in process."""
    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.serving.app import RecommendApp
    from kmlserver_tpu_torch.serving.engine import RecommendEngine
    from kmlserver_tpu_torch.serving.replay import replay_async_http

    weight = report["measured_blend_weight"]
    cpu = RecommendEngine(ServingConfig(base_dir=pvc, hybrid_blend_measured=True), device="cpu")
    if not cpu.load() or cpu.blend_weight != weight:
        fail(f"phase 13 (c): the CPU engine serves w={cpu.blend_weight}, the report {weight}")
    payloads = distinct_sets(list(cpu.bundle.emb_vocab), QUALITY_DRAWS, 43)
    want = engine_answers(cpu, payloads)
    server, base, lines = start_server(pvc, KMLS_HYBRID_BLEND_WEIGHT="measured")
    try:
        served_w = scrape_metrics(base).get("kmls_hybrid_blend_weight")
        responses: list = []
        run = replay_async_http(base, payloads, qps=QUALITY_QPS, n_conns=CONFIG5_CONNS,
                                responses=responses)
    finally:
        code = stop_server(server)
    if served_w != weight or code != 0:
        fail(f"phase 13 (c): kmls_hybrid_blend_weight {served_w}, report {weight}; exit {code}")
    if len(responses) != len(payloads):
        fail(f"phase 13 (c): {len(payloads) - len(responses)} requests got no answer")
    degraded = overload_only("phase 13 (c)", responses, lines)
    near_ties = 0
    for i, status, head, body in responses:
        if status != 200:
            fail(f"phase 13 (c): HTTP {status} for {payloads[i]}: {head[:200]!r}")
        if b"x-kmls-degraded:" in head:
            hold_to_fallback("phase 13 (c)", cpu, payloads[i], json.loads(body)["songs"])
            continue
        if json.loads(body)["songs"] != want[i][0]:
            if not decisive_near_tie(cpu, payloads[i]):
                fail(f"phase 13 (c): answer for {payloads[i]} != the CPU engine's, no near-tie")
            near_ties += 1
    log(f"phase 13 (c) KMLS_HYBRID_BLEND_WEIGHT=measured: kmls_hybrid_blend_weight {served_w} "
        f"== the report's; {len(payloads)} draws at {QUALITY_QPS:.0f} QPS → {run.achieved_qps:.1f} "
        f"QPS, client p50/p99 {run.p50_ms:.3f}/{run.p99_ms:.3f} ms, 0 5xx; answers == the CPU "
        f"engine's at w={weight} but {degraded} degraded (the fallback) and {near_ties} near-ties (|Δ| <= {NEAR_TIE})")

    # ---- (d) the staleness bound, in process on the card
    stale = {}
    for bound in (QUALITY_STALE_S, 0.0):
        app = RecommendApp(ServingConfig(base_dir=pvc, artifact_max_age_s=bound), device="cuda")
        try:
            if not app.engine.load():
                fail("phase 13 (d): the card engine did not load the PVC")
            ages = app._artifact_ages()
            while min(ages.values()) <= QUALITY_STALE_S:
                time.sleep(0.1)
                ages = app._artifact_ages()
            status, _, body = app.handle("GET", "/readyz", None)
            ready = json.loads(body)
            _, _, text = app.handle("GET", "/metrics", None)
        finally:
            app.close()
        flags = {line.split('"')[1]: float(line.rsplit(" ", 1)[1])
                 for line in text.decode().splitlines()
                 if line.startswith("kmls_artifact_stale{")}
        if bound > 0:
            reason = next((r for r in ready.get("reasons", []) if r.startswith("artifacts stale")),
                          "")
            named = all(f"{name} (" in reason for name in ages)
            if status != 200 or ready["status"] != "degraded" or not named or (
                    set(flags) != set(ages) or set(flags.values()) != {1.0}):
                fail(f"phase 13 (d) bound {bound}: {status} {ready}, flags {flags}")
        elif status != 200 or ready["status"] != "ready" or set(flags.values()) != {0.0} or (
                set(flags) != set(ages)):
            fail(f"phase 13 (d) bound 0: {status} {ready}, flags {flags}")
        stale[str(bound)] = {"readyz": ready, "flags": flags}
    log(f"phase 13 (d) KMLS_ARTIFACT_MAX_AGE_S={QUALITY_STALE_S}: /readyz 200 "
        f"{stale[str(QUALITY_STALE_S)]['readyz']['reasons']}, kmls_artifact_stale "
        f"{stale[str(QUALITY_STALE_S)]['flags']}; bound 0: /readyz "
        f"{stale['0.0']['readyz']['status']}, flags {stale['0.0']['flags']}")
    return {"served_weight": served_w, "achieved_qps": run.achieved_qps, "p50_ms": run.p50_ms,
            "p99_ms": run.p99_ms, "near_ties": near_ties, "stale": stale}


def bundle_members(path: str) -> dict:
    """A delta bundle's zip members → their bytes (the zip's own member
    timestamps aside, the bundle's bytes)."""
    import zipfile

    with zipfile.ZipFile(path) as zf:
        return {info.filename: zf.read(info) for info in zf.infolist()}


def quality_ranks(work: str, csv_src: str) -> dict:
    """Phase 13 (e): two ranks sharing the card over gloo on a delta-armed
    PVC after one append publish one bundle, from rank 0, equal to a
    one-rank job's; neither enters the full mine."""
    src = os.path.join(work, "pvc_fresh")
    staged = os.path.join(work, "pvc_delta_staged")
    if os.path.exists(os.path.join(src, "last_execution.txt")):
        shutil.copytree(src, staged)  # phase 12 (a)'s PVC
    else:
        os.makedirs(os.path.join(staged, "datasets"))
        shutil.copy(csv_src, os.path.join(staged, "datasets", FRESH_CSV))
        job_process(staged, "phase 13 delta base", KMLS_DELTA_ENABLED="1")
    append_bench_rows(os.path.join(staged, "datasets", FRESH_CSV), np.random.default_rng(13),
                      10_000_000 + 5_000, 96 + 4 * 160, 9_000_005)
    before = {n for n in os.listdir(os.path.join(staged, "pickles")) if n.endswith(".bundle")}
    one, two = (os.path.join(work, name) for name in ("pvc_delta_one", "pvc_delta_two"))
    shutil.copytree(staged, one)
    shutil.copytree(staged, two)
    t0 = time.perf_counter()
    one_out, _ = job_process(one, "delta one rank", KMLS_DELTA_ENABLED="1")
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logs = run_ranks([[sys.executable, "-m", "kmlserver_tpu_torch.mining.job"]] * RANKS,
                     rank_envs(free_port(), BASE_DIR=two, DATASETS_DIR=os.path.join(two, "datasets"),
                               KMLS_DELTA_ENABLED="1"),
                     300, "phase 13 (e)")
    two_s = time.perf_counter() - t0
    for rank, out in enumerate(logs):
        for line in out.splitlines():
            log(f"  rank {rank} | {line}")
    new = {n for p in (one, two) for n in os.listdir(os.path.join(p, "pickles"))
           if n.endswith(".bundle")} - before
    published = [ln for ln in logs[0].splitlines() if ln.startswith("Delta ") and "published" in ln]
    full_mine = [i for i, out in enumerate(logs) if "Loaded " in out or "Pair-count path" in out]
    if (len(new) != 1 or not published or "rank 0 ran the delta route" not in logs[1]
            or full_mine or "published" not in one_out):
        fail(f"phase 13 (e): new bundles {sorted(new)}, rank 0 {published}, full mine on ranks "
             f"{full_mine}, rank 1 log tail {logs[1].splitlines()[-5:]}")
    name = new.pop()
    a, b = (bundle_members(os.path.join(p, "pickles", name)) for p in (one, two))
    if a != b:
        fail(f"phase 13 (e): {name} of the two-rank job differs from the one-rank job's: "
             f"{sorted(k for k in a if a.get(k) != b.get(k))}")
    log(f"phase 13 (e) two ranks on one host (gloo, sharing cuda:0): rank 0 {published[0]!r}; "
        f"rank 1 took the broadcast outcome; neither ran the full mine; {name}'s members == the "
        f"one-rank job's; two ranks {two_s:.3f} s, one rank {one_s:.3f} s wall")
    return {"bundle": name, "two_ranks_s": two_s, "one_rank_s": one_s}


def phase_quality(work: str | None = None) -> dict:
    """Phase 13: the quality loop on the card (alone: ``python -c "import
    chip_smoke as c; c.phase_quality()"`` writes its own ds2 CSV)."""
    from kmlserver_tpu_torch.data.csv import write_tracks_csv
    from kmlserver_tpu_torch.data.synthetic import DS2_SHAPE, synthetic_table

    t0 = time.perf_counter()
    own = work is None
    work = work or tempfile.mkdtemp(prefix="kmls_smoke13_")
    try:
        csv_src = os.path.join(work, "pvc", "datasets", FRESH_CSV)  # phase 4's
        if not os.path.exists(csv_src):
            csv_src = os.path.join(work, FRESH_CSV)
            write_tracks_csv(csv_src, synthetic_table(**DS2_SHAPE, seed=7))
        evaluated = quality_eval(work, csv_src)
        serving = quality_serving(evaluated.pop("pvc"), evaluated["report"])
        ranks = quality_ranks(work, csv_src)
        result = {"eval": evaluated, "serving": serving, "ranks": ranks,
                  "seconds": time.perf_counter() - t0}
        log(f"phase 13 seconds {result['seconds']:.3f}")
        log("PHASE13 " + json.dumps(result, default=str))
        return result
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 14

SHARDED_IMPLS = ("gspmd", "allgather", "ring")
# kubernetes/job-multihost.yaml's knobs (:109-112, :132-135, :164-165, :172-173)
MANIFEST_ENV = dict(KMLS_MESH_SHAPE="hybrid", KMLS_MODEL_LAYOUT="sharded",
                    KMLS_K_MAX_CONSEQUENTS="256", KMLS_EMBED_ENABLED="1",
                    KMLS_CKPT_ENABLED="1", MIN_SUPPORT="0.05",
                    REGEX_FILENAME="2023_spotify_ds*.csv")
ALS_LAYOUT_RTOL, ALS_LAYOUT_ATOL = 2e-4, 2e-5  # the reference's sharded-vs-dense bar
SHARDED_K = 256  # the manifest's KMLS_K_MAX_CONSEQUENTS
SHARDED_ALS_BUDGET = 24 << 30  # per rank: the 1M x 8,124 X block is 16.2 GB in f32
WIDE_V, WIDE_LONG, WIDE_MIN_COUNT = 16_384, 64, 2  # phase 14 (b)'s wide sparse-sharded check


def host_free_gib() -> float:
    """MemAvailable of the host, GiB (gloo stages the card's collectives
    through host memory)."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def worker_sharded(_mesh, work: str) -> dict:
    """Phase 14 (b), one rank: the ds2 baskets on a ``1x2`` (2 ranks) or
    ``2x2`` (4 ranks) mesh — each dense schedule's counts against the
    one-card C and the plain version, its emission against the one-card
    emission; on ``2x2`` the staged ``sharded-dense-<impl>`` route at
    ``max_itemset_len=3``; the sparse-sharded route with the long-basket
    block, its popcount launches counted."""
    import torch

    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.data.csv import read_tracks
    from kmlserver_tpu_torch.mining.miner import mine, prune_infrequent
    from kmlserver_tpu_torch.mining.vocab import build_baskets
    from kmlserver_tpu_torch.ops import encode, rules
    from kmlserver_tpu_torch.ops import popcount as pc
    from kmlserver_tpu_torch.ops.support import min_count_for, pair_counts
    from kmlserver_tpu_torch.parallel import support
    from kmlserver_tpu_torch.parallel.mesh import make_mesh, world_ranks

    world = len(world_ranks())
    shape = "1x2" if world == 2 else "2x2"
    dp, tp = (int(n) for n in shape.split("x"))
    grid = make_mesh(shape)
    datasets = os.path.join(work, "pvc", "datasets")
    baskets = build_baskets(read_tracks(os.path.join(datasets, os.listdir(datasets)[0])))
    min_count = min_count_for(DS2_MIN_SUPPORT, baskets.n_playlists)
    reduced, _ = prune_infrequent(baskets, min_count)
    v = reduced.n_tracks
    x = encode.onehot_matrix(torch.as_tensor(reduced.playlist_rows, device="cuda"),
                             torch.as_tensor(reduced.track_ids, device="cuda"),
                             n_playlists=reduced.n_playlists, n_tracks=v)
    single = pair_counts(x)
    del x
    want = rules.emit_rule_tensors(single, min_count, k_max=SHARDED_K)
    want = [t.cpu().numpy() for t in want] + [torch.diagonal(single).cpu().numpy()]
    plain = support.sharded_pair_counts_plain(reduced, dp, tp, device="cuda")
    out = {"mesh": shape, "v": v, "impls": {}, "mines": {}}
    for impl in SHARDED_IMPLS:
        for key in support.CALLS:
            support.CALLS[key] = 0
        counts = support.sharded_pair_counts(reduced, grid, impl, device="cuda")
        emitted = support.sharded_rule_tensors(reduced, grid, min_count, SHARDED_K, impl,
                                               device="cuda")
        torch.cuda.synchronize()
        out["impls"][impl] = {
            "calls": dict(support.CALLS),
            "counts_eq_single": bool(torch.equal(counts, single)),
            "counts_eq_plain": bool(torch.equal(plain[:v, :v], counts)),
            "max_abs_err": int((plain[:v, :v].long() - counts.long()).abs().max()),
            "emit_eq_single": all(np.array_equal(a, b) for a, b in zip(emitted, want)),
        }
    knobs = {"sparse-sharded": dict(model_layout="sharded", count_path="sparse",
                                    sparse_long_basket=64)}
    if shape == "2x2":
        knobs.update({f"staged-{impl}": dict(count_path="dense", max_itemset_len=3,
                                             sharded_impl=impl) for impl in SHARDED_IMPLS})
    for label, kw in knobs.items():
        cfg = MiningConfig(min_support=DS2_MIN_SUPPORT, k_max_consequents=SHARDED_K, **kw)
        for key in pc.LAUNCHES:
            pc.LAUNCHES[key] = 0
        for key in support.CALLS:
            support.CALLS[key] = 0
        got = mine(baskets, cfg, device="cuda", mesh=grid)
        launches = {"popcount_pairs": pc.LAUNCHES["popcount_pairs"]}
        calls = dict(support.CALLS)
        alone = mine(baskets, cfg, device="cuda")
        out["mines"][label] = {
            "count_path": got.count_path, "one_card_path": alone.count_path,
            "launches": launches, "calls": calls, "census": got.itemset_census,
            # the census differs by design: over a mesh no one-hot is whole,
            # so length 3 is not enumerated (the reference's behaviour)
            "eq_one_card": same_tensors(got.tensors, alone.tensors),
        }
    del single, want, plain
    meshes = {shape: grid} | ({"1x4": make_mesh("1x4")} if world == 4 else {})
    out["wide"] = wide_sparse_memory(meshes)
    return out


def wide_baskets():
    """Phase 14 (b)'s wide vocabulary: ``WIDE_V`` tracks (its ``(V, V)``
    int32 counts are 1 GiB), 20,000 baskets of 2–40 tracks and 200 of 200,
    past the long-basket threshold, from numpy seed 14."""
    from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab

    rng = np.random.default_rng(14)
    lengths = np.concatenate([rng.integers(2, 41, 20_000), np.full(200, 200)])
    rows = np.repeat(np.arange(len(lengths), dtype=np.int64), lengths)
    keys = np.unique(rows * WIDE_V + rng.integers(0, WIDE_V, len(rows)))
    names = [str(i) for i in range(WIDE_V)]
    return Baskets(playlist_rows=(keys // WIDE_V).astype(np.int32),
                   track_ids=(keys % WIDE_V).astype(np.int32), n_playlists=len(lengths),
                   vocab=Vocab(names=names, index={n: i for i, n in enumerate(names)}))


def wide_sparse_memory(meshes: dict) -> dict:
    """Phase 14 (b), one rank: the sparse-sharded count of the wide
    baskets on each mesh — this rank's slab against the rows of the
    one-card count, its peak device memory above what was held before, and
    the gathered emission against the one-card emission (rank 0)."""
    import torch

    from kmlserver_tpu_torch.ops import rules
    from kmlserver_tpu_torch.ops import sparse as sparse_mod
    from kmlserver_tpu_torch.parallel import support
    from kmlserver_tpu_torch.parallel.mesh import this_rank

    wide = wide_baskets()
    full = sparse_mod.sparse_pair_counts_device(
        wide.playlist_rows, wide.track_ids, n_playlists=wide.n_playlists, n_tracks=WIDE_V,
        long_basket_threshold=WIDE_LONG, device="cuda")
    if this_rank() == 0:
        want = rules.emit_rule_tensors(full, WIDE_MIN_COUNT, k_max=SHARDED_K)
        want = [t.cpu().numpy() for t in want] + [torch.diagonal(full).cpu().numpy()]
    out = {}
    for label, mesh in meshes.items():
        tp = mesh.shape["tp"]
        v_loc = -(-WIDE_V // tp)
        lo = mesh.position(this_rank())[1] * v_loc
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        slab = support.sparse_sharded_slab(wide, mesh, WIDE_LONG, "cuda")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        rows = min(v_loc, WIDE_V - lo)
        eq = bool(torch.equal(slab[:rows, :WIDE_V], full[lo:lo + rows])
                  and not slab[rows:].any() and not slab[:, WIDE_V:].any())
        del slab
        emitted = support.sparse_sharded_rule_tensors(wide, mesh, WIDE_MIN_COUNT, SHARDED_K,
                                                      WIDE_LONG, device="cuda")
        out[label] = {"tp": tp, "count_peak_bytes": peak, "slab_eq_full_rows": eq,
                      "emit_eq_one_card": None if this_rank() else
                      all(np.array_equal(a, b) for a, b in zip(emitted, want))}
    return out


def worker_sharded_scale(_mesh, work: str) -> dict:
    """Phase 14 (c), one rank of a ``1x2`` mesh on phase 5's pruned scale
    baskets: ``allgather`` and ``ring`` through ``sharded_rule_tensors``
    (rank 0 saves the emitted tensors), each rank's local product timed in
    turn with CUDA events, rank 0's library and plain products, the
    emission against its plain version, then one vocab-sharded dense ALS
    training."""
    import hashlib

    import torch

    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.mining import als
    from kmlserver_tpu_torch.mining.miner import prune_infrequent
    from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
    from kmlserver_tpu_torch.ops import encode
    from kmlserver_tpu_torch.ops.support import int8_gram, int8_gram_plain, min_count_for
    from kmlserver_tpu_torch.parallel import distributed, support
    from kmlserver_tpu_torch.parallel.mesh import make_mesh
    from kmlserver_tpu_torch.utils.profiling import PhaseTimer

    grid = make_mesh("1x2")
    me = distributed.runtime().rank
    with open(os.path.join(work, "scale_shape.json")) as fh:
        shape = json.load(fh)
    names = [f"Track {i:07d}" for i in range(shape["n_tracks"])]
    baskets = Baskets(
        playlist_rows=np.load(os.path.join(work, "scale_rows.npy")),
        track_ids=np.load(os.path.join(work, "scale_tids.npy")),
        n_playlists=shape["n_playlists"],
        vocab=Vocab(names=names, index={n: i for i, n in enumerate(names)}),
    )
    min_count = min_count_for(SCALE_MIN_SUPPORT, baskets.n_playlists)
    reduced, _ = prune_infrequent(baskets, min_count)
    del baskets
    out = {"host_free_gib_start": host_free_gib(), "routes": {}, "shape": [
        reduced.n_playlists, reduced.n_tracks, int(len(reduced.track_ids))]}
    for impl in ("allgather", "ring"):
        for key in support.CALLS:
            support.CALLS[key] = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timer = PhaseTimer(torch.device("cuda"))
        distributed.barrier()
        t0 = time.perf_counter()
        emitted = support.sharded_rule_tensors(reduced, grid, min_count, SHARDED_K, impl,
                                               device="cuda", timer=timer)
        wall = time.perf_counter() - t0
        if me == 0:
            np.savez(os.path.join(work, f"sharded_{impl}.npz"), rule_ids=emitted[0],
                     rule_counts=emitted[1], row_valid_counts=emitted[2], item_counts=emitted[3])
        out["routes"][impl] = {"wall_s": wall, "phases": dict(timer.phases),
                               "calls": dict(support.CALLS),
                               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del emitted
    out["recount"] = worker_recount(reduced, grid, me, work)
    # ---- the local products, ranks in turn, and rank 0's yardsticks, on
    # the operands the all-gather gives, built here whole on each rank
    axis = grid.axis("tp")
    p_pad, v_pad = support.dense_padded_shape(reduced.n_playlists, reduced.n_tracks, 1, axis.size)
    cols = encode.onehot_matrix(torch.as_tensor(reduced.track_ids, device="cuda"),
                                torch.as_tensor(reduced.playlist_rows, device="cuda"),
                                n_playlists=v_pad, n_tracks=p_pad)
    v_loc, p_loc = v_pad // axis.size, p_pad
    lo = axis.ranks.index(me) * v_loc
    xt = cols[lo:lo + v_loc]
    slab = int8_gram(xt, cols)
    torch.cuda.synchronize()
    times = {}
    for turn in axis.ranks:
        distributed.barrier()
        if turn == me:
            times["product_ms"] = cuda_ms(lambda: int8_gram(xt, cols), 3)
            times["ring_step_ms"] = cuda_ms(lambda: int8_gram(xt, xt), 3)
            times["emit_ms"] = cuda_ms(
                lambda: support.emit_slab(slab, lo, min_count, SHARDED_K), 3)
    distributed.barrier()
    if me == 0:
        times["library_ms"] = cuda_ms(lambda: int8_gram(cols, cols), 2)  # one card, whole C
        chunk = RECOUNT_PLAIN_CHUNK
        plain = torch.zeros_like(slab)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for c in range(0, p_loc, chunk):
            plain += int8_gram_plain(xt[:, c:c + chunk], cols[:, c:c + chunk])
        end.record()
        torch.cuda.synchronize()
        times["plain_ms"] = start.elapsed_time(end)
        times["product_eq_plain"] = bool(torch.equal(plain, slab))
        times["product_max_abs_err"] = int((plain.long() - slab.long()).abs().max())
        del plain
        slab_h = slab.cpu()
        t0 = time.perf_counter()
        emit_plain = support.emit_slab(slab_h, lo, min_count, SHARDED_K)
        times["emit_plain_ms"] = 1e3 * (time.perf_counter() - t0)
        emit_card = support.emit_slab(slab, lo, min_count, SHARDED_K)
        times["emit_eq_plain"] = all(torch.equal(a.cpu(), b) for a, b in zip(emit_card, emit_plain))
    distributed.barrier()
    out["times"] = times
    out["v_loc"], out["p_loc"], out["v_pad"] = v_loc, p_loc, cols.shape[0]
    del xt, cols, slab
    # ---- one vocab-sharded dense ALS training
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["host_free_gib_als"] = host_free_gib()
    als.CALLS["sharded_sweep"] = 0
    sweep_s: list[float] = []
    inner = als._sharded_sweep

    def timed_sweep(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(*args)
        torch.cuda.synchronize()
        sweep_s.append(time.perf_counter() - t0)
        return res

    als._sharded_sweep = timed_sweep
    try:
        cfg = MiningConfig(model_layout="sharded", embed_enabled=True,
                           hbm_budget_bytes=SHARDED_ALS_BUDGET)
        payload = als.train_embeddings(reduced, cfg, mesh=grid, device="cuda")
    finally:
        als._sharded_sweep = inner
    factors = payload["item_factors"]
    out["als"] = {
        "shards": payload.get("shards"), "storage": payload.get("storage"),
        "skipped": payload.get("skipped"), "iters": payload["iters"], "rank": payload["rank"],
        "final_loss": payload["final_loss"], "duration_s": payload["duration_s"],
        "sweep_s": sweep_s, "calls": als.CALLS["sharded_sweep"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "finite": bool(factors is not None and np.isfinite(factors).all()),
        "factors_sha": None if factors is None else hashlib.sha256(factors.tobytes()).hexdigest(),
    }
    return out


def worker_recount(reduced, grid, me: int, work: str) -> dict:
    """Phase 14 (c), A.8.2: phase 12 (b)'s delta-recount rows over the
    ``1x2`` ranks (``restricted_pair_counts`` with the mesh) against phase
    12 (b)'s one-card rows; the call's phases, calls and peak memory, then
    its product alone, ranks in turn, with CUDA events."""
    import torch

    from kmlserver_tpu_torch.ops.support import int8_gram
    from kmlserver_tpu_torch.parallel import distributed, support
    from kmlserver_tpu_torch.utils.profiling import PhaseTimer

    r_ids = np.load(os.path.join(work, "recount_rows.npy"))
    for key in support.CALLS:
        support.CALLS[key] = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer(torch.device("cuda"))
    distributed.barrier()
    t0 = time.perf_counter()
    got = support.restricted_pair_counts(reduced, r_ids, device="cuda", mesh=grid, timer=timer)
    wall = time.perf_counter() - t0
    out = {"wall_s": wall, "phases": dict(timer.phases), "calls": dict(support.CALLS),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "eq_one_card": bool(np.array_equal(got, np.load(os.path.join(work,
                                                                        "recount_counts.npy"))))}
    del got
    xt = support.onehot_block_t(reduced, grid, device="cuda")
    a = support.restricted_rows_block(reduced, np.unique(r_ids).astype(np.int64), grid,
                                      device="cuda")
    int8_gram(a, xt)
    torch.cuda.synchronize()
    for turn in grid.axis("tp").ranks:
        distributed.barrier()
        if turn == me:
            out["product_ms"] = cuda_ms(lambda: int8_gram(a, xt), 3)
    distributed.barrier()
    out["r"], out["r_pad"], out["v_loc"], out["p_loc"] = (len(r_ids), a.shape[0], xt.shape[0],
                                                          xt.shape[1])
    del a, xt
    torch.cuda.empty_cache()
    return out


def sharded_manifest_job(work: str, csv_src: str) -> dict:
    """Phase 14 (a): ``kubernetes/job-multihost.yaml``'s mining job on two
    ranks against one card with the same knobs."""
    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.io import artifacts

    def pvc(name: str) -> str:
        path = os.path.join(work, name)
        os.makedirs(os.path.join(path, "datasets"))
        shutil.copy(csv_src, os.path.join(path, "datasets", FRESH_CSV))
        return path

    def ranks_job(base: str, label: str, want_exit: int = 0, **extra: str) -> tuple[list, float]:
        t0 = time.perf_counter()
        logs = run_ranks([[sys.executable, "-m", "kmlserver_tpu_torch.mining.job"]] * RANKS,
                         rank_envs(free_port(), BASE_DIR=base,
                                   DATASETS_DIR=os.path.join(base, "datasets"),
                                   **MANIFEST_ENV, **extra),
                         300, f"phase 14 (a) {label}", want_exit=want_exit)
        wall = time.perf_counter() - t0
        for rank, out in enumerate(logs):
            for line in out.splitlines():
                log(f"  {label} rank {rank} | {line}")
        return logs, wall

    cfg = MiningConfig()
    pickles = [cfg.recommendations_file, cfg.best_tracks_file, cfg.artists_mapping_file,
               cfg.track_info_file]
    npz = cfg.recommendations_file + artifacts.TENSOR_ARTIFACT_SUFFIX

    def published(base: str) -> dict:
        names = pickles + [npz, artifacts.EMBEDDINGS_FILENAME]
        files = {}
        for name in names:
            with open(os.path.join(base, "pickles", name), "rb") as fh:
                files[name] = fh.read()
        return {"bytes": files,
                "manifest": artifacts.load_manifest(os.path.join(base, "pickles"))["files"]}

    one = pvc("pvc_sharded_one")
    one_out, one_s = job_process(one, "phase 14 one card", **MANIFEST_ENV)
    first = pvc("pvc_sharded_a")
    logs, first_s = ranks_job(first, "sharded")
    for rank, out in enumerate(logs):
        if "Pair-count path: sharded-vocab-gspmd" not in out or "NOTE:" in out:
            fail(f"phase 14 (a) rank {rank}: not 'Pair-count path: sharded-vocab-gspmd', or a "
                 f"NOTE: {[l for l in out.splitlines() if 'Pair-count' in l or 'NOTE' in l]}")
        if "ALS embeddings trained" not in out:
            fail(f"phase 14 (a) rank {rank} trained no embeddings")
    a, b = published(first), published(one)
    for name in pickles:
        if (artifacts.load_pickle(os.path.join(first, "pickles", name))
                != artifacts.load_pickle(os.path.join(one, "pickles", name))):
            fail(f"phase 14 (a): {name} of the sharded job differs from the one-card job's")
        if a["manifest"][name] != b["manifest"][name]:
            fail(f"phase 14 (a): the manifest's {name} entry differs from the one-card job's")
    x = np.load(os.path.join(first, "pickles", npz), allow_pickle=True)
    y = np.load(os.path.join(one, "pickles", npz), allow_pickle=True)
    if x.files != y.files or not all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]) for k in x.files):
        fail("phase 14 (a): the npz twin differs from the one-card job's, member by member")
    if a["manifest"][npz] != b["manifest"][npz]:
        fail("phase 14 (a): the manifest's npz entry differs from the one-card job's")
    ea = np.load(os.path.join(first, "pickles", artifacts.EMBEDDINGS_FILENAME), allow_pickle=True)
    eb = np.load(os.path.join(one, "pickles", artifacts.EMBEDDINGS_FILENAME), allow_pickle=True)
    fa, fb = ea["item_factors"], eb["item_factors"]
    if list(ea["vocab"]) != list(eb["vocab"]) or not np.allclose(
            fa, fb, rtol=ALS_LAYOUT_RTOL, atol=ALS_LAYOUT_ATOL):
        fail(f"phase 14 (a): sharded factors outside rtol {ALS_LAYOUT_RTOL} atol "
             f"{ALS_LAYOUT_ATOL} of the one-card training (max |Δ| "
             f"{float(np.abs(fa - fb).max())})")
    factor_diff = float(np.abs(fa - fb).max())
    loss_rel = abs(float(ea["final_loss"]) - float(eb["final_loss"])) / abs(float(eb["final_loss"]))
    second = pvc("pvc_sharded_b")
    _, second_s = ranks_job(second, "sharded again")
    if published(second)["bytes"][artifacts.EMBEDDINGS_FILENAME] != \
            a["bytes"][artifacts.EMBEDDINGS_FILENAME]:
        fail("phase 14 (a): a second sharded run's embeddings.npz differs")
    killed = pvc("pvc_sharded_killed")
    ranks_job(killed, "sharded killed after mine", want_exit=75,
              KMLS_FAULT_MINE_CRASH_PHASE="mine")
    logs, resume_s = ranks_job(killed, "sharded resumed")
    if not all("Resumed phase 'mine' from checkpoint" in out for out in logs):
        fail("phase 14 (a): a rank did not resume the mine from its checkpoint")
    got = published(killed)
    if got["bytes"] != a["bytes"] or got["manifest"] != a["manifest"]:
        fail("phase 14 (a): the resumed run's bytes differ from the uninterrupted run's: "
             f"{sorted(k for k in a['bytes'] if got['bytes'].get(k) != a['bytes'][k])}")
    # the replicated layout, no count path pinned: the reference's dense
    # sharded count on the job's auto mesh, held against phase 4's publication
    base4 = ds2_pvc(work)
    replicated = pvc("pvc_replicated")
    t0 = time.perf_counter()
    logs = run_ranks([[sys.executable, "-m", "kmlserver_tpu_torch.mining.job"]] * RANKS,
                     rank_envs(free_port(), BASE_DIR=replicated,
                               DATASETS_DIR=os.path.join(replicated, "datasets")),
                     300, "phase 14 (a) replicated")
    replicated_s = time.perf_counter() - t0
    for rank, out in enumerate(logs):
        for line in out.splitlines():
            log(f"  replicated rank {rank} | {line}")
        n = [int(l.rsplit(":", 1)[1]) for l in out.splitlines()
             if l.startswith("Popcount kernel launches:")]
        if "Pair-count path: sharded-dense-gspmd" not in out or "NOTE:" in out or n != [0]:
            fail(f"phase 14 (a) replicated rank {rank}: not 'Pair-count path: "
                 f"sharded-dense-gspmd' without a NOTE and 0 popcount launches ({n})")
    if not same_publication(base4, replicated):
        fail("phase 14 (a): the replicated two-rank job's publication differs from phase 4's")
    log(f"phase 14 (a) the replicated job on {RANKS} ranks, unpinned: sharded-dense-gspmd, "
        f"no NOTE, 0 popcount launches; pickles and npz == phase 4's; {replicated_s:.3f} s")
    log(f"phase 14 (a) the manifest's job on {RANKS} ranks: sharded-vocab-gspmd, no NOTE; "
        f"pickles, npz (member by member) and their manifest entries == the one-card job's; "
        f"factors max |Δ| {factor_diff:.3g} (bar rtol {ALS_LAYOUT_RTOL}, atol "
        f"{ALS_LAYOUT_ATOL}), loss rel {loss_rel:.3g}; second run's embeddings.npz byte-equal; "
        f"killed after mine, resumed to the same bytes; wall {first_s:.3f} s ranks, "
        f"{one_s:.3f} s one card, {resume_s:.3f} s resume")
    return {"ranks_s": first_s, "one_card_s": one_s, "second_s": second_s,
            "resume_s": resume_s, "replicated_s": replicated_s,
            "factor_max_abs_diff": factor_diff, "loss_rel": loss_rel}


def emission_bound(rows: int, cols: int, k: int) -> tuple[float, str]:
    """(ms, what binds) for one slab emission: the int32 slab read once and
    the four outputs written once over the HBM rate (its comparisons are
    few beside those bytes)."""
    nbytes = 4 * rows * cols + 2 * 4 * rows * k + 2 * 4 * rows
    return 1e3 * nbytes / PEAK_BYTES_PER_S, "bytes"


def sharded_in_process(work: str) -> dict:
    """Phase 14 (b): the ds2 baskets on the ranks' meshes (``1x2``, then
    ``2x2`` on four ranks)."""
    worker = [sys.executable, os.path.abspath(__file__), "--rank-worker", "sharded", work]
    result = {}
    for world in (RANKS, 4):
        t0 = time.perf_counter()
        outs = run_ranks([worker] * world, rank_envs(free_port(), world), 300,
                         f"phase 14 (b) {world} ranks")
        for r, out in enumerate(outs):
            res = rank_result(out, r)
            for impl, c in res["impls"].items():
                if not (c["counts_eq_single"] and c["counts_eq_plain"] and c["emit_eq_single"]):
                    fail(f"phase 14 (b) {res['mesh']} rank {r} {impl}: {c}")
                key = "sharded_counts_ring" if impl == "ring" else "sharded_counts_allgather"
                if c["calls"][key] != 2 or c["calls"]["sharded_emit"] != 1:
                    fail(f"phase 14 (b) {res['mesh']} rank {r} {impl}: calls {c['calls']}")
            for label, m in res["mines"].items():
                want = ("sparse-sharded" if label == "sparse-sharded"
                        else f"sharded-dense-{label.split('-', 1)[1]}")
                if m["count_path"] != want or not m["eq_one_card"]:
                    fail(f"phase 14 (b) {res['mesh']} rank {r} {label}: {m}")
                if label == "sparse-sharded" and (m["launches"]["popcount_pairs"] < 1 or
                                                  m["calls"]["sparse_sharded_counts"] != 1):
                    fail(f"phase 14 (b) {res['mesh']} rank {r}: the sparse-sharded route's "
                         f"launches {m['launches']}, calls {m['calls']}")
            full_bytes = 4 * WIDE_V * WIDE_V
            for label, w in res["wide"].items():
                if not (w["slab_eq_full_rows"] and w["emit_eq_one_card"] in (None, True)
                        and w["count_peak_bytes"] < full_bytes):
                    fail(f"phase 14 (b) wide sparse-sharded on {label}, rank {r}: {w} (one "
                         f"(V, V) int32 count: {full_bytes} B)")
            if world == 4 and (res["wide"]["1x4"]["count_peak_bytes"]
                               > 0.6 * res["wide"]["2x2"]["count_peak_bytes"]):
                fail(f"phase 14 (b) wide sparse-sharded, rank {r}: peak memory does not fall "
                     f"with V/tp: {res['wide']}")
            log(f"  rank {r} wide sparse-sharded (V {WIDE_V}): slab == the one-card count's "
                f"rows; count peak " + ", ".join(
                    f"{label} {w['count_peak_bytes']} B" for label, w in res["wide"].items())
                + f" (one (V, V) int32 count {full_bytes} B)")
            result[f"{res['mesh']}.rank{r}"] = res
        log(f"phase 14 (b) {res['mesh']} on {world} ranks ({time.perf_counter() - t0:.3f} s): "
            f"every schedule's counts == one-card C == plain, emission == one-card; "
            + "; ".join(f"{label}: {m['count_path']} (launches {m['launches']}, calls "
                        f"{m['calls']}) == one card's {m['one_card_path']}"
                        for label, m in res["mines"].items()))
    return result


def sharded_scale(work: str, one_card_loss: float | None) -> dict:
    """Phase 14 (c): the scale shape on two ranks (``1x2``)."""
    from kmlserver_tpu_torch.mining import als as als_mod
    from kmlserver_tpu_torch.parallel.mesh import round_up

    worker = [sys.executable, os.path.abspath(__file__), "--rank-worker", "sharded_scale", work]
    log(f"phase 14 (c) host MemAvailable {host_free_gib():.1f} GiB before the ranks start")
    t0 = time.perf_counter()
    outs = run_ranks([worker] * RANKS, rank_envs(free_port()), 600, "phase 14 (c)")
    wall = time.perf_counter() - t0
    results = [rank_result(out, r) for r, out in enumerate(outs)]
    want = np.load(os.path.join(work, "scale_tensors.npz"))
    for impl in ("allgather", "ring"):
        got = np.load(os.path.join(work, f"sharded_{impl}.npz"))
        for key in got.files:
            if not np.array_equal(got[key], want[key]):
                fail(f"phase 14 (c) {impl}: {key} differs from phase 5's one-card emission")
    t = results[0]["times"]
    if not (t["product_eq_plain"] and t["emit_eq_plain"]):
        fail(f"phase 14 (c): the local product or the emission differs from its plain version: {t}")
    p, v, nnz = results[0]["shape"]
    v_loc, p_loc, v_pad = results[0]["v_loc"], results[0]["p_loc"], results[0]["v_pad"]
    bound = product_bound(2 * v_loc * v_pad * p_loc, (v_loc + v_pad) * p_loc + 4 * v_loc * v_pad)
    ring_bound = product_bound(2 * v_loc * v_loc * p_loc, 2 * v_loc * p_loc + 4 * v_loc * v_loc)
    emit_bound = emission_bound(v_loc, v_pad, SHARDED_K)
    # one rank's share of the sharded training: its (P, V/tp) block
    first_als = results[0]["als"]
    als_bound = als_dense_bound(p, round_up(v, RANKS) // RANKS, first_als["rank"],
                                first_als["iters"])
    block_bytes = v_loc * p_loc
    for r, res in enumerate(results):
        for impl, route in res["routes"].items():
            moved = block_bytes * (RANKS - 1)
            coll = route["phases"].get("all_gather" if impl == "allgather" else "ring", 0.0)
            log(f"  rank {r} {impl}: {route['wall_s']:.3f} s wall ("
                + ", ".join(f"{k} {v_:.3f} s" for k, v_ in route["phases"].items())
                + f"); collective {coll:.3f} s for {moved} B received "
                f"({moved / max(coll, 1e-9) / 1e9:.3f} GB/s); calls {route['calls']}; "
                f"peak device memory {route['peak_gib']:.3f} GiB")
        tr = res["times"]
        log(f"  rank {r} local product ({v_loc} x {p_loc}) x ({v_pad} x {p_loc})ᵀ "
            f"{tr['product_ms']:.3f} ms (CUDA events; bound {bound[0]:.3f} ms, {bound[1]}); "
            f"ring step {tr['ring_step_ms']:.3f} ms (bound {ring_bound[0]:.3f} ms); emission "
            f"{tr['emit_ms']:.3f} ms (bound {emit_bound[0]:.4f} ms, bytes); ALS "
            f"{res['als']['storage']} shards {res['als']['shards']} (training bound "
            f"{als_bound['ms']:.3f} ms, {als_bound['bound_by']}), "
            f"{len(res['als']['sweep_s'])} sweeps {res['als']['sweep_s']}, final loss "
            f"{res['als']['final_loss']}, peak {res['als']['peak_gib']:.3f} GiB; host "
            f"MemAvailable {res['host_free_gib_start']:.1f} / {res['host_free_gib_als']:.1f} GiB")
    recount = check_sharded_recount(work, results)
    als_ = [res["als"] for res in results]
    if (any(a["shards"] != RANKS or not a["finite"] or a["calls"] != a["iters"] for a in als_)
            or len({a["factors_sha"] for a in als_}) != 1):
        fail(f"phase 14 (c) sharded ALS: {als_}")
    # a rank holds its X block and one chunk of the loss's residual, never
    # a second block
    x_block = 4 * p * (round_up(v, RANKS) // RANKS)
    als_limit = x_block + 2 * 4 * als_mod._LOSS_CHUNK_ELEMS
    if any(a["peak_gib"] * 2**30 >= als_limit for a in als_):
        fail(f"phase 14 (c) sharded ALS peak {[a['peak_gib'] for a in als_]} GiB per rank, "
             f"want below the X block ({x_block} B) and two loss chunks: {als_limit} B")
    log(f"phase 14 (c) scale shape {p} x {v} ({nnz} memberships) on 1x{RANKS} ranks, {wall:.3f} s "
        f"wall: allgather and ring emissions == phase 5's one-card emission; rank 0's product == "
        f"int8_gram_plain ({t['plain_ms']:.3f} ms, chunked float64) and torch._int_mm on the whole "
        f"one-hot {t['library_ms']:.3f} ms; emission == its CPU plain version "
        f"({t['emit_plain_ms']:.3f} ms); sharded ALS loss {als_[0]['final_loss']} (phase 11 (c)'s "
        f"one-card sparse training at 1M x 1M: {one_card_loss})")
    return {"ranks": results, "wall_s": wall, "bound_ms": bound[0], "bound_by": bound[1],
            "ring_step_bound_ms": ring_bound[0], "emit_bound_ms": emit_bound[0],
            "als_bound_ms": als_bound["ms"], "als_bound_by": als_bound["bound_by"],
            "recount": recount}


def check_sharded_recount(work: str, results: list[dict]) -> dict:
    """Phase 14 (c)'s A.8.2 recount: every rank's rows equal phase 12 (b)'s
    one-card rows, one sharded call each, and a rank's peak below the one-card
    route's (it holds its ``V/tp`` block of the one-hot, never the whole);
    each rank's product against its int8 bound, its exchange and its peak
    logged."""
    with open(os.path.join(work, "recount_peak.json")) as fh:
        one_card_peak = json.load(fh)["peak_device_bytes"]
    rows = []
    for r, res in enumerate(results):
        rc = res["recount"]
        v_pad = rc["v_loc"] * RANKS
        whole = (v_pad + rc["r_pad"]) * rc["p_loc"]  # the one-card route's operands
        if (not rc["eq_one_card"] or rc["calls"]["restricted_recount_sharded"] != 1
                or rc["peak_bytes"] >= min(one_card_peak, whole)):
            fail(f"phase 14 (c) recount over the ranks, rank {r}: {rc} (one-card peak "
                 f"{one_card_peak} B, one-card operands {whole} B)")
        bound = recount_bound(rc["r_pad"], rc["v_loc"], rc["p_loc"])
        exchange_s = rc["phases"].get("all_reduce", 0.0) + rc["phases"].get("gather_counts", 0.0)
        received = 4 * rc["r_pad"] * rc["v_loc"] * (RANKS - 1)
        rows.append({"rank": r, "product_ms": rc["product_ms"], "bound_ms": bound["ms"],
                     "bound_by": bound["bound_by"], "exchange_s": exchange_s,
                     "exchange_bytes": received, "peak_bytes": rc["peak_bytes"],
                     "wall_s": rc["wall_s"]})
        log(f"  rank {r} recount (A.8.2) R {rc['r']} x V_loc {rc['v_loc']} x P {rc['p_loc']}: "
            f"rows == phase 12 (b)'s one-card rows; {rc['wall_s']:.3f} s wall ("
            + ", ".join(f"{k} {v:.3f} s" for k, v in rc["phases"].items())
            + f"); product {rc['product_ms']:.3f} ms (CUDA events; bound {bound['ms']:.3f} ms, "
            f"{bound['bound_by']}); exchange {exchange_s:.3f} s for {received} B received; peak "
            f"{rc['peak_bytes']} B (one-card route {one_card_peak} B)")
    return {"ranks": rows, "one_card_peak_bytes": one_card_peak}


def phase_sharded(work: str | None = None, one_card_loss: float | None = None,
                  shape: dict | None = None) -> dict:
    """Phase 14: vocab-sharded mining on ranks sharing the card (alone:
    ``python -c "import chip_smoke as c; c.phase_sharded()"`` writes its own
    ds2 PVC and scale baskets at ``shape``, default the full scale shape)."""
    import torch

    from kmlserver_tpu_torch.data.csv import write_tracks_csv
    from kmlserver_tpu_torch.data.synthetic import DS2_SHAPE, synthetic_baskets, synthetic_table

    t0 = time.perf_counter()
    own = work is None
    work = work or tempfile.mkdtemp(prefix="kmls_smoke14_")
    try:
        backend = predicted_backend()
        log(f"phase 14 case: {RANKS} and 4 ranks "
            + ("over nccl" if backend == "nccl" else "sharing cuda:0 over gloo")
            + f" ({torch.cuda.device_count()} card(s) visible)")
        csv_src = os.path.join(work, "pvc", "datasets", FRESH_CSV)  # phase 4's
        if not os.path.exists(csv_src):
            os.makedirs(os.path.dirname(csv_src))
            write_tracks_csv(csv_src, synthetic_table(**DS2_SHAPE, seed=7))
        if not os.path.exists(os.path.join(work, "scale_tensors.npz")):
            from kmlserver_tpu_torch.config import MiningConfig
            from kmlserver_tpu_torch.mining.miner import mine

            baskets = synthetic_baskets(**(shape or SCALE), seed=2024, device="cuda")
            np.save(os.path.join(work, "scale_rows.npy"), baskets.playlist_rows)
            np.save(os.path.join(work, "scale_tids.npy"), baskets.track_ids)
            with open(os.path.join(work, "scale_shape.json"), "w") as fh:
                json.dump({"n_playlists": baskets.n_playlists, "n_tracks": baskets.n_tracks}, fh)
            save_tensors(work, mine(baskets, MiningConfig(min_support=SCALE_MIN_SUPPORT)).tensors)
            del baskets
            torch.cuda.empty_cache()
            log(f"phase 14: scale baskets {shape or SCALE} generated (seed 2024) and mined")
        if not os.path.exists(os.path.join(work, "recount_rows.npy")):
            freshness_scale(work)  # (c) recounts phase 12 (b)'s rows
        t_a = time.perf_counter()
        job = sharded_manifest_job(work, csv_src)
        t_b = time.perf_counter()
        in_process = sharded_in_process(work)
        t_c = time.perf_counter()
        scale = sharded_scale(work, one_card_loss)
        t_end = time.perf_counter()
        result = {"job": job, "ds2": in_process, "scale": scale,
                  "seconds": {"a": t_b - t_a, "b": t_c - t_b, "c": t_end - t_c,
                              "phase": t_end - t0}}
        log(f"phase 14 seconds {t_end - t0:.3f} ((a) {t_b - t_a:.3f}, (b) {t_c - t_b:.3f}, "
            f"(c) {t_end - t_c:.3f})")
        log("PHASE14 " + json.dumps(result, default=str))
        return result
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 15

MESH_SHARDS = (2, 3, 4)  # X9's shard counts: 3 leaves both vocabularies no multiple of S
MESH_TIMED_SHARDS = (2, 4)
MESH_SERVE_SHARDS = 2  # the (b) engine's slabs
MESH_REQUESTS = 1000  # per run; config 5's meshserve bracket sends 4,000 (bench.py:3502-3503)
MESH_QPS = 500.0
MESH_DRAWS = 2000  # (b): config-5 draws through the sharded engine
MESH_PROBES = 300  # fresh draws checked after the re-form and after the delta
MESH_SETTLE = 20  # of those after the re-form, sent one at a time (gang_on_card)
MESH_HEDGE_DELAY_MS = "500"  # the gang's straggler floor: only the armed fault crosses it
MESH_FAULT_MS = 1500  # the armed mesh.peer delay on the respawned rank 1
X9_V, X9_K = 1_000_000, 256  # BASELINE config 4's catalog at K_max = 256
X9_SEED = 15
X9_SCALE_BUCKETS = ((1, 8), (8, 8), (32, 8), (32, 128))
X9_CPU_BUCKET = (2, 8)  # the 1M CPU run's bucket (the CPU sorts B x 1M scores per shard)


def serve_shard_bound(seeds, shard_size: int, k_max: int, v_pad: int, k_best: int) -> dict:
    """The least time of X9 for one batch: bytes over the memory rate. The
    seeds read once; per shard the rule rows of the distinct seeds it holds
    (ids and confidences, ``8·K`` bytes a row), its ``(B, V_pad + 1)``
    float32 scores written and read once, its ``(B, k)`` partial written;
    the merge reads the S partials and writes the answer."""
    b, length = seeds.shape
    uniq = np.unique(seeds[seeds >= 0])
    n_shards = v_pad // shard_size
    nbytes = (4 * b * length + 8 * k_max * len(uniq)
              + n_shards * (2 * 4 * b * (v_pad + 1) + 8 * b * k_best)
              + n_shards * 8 * b * k_best + 8 * b * k_best)
    return {"ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes", "bytes": nbytes}


def device_slabs(ids, confs, n_shards: int):
    """The rule tensors cut into ``n_shards`` slabs on their device, the
    vocabulary padded with empty rows (only the last slab is copied) →
    (slab ids, slab confs, V_loc)."""
    import torch

    v, k = ids.shape
    v_loc = -(-v // n_shards)
    slab_ids, slab_confs = [], []
    for s in range(n_shards):
        a, b = ids[s * v_loc:(s + 1) * v_loc], confs[s * v_loc:(s + 1) * v_loc]
        if a.shape[0] < v_loc:
            pad = v_loc - a.shape[0]
            a = torch.cat([a, torch.full((pad, k), -1, dtype=a.dtype, device=a.device)])
            b = torch.cat([b, torch.zeros((pad, k), dtype=b.dtype, device=b.device)])
        slab_ids.append(a)
        slab_confs.append(b)
    return slab_ids, slab_confs, v_loc


def x9_rules_1m():
    """Synthetic rule tensors at V = 1M rows x K_max = 256, on the card
    from a numpy seed: consequent ids Zipf-distributed (``floor(V^u)``, u
    uniform: P(id < x) ≈ ln x / ln V, Zipf 1.0), each row's confidences
    descending, trailing rows of -1 / 0 past a uniform row length."""
    import torch

    seed = int(np.random.default_rng(X9_SEED).integers(2**31))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand((X9_V, X9_K), generator=gen, device="cuda")
    ids = (torch.pow(float(X9_V), u) - 1).to(torch.int32).clamp_(0, X9_V - 1)
    u.uniform_(generator=gen)
    confs = torch.sort(u, dim=1, descending=True).values
    del u
    lengths = torch.randint(0, X9_K + 1, (X9_V, 1), generator=gen, device="cuda")
    dead = torch.arange(X9_K, device="cuda")[None, :] >= lengths
    ids.masked_fill_(dead, -1)
    confs.masked_fill_(dead, 0.0)
    del dead, lengths
    return ids, confs, seed


def x9_case(label: str, ids, confs, cpu_ids, cpu_confs, buckets, k_best: int, gen,
            timed: bool, cpu_buckets) -> list[dict]:
    """X9 on one set of rule tensors: at every bucket and shard count, the
    sharded lookup (the slabs' partials and the merge) bit-identical to
    ``recommend_batch`` on the whole tensors, and at ``cpu_buckets`` to the
    CPU run of both; with ``timed``, CUDA-event times of the whole sharded
    lookup, one slab's partial and the merge beside the replicated lookup
    and the bound."""
    import torch

    from kmlserver_tpu_torch.ops import serve

    v, k_max = ids.shape
    rows = []
    for n_shards in MESH_SHARDS:
        slab_ids, slab_confs, v_loc = device_slabs(ids, confs, n_shards)
        v_pad = v_loc * n_shards
        for batch, length in buckets:
            seeds = torch.randint(0, v, (batch, length), generator=gen).to(torch.int32)
            seeds[0, length // 2:] = -1
            dev_seeds = seeds.cuda()
            want = serve.recommend_batch(ids, confs, dev_seeds, k_best=k_best)
            got = serve.sharded_recommend(slab_ids, slab_confs, dev_seeds, k_best=k_best)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                fail(f"phase 15 (a) {label} S={n_shards} {batch}x{length}: the sharded lookup "
                     "differs from recommend_batch on the whole tensors")
            row = {"label": label, "shards": n_shards, "batch": batch, "length": length}
            if (batch, length) in cpu_buckets and n_shards in (2, 3):
                c_ids, c_confs, _ = device_slabs(cpu_ids, cpu_confs, n_shards)
                cpu = serve.sharded_recommend(c_ids, c_confs, seeds, k_best=k_best)
                cpu_whole = serve.recommend_batch(cpu_ids, cpu_confs, seeds, k_best=k_best)
                if not all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu)) or not all(
                        torch.equal(a, b) for a, b in zip(cpu, cpu_whole)):
                    fail(f"phase 15 (a) {label} S={n_shards} {batch}x{length}: the card's "
                         "sharded lookup differs from the CPU run")
                row["cpu_checked"] = True
            if timed and n_shards in MESH_TIMED_SHARDS:
                reps = 10 if v < 100_000 else 3
                row["ms"] = cuda_ms(lambda: serve.sharded_recommend(
                    slab_ids, slab_confs, dev_seeds, k_best=k_best), reps)
                row["partial_ms"] = cuda_ms(lambda: serve.shard_partial_topk(
                    slab_ids[0], slab_confs[0], dev_seeds, 0, v=v_pad, k_best=k_best), reps)
                parts = [serve.shard_partial_topk(slab_ids[s], slab_confs[s], dev_seeds,
                                                  s * v_loc, v=v_pad, k_best=k_best)
                         for s in range(n_shards)]
                stack_ids = torch.stack([p[0] for p in parts])
                stack_confs = torch.stack([p[1] for p in parts])
                row["merge_ms"] = cuda_ms(lambda: serve.merge_partial_topk(
                    stack_ids, stack_confs, v=v_pad, k_best=k_best), reps)
                row["replicated_ms"] = cuda_ms(lambda: serve.recommend_batch(
                    ids, confs, dev_seeds, k_best=k_best), reps)
                bound = serve_shard_bound(seeds.numpy(), v_loc, k_max, v_pad, k_best)
                row["bound_ms"], row["bound_by"] = bound["ms"], bound["bound_by"]
                if row["ms"] < bound["ms"]:
                    fail(f"phase 15 (a) {label}: {row} is below its bound")
            rows.append(row)
        del slab_ids, slab_confs
    return rows


def x9_on_card(pvc: str) -> dict:
    """Phase 15 (a): X9 on the ds2 rule tensors at every (batch, length)
    bucket — and once with ``k_best`` above V — and on the 1M x 256
    synthetic rules at :data:`X9_SCALE_BUCKETS`, each against
    ``recommend_batch`` and the CPU run; times beside the replicated lookup
    and :func:`serve_shard_bound`."""
    import torch

    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.io import artifacts
    from kmlserver_tpu_torch.serving.engine import RecommendEngine

    t0 = time.perf_counter()
    cfg = ServingConfig(base_dir=pvc)
    arrays = artifacts.load_rule_tensors(artifacts.tensor_artifact_path(
        os.path.join(cfg.pickles_dir, cfg.recommendations_file)))
    from kmlserver_tpu_torch.serving.engine import _host_rule_arrays

    _, _, host_ids, host_confs = _host_rule_arrays(arrays)
    cpu_ids, cpu_confs = torch.from_numpy(host_ids), torch.from_numpy(host_confs)
    ids, confs = cpu_ids.cuda(), cpu_confs.cuda()
    probe = RecommendEngine(cfg, device="cpu")
    buckets = [(b, n) for n in probe._len_buckets() for b in probe._batch_buckets()]
    gen = torch.Generator().manual_seed(X9_SEED)
    k_best = cfg.k_best_tracks
    ds2 = x9_case("ds2", ids, confs, cpu_ids, cpu_confs, buckets, k_best, gen, True, buckets)
    over = x9_case("ds2 k_best > V", ids, confs, cpu_ids, cpu_confs, [(4, 8)],
                   ids.shape[0] + 7, gen, False, [(4, 8)])
    t_ds2 = time.perf_counter() - t0
    t1 = time.perf_counter()
    big_ids, big_confs, seed = x9_rules_1m()
    nbytes = big_ids.nbytes + big_confs.nbytes
    big_cpu = (big_ids.cpu(), big_confs.cpu())
    scale = x9_case("1M", big_ids, big_confs, *big_cpu, X9_SCALE_BUCKETS, k_best, gen, True,
                    [X9_CPU_BUCKET])
    scale += x9_case("1M cpu", big_ids, big_confs, *big_cpu, [X9_CPU_BUCKET], k_best, gen,
                     False, [X9_CPU_BUCKET])
    del big_ids, big_confs, big_cpu
    torch.cuda.empty_cache()
    t_scale = time.perf_counter() - t1
    n_cpu = sum(1 for r in ds2 + over + scale if r.get("cpu_checked"))
    log(f"phase 15 (a) X9 on the card: ds2 rules ({ids.shape[0]} x {ids.shape[1]}) at "
        f"{len(buckets)} buckets x S in {MESH_SHARDS}, and k_best {ids.shape[0] + 7} > V; "
        f"synthetic {X9_V} x {X9_K} ({nbytes} B, Zipf ids from seed {X9_SEED} → torch seed "
        f"{seed}) at {X9_SCALE_BUCKETS}: every sharded lookup == recommend_batch on the whole "
        f"tensors, and == the CPU run at {n_cpu} (bucket, S) cases; {t_ds2:.3f} s + "
        f"{t_scale:.3f} s")
    log("reduced: phase 15 (a) places every slab on cuda:0 (the machine has one H100); a "
        "slab's partial runs in turn on one stream, so the whole lookup's time is the sum")
    for row in ds2 + scale:
        if "ms" in row:
            log(f"  X9 {row['label']} S={row['shards']} {row['batch']}x{row['length']}: sharded "
                f"{row['ms']:.4f} ms (one partial {row['partial_ms']:.4f}, merge "
                f"{row['merge_ms']:.4f}) vs replicated {row['replicated_ms']:.4f} ms; bound "
                f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    return {"ds2": ds2, "over": over, "scale": scale, "scale_bytes": nbytes,
            "seconds": {"ds2": t_ds2, "scale": t_scale}}


def sharded_engine(cfg, n_shards: int):
    """A ``RecommendEngine`` on the card whose serving devices are
    ``[cuda:0] * n_shards`` (the machine has one card)."""
    import torch

    from kmlserver_tpu_torch.serving.engine import RecommendEngine

    engine = RecommendEngine(cfg, device="cuda")
    devices = [torch.device("cuda", 0)] * n_shards
    engine._serve_devices = lambda: devices
    return engine


def sharded_on_card(pvc: str, keys: list, cpu) -> tuple[dict, object]:
    """Phase 15 (b): the ``sharded`` engine on the card (two slabs on
    cuda:0) under config 5's draws against the replicated CPU engine; the
    compile watch, the shard series; the ``auto`` layout's budget flip.
    → (result, the engine, kept for (d))."""
    import dataclasses as dc

    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.ops import serve
    from kmlserver_tpu_torch.serving.app import RecommendApp
    from kmlserver_tpu_torch.serving.replay import sample_seed_sets

    t0 = time.perf_counter()
    cfg = ServingConfig(base_dir=pvc, model_layout="sharded", delta_enabled=True)
    engine = sharded_engine(cfg, MESH_SERVE_SHARDS)
    if not engine.load() or engine.model_layout != "sharded" or (
            engine.n_shards != MESH_SERVE_SHARDS):
        fail(f"phase 15 (b): the sharded engine did not publish {MESH_SERVE_SHARDS} slabs")
    draws = sample_seed_sets(keys, MESH_DRAWS, rng_seed=15)
    want = engine_answers(cpu, draws)
    # the main path: the counts to 0, the draws, the counts read
    for key in serve.CALLS:
        serve.CALLS[key] = 0
    got = engine_answers(engine, draws)
    calls = dict(serve.CALLS)
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        fail(f"phase 15 (b): answer for {draws[bad]} {got[bad]} != the CPU engine's {want[bad]}")
    if min(calls.values()) < 1:
        fail(f"phase 15 (b): X9 calls {calls}")
    compiles = engine.cost_model.compiles_post_publish()
    app = RecommendApp(cfg, engine=engine, device="cuda", defer_batcher=True)
    try:
        text = app.handle("GET", "/metrics", None)[2].decode()
    finally:
        app.close()
    shards = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
              if line.startswith("kmls_shard_dispatch_total{")]
    if (engine.unwarmed_dispatches or any(compiles.values())
            or f"kmls_model_shards {MESH_SERVE_SHARDS}" not in text
            or len(shards) != MESH_SERVE_SHARDS or min(shards) <= 0):
        fail(f"phase 15 (b): unwarmed {engine.unwarmed_dispatches}, compiles {compiles}, "
             f"shard series {shards}")
    layouts = {}
    for label, budget in (("default budget", cfg.device_budget_bytes), ("tight budget", None)):
        auto_cfg = dc.replace(cfg, model_layout="auto", delta_enabled=False)
        if budget is None:  # one byte below the measured (unpadded) rule tensors
            budget = int(cpu.bundle.rule_ids.nbytes + cpu.bundle.rule_confs.nbytes) - 1
        auto = sharded_engine(dc.replace(auto_cfg, device_budget_bytes=budget), MESH_SERVE_SHARDS)
        if not auto.load():
            fail(f"phase 15 (b): the auto engine ({label}) did not load")
        layouts[label] = (auto.model_layout, budget)
    if (layouts["default budget"][0] != "replicated" or layouts["tight budget"][0] != "sharded"):
        fail(f"phase 15 (b): KMLS_MODEL_LAYOUT=auto resolved {layouts}")
    seconds = time.perf_counter() - t0
    log(f"phase 15 (b) sharded engine on the card ({MESH_SERVE_SHARDS} slabs of "
        f"{engine.bundle.shard_size} rows on cuda:0): {MESH_DRAWS} config-5 draws == the "
        f"replicated CPU engine's; X9 calls {calls}; unwarmed 0, compiles {compiles}; "
        f"kmls_model_shards {MESH_SERVE_SHARDS}, kmls_shard_dispatch_total {shards}; auto: "
        f"{layouts}; {seconds:.3f} s")
    log(f"reduced: phase 15 (b) passes the engine [cuda:0] * {MESH_SERVE_SHARDS} as its serving "
        "devices (one H100 on this machine)")
    return {"calls": calls, "shard_dispatch": shards, "layouts": layouts,
            "seconds": seconds}, engine


def gang_ports() -> int:
    """Two consecutive free localhost ports (rank r on base + r), probed
    as ``bench.py:3507-3523`` probes them."""
    import socket

    for _ in range(50):
        with socket.socket() as s0:
            s0.bind(("127.0.0.1", 0))
            base = s0.getsockname()[1]
        if base + 1 > 65535:
            continue
        try:
            with socket.socket() as s1:
                s1.bind(("127.0.0.1", base + 1))
            return base
        except OSError:
            continue
    fail("phase 15: no consecutive free port pair")


def gang_env(port: int, rank: int, **extra: str) -> dict:
    """A gang member's env: the quartet, the cache off (every answer goes
    through the mesh), deltas polled, and the straggler bound armed."""
    return dict(KMLS_SERVE_GANG_COORDINATOR=f"127.0.0.1:{port}", KMLS_SERVE_GANG_SIZE="2",
                KMLS_SERVE_GANG_RANK=str(rank), KMLS_SERVE_GANG_PORT=str(port + rank),
                KMLS_CACHE_ENABLED="0", KMLS_DELTA_ENABLED="1", POLLING_WAIT_IN_MINUTES=FRESH_POLL,
                KMLS_HEDGE="1", KMLS_HEDGE_DELAY_MS=MESH_HEDGE_DELAY_MS, **extra)


def readyz(base: str) -> dict:
    try:
        with urllib.request.urlopen(base + "/readyz", timeout=10) as resp:
            return json.loads(resp.read())
    except (urllib.error.URLError, ConnectionError) as exc:
        return {"status": f"unreachable: {exc}"}


def wait_gang_ready(bases: list[str], timeout_s: float) -> float:
    """Until every member's ``/readyz`` says ``ready`` (its probe re-admits
    a peer that came up after it) → seconds waited."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if all(readyz(b).get("status") == "ready" for b in bases):
            return time.perf_counter() - t0
        time.sleep(0.05)
    fail(f"phase 15: the gang never formed: {[readyz(b) for b in bases]}")


def server_unwarmed(lines: list[str]) -> int:
    return sum("unwarmed seed shape" in ln or "mesh partial for unwarmed" in ln for ln in lines)


def mesh_probe(base: str, seeds: list) -> tuple[int, dict, dict]:
    """One POST → (status, lower-cased headers, body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", int(base.rsplit(":", 1)[1]), timeout=30)
    try:
        conn.request("POST", "/api/recommend/", json.dumps({"songs": seeds}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, json.loads(body or b"{}")
    finally:
        conn.close()


def songs_check(label: str, base: str, payloads: list, want: list) -> None:
    """Every answer 200, not degraded, its songs ``want``'s (the payloads
    sent through the port's load generator at the replays' rate, so the
    admission ladder has no cause to degrade one)."""
    from kmlserver_tpu_torch.serving.replay import replay_async_http

    responses: list = []
    replay_async_http(base, payloads, qps=MESH_QPS, n_conns=CONFIG5_CONNS, responses=responses)
    if len(responses) != len(payloads):
        fail(f"phase 15 {label}: {len(payloads) - len(responses)} requests got no answer")
    for i, status, head, body in responses:
        songs = json.loads(body).get("songs") if status == 200 else None
        degraded = [ln for ln in head.split(b"\r\n") if ln.startswith(b"x-kmls-degraded:")]
        if status != 200 or degraded or songs != want[i][0]:
            fail(f"phase 15 {label}: {payloads[i]} → {status} {degraded} {body[:200]!r} != "
                 f"{want[i][0]}")


def gang_on_card(pvc: str, keys: list, cpu, spawned: list, port: int) -> tuple[dict, list]:
    """Phase 15 (c): the two gang members and one replicated server
    (spawned earlier over ``pvc``) under config 5's draws; SIGKILL of rank
    1, its respawn with ``mesh.peer`` armed once, the re-form. → (result,
    the live servers: rank 0, rank 1, replicated)."""
    from kmlserver_tpu_torch.serving.replay import sample_seed_sets

    t0 = time.perf_counter()
    servers = [await_server(s) for s in spawned]
    bases = [s[1] for s in servers]
    form_s = wait_gang_ready(bases[:2], 60)
    log(f"phase 15 (c): the gang formed and the replicated server ready "
        f"{time.perf_counter() - t0:.3f} s into the wait ({form_s:.3f} s of /readyz probes); "
        f"gang ports {port}, {port + 1}")
    if not any(ln.startswith("NOTE: serve gang rank 0/2: socket transport")
               for ln in servers[0][2]):
        fail("phase 15 (c): rank 0 logged no NOTE about the socket transport")
    payloads = sample_seed_sets(keys, MESH_REQUESTS, rng_seed=16)
    want = engine_answers(cpu, payloads)
    log(f"reduced: phase 15 (c) replays {MESH_REQUESTS} of config 5's draws a run, not the "
        "meshserve bracket's 4,000 (2,000 before phase 15 (e)): the smoke's time limit")
    runs = {}
    for label, (_, base, lines) in zip(("gang rank 0", "gang rank 1", "replicated"), servers):
        row = replay_run(base, f"(c) {label}", payloads, want, cpu, MESH_QPS, phase="phase 15",
                         ladder_lines=lines)
        if row["shed"] or row["errors"]:
            fail(f"phase 15 (c) {label}: {row}")
        runs[label] = row
    serving_key = 'kmls_serve_mesh_shards{state="serving"}'
    for rank, base in enumerate(bases[:2]):
        m = scrape_metrics(base)
        if m.get(serving_key) != 2 or m.get("kmls_model_shards") != 2:
            fail(f"phase 15 (c) rank {rank}: {serving_key} {m.get(serving_key)}, "
                 f"kmls_model_shards {m.get('kmls_model_shards')}")
    unwarmed = [server_unwarmed(s[2]) for s in servers]
    if any(unwarmed):
        fail(f"phase 15 (c): unwarmed dispatches {unwarmed}")
    # shard loss: SIGKILL rank 1, then seeds not sent before
    sent = {tuple(p) for p in payloads}
    fresh = [p for p in sample_seed_sets(keys, 4 * MESH_PROBES, rng_seed=17)
             if tuple(p) not in sent and not p[0].startswith("__")]
    servers[1][0].kill()
    servers[1][0].wait()
    for seeds in fresh[:3]:
        status, headers, _ = mesh_probe(bases[0], seeds)
        if status != 200 or headers.get("x-kmls-degraded") != "mesh-shard-missing:1":
            fail(f"phase 15 (c) after the kill: {status} {headers}")
    ready = readyz(bases[0])
    if ready.get("status") != "degraded" or (
            "serve_mesh_shard_missing:1" not in ready.get("reasons", [])):
        fail(f"phase 15 (c) after the kill: /readyz {ready}")
    # the respawn: the same env, mesh.peer armed for its first partial
    t_spawn = time.perf_counter()
    reborn = await_server(spawn_server(pvc, **gang_env(
        port, 1, KMLS_FAULT_MESH_PEER_DELAY_MS=f"1:{MESH_FAULT_MS}:1")))
    wait_gang_ready(bases[:1] + [reborn[1]], 60)
    reform_s = time.perf_counter() - t_spawn
    servers[1] = reborn
    status, headers, _ = mesh_probe(bases[0], fresh[3])
    if status != 200 or headers.get("x-kmls-degraded") != "mesh-straggler":
        fail(f"phase 15 (c) mesh.peer armed on rank 1: {status} {headers}")
    time.sleep(MESH_FAULT_MS / 1e3)  # the late partial lands; the link is free
    probes = fresh[4:4 + MESH_PROBES]
    want = engine_answers(cpu, probes)
    # the straggler's batch (the hedge delay long) sits in the admission
    # ladder's per-batch device-time EWMA, which only completions bring
    # down, as in the reference's batcher: at 500 QPS its projection would
    # degrade some of the next requests ("overload"). One request at a
    # time is admitted at zero projected wait and each completion shrinks
    # the estimate, so the first MESH_SETTLE probes go one by one.
    for seeds, (songs, *_rest) in zip(probes[:MESH_SETTLE], want):
        status, headers, body = mesh_probe(bases[0], seeds)
        if status != 200 or "x-kmls-degraded" in headers or body.get("songs") != songs:
            fail(f"phase 15 (c) after the re-form, one by one: {seeds} → {status} "
                 f"{headers.get('x-kmls-degraded')} {body} != {songs}")
    songs_check("(c) after the re-form", bases[0], probes[MESH_SETTLE:], want[MESH_SETTLE:])
    m = scrape_metrics(bases[0])
    result = {"runs": runs, "form_s": form_s, "reform_s": reform_s,
              "straggler_degraded": m.get("kmls_mesh_straggler_degraded_total"),
              "seconds": time.perf_counter() - t0}
    log(f"phase 15 (c) gang of two `python -m kmlserver_tpu_torch.serving.server` sharing the "
        f"card: {MESH_REQUESTS} config-5 draws at {MESH_QPS:.0f} QPS at each member == the CPU "
        f"engine's but {sum(r['degraded'] for r in runs.values())} degraded by the admission "
        f"ladder (each the fallback), 0 shed, 0 5xx, 0 unwarmed; client p50/p99 rank 0 "
        f"{runs['gang rank 0']['p50_ms']:.3f}/{runs['gang rank 0']['p99_ms']:.3f} ms, rank 1 "
        f"{runs['gang rank 1']['p50_ms']:.3f}/{runs['gang rank 1']['p99_ms']:.3f} ms, one "
        f"replicated server {runs['replicated']['p50_ms']:.3f}/{runs['replicated']['p99_ms']:.3f}"
        f" ms; rank 1 SIGKILLed: 200 + X-KMLS-Degraded: mesh-shard-missing:1, /readyz "
        f"{ready['reasons']}; respawned, the gang re-formed in {reform_s:.3f} s; mesh.peer "
        f"armed once → mesh-straggler; {len(probes)} fresh answers identical again "
        f"({MESH_SETTLE} one at a time, then {len(probes) - MESH_SETTLE} at {MESH_QPS:.0f} QPS)")
    return result, servers


def delta_across_layouts(work: str, pvc: str, engine, servers: list, cpu) -> dict:
    """Phase 15 (d): one bench-size append to ``pvc`` (mined by two sharded
    ranks), the two-rank sharded delta job (the mesh recount on both
    ranks), its bundle against a one-card delta job's, and the apply into
    the (b) engine and the (c) gang against a pristine full re-mine; then
    the sharded compaction against the same re-mine."""
    import dataclasses as dc

    from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
    from kmlserver_tpu_torch.io import artifacts
    from kmlserver_tpu_torch.mining.pipeline import run_mining_job
    from kmlserver_tpu_torch.quality import lifecycle
    from kmlserver_tpu_torch.serving.engine import RecommendEngine
    from kmlserver_tpu_torch.serving.replay import sample_seed_sets

    t0 = time.perf_counter()
    csv_path = os.path.join(pvc, "datasets", FRESH_CSV)
    append_bench_rows(csv_path, np.random.default_rng(15), 10_000_000 + 7_000, 96 + 5 * 160,
                      9_000_015)
    one = os.path.join(work, "pvc15_one")
    shutil.copytree(pvc, one)
    full = os.path.join(work, "pvc15_full")
    os.makedirs(os.path.join(full, "datasets"))
    shutil.copy(csv_path, os.path.join(full, "datasets", FRESH_CSV))
    logs = run_ranks([[sys.executable, "-m", "kmlserver_tpu_torch.mining.job"]] * RANKS,
                     rank_envs(free_port(), **mesh_job_env(pvc)), 300, "phase 15 (d)")
    t_two = time.perf_counter() - t0
    # the one-card delta job and the pristine full re-mine, in this process
    cfg = MiningConfig(base_dir=one, datasets_dir=os.path.join(one, "datasets"),
                       delta_enabled=True, model_layout="sharded")
    if run_mining_job(cfg, device="cuda").delta_seq != 1:
        fail("phase 15 (d): the one-card delta job published no bundle")
    run_mining_job(dc.replace(cfg, base_dir=full, delta_enabled=False,
                              datasets_dir=os.path.join(full, "datasets")), device="cuda")
    route = [ln for out in logs for ln in out.splitlines() if ln.startswith("Delta recount route")]
    if (len(route) != RANKS or not all(f"rank {r} contributes" in route[r] for r in range(RANKS))
            or "Delta 1 published" not in logs[0]):
        fail(f"phase 15 (d): the two-rank delta job's recount routes {route}:\n"
             + "\n".join(logs[0].splitlines()[-20:]))
    name = artifacts.delta_bundle_filename(1)
    a, b = (bundle_members(os.path.join(p, "pickles", name)) for p in (one, pvc))
    if a != b:
        fail(f"phase 15 (d): {name} of the two-rank job differs from the one-card job's: "
             f"{sorted(k for k in a if a.get(k) != b.get(k))}")
    want_engine = RecommendEngine(ServingConfig(base_dir=full), device="cpu")
    if not want_engine.load():
        fail("phase 15 (d): the full re-mine did not load")
    keys = sorted(n for n, k in zip(want_engine.bundle.vocab, want_engine.bundle.known_mask) if k)
    # rule answers only: a delta leaves the popularity list (the fallback's)
    # as the base published it, a re-mine recomputes it
    probes = [p for p in sample_seed_sets(keys, MESH_PROBES, rng_seed=18)
              if not p[0].startswith("__")]
    want = engine_answers(want_engine, probes)
    # (b)'s sharded engine: the bundle applied into its slabs
    if engine.apply_pending_deltas() != 1 or engine.n_shards != MESH_SERVE_SHARDS:
        fail(f"phase 15 (d): the sharded engine applied {engine.delta_seq}, "
             f"{engine.n_shards} shards")
    if engine_answers(engine, probes) != want or engine.unwarmed_dispatches:
        fail("phase 15 (d): the sharded engine's answers after the delta != the full re-mine's")
    # the gang: each member polls and applies into its slab
    deadline = time.perf_counter() + 60
    while True:
        seqs = [scrape_metrics(s[1]).get("kmls_delta_seq") for s in servers[:2]]
        if seqs == [1, 1]:
            break
        if time.perf_counter() > deadline:
            fail(f"phase 15 (d): the gang's delta seqs {seqs}")
        time.sleep(0.1)
    for rank in range(2):
        m = scrape_metrics(servers[rank][1])
        if m.get("kmls_model_shards") != 2:
            fail(f"phase 15 (d) rank {rank}: kmls_model_shards {m.get('kmls_model_shards')}")
        songs_check(f"(d) gang rank {rank} after the delta", servers[rank][1], probes, want)
    # the compaction under the sharded layout
    for server in servers:
        stop_server(server[0])
    compacted = lifecycle.compact_delta_chain(dc.replace(
        cfg, base_dir=pvc, datasets_dir=os.path.join(pvc, "datasets")))
    got_npz, want_npz = (artifacts.load_rule_tensors(artifacts.tensor_artifact_path(
        os.path.join(p, "pickles", cfg.recommendations_file))) for p in (pvc, full))
    if compacted.n_folded != 1 or got_npz["vocab"] != want_npz["vocab"] or not all(
            np.array_equal(got_npz[k], want_npz[k]) for k in ("rule_ids", "rule_counts",
                                                               "item_counts")):
        fail(f"phase 15 (d): the sharded compaction ({compacted}) != the full re-mine")
    seconds = time.perf_counter() - t0
    log(f"phase 15 (d) one append ({FRESH_CSV}, bench size): two sharded ranks on 1x2 — "
        + "; ".join(route) + f" — published {name} in {t_two:.3f} s, its members == the "
        f"one-card job's; applied into the sharded engine ({engine.n_shards} slabs) and into "
        f"both gang members (kmls_model_shards 2, delta seq 1): {len(probes)} answers == the "
        f"pristine full re-mine's; the compaction (folded {compacted.n_folded}) == the full "
        f"re-mine's npz; {seconds:.3f} s")
    return {"two_ranks_s": t_two, "route": route, "seconds": seconds}


GANG_DRAWS = 1000  # (e): config-5 draws a collective member answers
GANG_THREADS = 2  # submitting threads a member, so rounds carry both members' batches
GANG_MAX_ROWS = 16  # a thread's batches hold 1..16 draws
GANG_HEARTBEAT_S = 3.0  # the members' heartbeat_timeout_s: the kill's bound
GANG_IDLE_S = 1.0  # the idle window rank 0 measures its CPU share over
GANG_PROBES = 50  # one-row batches rank 0 sends to the idle gang, 20 ms apart


def wait_barrier(directory: str, name: str, count: int, timeout_s: float) -> None:
    """Until ``count`` files ``<name>.<rank>`` exist in ``directory``."""
    deadline = time.monotonic() + timeout_s
    while sum(n.startswith(name + ".") for n in os.listdir(directory)) < count:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{name}: {count} members never arrived")
        time.sleep(0.01)


def mark_barrier(directory: str, name: str, rank: int) -> None:
    with open(os.path.join(directory, f"{name}.{rank}"), "w", encoding="utf-8") as fh:
        fh.write(repr(time.time()))


def quantile_ms(values) -> dict:
    values = np.asarray(list(values), dtype=np.float64)
    return ({"p50": float(np.percentile(values, 50)), "p99": float(np.percentile(values, 99))}
            if values.size else {"p50": None, "p99": None})


def thread_cpu_s() -> dict[str, float]:
    """This process's CPU seconds by thread name (``/proc/self/task``),
    threads of one name summed."""
    tick = os.sysconf("SC_CLK_TCK")
    out: dict[str, float] = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat", encoding="utf-8") as fh:
                stat = fh.read()
        except OSError:
            continue
        name = stat[stat.index("(") + 1:stat.rindex(")")]
        fields = stat[stat.rindex(")") + 2:].split()
        out[name] = out.get(name, 0.0) + (int(fields[11]) + int(fields[12])) / tick
    return out


def gang_worker(work: str, rank: int) -> int:
    """One member of phase 15 (e)'s collective gang, on cuda:0: joins the
    gang's world (the heartbeat bound :data:`GANG_HEARTBEAT_S`), serves its
    draws from :data:`GANG_THREADS` threads through the engine with the X9
    counts set to 0 just before and read just after, writes
    ``gang<rank>.json``; then rank 0 measures the idle gang and keeps
    submitting until its watchdog ends it, and rank 1 SIGKILLs itself."""
    sys.path.insert(0, ROOT)
    import signal

    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.ops import serve
    from kmlserver_tpu_torch.parallel import distributed
    from kmlserver_tpu_torch.serving.engine import RecommendEngine
    from kmlserver_tpu_torch.serving.mesh import MeshShardUnavailable

    with open(os.path.join(work, "gang_spec.json"), encoding="utf-8") as fh:
        spec = json.load(fh)
    coordinator = spec["coordinator"]
    distributed.maybe_initialize_serve_gang(coordinator, 2, rank, "cuda",
                                            heartbeat_timeout_s=GANG_HEARTBEAT_S)
    cfg = ServingConfig(base_dir=spec["pvc"], serve_gang_coordinator=coordinator,
                        serve_gang_size=2, serve_gang_rank=rank)
    engine = RecommendEngine(cfg, device="cuda", gang_transport="collective")
    t_load = time.perf_counter()
    if not engine.load():
        print("GANG_FAIL the engine did not load", flush=True)
        return 1
    gang = engine.mesh_coordinator
    while not gang.formed:
        if time.perf_counter() - t_load > 60:
            print(f"GANG_FAIL the gang never formed: missing {engine.mesh_missing_shards()}",
                  flush=True)
            return 1
        time.sleep(0.005)
    formed_s = time.perf_counter() - t_load
    mark_barrier(work, "ready", rank)
    wait_barrier(work, "ready", 2, 60)
    draws = spec["draws"][rank]
    rng = np.random.default_rng(15 + rank)
    plans = []
    for t in range(GANG_THREADS):
        mine, batches, i = draws[t::GANG_THREADS], [], 0
        while i < len(mine):
            n = int(rng.integers(1, GANG_MAX_ROWS + 1))
            batches.append(mine[i:i + n])
            i += n
        plans.append(batches)
    answers: list[list] = [[] for _ in plans]
    latency: list[float] = []

    def submit(t: int) -> None:
        for batch in plans[t]:
            t0 = time.perf_counter()
            answers[t].append(engine.recommend_many(batch))
            latency.append(1e3 * (time.perf_counter() - t0))

    # the main path: the counts to 0, the draws, the counts read
    for key in serve.CALLS:
        serve.CALLS[key] = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=submit, args=(t,)) for t in range(GANG_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    traffic_s = time.perf_counter() - t0
    calls = dict(serve.CALLS)
    result = {
        "rank": rank, "formed_s": formed_s, "traffic_s": traffic_s, "calls": calls,
        "answers": [[list(a) for a in batch] for t in answers for batch in t],
        "order": [batch for plan in plans for batch in plan],
        "batches": sum(len(p) for p in plans), "latency_ms": quantile_ms(latency),
        "merge_ms": quantile_ms(engine.mesh_merge_ms.copy()), "stats": gang.stats(),
        "unwarmed": engine.unwarmed_dispatches,
    }
    if rank == 0:
        # the idle gang: both members submit nothing for GANG_IDLE_S
        time.sleep(0.1)
        rounds0, cpu0, wall0 = gang.rounds, time.process_time(), time.perf_counter()
        threads0 = thread_cpu_s()
        time.sleep(GANG_IDLE_S)
        wall = time.perf_counter() - wall0
        threads1 = thread_cpu_s()
        by_thread = sorted(((threads1[n] - threads0.get(n, 0.0)) / wall, n) for n in threads1)
        result["idle"] = {"cpu_share": (time.process_time() - cpu0) / wall,
                          "rounds_per_s": (gang.rounds - rounds0) / wall,
                          "by_thread": {n: share for share, n in by_thread[::-1][:5] if share}}
        probe_ms = []
        for seeds in draws[:GANG_PROBES]:
            time.sleep(0.02)
            t0 = time.perf_counter()
            engine.recommend_many([seeds])
            probe_ms.append(1e3 * (time.perf_counter() - t0))
        result["idle"]["probe_ms"] = quantile_ms(probe_ms)
        result["unwarmed"] = engine.unwarmed_dispatches
    with open(os.path.join(work, f"gang{rank}.json"), "w", encoding="utf-8") as fh:
        json.dump(result, fh)
    mark_barrier(work, "done", rank)
    print(f"GANG_DONE rank {rank}", flush=True)
    wait_barrier(work, "done", 2, 120)
    if rank == 1:
        mark_barrier(work, "killed", rank)
        os.kill(os.getpid(), signal.SIGKILL)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:  # until the watchdog ends this member
        try:
            engine.recommend_many([draws[0]])
        except MeshShardUnavailable:
            pass
    print("GANG_FAIL rank 0 outlived its peer's SIGKILL by 60 s", flush=True)
    return 1


def collective_gang(work: str, pvc: str, keys: list, cpu) -> dict:
    """Phase 15 (e): the collective gang of two members on cuda:0 over
    gloo (:func:`gang_worker`), held to the CPU engine; rank 1's SIGKILL
    ends rank 0 with exit 76 within the bound."""
    from kmlserver_tpu_torch.serving.replay import sample_seed_sets

    t0 = time.perf_counter()
    gw = os.path.join(work, "gang15e")
    os.makedirs(gw)
    draws = sample_seed_sets(keys, 2 * GANG_DRAWS, rng_seed=19)
    want = {tuple(d): list(a) for d, a in zip(draws, engine_answers(cpu, draws))}
    with open(os.path.join(gw, "gang_spec.json"), "w", encoding="utf-8") as fh:
        json.dump({"coordinator": f"127.0.0.1:{free_port()}", "pvc": pvc,
                   "draws": [draws[:GANG_DRAWS], draws[GANG_DRAWS:]]}, fh)
    exit_times: dict = {}
    worker = [sys.executable, os.path.abspath(__file__), "--gang-worker", gw]
    outs = run_ranks([worker + [str(r)] for r in range(2)], [subproc_env()] * 2, 300,
                     "phase 15 (e)", want_exit=[76, -9], exit_times=exit_times)
    with open(os.path.join(gw, "killed.1"), encoding="utf-8") as fh:
        t_kill = float(fh.read())
    end_s = exit_times[0] - t_kill
    members = []
    for rank, out in enumerate(outs):
        line = f"Serve gang: rank {rank}/2 on cuda:0, backend gloo (ranks share a card)"
        note = (f"NOTE: serve gang rank {rank}/2: collective transport (asked for; members share "
                "a card)")
        if line not in out or note not in out:
            fail(f"phase 15 (e) rank {rank}: no gloo world on cuda:0:\n" + out[-3000:])
        with open(os.path.join(gw, f"gang{rank}.json"), encoding="utf-8") as fh:
            res = json.load(fh)
        got = [tuple(a) for batch in res["answers"] for a in batch]
        sent = [tuple(d) for batch in res["order"] for d in batch]
        bad = [i for i, (d, a) in enumerate(zip(sent, got)) if want[d] != list(a)]
        if len(got) != GANG_DRAWS or bad:
            fail(f"phase 15 (e) rank {rank}: {len(got)} answers, {len(bad)} differ from the CPU "
                 f"engine's" + (f", first {sent[bad[0]]} {got[bad[0]]} != {want[sent[bad[0]]]}"
                                if bad else ""))
        if res["unwarmed"] or min(res["calls"].values()) < 1:
            fail(f"phase 15 (e) rank {rank}: unwarmed {res['unwarmed']}, X9 calls {res['calls']}")
        members.append(res)
    if "RANK WATCHDOG ABORT (rank 0)" not in outs[0] or not 0 <= end_s <= GANG_HEARTBEAT_S + 5:
        fail(f"phase 15 (e): rank 0 exited 76 {end_s:.3f} s after rank 1's SIGKILL (bound "
             f"{GANG_HEARTBEAT_S} + 5 s):\n" + outs[0][-2000:])
    abort = next(ln for ln in outs[0].splitlines() if "RANK WATCHDOG ABORT" in ln)
    seconds = time.perf_counter() - t0
    stats = members[0]["stats"]
    split = {k: stats[f"{k}_ms"] for k in ("header", "seeds", "partials", "gather")}
    split["merge"] = members[0]["merge_ms"]
    log(f"phase 15 (e) collective gang: two RecommendEngine(gang_transport='collective') on "
        f"cuda:0, one torch.distributed world over gloo; {2 * GANG_DRAWS} config-5 draws "
        f"({GANG_THREADS} threads a member, batches of 1-{GANG_MAX_ROWS}) == the CPU engine's, "
        f"0 unwarmed, X9 calls {[m['calls'] for m in members]}; formed in "
        f"{members[0]['formed_s']:.3f} / {members[1]['formed_s']:.3f} s after load; traffic "
        f"{members[0]['traffic_s']:.3f} / {members[1]['traffic_s']:.3f} s; rank 0: "
        f"{stats['rounds']} rounds ({stats['empty_rounds']} empty), "
        f"{stats['bytes_per_work_round']:.0f} B received a round with rows; per round ms p50/p99 "
        + ", ".join(f"{k} {v['p50']:.3f}/{v['p99']:.3f}" for k, v in split.items())
        + f"; a batch dispatch-to-finish p50/p99 {members[0]['latency_ms']['p50']:.3f}/"
        f"{members[0]['latency_ms']['p99']:.3f} ms (rank 1 {members[1]['latency_ms']['p50']:.3f}/"
        f"{members[1]['latency_ms']['p99']:.3f}); idle gang (parked on the store, {stats['parks']}"
        f" parks): {members[0]['idle']['rounds_per_s']:.1f} rounds/s, CPU share "
        f"{members[0]['idle']['cpu_share']:.4f} of a core (by thread "
        f"{members[0]['idle']['by_thread']}), a one-row batch to it p50/p99 "
        f"{members[0]['idle']['probe_ms']['p50']:.3f}/{members[0]['idle']['probe_ms']['p99']:.3f}"
        f" ms; rank 1 SIGKILLed → rank 0 exit 76 after {end_s:.3f} s (bound {GANG_HEARTBEAT_S} +"
        f" 5 s): {abort.strip()}; {nvidia_smi_query('name,power.limit')}; {seconds:.3f} s")
    return {"members": [{k: v for k, v in m.items() if k not in ("answers", "order")}
                        for m in members],
            "split_ms": split, "kill_to_exit_s": end_s, "abort": abort.strip(),
            "seconds": seconds}


def mesh_job_env(pvc: str) -> dict:
    """The sharded delta-armed job's env (two ranks on ``1x2``)."""
    return dict(BASE_DIR=pvc, DATASETS_DIR=os.path.join(pvc, "datasets"),
                KMLS_MODEL_LAYOUT="sharded", KMLS_MESH_SHAPE=f"1x{RANKS}", KMLS_DELTA_ENABLED="1")


def phase_model_parallel(work: str | None = None) -> dict:
    """Phase 15: model-parallel serving on phase 4's CSV (alone: ``python
    -c "import chip_smoke as c; c.phase_model_parallel()"`` mines its own
    ds2 PVC first)."""
    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.serving.engine import RecommendEngine

    t0 = time.perf_counter()
    own = work is None
    work = work or tempfile.mkdtemp(prefix="kmls_smoke15_")
    try:
        src = os.path.join(ds2_pvc(work), "datasets", FRESH_CSV)
        pvc = os.path.join(work, "pvc15")
        os.makedirs(os.path.join(pvc, "datasets"))
        shutil.copy(src, os.path.join(pvc, "datasets", FRESH_CSV))
        t_base = time.perf_counter()
        outs = run_ranks([[sys.executable, "-m", "kmlserver_tpu_torch.mining.job"]] * RANKS,
                         rank_envs(free_port(), **mesh_job_env(pvc)), 300,
                         "phase 15 base mine")
        if "sharded-vocab" not in outs[0]:
            fail("phase 15: the two-rank sharded base mine failed:\n" + outs[0][-3000:])
        if not same_publication(pvc, os.path.join(work, "pvc")):
            fail("phase 15: the two-rank sharded mine's publication != phase 4's")
        t_mine = time.perf_counter() - t_base
        log(f"phase 15: phase 4's CSV mined by two ranks (KMLS_MODEL_LAYOUT=sharded, 1x{RANKS}, "
            f"deltas armed) in {t_mine:.3f} s wall, its publication == phase 4's; rank 0: "
            + "; ".join(ln for ln in outs[0].splitlines()
                        if ln.startswith(("Pair-count path", "Phase timings", "Distributed"))))
        port = gang_ports()
        spawned = [spawn_server(pvc, **gang_env(port, rank)) for rank in range(2)]
        spawned.append(spawn_server(pvc, KMLS_CACHE_ENABLED="0"))
        cpu = RecommendEngine(ServingConfig(base_dir=pvc), device="cpu")
        if not cpu.load():
            fail("phase 15: the CPU engine could not load the PVC")
        keys = sorted(n for n, k in zip(cpu.bundle.vocab, cpu.bundle.known_mask) if k)
        sharded, engine = sharded_on_card(pvc, keys, cpu)
        gang, servers = gang_on_card(pvc, keys, cpu, spawned, port)
        x9 = x9_on_card(pvc)  # the servers idle: the card is this process's
        collective = collective_gang(work, pvc, keys, cpu)  # before (d) appends
        delta = delta_across_layouts(work, pvc, engine, servers, cpu)
        seconds = time.perf_counter() - t0
        result = {"x9": x9, "sharded": sharded, "gang": gang, "collective": collective,
                  "delta": delta, "seconds": {"base_mine": t_mine, "phase": seconds}}
        log(f"phase 15 seconds {seconds:.3f} (the two-rank base mine {t_mine:.3f}, (a) "
            f"{sum(x9['seconds'].values()):.3f}, (b) {sharded['seconds']:.3f}, (c) "
            f"{gang['seconds']:.3f}, (e) {collective['seconds']:.3f}, (d) "
            f"{delta['seconds']:.3f})")
        log("PHASE15 " + json.dumps(result, default=str))
        return result
    finally:
        stop_spawned()
        if own:
            shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 16

FLEET_PEERS = [f"replica-{i}" for i in range(3)]  # kubernetes/statefulset.yaml: replicas 3
FLEET_QPS = 10500.0  # bench.py _FLEET_BENCH's defaults
FLEET_REQUESTS = 42000
FLEET_CACHE = 512  # per-replica LRU
FLEET_POOL = int(FLEET_CACHE * (len(FLEET_PEERS) + 1.5))  # 2,304 sets: wider than one LRU
FLEET_POLL = "0.005"  # POLLING_WAIT_IN_MINUTES: the mid-replay delta applies within ~0.3 s
FLEET_CSV = "2023_spotify_ds2.csv"
SLOW_QPS = 32.0  # under the stalled peer's capacity (bench.py _SLOWPEER_BENCH)
# the bracket's 600 a leg cut to 300 (its gang leg 300 → 150): the whole
# smoke took 1,061.694 s with 600, past the ~1,050 s the time limit leaves
SLOW_REQUESTS = 300
SLOW_STALL_MS = 200
SLOW_PEERS = ["replica-0", "replica-1"]
SHAPE_QPS = 1000.0  # bench.py _LOADSHAPE_PRED_BENCH
SHAPE_REQUESTS = 8000
SHAPE_SEEDS = {"ramp": 41, "sine": 43, "constant": 47}
PREFETCH_DRAWS = 2000  # (c)'s Zipf traffic before the delta the pre-fetch follows


# the admission ladder off, as the reference bench's fleet and meshserve
# servers have it: phase 16's replicas and its gang
LADDER_OFF = {"KMLS_SHED_QUEUE_BUDGET_MS": "0"}


def fleet_env(me: str, peers: list[str], **extra: str) -> dict:
    """A fleet replica's env: its stable identity among ``peers``, as
    kubernetes/statefulset.yaml sets ``KMLS_FLEET_SELF`` / ``_PEERS``; the
    admission ladder off as the bench's fleet servers have it."""
    return dict(KMLS_FLEET_SELF=me, KMLS_FLEET_PEERS=",".join(peers), **LADDER_OFF, **extra)


def fleet_pvc(work: str) -> str:
    """ds2 from seed 123 mined on the card in process with deltas armed
    (the bench's fleet PVC, min_support 0.05) → the PVC."""
    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.data.csv import write_tracks_csv
    from kmlserver_tpu_torch.data.synthetic import DS2_SHAPE, synthetic_table
    from kmlserver_tpu_torch.mining.pipeline import run_mining_job

    pvc = os.path.join(work, "pvc16")
    datasets = os.path.join(pvc, "datasets")
    os.makedirs(datasets)
    write_tracks_csv(os.path.join(datasets, FLEET_CSV), synthetic_table(**DS2_SHAPE, seed=123))
    run_mining_job(MiningConfig(base_dir=pvc, datasets_dir=datasets, min_support=0.05,
                                delta_enabled=True), device="cuda")
    return pvc


def rule_vocab(pvc: str) -> list[str]:
    """The rule dict's keys, sorted (the bench's payload vocabulary)."""
    from kmlserver_tpu_torch.io import artifacts

    return sorted(artifacts.load_pickle(os.path.join(pvc, "pickles", "recommendations.pickle")))


def fleet_answers_check(label: str, responses: list, payloads: list, cpu,
                        straggler_ok: bool = False) -> dict:
    """``replay_fleet_http``'s answers (one per request) against the CPU
    engine's: 200 and its songs, or a counted degraded answer — the
    popularity fallback, or with ``straggler_ok`` a merge without a late
    slab. → counts by outcome."""
    if len(responses) != len(payloads):
        fail(f"phase 16 {label}: {len(payloads) - len(responses)} requests got no answer")
    want = engine_answers(cpu, payloads)
    head_k = [b["track_name"] for b in cpu.best_tracks][: cpu.cfg.k_best_tracks]
    counts: dict[str, int] = {"ok": 0, "cached": 0}
    for i, _peer, status, head, body in responses:
        songs = json.loads(body).get("songs") if status == 200 else None
        reason = [ln.split(b":", 1)[1].strip().decode() for ln in head.split(b"\r\n")
                  if ln.startswith(b"x-kmls-degraded:")]
        if status == 200 and reason:
            counts[reason[0]] = counts.get(reason[0], 0) + 1
            if reason[0] == "mesh-straggler" and straggler_ok:
                continue
            if songs not in (cpu.static_recommendation(payloads[i]), head_k):
                fail(f"phase 16 {label}: degraded ({reason[0]}) answer for {payloads[i]} is "
                     "not the fallback")
            continue
        if status != 200 or songs != want[i][0]:
            fail(f"phase 16 {label}: {payloads[i]} → {status} {body[:200]!r} != {want[i][0]}")
        counts["ok"] += 1
        counts["cached"] += b"x-kmls-cache: hit" in head
    return counts


def fleet_routed(pvc: str, servers: dict, cpu, card, phase8_buckets) -> dict:
    """Phase 16 (a): ``_FLEET_BENCH`` at its defaults on the three replicas
    — leg A round robin (rng 31) with X1 timed per bucket while it runs,
    leg B ring-routed (rng 32) with the append + delta job at 30 % and
    replica-2 SIGKILLed at 60 %; the survivors' delta and answers."""
    import torch

    from kmlserver_tpu_torch.freshness.ring import seeds_key, simulate_fleet
    from kmlserver_tpu_torch.serving.replay import replay_fleet_http, sample_seed_sets

    t0 = time.perf_counter()
    urls = {me: base for me, (_proc, base, _lines) in servers.items()}
    vocab = rule_vocab(pvc)
    window_end = int(FLEET_REQUESTS * 0.30)
    kill_at = int(FLEET_REQUESTS * 0.60)
    idle = serve_bucket_times(card, label="phase 16 (a), three replicas idle")
    # leg A: X1 per bucket timed in this process while three servers answer
    payloads_a = sample_seed_sets(vocab, FLEET_REQUESTS, rng_seed=31, zipf_s=0.9,
                                  zipf_pool=FLEET_POOL)
    leg_a_done = threading.Event()
    timed: dict = {}

    def time_under_load() -> None:
        time.sleep(0.2)  # the client's first bursts
        # fewer launches a bucket than idle, so most buckets finish inside
        # the leg; each row says whether the leg still ran when it ended
        timed["rows"] = serve_bucket_times(card, "phase 16 (a), under leg A's load", reps=20,
                                           walls_n=10, loaded=lambda: not leg_a_done.is_set())

    timer = threading.Thread(target=time_under_load, daemon=True)
    timer.start()
    rep_a, fleet_a = replay_fleet_http(urls, payloads_a, qps=FLEET_QPS, policy="roundrobin",
                                       window_end=window_end)
    leg_a_done.set()
    timer.join(120)
    loaded = [(r["ms"], i["ms"]) for r, i in zip(timed["rows"], idle) if r["loaded"]]
    x1_ratio = sorted(ms / idle_ms for ms, idle_ms in loaded)
    log(f"phase 16 (a): X1 under leg A's load in {len(loaded)} of {len(idle)} buckets, "
        f"{x1_ratio[0]:.3f}–{x1_ratio[-1]:.3f}× the idle time (median "
        f"{x1_ratio[len(x1_ratio) // 2]:.3f}×)" if loaded else
        "phase 16 (a): leg A ended before the first bucket was timed")
    log(f"phase 16 (a) independent: window hit {fleet_a['window_hit_ratio']:.4f}, achieved "
        f"{rep_a.achieved_qps:.1f} QPS of {FLEET_QPS:.0f}, p50/p99 {rep_a.p50_ms:.3f}/"
        f"{rep_a.p99_ms:.3f} ms, {fleet_a['http_5xx']} 5xx, {rep_a.n_errors} errors")
    # round robin lands ~2/3 of the traffic off its owner: the routed leg's
    # drift is read as a delta over this
    misrouted_before = {me: scrape_metrics(b).get("kmls_cache_misrouted_total", 0.0)
                        for me, b in urls.items()}
    payloads_b = sample_seed_sets(vocab, FLEET_REQUESTS, rng_seed=32, zipf_s=0.9,
                                  zipf_pool=FLEET_POOL)
    victim = FLEET_PEERS[-1]
    delta: dict = {}

    def run_delta() -> None:
        # the fleet bracket's mid-replay append: over tracks 96-223, rng 7
        append_bench_rows(os.path.join(pvc, "datasets", FLEET_CSV), np.random.default_rng(7),
                          30_000_000, 96, None)
        out, wall = job_process(pvc, "phase 16 (a) delta", KMLS_DELTA_ENABLED="1",
                                MIN_SUPPORT="0.05")
        delta["published"] = "Delta 1 published" in out
        delta["job_s"] = wall

    mem: dict = {}

    def kill() -> None:
        mem["free_before"] = torch.cuda.mem_get_info()[0]
        servers[victim][0].kill()  # SIGKILL: a crash holding a CUDA context
        mem["t_kill"] = time.perf_counter()

    delta_thread = threading.Thread(target=run_delta, daemon=True)
    rep_b, fleet_b = replay_fleet_http(
        urls, payloads_b, qps=FLEET_QPS, policy="ring", window_end=window_end,
        events=[(window_end, delta_thread.start), (kill_at, kill)],
    )
    delta_thread.join(300)
    servers[victim][0].wait(30)
    deadline = time.perf_counter() + 10
    while True:  # the dead context's card memory returns once the process is reaped
        mem["free_after"] = torch.cuda.mem_get_info()[0]
        if mem["free_after"] > mem["free_before"] or time.perf_counter() > deadline:
            break
        time.sleep(0.1)
    mem["freed_bytes"] = mem["free_after"] - mem["free_before"]
    log(f"phase 16 (a) routed: window hit {fleet_b['window_hit_ratio']:.4f}, achieved "
        f"{rep_b.achieved_qps:.1f} QPS of {FLEET_QPS:.0f}, p50/p99 {rep_b.p50_ms:.3f}/"
        f"{rep_b.p99_ms:.3f} ms, {fleet_b['http_5xx']} 5xx, {rep_b.n_errors} errors, rerouted "
        f"{fleet_b['rerouted']}, ejections {fleet_b['ejections']}, spills {fleet_b['spills']}, "
        f"owner-stamped {fleet_b['owner_stamped']}; {victim} SIGKILLed at request {kill_at}: "
        f"free card memory {mem['free_before']} → {mem['free_after']} bytes")
    if not delta.get("published"):
        fail(f"phase 16 (a): the mid-replay delta job published no bundle: {delta}")
    survivors = [me for me in FLEET_PEERS if me != victim]
    metrics = {}
    for me in survivors:
        metrics[me], _ = wait_metrics(urls[me], lambda m: m.get("kmls_delta_seq", 0) >= 1, 60,
                                      f"phase 16 (a) {me}'s delta apply")
    if cpu.apply_pending_deltas() != 1:
        fail("phase 16 (a): the CPU engine did not apply delta 1")
    probes = payloads_b[:4] + [["Track 0000100"], vocab[:3]]
    answers = {me: [json.loads(post(urls[me] + "/api/recommend/", {"songs": s})[1])["songs"]
                    for s in probes] for me in survivors}
    want = [cpu.recommend(s)[0] for s in probes]
    keys_b = [seeds_key(p) for p in payloads_b[:window_end]]
    sim_aff = simulate_fleet(keys_b, len(FLEET_PEERS), FLEET_CACHE, "affinity")
    sim_rr = simulate_fleet(keys_b, len(FLEET_PEERS), FLEET_CACHE, "roundrobin")
    result = {
        "qps": FLEET_QPS, "requests": FLEET_REQUESTS, "replicas": len(FLEET_PEERS),
        "cache_entries": FLEET_CACHE, "zipf_pool": FLEET_POOL,
        "independent_hit_ratio": fleet_a["window_hit_ratio"],
        "routed_hit_ratio": fleet_b["window_hit_ratio"],
        "independent_hit_ratio_full": fleet_a["hit_ratio"],
        "routed_hit_ratio_full": fleet_b["hit_ratio"],
        "multiplier_achieved": fleet_b["window_hit_ratio"] / fleet_a["window_hit_ratio"],
        "multiplier_simulated": sim_aff / sim_rr, "sim_affinity_hit": sim_aff,
        "sim_roundrobin_hit": sim_rr,
        "leg_a": {"offered_qps": rep_a.offered_qps, "achieved_qps": rep_a.achieved_qps,
                  "p50_ms": rep_a.p50_ms, "p99_ms": rep_a.p99_ms},
        "offered_qps": rep_b.offered_qps, "achieved_qps": rep_b.achieved_qps,
        "p50_ms": rep_b.p50_ms, "p99_ms": rep_b.p99_ms,
        "errors": rep_a.n_errors + rep_b.n_errors,
        "http_5xx": fleet_a["http_5xx"] + fleet_b["http_5xx"],
        "kill_peer": victim, "rerouted": fleet_b["rerouted"],
        "router_ejections": fleet_b["ejections"], "router_spills": fleet_b["spills"],
        "owner_stamped": fleet_b["owner_stamped"], "answered_by": fleet_b["answered_by"],
        "delta_seq": {me: metrics[me].get("kmls_delta_seq") for me in survivors},
        "selective_invalidations": sum(
            metrics[me].get("kmls_cache_selective_invalidations_total", 0) for me in survivors),
        "misrouted_total": sum(metrics[me].get("kmls_cache_misrouted_total", 0)
                               - misrouted_before[me] for me in survivors),
        "delta_job_s": delta["job_s"], "card_memory": mem,
        "device_ms": {me: {q: metrics[me].get(f'kmls_device_ms{{quantile="{q}"}}')
                           for q in ("0.5", "0.99")} for me in survivors},
        "x1_buckets": {"idle": idle, "under_load": timed.get("rows"),
                       "loaded_over_idle": x1_ratio, "phase8_single_server": phase8_buckets},
    }
    if result["http_5xx"] or result["errors"]:
        fail(f"phase 16 (a): {result['http_5xx']} 5xx and {result['errors']} errors over the legs")
    if not all(metrics[me].get("kmls_delta_applied_total", 0) >= 1
               and metrics[me].get("kmls_delta_rejected_total", 0) == 0 for me in survivors):
        fail(f"phase 16 (a): a survivor did not apply the delta cleanly: {metrics}")
    if result["selective_invalidations"] <= 0:
        fail("phase 16 (a): no selective invalidation on the survivors")
    if any(answers[me] != want for me in survivors):
        fail(f"phase 16 (a): the survivors' probe answers differ from each other or the CPU "
             f"engine's on the post-delta bundle: {answers} vs {want}")
    if not result["routed_hit_ratio"] > result["independent_hit_ratio"]:
        fail(f"phase 16 (a): routed window hit ratio {result['routed_hit_ratio']} is not above "
             f"the independent {result['independent_hit_ratio']}")
    if mem["freed_bytes"] <= 0:
        fail(f"phase 16 (a): the killed replica's card memory was not freed: {mem}")
    result["seconds"] = time.perf_counter() - t0
    log(f"phase 16 (a): multiplier achieved {result['multiplier_achieved']:.4f} vs simulated "
        f"{result['multiplier_simulated']:.4f}; misrouted {result['misrouted_total']:.0f}, "
        f"selective invalidations {result['selective_invalidations']:.0f}; survivors' probes "
        f"== the CPU engine's post-delta answers; {mem['freed_bytes']} bytes freed by the kill; "
        f"{result['seconds']:.3f} s")
    return result


def gray_failure(pvc: str, pair: dict, gang: list, cpu) -> dict:
    """Phase 16 (b): ``_SLOWPEER_BENCH`` — control and hedged legs against
    the two-replica fleet whose replica-1 stalls every request, then the
    two-member gang as the one ring peer under a finite ``mesh.peer``
    stall, then rank 1 SIGKILLed under routing."""
    from kmlserver_tpu_torch.serving import replay as replay_mod
    from kmlserver_tpu_torch.serving.replay import replay_fleet_http, sample_seed_sets

    t0 = time.perf_counter()
    urls = {me: base for me, (_proc, base, _lines) in pair.items()}
    vocab = rule_vocab(pvc)
    hedges_before = replay_mod.HEDGES_ISSUED
    payloads_a = sample_seed_sets(vocab, SLOW_REQUESTS, rng_seed=41, zipf_s=1.1, zipf_pool=1024)
    resp_a: list = []
    rep_ctl, fleet_ctl = replay_fleet_http(urls, payloads_a, qps=SLOW_QPS, policy="ring",
                                           responses=resp_a)
    control_hedges = replay_mod.HEDGES_ISSUED - hedges_before
    counts_ctl = fleet_answers_check("(b) control", resp_a, payloads_a, cpu)
    payloads_b = sample_seed_sets(vocab, SLOW_REQUESTS, rng_seed=42, zipf_s=1.1, zipf_pool=1024)
    resp_b: list = []
    rep_hdg, fleet_hdg = replay_fleet_http(
        urls, payloads_b, qps=SLOW_QPS, policy="ring", hedge=True, hedge_delay_ms=20.0,
        hedge_max_frac=0.5, slow_ratio=3.0, deadline_ms=5000.0, probe_interval_s=5.0,
        responses=resp_b,
    )
    counts_hdg = fleet_answers_check("(b) hedged", resp_b, payloads_b, cpu)
    log(f"phase 16 (b) control: p50/p99 {rep_ctl.p50_ms:.3f}/{rep_ctl.p99_ms:.3f} ms, "
        f"{fleet_ctl['http_5xx']} 5xx, {rep_ctl.n_errors} errors, hedges {control_hedges}; "
        f"hedged: p50/p99 {rep_hdg.p50_ms:.3f}/{rep_hdg.p99_ms:.3f} ms, "
        f"{fleet_hdg['hedges_issued']} hedges ({fleet_hdg['hedge_wins']} won, "
        f"{fleet_hdg['hedges_suppressed']} suppressed), {fleet_hdg['slow_ejections']} slow "
        f"ejections, {fleet_hdg['http_5xx']} 5xx, {rep_hdg.n_errors} errors; answers {counts_ctl} "
        f"/ {counts_hdg}")
    # the gang, one ring peer
    gang_urls = [base for _proc, base, _lines in gang]
    wait_gang_ready(gang_urls, 120)
    payloads_m = sample_seed_sets(vocab, max(100, SLOW_REQUESTS // 2), rng_seed=43, zipf_s=1.1,
                                  zipf_pool=1024)
    resp_m: list = []
    rep_m, fleet_m = replay_fleet_http({"gang": gang_urls[0]}, payloads_m, qps=SLOW_QPS,
                                       policy="ring", deadline_ms=1500.0, responses=resp_m)
    if rep_m.n_errors or fleet_m["http_5xx"]:
        fail(f"phase 16 (b): the gang leg: {rep_m.n_errors} errors, {fleet_m}")
    counts_m = fleet_answers_check("(b) gang", resp_m, payloads_m, cpu, straggler_ok=True)
    front = scrape_metrics(gang_urls[0])
    # rank 1 killed under routing: the gang answers 503, the client spills
    gang[1][0].kill()
    gang[1][0].wait(30)
    # a seed set never sent: a cached answer would not reach the mesh
    fresh = next(p for p in sample_seed_sets(vocab, 50, rng_seed=45, unknown_fraction=0.0)
                 if p not in payloads_m)
    status, headers, _body = mesh_probe(gang_urls[0], fresh)
    payloads_k = sample_seed_sets(vocab, 60, rng_seed=44)
    resp_k: list = []
    rep_k, fleet_k = replay_fleet_http(
        {"gang": gang_urls[0], "solo": urls["replica-0"]}, payloads_k, qps=SLOW_QPS,
        eject_threshold=1, redispatch_max=4, probe_interval_s=30.0, responses=resp_k,
    )
    counts_k = fleet_answers_check("(b) gang member killed", resp_k, payloads_k, cpu)
    result = {
        "qps": SLOW_QPS, "requests": SLOW_REQUESTS, "stall_ms": SLOW_STALL_MS,
        "control": {"p50_ms": rep_ctl.p50_ms, "p99_ms": rep_ctl.p99_ms,
                    "errors": rep_ctl.n_errors, "http_5xx": fleet_ctl["http_5xx"],
                    "hedges": control_hedges, "answers": counts_ctl},
        "hedged": {"p50_ms": rep_hdg.p50_ms, "p99_ms": rep_hdg.p99_ms,
                   "errors": rep_hdg.n_errors, "http_5xx": fleet_hdg["http_5xx"],
                   **{k: fleet_hdg[k] for k in ("hedges_issued", "hedge_wins", "hedge_losses",
                                                "hedges_suppressed", "hedge_mismatch",
                                                "slow_ejections", "ejections", "readmissions",
                                                "deadline_expired")},
                   "answers": counts_hdg},
        "p99_ratio": rep_ctl.p99_ms / rep_hdg.p99_ms,
        "gang": {"requests": len(payloads_m), "p50_ms": rep_m.p50_ms, "p99_ms": rep_m.p99_ms,
                 "errors": rep_m.n_errors, "http_5xx": fleet_m["http_5xx"], "answers": counts_m,
                 "hedge_wins_total": front.get("kmls_hedge_wins_total"),
                 "straggler_degraded_total": front.get("kmls_mesh_straggler_degraded_total"),
                 "peer_slow_ejections_total": front.get("kmls_peer_slow_ejections_total")},
        "gang_killed": {"probe_status": status,
                        "mesh_unavailable_header": headers.get("x-kmls-mesh-unavailable"),
                        "retry_after": headers.get("retry-after"),
                        "errors": rep_k.n_errors, "http_5xx": fleet_k["http_5xx"],
                        **{k: fleet_k[k] for k in ("mesh_unavailable", "rerouted", "ejections",
                                                   "failed_shards", "answered_by")},
                        "answers": counts_k},
    }
    if control_hedges:
        fail(f"phase 16 (b): {control_hedges} hedges issued with hedging off")
    for leg in (result["control"], result["hedged"], result["gang"], result["gang_killed"]):
        if leg["errors"] or leg["http_5xx"]:
            fail(f"phase 16 (b): a leg with errors or 5xx: {result}")
    if not rep_hdg.p99_ms < rep_ctl.p99_ms:
        fail(f"phase 16 (b): hedged p99 {rep_hdg.p99_ms:.3f} ms is not below the control's "
             f"{rep_ctl.p99_ms:.3f} ms")
    if fleet_hdg["slow_ejections"] < 1 or fleet_hdg["hedge_mismatch"]:
        fail(f"phase 16 (b): no slow ejection of replica-1, or a hedge answered differently: "
             f"{fleet_hdg}")
    if (status != 503 or headers.get("x-kmls-mesh-unavailable") != "1"
            or not (headers.get("retry-after") or "").isdigit()):
        fail(f"phase 16 (b): the gang with rank 1 dead answered {status} {headers}")
    if not (result["gang"]["hedge_wins_total"] or 0) >= 1 or not (
            result["gang"]["straggler_degraded_total"] or 0) >= 1:
        fail(f"phase 16 (b): the gang's coordinator never left the straggler out: {front}")
    if fleet_k["mesh_unavailable"] < 1 or fleet_k["failed_shards"] != {"gang": 1}:
        fail(f"phase 16 (b): the routed client did not spill the gang's 503s: {fleet_k}")
    result["seconds"] = time.perf_counter() - t0
    log(f"phase 16 (b): hedged p99 {rep_hdg.p99_ms:.3f} < control {rep_ctl.p99_ms:.3f} ms "
        f"(x{result['p99_ratio']:.3f}); gang leg p50/p99 {rep_m.p50_ms:.3f}/{rep_m.p99_ms:.3f} "
        f"ms, answers {counts_m}, hedge wins {front.get('kmls_hedge_wins_total')}; rank 1 "
        f"killed: 503 + X-KMLS-Mesh-Unavailable 1, Retry-After {headers.get('retry-after')}, "
        f"{fleet_k['mesh_unavailable']} refusals spilled to solo ({fleet_k['answered_by']}); "
        f"{result['seconds']:.3f} s")
    return result


def shape_leg(base_cfg, engine, shape: str, predictive: bool, payloads: list,
              arrivals) -> dict:
    """One ``_LOADSHAPE_PRED_BENCH`` leg in process on the card: a fresh
    app over the shared engine (equal capacity; the forecaster knob is the
    only difference), every distinct payload once, a half-rate pass, then
    the shaped replay with the utilization sampled every 10 ms."""
    import dataclasses as dc

    from kmlserver_tpu_torch.serving import forecast as forecast_mod
    from kmlserver_tpu_torch.serving.app import RecommendApp
    from kmlserver_tpu_torch.serving.batcher import (
        DeadlineExceeded, NoHealthyReplicas, Overloaded, OverloadDegraded,
    )
    from kmlserver_tpu_torch.serving.replay import replay_pooled

    app = RecommendApp(dc.replace(base_cfg, forecast_enabled=predictive), engine=engine,
                       device="cuda")
    would_5xx = [0]
    lock = threading.Lock()

    def make_send():
        def send(seeds):
            try:
                _recs, _source, cached = app.recommend_direct(seeds)
            except Overloaded:
                return "shed", None
            except (OverloadDegraded, DeadlineExceeded, NoHealthyReplicas):
                return "degraded", None
            except Exception:
                with lock:
                    would_5xx[0] += 1  # handle() would answer 500
                raise
            return "ok", cached
        return send

    try:
        warm = make_send()
        for p in {tuple(p): p for p in payloads}.values():
            warm(p)
        replay_pooled(make_send, payloads[:3000], qps=SHAPE_QPS / 2, n_workers=16)
        shed0, obs0 = app.batcher.shed_total, forecast_mod.OBSERVATIONS_TOTAL
        lead = {"min": float("inf"), "max": 0.0, "samples": 0}
        stop = threading.Event()

        def sample() -> None:
            while not stop.wait(0.01):
                reactive, led = app.batcher.utilization_parts()
                lead["min"] = min(lead["min"], led - reactive)
                lead["max"] = max(lead["max"], led - reactive)
                lead["samples"] += 1

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        rep = replay_pooled(make_send, payloads, qps=SHAPE_QPS, n_workers=16, max_queue=16384,
                            arrivals=arrivals)
        stop.set()
        sampler.join(5)
        out = {"p50_ms": rep.p50_ms, "p99_ms": rep.p99_ms, "onset_p99_ms": rep.onset_p99_ms,
               "steady_p99_ms": rep.steady_p99_ms, "errors": rep.n_errors,
               "http_5xx": would_5xx[0], "shed": app.batcher.shed_total - shed0,
               "degraded": rep.by_source.get("degraded", 0), "ok": rep.by_source.get("ok", 0),
               "achieved_qps": rep.achieved_qps, "lead_min": lead["min"],
               "lead_max": lead["max"], "lead_samples": lead["samples"],
               "observations_delta": forecast_mod.OBSERVATIONS_TOTAL - obs0}
        if predictive:
            out["forecast_observations"] = app.forecaster.observations
            out["prewarm_total"] = app.batcher.prewarm_total
        log(f"phase 16 (c) {shape}/{'pred' if predictive else 'react'}: p50/p99 "
            f"{rep.p50_ms:.3f}/{rep.p99_ms:.3f} ms, onset/steady p99 {rep.onset_p99_ms}/"
            f"{rep.steady_p99_ms}, shed {out['shed']}, degraded {out['degraded']}, 5xx "
            f"{would_5xx[0]}, lead over reactive [{lead['min']:.4f}, {lead['max']:.4f}] in "
            f"{lead['samples']} samples, pre-touches {out.get('prewarm_total', 0)}")
        return out
    finally:
        app.close()
        engine.delta_listeners.remove(app._on_delta_applied)


def prefetch_after_delta(pvc: str, base_cfg) -> dict:
    """(c)'s pre-fetch: an app with the cache, the forecaster and deltas
    armed under Zipf traffic, an append whose playlists hold its hottest
    seed sets' tracks, the delta job in process on the card (the bench's
    way; a process start-up's ~20 windows would decay the mix table), the
    apply → the pre-fetched answers against the CPU engine's on the
    post-delta bundle."""
    import dataclasses as dc

    from kmlserver_tpu_torch.config import MiningConfig, ServingConfig
    from kmlserver_tpu_torch.mining.pipeline import run_mining_job
    from kmlserver_tpu_torch.serving.app import RecommendApp
    from kmlserver_tpu_torch.serving.engine import RecommendEngine
    from kmlserver_tpu_torch.serving.replay import replay_pooled, sample_seed_sets

    app = RecommendApp(dc.replace(base_cfg, cache_enabled=True, forecast_enabled=True,
                                  delta_enabled=True), device="cuda")
    try:
        if not app.engine.load():
            fail("phase 16 (c): the delta app could not load its PVC")
        payloads = sample_seed_sets(rule_vocab(pvc), PREFETCH_DRAWS, rng_seed=48, zipf_s=1.1)

        def make_send():
            def send(seeds):
                return app.recommend_direct(seeds)[1]
            return send

        replay_pooled(make_send, payloads, qps=SHAPE_QPS, n_workers=16)
        hot = app.forecaster.hot_seed_sets(base_cfg.forecast_prefetch_top_n)
        tracks = sorted({int(s.split()[1]) for seeds in hot for s in seeds
                         if s.startswith("Track ")})
        rng = np.random.default_rng(16)
        appended = append_rows(os.path.join(pvc, "datasets", FLEET_CSV), [
            track_row(31_000_000 + p, t)
            for p in range(24) for t in tracks + [int(t) for t in rng.integers(0, 4000, size=30)]
        ])
        datasets = os.path.join(pvc, "datasets")
        summary = run_mining_job(MiningConfig(base_dir=pvc, datasets_dir=datasets,
                                              delta_enabled=True), device="cuda")
        if summary.delta_seq != 1:
            fail("phase 16 (c): the delta job published no bundle")
        if app.engine.apply_pending_deltas() != 1:
            fail("phase 16 (c): the app's engine did not apply delta 1")
        cpu = RecommendEngine(ServingConfig(base_dir=pvc, delta_enabled=True), device="cpu")
        if not cpu.load() or cpu.apply_pending_deltas() != 1:
            fail("phase 16 (c): the CPU engine did not load and apply delta 1")
        # the hot sets the delta cooled come back through the pre-fetch;
        # the rest stayed cached
        deadline = time.perf_counter() + 30
        warmed: list = []
        while time.perf_counter() < deadline:
            warmed = [s for s in hot if app.cache.contains(app._cache_key(s))]
            if len(warmed) == len(hot):
                break
            time.sleep(0.02)
        result = {"hot_sets": len(hot), "appended_rows": appended,
                  "prefetch_total": app.forecast_prefetch_total, "cached_hot_sets": len(warmed),
                  "delta_seq": app.engine.delta_seq}
        if app.forecast_prefetch_total < 1 or len(warmed) != len(hot):
            fail(f"phase 16 (c): the delta apply did not re-warm the hot sets: {result}")
        for seeds in warmed:
            got = app.cache.get(app._cache_key(seeds))
            if got is None or got[0] != cpu.recommend(seeds)[0]:
                fail(f"phase 16 (c): the pre-fetched answer for {seeds} != the CPU engine's "
                     f"post-delta answer")
        log(f"phase 16 (c) pre-fetch: {result['prefetch_total']} of {len(hot)} hot sets "
            f"re-warmed after delta {result['delta_seq']}, each == the CPU engine's post-delta "
            "answer")
        return result
    finally:
        app.close()


def predictive(pvc: str) -> dict:
    """Phase 16 (c): ``_LOADSHAPE_PRED_BENCH`` in process on the card —
    ramp (to 3×), sine and constant at 1,000 QPS, 8,000 Zipf 1.1 requests,
    the forecaster off then on at equal capacity; then the pre-fetch after
    a delta. The legs run with the answer cache off: the forecaster feeds
    from the batcher's submit, and after the bench's warm pass every
    measured request would be a cache hit, so no actuator could fire."""
    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.serving.engine import RecommendEngine
    from kmlserver_tpu_torch.serving.replay import sample_seed_sets, shaped_arrivals

    t0 = time.perf_counter()
    # a 30 ms shed budget puts the admission ladder in play (the bench's)
    base_cfg = ServingConfig(base_dir=pvc, batch_max_size=64, request_deadline_ms=2000.0,
                             shed_queue_budget_ms=30.0, cache_enabled=False)
    engine = RecommendEngine(base_cfg, device="cuda")
    if not engine.load():
        fail("phase 16 (c): the engine could not load its PVC")
    vocab = list(engine.bundle.vocab)
    shapes = {}
    for shape, rng_seed in SHAPE_SEEDS.items():
        payloads = sample_seed_sets(vocab, SHAPE_REQUESTS, rng_seed=rng_seed, zipf_s=1.1)
        kw = {"ramp_stop_factor": 3.0} if shape == "ramp" else {}
        arrivals = shaped_arrivals(SHAPE_REQUESTS, SHAPE_QPS, shape, **kw)
        shapes[shape] = {mode: shape_leg(base_cfg, engine, shape, mode == "predictive",
                                         payloads, arrivals)
                         for mode in ("reactive", "predictive")}
    engine.close()
    for shape, legs in shapes.items():
        react, pred = legs["reactive"], legs["predictive"]
        if react["http_5xx"] or pred["http_5xx"]:
            fail(f"phase 16 (c) {shape}: 5xx answers: {legs}")
        if react["observations_delta"] != 0 or pred["forecast_observations"] <= 0:
            fail(f"phase 16 (c) {shape}: forecaster observations off {react['observations_delta']}"
                 f", on {pred['forecast_observations']}")
        if pred["lead_min"] < 0.0:
            fail(f"phase 16 (c) {shape}: the led utilization fell below the reactive one")
    if shapes["ramp"]["predictive"]["prewarm_total"] < 1:
        fail("phase 16 (c): no pre-touch on the ramp")
    result = {"qps": SHAPE_QPS, "requests": SHAPE_REQUESTS, "shapes": shapes,
              "prefetch": prefetch_after_delta(pvc, base_cfg)}
    result["seconds"] = time.perf_counter() - t0
    log(f"phase 16 (c): {result['seconds']:.3f} s")
    return result


def phase_fleet(work: str | None = None, phase8_buckets: list | None = None) -> dict:
    """Phase 16: the serving fleet (``kubernetes/statefulset.yaml``'s
    owner-routed replicas, the gang as a ring peer, the forecaster) on the
    card (alone: ``python -c "import chip_smoke as c; c.phase_fleet()"``)."""
    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.serving.engine import RecommendEngine

    t0 = time.perf_counter()
    own = work is None
    work = work or tempfile.mkdtemp(prefix="kmls_smoke16_")
    try:
        pvc = fleet_pvc(work)
        pvc_b, pvc_c = os.path.join(work, "pvc16b"), os.path.join(work, "pvc16c")
        shutil.copytree(pvc, pvc_b)
        shutil.copytree(pvc, pvc_c)
        t_mine = time.perf_counter() - t0
        # every server of (a) and (b) starts at once
        spawned_a = {me: spawn_server(pvc, **fleet_env(
            me, FLEET_PEERS, POLLING_WAIT_IN_MINUTES=FLEET_POLL, KMLS_DELTA_ENABLED="1",
            KMLS_CACHE_MAX_ENTRIES=str(FLEET_CACHE))) for me in FLEET_PEERS}
        spawned_b = {me: spawn_server(pvc_b, **fleet_env(
            me, SLOW_PEERS, **({"KMLS_FAULT_FLEET_PEER_DELAY_MS": f"1:{SLOW_STALL_MS}:-1"}
                               if me == "replica-1" else {}))) for me in SLOW_PEERS}
        port = gang_ports()
        spawned_g = [spawn_server(pvc_b, **{
            **gang_env(port, rank), "KMLS_CACHE_ENABLED": "1", "KMLS_DELTA_ENABLED": "0",
            **LADDER_OFF,
            "KMLS_FLEET_SELF": "gang", "KMLS_FLEET_PEERS": "gang", "KMLS_HEDGE_DELAY_MS": "20",
            "KMLS_HEDGE_MAX_FRAC": "0.5", "KMLS_PEER_SLOW_RATIO": "3.0",
            **({"KMLS_FAULT_MESH_PEER_DELAY_MS": f"1:{SLOW_STALL_MS}:12"} if rank == 1 else {}),
        }) for rank in range(2)]
        cpu = RecommendEngine(ServingConfig(base_dir=pvc, delta_enabled=True), device="cpu")
        cpu_b = RecommendEngine(ServingConfig(base_dir=pvc_b), device="cpu")
        card = RecommendEngine(ServingConfig(base_dir=pvc_b), device="cuda")
        if not (cpu.load() and cpu_b.load() and card.load()):
            fail("phase 16: an engine could not load its PVC")
        t_up = time.perf_counter()
        servers_a = {me: await_server(s) for me, s in spawned_a.items()}
        servers_b = {me: await_server(s) for me, s in spawned_b.items()}
        gang = [await_server(s) for s in spawned_g]
        t_up = time.perf_counter() - t_up
        log(f"phase 16: 7 servers up on the card in {t_up:.3f} s after the engines' load "
            f"(fleet {', '.join(b for _p, b, _l in servers_a.values())}; pair "
            f"{', '.join(b for _p, b, _l in servers_b.values())}; gang "
            f"{', '.join(b for _p, b, _l in gang)})")
        fleet = fleet_routed(pvc, servers_a, cpu, card, phase8_buckets)
        card.close()
        gray = gray_failure(pvc_b, servers_b, gang, cpu_b)
        unwarmed = {me: server_unwarmed(lines) for me, (_p, _b, lines)
                    in list(servers_a.items()) + list(servers_b.items())}
        stop_spawned()  # (c) measures on a quiet card
        pred = predictive(pvc_c)
        seconds = time.perf_counter() - t0
        result = {"fleet": fleet, "gray": gray, "predictive": pred, "unwarmed": unwarmed,
                  "reduced": [f"(b): {SLOW_REQUESTS} requests a leg, the gang leg "
                              f"{max(100, SLOW_REQUESTS // 2)} (the bracket's 600 / 300): "
                              "the whole smoke took 1,061.694 s with 600"],
                  "seconds": {"mine": t_mine, "servers_up": t_up, "a": fleet["seconds"],
                              "b": gray["seconds"], "c": pred["seconds"], "phase": seconds}}
        if any(unwarmed.values()):
            fail(f"phase 16: unwarmed dispatches on the servers: {unwarmed}")
        log(f"phase 16 seconds {seconds:.3f} (mine {t_mine:.3f}, servers up {t_up:.3f}, (a) "
            f"{fleet['seconds']:.3f}, (b) {gray['seconds']:.3f}, (c) {pred['seconds']:.3f})")
        log("PHASE16 " + json.dumps(result, default=str))
        return result
    finally:
        stop_spawned()
        if own:
            shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 17

# the port's native host libraries (kmlserver_tpu_torch/native/<name>.cpp)
NATIVE_SOURCES = ("kmls_csv", "kmls_popcount", "kmls_serve")
NATIVE_READS = 3  # each reader's best of this many reads of the ds2 CSV
SWEEP_POINTS = 68  # the reference grid: arange(0.03, 0.2, 0.0025)
ROUTE_NAMES = {"dense": "dense-fused", "bitpack": "bitpack-cuda", "sparse": "sparse-hybrid"}


def lscpu_model() -> str:
    """The host CPU's model name, which host-native times need: ``lscpu``'s,
    else ``/proc/cpuinfo``'s, with the core count."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    names = [line.split(":", 1)[1].strip() for line in out.splitlines()
             if line.startswith("Model name:")]
    if not names or names[0] in ("", "unknown", "-"):
        try:
            with open("/proc/cpuinfo") as fh:
                names = [line.split(":", 1)[1].strip() for line in fh
                         if line.startswith("model name")]
        except OSError:
            names = []
    name = names[0] if names and names[0] else "not measured"
    return f"{name}, {os.cpu_count()} cores"


def build_native() -> dict:
    """Build (one g++ each, all started together) and load the three
    native libraries from the port's sources → their build records; fails
    the smoke when one does not build, load, or come from ``build/``."""
    from concurrent.futures import ThreadPoolExecutor

    from kmlserver_tpu_torch.data import native as csv_native
    from kmlserver_tpu_torch.ops import cpu_popcount
    from kmlserver_tpu_torch.serving import native_serve
    from kmlserver_tpu_torch.utils import nativelib

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(NATIVE_SOURCES)) as pool:
        futures = {name: pool.submit(nativelib.build, name) for name in NATIVE_SOURCES}
    for name, fut in futures.items():
        if fut.exception() is not None:
            fail(f"native library {name} did not build: {fut.exception()}")
    wall = time.perf_counter() - t0
    loaders = {"kmls_csv": csv_native._loader, "kmls_popcount": cpu_popcount._loader,
               "kmls_serve": native_serve._LIB}
    records = {}
    for name, loader in loaders.items():
        if loader.load() is None:
            fail(f"native library {name} did not load: {loader.error}")
        path = loader._lib._name
        if not path.startswith(str(nativelib.BUILD_DIR) + os.sep):
            fail(f"native library {name} loaded from {path}, not {nativelib.BUILD_DIR}")
        records[name] = {**nativelib.BUILD_LOG[name], "path": os.path.relpath(path, ROOT)}
    log(f"build: {', '.join(f'{n}.cpp' for n in NATIVE_SOURCES)} in {wall:.3f} s (g++ "
        + ", ".join(f"{n} {r['seconds']:.3f} s, digest {r['digest']}" for n, r in records.items())
        + f"; {next(iter(records.values()))['compiler']})")
    return {"wall_s": wall, "libraries": records}


def best_read_s(read, reps: int = NATIVE_READS) -> tuple[float, object]:
    best, table = None, None
    for _ in range(reps):
        t0 = time.perf_counter()
        table = read()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, table


def csv_rows(path: str) -> list[str]:
    """A results CSV's lines without the duration column."""
    with open(path) as fh:
        return [line.rsplit(",", 1)[0] for line in fh.read().splitlines()]


def phase_native(work: str | None = None, builds: dict | None = None) -> dict:
    """Phase 17: the host-native routes and the measured dispatch (alone:
    ``python -c "import chip_smoke as c; c.phase_native()"``, which writes
    its own ds2 CSV)."""
    import torch

    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.data import native as csv_native
    from kmlserver_tpu_torch.data.csv import parse_tracks, read_tracks, write_tracks_csv
    from kmlserver_tpu_torch.data.synthetic import DS2_SHAPE, synthetic_table
    from kmlserver_tpu_torch.io import artifacts
    from kmlserver_tpu_torch.mining import dispatch, sweep
    from kmlserver_tpu_torch.serving import native_serve
    from kmlserver_tpu_torch.serving.engine import RecommendEngine
    from kmlserver_tpu_torch.serving.replay import sample_seed_sets

    t_phase = time.perf_counter()
    own = work is None
    work = work or tempfile.mkdtemp(prefix="kmls_smoke17_")
    try:
        builds = builds or build_native()
        cpu_model = lscpu_model()
        csv_src = os.path.join(work, "pvc", "datasets", "2023_spotify_ds2_synthetic.csv")
        if not os.path.exists(csv_src):
            os.makedirs(os.path.dirname(csv_src))
            write_tracks_csv(csv_src, synthetic_table(**DS2_SHAPE, seed=7))
        pvcs = {}
        for side in ("card", "cpu"):
            pvcs[side] = os.path.join(work, f"pvc17_{side}")
            os.makedirs(os.path.join(pvcs[side], "datasets"))
            shutil.copy(csv_src, os.path.join(pvcs[side], "datasets"))

        # (b) the card job reads its CSV through the native reader
        out, launches, card_job_s = run_job(pvcs["card"], "phase 17 card")
        reader = [line for line in out.splitlines() if line.startswith("CSV reader:")]
        if not reader or not reader[0].startswith("CSV reader: native ("):
            fail(f"phase 17: the card job's CSV load did not go through the native reader "
                 f"({reader})")
        job_read_s = float(reader[0].split("(")[1].split()[0])
        native_s, table_n = best_read_s(lambda: read_tracks(csv_src))
        loads = dict(csv_native.LOADS)
        if loads["stdlib"]:
            fail(f"phase 17: read_tracks fell back to the stdlib parser ({loads})")

        def stdlib_read():
            with open(csv_src, newline="", encoding="utf-8", errors="replace") as fh:
                return parse_tracks(fh, csv_src)

        stdlib_s, table_s = best_read_s(stdlib_read)
        for field in ("pid", "track_name", "track_uri", "artist_name", "artist_uri", "album_name"):
            if not np.array_equal(np.asarray(getattr(table_n, field)),
                                  np.asarray(getattr(table_s, field))):
                fail(f"phase 17: the native reader's {field} != the stdlib parser's")
        reads = {"rows": len(table_n), "bytes": os.path.getsize(csv_src),
                 "job_native_s": job_read_s, "native_s": native_s, "stdlib_s": stdlib_s}
        log(f"phase 17 (b): the card job read {len(table_n)} rows through the native reader in "
            f"{job_read_s:.6f} s; in process (best of {NATIVE_READS}) native {native_s:.6f} s, "
            f"stdlib csv {stdlib_s:.6f} s, tables equal (host CPU {cpu_model})")

        # (c) the same job on the CPU: the native counter, no NOTE, same publication
        t0 = time.perf_counter()
        cpu_out, _ = job_process(pvcs["cpu"], "phase 17 cpu", KMLS_TORCH_DEVICE="cpu")
        cpu_job_s = time.perf_counter() - t0
        if "Pair-count path: native-cpu" not in cpu_out:
            fail("phase 17: the CPU job did not count through the native counter")
        if any(line.startswith("NOTE:") for line in cpu_out.splitlines()):
            fail("phase 17: the CPU job printed a NOTE: line")
        if not same_publication(pvcs["card"], pvcs["cpu"]):
            fail("phase 17: the CPU job's publication != the card job's")
        phases = [line for line in cpu_out.splitlines() if line.startswith("Phase timings:")]
        log(f"phase 17 (c): the CPU job took native-cpu in {cpu_job_s:.3f} s wall (card job "
            f"{card_job_s:.3f} s, {launches} launches), no NOTE, publication == the card job's; "
            f"{phases[0] if phases else ''}")

        # (d) config 5's draws through the CPU engine's native lookup and X1 on the card
        cfg = ServingConfig(base_dir=pvcs["card"])
        cpu = RecommendEngine(cfg, device="cpu")
        card = RecommendEngine(cfg, device="cuda")
        if not (cpu.load() and card.load()):
            fail("phase 17: an engine could not load the PVC")
        if cpu.bundle.host_rule_ids is None or card.bundle.host_rule_ids is not None:
            fail("phase 17: the CPU engine must serve natively and the card engine on the card")
        keys = sorted(artifacts.load_pickle(os.path.join(cfg.pickles_dir, cfg.recommendations_file)))
        payloads = sample_seed_sets(keys, CONFIG5_REQUESTS)
        calls = native_serve.CALLS["serve_topk"]
        t0 = time.perf_counter()
        got = engine_answers(cpu, payloads)
        cpu_serve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = engine_answers(card, payloads)
        card_serve_s = time.perf_counter() - t0
        batches = (len(payloads) + 31) // 32
        if native_serve.CALLS["serve_topk"] - calls != batches:
            fail(f"phase 17: {native_serve.CALLS['serve_topk'] - calls} native lookups for "
                 f"{batches} batches")
        if got != want:
            bad = sum(a != b for a, b in zip(got, want))
            fail(f"phase 17: {bad} of {len(payloads)} CPU native answers != the card's")
        stats_cpu = cpu.cost_model.kernel_stats().get("serve_native", {})
        stats_card = card.cost_model.kernel_stats().get("serve_rules", {})
        serving = {"draws": len(payloads), "batches": batches, "cpu_s": cpu_serve_s,
                   "card_s": card_serve_s,
                   "native_ms_per_batch": 1e3 * stats_cpu["device_s"] / stats_cpu["dispatches"],
                   "x1_ms_per_batch": 1e3 * stats_card["device_s"] / stats_card["dispatches"]}
        card.close()
        cpu.close()
        log(f"phase 17 (d): {len(payloads)} config-5 draws in {batches} batches of 32: the CPU "
            f"engine's native lookup == X1 on the card, every answer; native "
            f"{serving['native_ms_per_batch']:.4f} ms a batch ({cpu_serve_s:.3f} s in all), "
            f"X1 dispatch → event {serving['x1_ms_per_batch']:.4f} ms ({card_serve_s:.3f} s)")

        # (e) the support sweep over the reference grid, on the card and on the CPU
        sweeps = {}
        for side, extra in (("card", {}), ("cpu", {"KMLS_TORCH_DEVICE": "cpu"})):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "kmlserver_tpu_torch.mining.sweep"], cwd=ROOT,
                capture_output=True, text=True, timeout=600,
                env=subproc_env(BASE_DIR=pvcs[side],
                                DATASETS_DIR=os.path.join(pvcs[side], "datasets"), **extra))
            wall = time.perf_counter() - t0
            if proc.returncode != 0 or f"wrote {SWEEP_POINTS} sweep points" not in proc.stdout:
                log(proc.stdout[-3000:] + proc.stderr[-3000:])
                fail(f"phase 17: the {side} support sweep failed (exit {proc.returncode})")
            counted = [line for line in proc.stdout.splitlines()
                       if line.startswith("pair counts once:")]
            sweeps[side] = {"wall_s": wall, "count_line": counted[0] if counted else ""}
        rows = {side: csv_rows(os.path.join(pvcs[side], sweep.RESULTS_FILE)) for side in pvcs}
        if rows["card"] != rows["cpu"] or len(rows["card"]) != SWEEP_POINTS + 1:
            fail("phase 17: the card's support sweep != the CPU's (durations aside)")
        log(f"phase 17 (e): support sweep, {SWEEP_POINTS} points: card {sweeps['card']['wall_s']:.3f}"
            f" s wall ({sweeps['card']['count_line']}), CPU {sweeps['cpu']['wall_s']:.3f} s "
            f"({sweeps['cpu']['count_line']}); the two CSVs equal but for the durations")

        # (f) the density sweep over the reference grid, banked into a temp table
        dev = torch.device("cuda")
        t0 = time.perf_counter()
        records = sweep.run_density_sweep(repeat=sweep.BANK_REPEAT, device=dev)
        density_s = time.perf_counter() - t0
        if not records or not all(r["identical"] for r in records):
            fail(f"phase 17: a density-sweep point is not identical: {records}")
        table = sweep.bank_density_table(records, dev, os.path.join(work, "table17.json"))
        packaged = dispatch.load_table()
        gpu = table["backends"].get("gpu")
        if gpu is None or torch.cuda.get_device_name(0) not in gpu["measured_on"]:
            fail(f"phase 17: the banked table has no gpu backend measured on the card")
        if table["backends"]["cpu"] != packaged["backends"]["cpu"]:
            fail("phase 17: banking the gpu cells moved the cpu cells")
        packaged_gpu = packaged["backends"].get("gpu", {}).get("cells", {})
        flips = {cell: (packaged_gpu.get(cell, {}).get("path"), rec["path"])
                 for cell, rec in gpu["cells"].items()
                 if packaged_gpu.get(cell, {}).get("path") != rec["path"]}
        log(f"phase 17 (f): density sweep, {len(records)} points in {density_s:.3f} s, every "
            f"point identical; winners " + ", ".join(
                f"{r['shape']}@{r['density']:.5f} {r['winner']}" for r in records)
            + f"; cells whose winner differs from the packaged table's: {flips or 'none'}")
        seconds = time.perf_counter() - t_phase
        result = {"builds": builds, "host_cpu": cpu_model, "reads": reads,
                  "cpu_job_s": cpu_job_s, "card_job_s": card_job_s, "serving": serving,
                  "sweeps": sweeps, "density": {"seconds": density_s, "records": records,
                                                "flips": flips},
                  "seconds": seconds}
        log(f"phase 17 seconds {seconds:.3f}")
        log("PHASE17 " + json.dumps(result, default=str))
        return result
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- phase 18

# BASELINE config 4 (BASELINE.json): 10M playlists x 1M tracks x 500M rows
CONFIG4 = dict(playlists=10_000_000, tracks=1_000_000, rows=500_000_000)
CONFIG4_QUICK = dict(playlists=1_000_000, tracks=1_000_000, rows=50_000_000)
CONFIG4_RANKS = dict(playlists=1_000_000, tracks=1_000_000, rows=50_000_000)  # phase 5's
CONFIG4_MIN_SUPPORT = 5e-4
CONFIG4_SEED = 7
CONFIG4_SAMPLE_ROWS = 16  # rows of the generated bitset held against the plain generator
CONFIG4_BEYOND_ROWS = 256  # tracks past the candidate cut drawn to show none is frequent
# thread-instructions an SM issues per clock: 4 schedulers x 32 lanes (the
# width of its fp32 units, 67 TFLOP/s over 132 SMs at 1,980 MHz with an FMA
# as two); a kernel of integer work on every pipe cannot issue faster
ISSUE_PER_CLOCK_PER_SM = 128
# the fewest instructions a draw of bernoulli_bits.cu can take: 20 rounds
# of add, funnel-shift rotate and xor, each depending on the last (60; the
# key injections can fold into the adds), then the halves' xor, the shift
# and or into a float, and its compare (4)
THREEFRY_MIN_INSTRUCTIONS = 64
# (n_playlists, v_pad, w_width, row_block, word_offset, seed, rows with q > 0
# or None for all): a ragged P, row blocks 8 / 32 / 64, a slab past word 0,
# seeds with bit 31 set, a counter past 2^32 (rows 64.. of a 128-row block
# at 2^21 words: (64 * 2^21 + w) * 32 >= 2^32)
BERNOULLI_EDGES = [
    (1000, 64, 32, 32, 0, 7, None),
    (1000, 64, 40, 8, 0, 2**31 + 5, None),
    (4099, 128, 130, 64, 0, 3, None),
    (5000, 96, 70, 32, 100, 2**32 - 1, None),
    (31, 32, 1, 32, 0, 0, None),
    (1 << 26, 128, 1 << 21, 128, 0, 2**31 + 1, [0, 63, 64, 65, 127]),
]


# q of the threshold's edges: k * 2^-23 and one ulp either side for k in
# {1, 7, 2^22, 2^23 - 1}, 2^-24, the smallest subnormal, 0.5 and 1.0
EDGE_Q = [float(f(np.float32(k * 2.0**-23)))
          for k in (1, 7, 2**22, 2**23 - 1)
          for f in (lambda x: x, lambda x: np.nextafter(x, np.float32(0)),
                    lambda x: np.nextafter(x, np.float32(2)))] + [
    2.0**-24, float(np.float32(1.4e-45)), 0.5, 1.0]
# the straddle sweep's (v_pad, w_width, row_block): its last real word is
# word L of the first tile for every lane L, with 1..31 of its bits real
STRADDLE_SHAPE = (32, 40, 32)


def edge_probs(v_pad: int, live, seed: int):
    """q for a generator edge case: uniform draws with a q-0 row, a q-1
    row and zero pad rows (``live``: only those rows above 0); where every
    row is live, rows 6.. hold the threshold's edges of :data:`EDGE_Q`."""
    rng = np.random.default_rng(seed)
    q = rng.random(v_pad).astype(np.float32)
    q[1], q[2] = 0.0, 1.0
    if live is None:
        q[6:6 + len(EDGE_Q)] = EDGE_Q
    q[-3:] = 0.0
    if live is not None:
        keep = np.zeros(v_pad, dtype=bool)
        keep[live] = True
        q[~keep] = 0.0
    return q


def on_a_draw(q, keys, rows, row_block: int, w_width: int, word_offset: int, n_playlists: int):
    """Sit three rows' q on one of their own draws: ``q[r] = u`` for a draw
    ``u = k * 2^-23`` of row ``r`` at a real position, then one ulp below
    and one above it on the next rows (each on its own draw), so the
    compare at the limit decides a bit the plain version also decides."""
    import torch

    from kmlserver_tpu_torch.ops import threefry

    keys = np.asarray(keys, dtype=np.int64) & 0xFFFFFFFF
    moves = (lambda u: u, lambda u: np.nextafter(u, np.float32(0)),
             lambda u: np.nextafter(u, np.float32(2)))
    real = max(0, min(w_width * 32, n_playlists - word_offset * 32))
    for i, (r, move) in enumerate(zip(rows, moves)):
        pos = (37 * i + 5) % real
        n = (r % row_block) * w_width * 32 + pos
        k = keys[r // row_block]
        bits = threefry.bits_at(int(k[0]), int(k[1]), torch.as_tensor([n]))
        u = np.float32(threefry.uniform_from_bits(bits).numpy()[0])
        q[r] = move(u) if u > 0 else np.float32(2.0**-23)
    return q


def bernoulli_vs_plain(keys, q, rows, label: str, **kw) -> int:
    """One launch of the generator against its plain version on ``rows``,
    exact; the launch moves its counter by one → the largest difference."""
    import torch

    from kmlserver_tpu_torch.ops import bernoulli

    before = bernoulli.LAUNCHES["bernoulli_bits"]
    got = bernoulli.bernoulli_words(keys, q, **kw)
    torch.cuda.synchronize()
    if bernoulli.LAUNCHES["bernoulli_bits"] != before + 1:
        fail("bernoulli_bits: a launch did not move its counter by one")
    want = bernoulli.bernoulli_words_plain(keys, q, rows=rows, **kw)
    part = got[rows]
    if not torch.equal(part, want):
        fail(f"bernoulli_bits != plain at {label}: {int((part != want).sum())} words differ")
    return int((part.long() - want.long()).abs().max())


def phase_bernoulli_edges() -> int:
    """Phase 18 (a): the generator kernel against its plain version at
    every edge case, exact; each launch moves its counter by one. Every
    case has rows whose q sits on, and one ulp around, one of their own
    draws; the straddle sweep ends the real playlists inside the word of
    every lane of a tile."""
    import torch

    from kmlserver_tpu_torch.data import device_synthetic as ds

    max_err = 0
    for n_playlists, v_pad, w_width, row_block, offset, seed, live in BERNOULLI_EDGES:
        kw = dict(row_block=row_block, w_width=w_width, word_offset=offset,
                  n_playlists=n_playlists)
        keys = ds.shard_keys(seed, 3, v_pad // row_block)
        q = edge_probs(v_pad, live, seed & 0xFFFF)
        on_a_draw(q, keys, [3, 4, 5] if live is None else live[1:4], **kw)
        q = torch.as_tensor(q, device="cuda")
        rows = list(range(v_pad)) if live is None else [*live, 1, v_pad - 1]
        label = (f"P {n_playlists}, ({v_pad}, {w_width}), row block {row_block}, word offset "
                 f"{offset}, seed {seed}")
        max_err = max(max_err, bernoulli_vs_plain(keys, q, rows, label, **kw))
        log(f"phase 18 (a) bernoulli_bits == plain: {label}, {len(rows)} rows checked, q on and "
            f"one ulp around a draw (exact)")
    v_pad, w_width, row_block = STRADDLE_SHAPE
    for lane in range(32):
        offset = lane % 3
        n_playlists = (offset + lane) * 32 + 1 + (7 * lane) % 31
        kw = dict(row_block=row_block, w_width=w_width, word_offset=offset,
                  n_playlists=n_playlists)
        keys = ds.shard_keys(lane, 1, v_pad // row_block)
        q = torch.as_tensor(on_a_draw(edge_probs(v_pad, None, lane), keys, [3, 4, 5], **kw),
                            device="cuda")
        max_err = max(max_err, bernoulli_vs_plain(
            keys, q, list(range(v_pad)), f"the straddle at lane {lane} (P {n_playlists})", **kw))
    log(f"phase 18 (a) bernoulli_bits == plain: n_playlists ends inside the word of each of a "
        f"tile's 32 lanes, 1..31 bits real, word offsets 0..2 (exact)")
    return max_err


# SASS opcodes by the pipe that issues them on sm_90: the integer ALU pipe
# (logic, shifts, compares, selects, IADD3) and the FMA-heavy pipe (IMAD in
# every form, IMAD.HI and IMAD.WIDE included); each takes a warp
# instruction every other clock
ALU_OPS = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA", "IMNMX", "FLO", "BMSK",
           "PLOP3", "IABS", "SGXT", "BREV", "FSEL", "FSETP", "MOV", "P2R", "R2P")
FMA_OPS = ("IMAD", "IMUL", "FFMA", "FMUL", "FADD", "IDP")


def sass_pipes(library: str, kernel: str) -> dict:
    """``kernel``'s SASS in ``library`` by the toolkit's ``cuobjdump -sass``:
    its instructions on the ALU pipe, on the FMA pipe and in all, and its
    opcode counts (modifiers kept)."""
    import re
    from collections import Counter

    from kmlserver_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    ops: Counter = Counter()
    inside = False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            ops[m.group(1)] += 1
    if not ops:
        fail(f"no SASS of {kernel} in {library}")
    return {"alu": sum(n for op, n in ops.items() if op.split(".")[0] in ALU_OPS),
            "fma": sum(n for op, n in ops.items() if op.split(".")[0] in FMA_OPS),
            "all": sum(ops.values()), "ops": dict(ops)}


def bernoulli_bound(draws: int, out_bytes: int) -> dict:
    """The least time for the generator: the fewest instructions of every
    draw the function needs (:data:`THREEFRY_MIN_INSTRUCTIONS` each) at the
    card's issue rate and maximum SM clock, or its bitset written once over
    the memory rate, the larger."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = 1e6 * float(nvidia_smi_query("clocks.max.sm").split()[0])
    ops = draws * THREEFRY_MIN_INSTRUCTIONS
    t_ops = 1e3 * ops / (ISSUE_PER_CLOCK_PER_SM * sms * clock_hz)
    t_bytes = 1e3 * out_bytes / PEAK_BYTES_PER_S
    by_ops = t_ops >= t_bytes
    return {"ms": max(t_ops, t_bytes), "bound_by": "operations" if by_ops else "bytes",
            "unit": "issue slots" if by_ops else "HBM3", "ops_ms": t_ops, "bytes_ms": t_bytes,
            "draws": draws, "instructions": ops, "bytes": out_bytes, "clock_hz": clock_hz,
            "sms": sms}


def config4_args(shape: dict) -> list[str]:
    return ["--device-gen", "--playlists", str(shape["playlists"]), "--tracks",
            str(shape["tracks"]), "--rows", str(shape["rows"]), "--min-support",
            str(CONFIG4_MIN_SUPPORT), "--seed", str(CONFIG4_SEED)]


def json_lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def config4_probs(shape: dict):
    """(q over the vocabulary, candidates, min_count, q_padded on the card)."""
    import torch

    from kmlserver_tpu_torch.data import device_synthetic as ds
    from kmlserver_tpu_torch.ops import popcount as pc
    from kmlserver_tpu_torch.ops.support import min_count_for

    p = shape["playlists"]
    q = ds.zipf_bit_probs(shape["tracks"], p, shape["rows"])
    min_count = min_count_for(CONFIG4_MIN_SUPPORT, p)
    f = ds.candidate_frequent_count(q, p, min_count)
    v_pad, _ = pc.padded_shape(f, p)
    q_padded = np.zeros(v_pad, dtype=np.float32)
    q_padded[:f] = q[:f]
    return q, f, min_count, torch.as_tensor(q_padded, device="cuda")


def config4_on_card(shape: dict) -> dict:
    """Phase 18 (b): ``python -m kmlserver_tpu_torch.mining.config4
    --device-gen`` at ``shape`` in a subprocess (the main path: its JSON
    carries its launches), then the same bitset regenerated here and held
    against the plain generator, the popcount kernel's counts against the
    plain count, the diagonal against the model, tracks past the cut drawn
    and counted, the emission against the runner's numbers."""
    import torch

    from kmlserver_tpu_torch.data import device_synthetic as ds
    from kmlserver_tpu_torch.ops import bernoulli, rules, threefry
    from kmlserver_tpu_torch.ops import popcount as pc

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kmlserver_tpu_torch.mining.config4", *config4_args(shape)],
        cwd=ROOT, env=subproc_env(), capture_output=True, text=True, timeout=900,
    )
    runner_s = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"  config4 | {line}")
    if proc.returncode != 0:
        fail(f"phase 18 (b): the config-4 runner exited {proc.returncode}")
    lines = json_lines(proc.stdout)
    if len(lines) != 2:
        fail(f"phase 18 (b): {len(lines)} JSON lines from the runner, want 2 (cold, warm)")
    run = lines[-1]
    want_launches = {"bernoulli_bits": 1, "popcount_pairs": 2, "popcount_pairs_swar": 0}
    if run["launches"] != want_launches or run["count_path"] != "bitpack-cuda-devicegen":
        fail(f"phase 18 (b): launches {run['launches']} / path {run['count_path']}, want "
             f"{want_launches} / bitpack-cuda-devicegen")
    log(f"phase 18 (b) runner ({runner_s:.3f} s wall): {json.dumps(run)}")

    # the same bitset here: the kernel is deterministic
    q, f, min_count, q_dev = config4_probs(shape)
    p = shape["playlists"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bitset, f_here, info = ds.device_synthetic_bitset(
        p, shape["tracks"], shape["rows"], min_count, seed=CONFIG4_SEED, device="cuda")
    torch.cuda.synchronize()
    gen_warm_s = time.perf_counter() - t0
    v_pad, w_pad = bitset.shape
    if f_here != f or f != run["candidate_tracks"]:
        fail(f"phase 18 (b): {f_here} candidates here, {run['candidate_tracks']} in the runner")
    keys = threefry.split(threefry.prng_key(CONFIG4_SEED), v_pad // 32)
    kw = dict(row_block=32, w_width=w_pad, word_offset=0, n_playlists=p)
    gen_ms = cuda_ms(lambda: bernoulli.bernoulli_words(keys, q_dev, **kw), 2)
    # the first row, the last candidate (its words start past 2^31), a pad
    # row and random candidates
    rng = np.random.default_rng(CONFIG4_SEED)
    fixed = [0, f - 1, v_pad - 1]
    rows = sorted(fixed + [int(r) for r in rng.choice(
        np.arange(1, f - 1), CONFIG4_SAMPLE_ROWS - len(fixed), replace=False)])
    t0 = time.perf_counter()
    want_rows = bernoulli.bernoulli_words_plain(keys, q_dev, rows=rows, **kw)
    torch.cuda.synchronize()
    rows_plain_s = time.perf_counter() - t0
    gen_err = int((bitset[rows].long() - want_rows.long()).abs().max())
    if not torch.equal(bitset[rows], want_rows):
        fail(f"phase 18 (b): generated rows != the plain generator's (rows {rows})")
    log(f"phase 18 (b) bitset ({v_pad}, {w_pad}): {len(rows)} rows (first {rows[0]}, last "
        f"candidate {f - 1} from word {(f - 1) * w_pad:,}, pad {v_pad - 1}) == the plain "
        f"generator's ({rows_plain_s:.3f} s); generated again in {gen_warm_s:.3f} s, the kernel "
        f"{gen_ms:.3f} ms by CUDA events")

    counts = pc.popcount_pair_counts_padded(bitset)
    torch.cuda.synchronize()
    count_ms = cuda_ms(lambda: pc.popcount_pair_counts_padded(bitset), 3)
    t0 = time.perf_counter()
    plain = pc.popcount_pair_counts_plain(bitset)
    torch.cuda.synchronize()
    count_plain_ms = 1e3 * (time.perf_counter() - t0)
    count_err = int((plain.long() - counts.long()).abs().max())
    if not torch.equal(plain, counts):
        fail(f"phase 18 (b): popcount kernel != plain at ({v_pad}, {w_pad})")
    del plain
    diag = counts.diagonal()[:f].double().cpu().numpy()
    expect = p * q[:f]
    sigma = np.sqrt(p * q[:f] * (1 - q[:f]))
    z = np.abs(diag - expect) / np.maximum(sigma, 1e-12)
    if (z > 8).any():
        fail(f"phase 18 (b): a candidate's count is {z.max():.2f} sigma from P·q")
    # tracks past the cut: drawn here (the runner never draws them), none
    # reaches min_count
    beyond = q[f:f + CONFIG4_BEYOND_ROWS].astype(np.float32)
    beyond_q = torch.as_tensor(beyond, device="cuda")
    extra = bernoulli.bernoulli_words(
        ds.shard_keys(CONFIG4_SEED + 1, 0, len(beyond) // 32), beyond_q,
        row_block=32, w_width=w_pad, n_playlists=p)
    beyond_max = int(pc.popcount_pair_counts_padded(extra).diagonal().max())
    del extra
    if beyond_max >= min_count:
        fail(f"phase 18 (b): a track past the cut reached {beyond_max} >= {min_count}")
    t0 = time.perf_counter()
    mined = rules.mine_rules_from_counts(
        counts, n_playlists=p, min_support=CONFIG4_MIN_SUPPORT, k_max=64,
        n_total_songs=shape["tracks"])
    emit_s = time.perf_counter() - t0
    here = {"frequent_items": mined.n_frequent_items,
            "n_rules": int((np.asarray(mined.rule_ids) >= 0).sum()),
            "rows_measured": int(mined.item_counts.astype(np.int64).sum())}
    for key, value in here.items():
        if run[key] != value:
            fail(f"phase 18 (b): {key} {value} here, {run[key]} in the runner")
    peak = torch.cuda.max_memory_allocated() / (1 << 30)
    gen_bound = bernoulli_bound(f * p, v_pad * w_pad * 4)
    count_bound = popcount_bound(v_pad, w_pad)
    check_share("bernoulli_bits", gen_ms, gen_bound)
    check_share("popcount_pairs", count_ms, count_bound)
    log(f"phase 18 (b) counts ({v_pad}, {v_pad}): kernel == plain (exact), kernel "
        f"{count_ms:.3f} ms (bound {count_bound['ms']:.3f}, {count_bound['unit']}), plain "
        f"{count_plain_ms:.3f} ms; every candidate within {z.max():.3f} sigma of P·q; "
        f"{len(beyond)} tracks past the cut at most {beyond_max} < {min_count}; emission "
        f"{emit_s:.3f} s here; {here} == the runner's; generator {gen_ms:.3f} ms, bound "
        f"{gen_bound['ms']:.3f} ms ({gen_bound['bound_by']}: {gen_bound['draws']:.6g} draws x "
        f"{THREEFRY_MIN_INSTRUCTIONS} instructions over {gen_bound['sms']} SMs x "
        f"{ISSUE_PER_CLOCK_PER_SM} x {gen_bound['clock_hz'] / 1e6:.0f} MHz; bytes "
        f"{gen_bound['bytes_ms']:.3f} ms); "
        f"peak here {peak:.3f} GiB, the runner's {run.get('peak_gib')} GiB")
    del bitset, counts
    torch.cuda.empty_cache()
    return {"run": run, "runner_s": runner_s, "gen_warm_s": gen_warm_s, "gen_ms": gen_ms,
            "gen_bound": gen_bound, "gen_err": gen_err, "count_ms": count_ms,
            "count_plain_ms": count_plain_ms, "count_bound": count_bound,
            "count_err": count_err, "shape": [v_pad, w_pad], "z_max": float(z.max()),
            "beyond_max": beyond_max, "emit_s": emit_s, "peak_gib": peak}


def worker_config4(_mesh, work: str) -> dict:
    """One rank of phase 18 (c): the runner's main function with ``--mesh
    auto`` (the counters read around it), then this rank's slab against
    the plain sharded generator and the all-reduced counts against one
    launch on the gathered slabs."""
    import torch

    from kmlserver_tpu_torch.data import device_synthetic as ds
    from kmlserver_tpu_torch.mining import config4
    from kmlserver_tpu_torch.ops import bernoulli
    from kmlserver_tpu_torch.ops import popcount as pc
    from kmlserver_tpu_torch.parallel import collectives
    from kmlserver_tpu_torch.parallel.mesh import this_rank

    with open(os.path.join(work, "config4_ranks.json")) as fh:
        shape = json.load(fh)
    keep: dict = {}
    for name in bernoulli.LAUNCHES:
        bernoulli.LAUNCHES[name] = 0
    for name in pc.LAUNCHES:
        pc.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    rc = config4.main([*config4_args(shape), "--mesh", "auto"], keep=keep)
    wall_s = time.perf_counter() - t0
    launches = {**bernoulli.LAUNCHES, **pc.LAUNCHES}
    if rc != 0:
        return {"rc": rc}
    slab, mesh, info = keep["bitset"], keep["mesh"], keep["info"]
    shard = mesh.position(this_rank())[0]
    _, f, _, q_dev = config4_probs(shape)
    v_pad, w_local = slab.shape
    kw = dict(row_block=32, w_width=w_local, word_offset=shard * w_local,
              n_playlists=shape["playlists"])
    keys = ds.shard_keys(CONFIG4_SEED, shard, v_pad // 32)
    t0 = time.perf_counter()
    plain = bernoulli.bernoulli_words_plain(keys, q_dev, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = int((plain.long() - slab.long()).abs().max())
    same = bool(torch.equal(plain, slab))
    del plain
    kernel_ms = cuda_ms(lambda: bernoulli.bernoulli_words(keys, q_dev, **kw), 3)
    whole = collectives.all_gather_cat(slab.t().contiguous(), mesh.axis("dp")).t().contiguous()
    single = pc.popcount_pair_counts_padded(whole)
    torch.cuda.synchronize()
    return {"rc": rc, "wall_s": wall_s, "launches": launches, "shard": shard,
            "slab_shape": [v_pad, w_local], "slab_eq_plain": same, "max_abs_err": err,
            "plain_ms": plain_ms, "kernel_ms": kernel_ms,
            "draws": f * max(0, min(shape["playlists"], (shard + 1) * w_local * 32)
                             - shard * w_local * 32),
            "counts_eq_one_launch": bool(torch.equal(single, keep["counts"])),
            "w_pad": info["w_pad"], "candidates": f}


def config4_ranks(work: str, shape: dict) -> dict:
    """Phase 18 (c): two ranks sharing the card over gloo run the runner
    with ``--mesh auto``; each slab equals the plain sharded generator's,
    the all-reduced counts one launch on the gathered slabs."""
    with open(os.path.join(work, "config4_ranks.json"), "w") as fh:
        json.dump(shape, fh)
    worker = [sys.executable, os.path.abspath(__file__), "--rank-worker", "config4", work]
    t0 = time.perf_counter()
    outs = run_ranks([worker] * RANKS, rank_envs(free_port()), 600, "phase 18 (c)")
    wall_s = time.perf_counter() - t0
    results = [rank_result(out, r) for r, out in enumerate(outs)]
    lines = [json_lines(out)[-1] for out in outs]
    want = {"bernoulli_bits": 1, "popcount_pairs": 2, "popcount_pairs_swar": 0}
    for r, res in enumerate(results):
        if res["rc"] != 0 or res["launches"] != want:
            fail(f"phase 18 (c) rank {r}: exit {res['rc']}, launches {res.get('launches')}")
        if not res["slab_eq_plain"] or not res["counts_eq_one_launch"]:
            fail(f"phase 18 (c) rank {r}: slab == plain {res['slab_eq_plain']}, all-reduced "
                 f"counts == one launch {res['counts_eq_one_launch']}")
        if lines[r]["count_path"] != "bitpack-cuda-devicegen-sharded":
            fail(f"phase 18 (c) rank {r}: count path {lines[r]['count_path']}")
    keys = ("candidate_tracks", "frequent_items", "n_rules", "rows_measured")
    if any(lines[0][k] != lines[1][k] for k in keys):
        fail(f"phase 18 (c): the ranks disagree: {[{k: ln[k] for k in keys} for ln in lines]}")
    for r, res in enumerate(results):
        log(f"phase 18 (c) rank {r} ({res['shard']} on dp, slab {tuple(res['slab_shape'])}): "
            f"runner {res['wall_s']:.3f} s, launches {res['launches']}, slab == the plain "
            f"sharded generator's ({res['plain_ms']:.3f} ms plain, {res['kernel_ms']:.3f} ms "
            f"kernel), all-reduced counts == one launch on the gathered slabs; "
            f"{ {k: lines[r][k] for k in keys} }")
    return {"wall_s": wall_s, "ranks": results, "lines": lines}


def phase_config4(work: str | None = None, quick: bool = False) -> dict:
    """Phase 18: BASELINE config 4 born on the card (``data/device_synthetic.py``,
    ``ops/bernoulli.py`` + ``csrc/bernoulli_bits.cu``, ``mining/config4.py``).
    Alone: ``python -c "import chip_smoke as c; c.phase_config4()"``."""
    import torch

    from kmlserver_tpu_torch.ops import cuda_build

    own = work is None
    work = work or tempfile.mkdtemp(prefix="kmls_phase18_")
    t_phase = time.perf_counter()
    # the ranks' shape stays: it is already small, and below ~1M playlists
    # the candidate cut lets every track through (100k x 100k: 100,096 rows,
    # a 37 GiB count a rank)
    shape, ranks_shape = (CONFIG4_QUICK if quick else CONFIG4), CONFIG4_RANKS
    if quick:
        log(f"reduced: --quick cuts phase 18's config 4 from {CONFIG4} to {shape}")
    try:
        cuda_build.build("bernoulli_bits")
        edge_err = phase_bernoulli_edges()
        card = config4_on_card(shape)
        torch.cuda.empty_cache()
        ranks = config4_ranks(work, ranks_shape)
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"phase 18: {seconds:.3f} s")
    summary = {"seconds": seconds, "shape": shape, "ranks_shape": ranks_shape,
               "edge_err": edge_err, **{k: v for k, v in card.items() if k != "run"},
               "run": card["run"], "ranks": ranks}
    log("PHASE18 " + json.dumps(summary, default=str))
    return summary


# ---------------------------------------------------------------- phase 20

EMBED4_SEED = 20  # phase 20's generator and init seed
EMBED4_HEAD_CHUNK = 32  # head rows the plain version expands at a time
EMBED4_USERS = 64  # playlists whose X F row is held against the in-order sums
EMBED4_TRACKS = 32  # tracks whose Xt U row is


def events_bound(kind: str, *, rows: int = 0, words: int = 0, tracks: int = 0,
                 events: int = 0) -> dict:
    """The least time of one source's event list (its count and write passes
    together): the head's bitset rows read once and its events' two int32
    columns written once, over the memory rate; the tail's draws (one an
    event and one a track, :data:`THREEFRY_MIN_INSTRUCTIONS` each) at the
    card's issue rate and top SM clock, or its probabilities read and its
    events written once, the larger."""
    import torch

    if kind == "bitset_events":
        nbytes, ops = 4 * rows * words + 8 * events, 0
    else:
        nbytes, ops = 8 * tracks + 8 * events, (events + tracks) * THREEFRY_MIN_INSTRUCTIONS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = 1e6 * float(nvidia_smi_query("clocks.max.sm").split()[0])
    ops_ms = 1e3 * ops / (ISSUE_PER_CLOCK_PER_SM * sms * clock_hz)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    return {"ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms > bytes_ms
            else "bytes", "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bytes": nbytes,
            "instructions": ops}


# int32 lane operations a PCG64 raw takes at least: the 128-bit multiply-add
# (16 partial products of 32-bit limbs, 4 adds of the increment), the xor
# and the rotation (kmls_bench/roofline/normals.py)
PCG64_MIN_INSTRUCTIONS = 26


def phase_init_normals(seed: int = EMBED4_SEED, p: int = CONFIG4["playlists"],
                       v: int = CONFIG4["tracks"], rank: int = 32) -> dict:
    """Phase 20 (e): the ALS init's normals at config 4 on the card
    (``ops/normals.py``): the main path's call, its launches counted around
    it, against numpy's draw of the whole init bit for bit; then each
    call timed beside its least time (one raw a value at the issue rate,
    or the values written once). Alone: ``python -c "import chip_smoke as
    c; c.phase_init_normals()"``."""
    import torch

    from kmlserver_tpu_torch.mining import als
    from kmlserver_tpu_torch.ops import cuda_build, normals

    cuda_build.build("normals")
    normals.LAUNCHES["normals"] = 0
    got = normals.init_rows(seed, (p, v), rank, torch.device("cuda"))
    launches = normals.LAUNCHES["normals"]
    if got is None or launches != 2:
        fail(f"phase 20 (e): init_rows gave {'nothing' if got is None else 'rows'} in "
             f"{launches} launches, want rows in 2")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    want = [np.empty((n, rank), dtype=np.float32) for n in (p, v)]
    for w in want:
        als._draw_init(rng, w)
    host_s = time.perf_counter() - t0
    differ = sum(int((g.cpu().numpy().view(np.int32) != w.view(np.int32)).sum())
                 for g, w in zip(got, want))
    if differ:
        fail(f"phase 20 (e): {differ} init values differ from numpy's draw")
    del got, want
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        normals.init_rows(seed, (p, v), rank, torch.device("cuda"))
    torch.cuda.synchronize()
    call_ms = 1e3 * (time.perf_counter() - t0) / 3
    values = (p + v) * rank
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = 1e6 * float(nvidia_smi_query("clocks.max.sm").split()[0])
    ops_ms = 1e3 * values * PCG64_MIN_INSTRUCTIONS / (ISSUE_PER_CLOCK_PER_SM * sms * clock_hz)
    bytes_ms = 1e3 * 4 * values / PEAK_BYTES_PER_S
    out = {"values": values, "launches": launches, "host_draw_s": host_s, "call_ms": call_ms,
           "bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms}
    log(f"phase 20 (e) init_rows at {p} + {v} rows x {rank}: {values} values in {launches} "
        f"launches, == numpy's draw bit for bit (the host's draw {host_s:.3f} s); the call "
        f"{call_ms:.3f} ms (the tails finished on the host included), bound "
        f"{out['bound_ms']:.3f} ms (bytes {bytes_ms:.3f}, operations {ops_ms:.3f})")
    return out


def in_order_sum(mat, idx, chunk: int = 1 << 22) -> np.ndarray:
    """The float32 sum of ``mat``'s rows ``idx`` added in ``idx``'s order
    from 0.0, one add at a time (``np.add.accumulate`` is sequential)."""
    acc = np.zeros(mat.shape[1], dtype=np.float32)
    for lo in range(0, len(idx), chunk):
        cols = mat[idx[lo:lo + chunk]].T.contiguous().cpu().numpy()
        cols[:, 0] = acc + cols[:, 0]
        acc = np.add.accumulate(cols, axis=1)[:, -1].copy()
    return acc


def phase_embed_config4(seed: int = EMBED4_SEED) -> dict:
    """Phase 20: config 4's embed phase at its full shape (10M playlists x
    1M tracks x 500M rows, ``min_support`` 5e-4). Alone: ``python -c
    "import chip_smoke as c; c.phase_embed_config4()"``."""
    import torch

    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.data import device_synthetic as ds
    from kmlserver_tpu_torch.mining import als
    from kmlserver_tpu_torch.mining.vocab import Baskets, Vocab
    from kmlserver_tpu_torch.ops import cuda_build, events, normals, segsum
    from kmlserver_tpu_torch.ops.support import min_count_for

    t_phase = time.perf_counter()
    for name in ("bernoulli_bits", "events", "normals", "segsum"):
        cuda_build.build(name)
    p, v, rows = CONFIG4["playlists"], CONFIG4["tracks"], CONFIG4["rows"]
    min_count = min_count_for(CONFIG4_MIN_SUPPORT, p)

    # ---- (a) the main path's call, its launches counted around it
    for key in events.LAUNCHES:
        events.LAUNCHES[key] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pl, tr = ds.device_synthetic_events(p, v, rows, min_count, seed=seed, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_peak = torch.cuda.max_memory_allocated()
    launches = dict(events.LAUNCHES)
    if launches != {"bitset_events": 2, "tail_events": 2}:
        fail(f"phase 20 (a): launches {launches}, want a count and a write pass each")
    nnz = pl.shape[0]
    log(f"phase 20 (a) device_synthetic_events at {p} x {v} x {rows} (seed {seed}): {nnz} "
        f"events in {gen_s:.3f} s (the first call: the bitset's draw included), launches "
        f"{launches}, peak {gen_peak} B")

    # ---- (b) the same bitset: each kernel's passes timed, its list against the plain version
    q = ds.zipf_bit_probs(v, p, rows, 1.0)
    bitset, f, _ = ds.device_synthetic_bitset(p, v, rows, min_count, seed=seed, device="cuda",
                                              q=q)
    words = -(-p // 32)
    n_head = int(torch.searchsorted(tr, torch.tensor([f], dtype=tr.dtype, device="cuda")))
    head = events.count_bitset(bitset, f, p)
    if int(head.total) != n_head:
        fail(f"phase 20 (b): the head counts {int(head.total)} events, the list {n_head}")
    col_pl = torch.empty(n_head, dtype=torch.int32, device="cuda")
    col_tr = torch.empty_like(col_pl)
    head_ms = {"count": cuda_ms(lambda: events.count_bitset(bitset, f, p), 3),
               "write": cuda_ms(lambda: events.write(head, col_pl, col_tr), 3)}
    if not (torch.equal(col_pl, pl[:n_head]) and torch.equal(col_tr, tr[:n_head])):
        fail("phase 20 (b): the head's write pass differs from the main path's list")
    del col_pl, col_tr, head
    head_diff, t0 = 0, time.perf_counter()
    bounds = torch.searchsorted(tr, torch.arange(0, f + EMBED4_HEAD_CHUNK, EMBED4_HEAD_CHUNK,
                                                 dtype=tr.dtype, device="cuda").clamp_(max=f))
    for i, lo in enumerate(range(0, f, EMBED4_HEAD_CHUNK)):
        hi = min(lo + EMBED4_HEAD_CHUNK, f)
        want_pl, want_tr = events.bitset_events_plain(bitset[lo:hi], hi - lo, p)
        a, b = int(bounds[i]), int(bounds[i + 1])
        if (b - a != want_pl.shape[0] or not torch.equal(pl[a:b], want_pl)
                or not torch.equal(tr[a:b], want_tr + lo)):
            head_diff += 1
    head_plain_s = time.perf_counter() - t0
    if head_diff:
        fail(f"phase 20 (b): {head_diff} chunks of {EMBED4_HEAD_CHUNK} head rows differ "
             f"from the plain version")
    head_bound = events_bound("bitset_events", rows=f, words=words, events=n_head)
    del bitset
    torch.cuda.empty_cache()
    key = events.tail_key(seed)
    q_tail = torch.as_tensor(q[f:], dtype=torch.float64).cuda()
    n_tail = nnz - n_head
    tail = events.count_tail(q_tail, f, p, key)
    col_pl = torch.empty(n_tail, dtype=torch.int32, device="cuda")
    col_tr = torch.empty_like(col_pl)
    tail_ms = {"count": cuda_ms(lambda: events.count_tail(q_tail, f, p, key), 3),
               "write": cuda_ms(lambda: events.write(tail, col_pl, col_tr), 3)}
    del col_pl, col_tr, tail
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_pl, want_tr = events.tail_events_plain(q_tail, f, p, key)
    torch.cuda.synchronize()
    tail_plain_s = time.perf_counter() - t0
    if not (torch.equal(pl[n_head:], want_pl) and torch.equal(tr[n_head:], want_tr)):
        fail(f"phase 20 (b): the tail's list differs from the plain version ({n_tail} against "
             f"{want_pl.shape[0]} events)")
    del want_pl, want_tr
    tail_bound = events_bound("tail_events", tracks=v - f, events=n_tail)
    for name, n, ms, bound, plain_s, what in (
            ("bitset_events", n_head, head_ms, head_bound, head_plain_s,
             f"all {f} head rows, in chunks of {EMBED4_HEAD_CHUNK}"),
            ("tail_events", n_tail, tail_ms, tail_bound, tail_plain_s,
             f"all {v - f} tail tracks")):
        log(f"phase 20 (b) {name}: {n} events, == the plain version bit for bit over {what} "
            f"(plain on the card {plain_s:.3f} s); count {ms['count']:.3f} ms + write "
            f"{ms['write']:.3f} ms = {ms['count'] + ms['write']:.3f} ms; bound "
            f"{bound['ms']:.3f} ms ({bound['bound_by']}: bytes {bound['bytes_ms']:.3f}, "
            f"operations {bound['ops_ms']:.3f})")

    # ---- (c) segsum at the config-4 CSRs: each side timed, chosen rows in order
    rank = MiningConfig().als_rank
    clock_hz = 1e6 * float(nvidia_smi_query("clocks.max.sm").split()[0])
    by_user = segsum.build_csr(pl, tr, p, v)
    by_item = segsum.build_csr(tr, pl, v, p)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    user = torch.randn(p, rank, device="cuda", generator=gen) / rank ** 0.5
    item = torch.randn(v, rank, device="cuda", generator=gen) / rank ** 0.5
    rng = np.random.default_rng(seed)
    lengths = (by_user.offsets[1:] - by_user.offsets[:-1])
    users = sorted({0, p - 1, int(lengths.argmax())}
                   | set(rng.choice(p, EMBED4_USERS - 3, replace=False).tolist()))
    tracks = sorted({0, 1, 2, f - 1, f, v - 1}
                    | set(rng.choice(v, EMBED4_TRACKS - 6, replace=False).tolist()))
    item_bounds = torch.searchsorted(tr, torch.tensor(tracks + [t + 1 for t in tracks],
                                                      dtype=tr.dtype, device="cuda")).tolist()
    sides = {
        "X F": (by_user, item, users,
                [tr[(pl == u).nonzero().flatten()].long() for u in users]),
        "Xt U": (by_item, user, tracks,
                 [pl[a:b].long() for a, b in zip(item_bounds[:len(tracks)],
                                                 item_bounds[len(tracks):])]),
    }
    seg = {}
    for label, (csr, mat, picked, idx) in sides.items():
        got = segsum.segment_sum(mat, csr)
        ms = cuda_ms(lambda: segsum.segment_sum(mat, csr), 3)
        picked_t = torch.tensor(picked, device="cuda")
        want = np.stack([in_order_sum(mat, i) for i in idx])
        differ = int((got[picked_t].cpu().numpy().view(np.int32) != want.view(np.int32)).sum())
        if differ:
            fail(f"phase 20 (c) {label}: {differ} bits of {len(picked)} rows differ from the "
                 f"in-order float32 sums")
        bound = segsum_bound(csr, rank, clock_hz)
        seg[label] = {"ms": ms, "bound_ms": bound["ms"], "bound_term": bound["bound_term"],
                      "bytes_ms": bound["bytes_ms"], "chain_ms": bound["chain_ms"],
                      "longest_row": bound["longest_row"], "long_rows": csr.n_long,
                      "rows_checked": len(picked)}
        log(f"phase 20 (c) segsum {label} (out {csr.n_out} x {rank}, {csr.nnz} events, longest "
            f"row {bound['longest_row']}, {csr.n_long} long rows): {len(picked)} rows == the "
            f"in-order float32 sums bit for bit (the longest included); {ms:.3f} ms, bound "
            f"{bound['ms']:.3f} ms ({bound['bound_term']}: bytes {bound['bytes_ms']:.3f}, chain "
            f"{bound['chain_ms']:.3f})")
    del by_user, by_item, user, item, sides, got

    # ---- (d) the embed phase's call over the list: sparse, 17 segsum launches,
    # the init drawn on the card (2 normals launches)
    names = [f"track_{t:07d}" for t in range(v)]
    baskets = Baskets(playlist_rows=pl, track_ids=tr, n_playlists=p,
                      vocab=Vocab(names=names, index={}))
    cfg = MiningConfig(embed_enabled=True)
    segsum.LAUNCHES["segsum"] = 0
    normals.LAUNCHES["normals"] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = als.train_embeddings(baskets, cfg, seed=seed, device="cuda")
    train_s = time.perf_counter() - t0
    seg_launches = segsum.LAUNCHES["segsum"]
    if (out["storage"] != "sparse" or seg_launches != 2 * cfg.als_iters + 1
            or normals.LAUNCHES["normals"] != 2):
        fail(f"phase 20 (d): storage {out['storage']}, {seg_launches} segsum and "
             f"{normals.LAUNCHES['normals']} normals launches, want sparse, "
             f"{2 * cfg.als_iters + 1} and 2")
    if not np.isfinite(out["item_factors"]).all():
        fail("phase 20 (d): non-finite factors")
    train_peak = torch.cuda.max_memory_allocated()
    log(f"phase 20 (d) train_embeddings over the {nnz} events (R={cfg.als_rank}, "
        f"{cfg.als_iters} iters, auto): {out['storage']}, {seg_launches} segsum launches "
        f"(2 a sweep, 1 the loss's), "
        f"{train_s:.3f} s, loss {out['final_loss']:.6f}, peak {train_peak} B")
    del baskets, pl, tr
    torch.cuda.empty_cache()
    init = phase_init_normals(seed, p, v, cfg.als_rank)
    summary = {"seconds": time.perf_counter() - t_phase, "seed": seed, "events": nnz,
               "head_events": n_head, "candidates": f, "gen_s": gen_s, "gen_peak": gen_peak,
               "launches": launches,
               "bitset_events": {"ms": head_ms, "bound": head_bound, "plain_s": head_plain_s},
               "tail_events": {"ms": tail_ms, "bound": tail_bound, "plain_s": tail_plain_s},
               "segsum": seg, "train_s": train_s, "segsum_launches": seg_launches,
               "train_peak": train_peak, "init": init}
    log(f"phase 20: {summary['seconds']:.3f} s")
    log("PHASE20 " + json.dumps(summary, default=str))
    return summary


# ---------------------------------------------------------------- phase 19

SYNC_GUARD_SHARDS = 2  # the sharded layout's slabs, both on cuda:0
SYNC_GUARD_SEED = 19


def guard_batches(engine, rule_names: list, emb_names: list, rng) -> list[list[list[str]]]:
    """One batch per warmed (batch, length) bucket of ``engine``: ``batch``
    seed sets of exactly ``length`` names (drawn with replacement, so the
    set lands in that bucket whatever the vocabulary's size), each led by a
    name the rule vocabulary knows (the rule lookup launches) and, where
    ``emb_names`` is given, continued from the embedding vocabulary (the
    embedding lookup launches too)."""
    pool = emb_names or rule_names
    batches = []
    for length in engine._len_buckets():
        for batch in engine._batch_buckets():
            if (batch, length) not in engine.bundle.warmed_shapes:
                fail(f"phase 19: bucket {(batch, length)} was not warmed")
            batches.append([
                [rule_names[rng.integers(len(rule_names))]]
                + [pool[i] for i in rng.integers(len(pool), size=length - 1)]
                for _ in range(batch)])
    return batches


def guarded_dispatches(label: str, engine, batches: list) -> list:
    """Every batch's dispatch half under ``set_sync_debug_mode("error")``
    (a host synchronization raises), then the mode back to ``default`` and
    every ``finish()`` → the answers, batch by batch."""
    import torch

    torch.cuda.synchronize()  # nothing earlier left for the dispatch to wait on
    finishes = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for sets in batches:
            finishes.append(engine.recommend_many_async(sets))
    except RuntimeError as exc:
        torch.cuda.set_sync_debug_mode("default")
        import traceback

        where = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
                 for f in traceback.extract_tb(exc.__traceback__)
                 if "kmlserver_tpu_torch" in f.filename]
        fail(f"phase 19 {label}: the dispatch of a {len(sets)} x {len(sets[0])} batch "
             f"synchronized the host at {where[-1] if where else '?'}: {exc}")
    torch.cuda.set_sync_debug_mode("default")
    return [finish() for finish in finishes]


def phase_sync_guard(work: str | None = None) -> dict:
    """Phase 19: the dispatch half of the rules, blend and sharded engines
    held free of host synchronization on the card, every warmed bucket,
    the answers against the unguarded dispatch and the CPU engine."""
    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.serving.engine import RecommendEngine

    own = work is None
    work = work or tempfile.mkdtemp(prefix="kmls_smoke19_")
    try:
        t0 = time.perf_counter()
        rules_pvc = ds2_pvc(work)
        blend_pvc = os.path.join(work, "pvc_embed")  # phase 11 (a)'s
        if not os.path.exists(os.path.join(blend_pvc, "pickles", "embeddings.npz")):
            os.makedirs(os.path.join(blend_pvc, "datasets"), exist_ok=True)
            shutil.copy(os.path.join(rules_pvc, "datasets", "2023_spotify_ds2_synthetic.csv"),
                        os.path.join(blend_pvc, "datasets"))
            run_job(blend_pvc, "phase 19 blend PVC", KMLS_EMBED_ENABLED="1")
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rules_cfg = ServingConfig(base_dir=rules_pvc)
        layouts = {
            "rules": (RecommendEngine(rules_cfg, device="cuda"), rules_cfg),
            "blend": (RecommendEngine(ServingConfig(base_dir=blend_pvc), device="cuda"),
                      ServingConfig(base_dir=blend_pvc)),
            "sharded": (sharded_engine(ServingConfig(base_dir=rules_pvc, model_layout="sharded"),
                                       SYNC_GUARD_SHARDS), rules_cfg),
        }
        rng = np.random.default_rng(SYNC_GUARD_SEED)
        dispatches, near_ties, buckets = 0, 0, set()
        per_layout = {}
        for label, (card, cpu_cfg) in layouts.items():
            cpu = RecommendEngine(cpu_cfg, device="cpu")
            if not card.load() or not cpu.load():
                fail(f"phase 19 {label}: an engine could not load its PVC")
            bundle = card.bundle
            if label == "blend" and (bundle.emb_factors is None or card.cfg.hybrid_mode != "blend"):
                fail("phase 19 blend: the engine serves no embeddings in blend mode")
            if label == "sharded" and (bundle.layout != "sharded"
                                        or bundle.n_shards != SYNC_GUARD_SHARDS):
                fail(f"phase 19 sharded: layout {bundle.layout} with {bundle.n_shards} slabs")
            rule_names = [n for n, k in zip(bundle.vocab, bundle.known_mask) if k]
            emb_names = list(bundle.emb_vocab or ()) if label == "blend" else []
            batches = guard_batches(card, rule_names, emb_names, rng)
            guarded = guarded_dispatches(label, card, batches)
            unguarded = [card.recommend_many_async(sets)() for sets in batches]
            ties = 0
            for sets, got, again in zip(batches, guarded, unguarded):
                want = engine_answers(cpu, sets)
                if got != again:
                    fail(f"phase 19 {label}: a guarded {len(sets)} x {len(sets[0])} batch "
                         "answered other than the same batch unguarded")
                for seeds, g, w in zip(sets, got, want):
                    if g == w:
                        continue
                    if label != "blend" or not decisive_near_tie(cpu, seeds):
                        fail(f"phase 19 {label}: answer for {seeds} {g} != the CPU engine's {w}")
                    ties += 1
            if card.unwarmed_dispatches:
                fail(f"phase 19 {label}: {card.unwarmed_dispatches} unwarmed dispatches")
            dispatches += len(batches)
            near_ties += ties
            buckets |= {(len(b), len(b[0])) for b in batches}
            per_layout[label] = {"dispatches": len(batches), "near_ties": ties}
            log(f"phase 19 {label}: {len(batches)} guarded dispatches, one per warmed bucket, "
                f"no raise; answers == unguarded == the CPU engine's ({ties} near-ties)")
            card.close()
            cpu.close()
        seconds = time.perf_counter() - t0
        print(f"sync_guard: layouts={','.join(layouts)} dispatches={dispatches} "
              f"buckets={len(buckets)} seconds={seconds:.3f}", flush=True)
        result = {"layouts": per_layout, "dispatches": dispatches, "buckets": sorted(buckets),
                  "near_ties": near_ties, "seconds": seconds, "setup_s": setup_s}
        log(f"phase 19: every warmed bucket's dispatch of the rules, blend and sharded "
            f"(S = {SYNC_GUARD_SHARDS} on cuda:0) engines ran under "
            f"set_sync_debug_mode('error') without a raise; answers == the unguarded "
            f"dispatch's and the CPU engine's (blend: {near_ties} near-ties); "
            f"{seconds:.3f} s (+ {setup_s:.3f} s making PVCs)")
        log("PHASE19 " + json.dumps(result))
        return result
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


# draws in bernoulli_bits.cu's code: a word's 32, fully unrolled
BERNOULLI_DRAWS_IN_CODE = 32


def bernoulli_entry(c4: dict) -> dict:
    """The generator's entry of the kernels line: its time at config 4
    beside its bound; its plain version timed over a whole rank slab of
    (c), beside the kernel on that slab; the launches of (b)'s runner and
    of each rank's."""
    from kmlserver_tpu_torch.ops import cuda_build

    r0 = c4["ranks"]["ranks"][0]
    ptxas = ptxas_report(cuda_build.BUILD_LOG["bernoulli_bits"]["ptxas"])
    sass = sass_pipes(str(cuda_build.library_path("bernoulli_bits")), "bernoulli_bits_kernel")
    return {
        "name": "bernoulli_bits",
        "route": "cuda",
        "source": "kmlserver_tpu_torch/ops/csrc/bernoulli_bits.cu",
        "replaces": "kmlserver_tpu/data/device_synthetic.py:88-127 (_scan_bernoulli_words "
                    "+ _position_mask; XLA, not Pallas)",
        "launches": c4["run"]["launches"]["bernoulli_bits"],
        "launches_ranks": [r["launches"]["bernoulli_bits"] for r in c4["ranks"]["ranks"]],
        "max_abs_err": max(c4["edge_err"], c4["gen_err"],
                           max(r["max_abs_err"] for r in c4["ranks"]["ranks"])),
        "ms": c4["gen_ms"],
        "plain_ms": r0["plain_ms"],
        "plain_shape": r0["slab_shape"],
        "ms_at_plain_shape": r0["kernel_ms"],
        "bound_ms": c4["gen_bound"]["ms"],
        "bound_by": c4["gen_bound"]["bound_by"],
        "share_of_bound": c4["gen_bound"]["ms"] / c4["gen_ms"],
        "library_ms": None,
        "sass_per_draw": {pipe: n / BERNOULLI_DRAWS_IN_CODE for pipe, n in sass.items()
                          if pipe != "ops"},
        "shape": c4["shape"],
        "draws": c4["gen_bound"]["draws"],
        "gen_device_s_cold": c4["run"]["gen_device_s"],
        "gen_device_s_warm": c4["gen_warm_s"],
        "ptxas_registers": {k: r.get("registers") for k, r in ptxas.items()},
        "ptxas_spill_bytes": {k: {"stores": r.get("spill_store_bytes"),
                                  "loads": r.get("spill_load_bytes")} for k, r in ptxas.items()},
    }


def x9_entry(mp: dict) -> dict:
    """X9's sub-entry of the kernels line: library ops, so calls (phase 15
    (b)'s main path), not launches; per bucket the sharded lookup's ms
    beside the replicated lookup's and the bound."""
    def rows(case: list) -> list[dict]:
        return [{k: r[k] for k in ("shards", "batch", "length", "ms", "partial_ms", "merge_ms",
                                   "replicated_ms", "bound_ms")} for r in case if "ms" in r]

    return {"shards": list(MESH_SHARDS), "calls": mp["sharded"]["calls"],
            "ds2": rows(mp["x9"]["ds2"]), "v_1m": rows(mp["x9"]["scale"]),
            "bound_by": "bytes"}


def save_tensors(work: str, tensors) -> None:
    """Phase 5's rule tensors, for phase 14 (c) to hold its emissions against."""
    np.savez(os.path.join(work, "scale_tensors.npz"), rule_ids=tensors.rule_ids,
             rule_counts=tensors.rule_counts, row_valid_counts=tensors.row_valid_counts,
             item_counts=tensors.item_counts)


def x8_entry(sharded: dict) -> dict:
    """The sharded routes' calls and times for the kernels line: each dense
    schedule, the slab emission, the sparse-sharded count and the sharded
    ALS sweep, by the ranks of phase 14 (b) and (c). They run library ops,
    no hand kernel, so they count calls (``support.CALLS``,
    ``als.CALLS``), not launches."""
    scale = sharded["scale"]
    r0 = scale["ranks"][0]
    t = r0["times"]
    calls: dict[str, int] = {}
    counted = [c["calls"] for res in sharded["ds2"].values() for c in res["impls"].values()]
    counted += [m["calls"] for res in sharded["ds2"].values() for m in res["mines"].values()]
    counted += [route["calls"] for res in scale["ranks"] for route in res["routes"].values()]
    for one in counted:
        for key, n in one.items():
            calls[key] = calls.get(key, 0) + n
    calls["als_sharded_sweep"] = sum(res["als"]["calls"] for res in scale["ranks"])
    return {
        "calls": calls,
        "local_product_ms": max(res["times"]["product_ms"] for res in scale["ranks"]),
        "ring_step_ms": max(res["times"]["ring_step_ms"] for res in scale["ranks"]),
        "bound_ms": scale["bound_ms"], "bound_by": scale["bound_by"],
        "ring_step_bound_ms": scale["ring_step_bound_ms"],
        "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
        "emit_ms": max(res["times"]["emit_ms"] for res in scale["ranks"]),
        "emit_bound_ms": scale["emit_bound_ms"],
        "emit_plain_ms": t["emit_plain_ms"],
        "route_wall_s": {impl: max(res["routes"][impl]["wall_s"] for res in scale["ranks"])
                         for impl in r0["routes"]},
        "als_sweep_s": [max(s) for s in zip(*(res["als"]["sweep_s"] for res in scale["ranks"]))],
        "als_train_s": max(res["als"]["duration_s"] for res in scale["ranks"]),
        "als_bound_ms": scale["als_bound_ms"], "als_bound_by": scale["als_bound_by"],
        "als_peak_gib": [res["als"]["peak_gib"] for res in scale["ranks"]],
        "max_abs_err": t["product_max_abs_err"],
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

    # every kernel source at once, one nvcc each, beside the native host
    # libraries (one g++ each)
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 1) as pool:
        native_builds = pool.submit(build_native)
        list(pool.map(cuda_build.build, KERNEL_SOURCES))
        native_builds = native_builds.result()
    log(f"build: {', '.join(f'{n}.cu' for n in KERNEL_SOURCES)} in "
        f"{time.perf_counter() - t0:.3f} s (nvcc "
        + ", ".join(f"{n} {cuda_build.BUILD_LOG[n]['seconds']:.3f} s" for n in KERNEL_SOURCES)
        + ")")
    for name in KERNEL_SOURCES:
        for line in cuda_build.BUILD_LOG[name]["ptxas"].splitlines():
            if any(k in line for k in ("registers", "spill", "entry function", "C7513")):
                log(f"  ptxas {name} | {line.strip()}")
    registers = ptxas_registers(cuda_build.BUILD_LOG["popcount"]["ptxas"])

    seconds: dict[str, float] = {}

    def timed(label: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t
        log(f"phase {label} took {seconds[label]:.3f} s")
        return out

    small_err = timed("3", phase_kernel_vs_plain)
    work = tempfile.mkdtemp(prefix="kmls_smoke_")
    try:
        e2e = timed("4", phase_end_to_end, work)
        serving = timed("8", phase_serving, work)
        resume = timed("9", phase_resume, work)
        timed("10", phase_observability, work)
        scale = timed("5", phase_scale, 2024, work, QUICK_SCALE if quick else SCALE)
        ranks = timed("6", phase_ranks, work, scale)
        save_tensors(work, scale["tensors"])  # phase 14 (c) is held against them
        # phase 5's tensors on the card are spent: phase 12 (b) needs the room
        for key in ("slabs", "slab_plain", "tensors"):
            scale.pop(key)
        embed = timed("11", phase_embeddings, work)
        timed("12", phase_freshness, work)
        quality = timed("13", phase_quality, work)
        routes = timed("7", phase_routes)
        torch.cuda.empty_cache()  # phase 14's ranks share the card with this process
        sharded = timed("14", phase_sharded, work, embed["scale"]["final_loss"])
        torch.cuda.empty_cache()
        model_parallel = timed("15", phase_model_parallel, work)
        torch.cuda.empty_cache()
        timed("16", phase_fleet, work, serving["buckets"])
        timed("17", phase_native, work, native_builds)
        torch.cuda.empty_cache()  # phase 18's runner and ranks share the card
        config4 = timed("18", phase_config4, work, quick)
        timed("19", phase_sync_guard, work)
        torch.cuda.empty_cache()
        timed("20", phase_embed_config4)
    finally:
        stop_spawned()
        shutil.rmtree(work, ignore_errors=True)
    kernel = scale["kernel"]
    kernel["launches_job"] = e2e["job_launches"]
    kernel["launches_resume_after_encode"] = resume["resumes"]["encode"]["launches"]
    kernel["launches_resume_after_mine"] = resume["resumes"]["mine"]["launches"]
    kernel["launches_sparse_long"] = routes["launches_sparse_long"]
    kernel["sparse_long_block"] = routes["long_block"]
    small_err = max(small_err, routes["long_block"]["max_abs_err"])
    kernel["launches_sharded"] = ranks["kernel"]["launches"] + sum(ranks["launches_job"])
    # phase 14: the sharded routes' launches; the sparse-sharded route's
    # long-basket block is this kernel's
    x8 = x8_entry(sharded)
    ranks["kernel"]["x8"] = x8
    ranks["kernel"]["x9"] = x9_entry(model_parallel)
    ranks["kernel"]["launches_sparse_sharded"] = sum(
        m["launches"]["popcount_pairs"] for res in sharded["ds2"].values()
        for label, m in res["mines"].items() if label == "sparse-sharded")
    kernel["max_abs_err"] = max(kernel["max_abs_err"], small_err)
    for entry in (kernel, ranks["kernel"]):
        entry["ptxas_registers"] = registers
    log(f"total smoke time {time.perf_counter() - t_all:.3f} s; by phase "
        + json.dumps({k: round(v, 3) for k, v in seconds.items()}))
    segsum_entry = embed["scale"]["entry"]
    segsum_entry["launches_resume_after_embed"] = resume["embed"]["segsum_launches"]
    segsum_entry["launches_ds2_sparse_job"] = resume["embed"]["baseline_segsum_launches"]
    # phase 13: the quality job (embed + eval) and its resume after eval
    for entry, key in ((kernel, "popcount_pairs"), (segsum_entry, "segsum")):
        entry["launches_quality_job"] = quality["eval"]["launches"][key]
        entry["launches_resume_after_eval"] = quality["eval"]["resume_launches"][key]
    segsum_ptxas = ptxas_report(cuda_build.BUILD_LOG["segsum"]["ptxas"])
    segsum_entry["ptxas_registers"] = {k: r["registers"] for k, r in segsum_ptxas.items()}
    segsum_entry["ptxas_spill_bytes"] = {
        k: {"stores": r.get("spill_store_bytes"), "loads": r.get("spill_load_bytes")}
        for k, r in segsum_ptxas.items()}
    # phase 18: the popcount kernel at BASELINE config 4's full shape
    kernel["config4"] = {
        "shape": config4["shape"], "ms": config4["count_ms"],
        "bound_ms": config4["count_bound"]["ms"], "bound_by": config4["count_bound"]["bound_by"],
        "plain_ms": config4["count_plain_ms"], "launches": config4["run"]["launches"]["popcount_pairs"],
        "launches_ranks": [r["launches"]["popcount_pairs"] for r in config4["ranks"]["ranks"]],
        "max_abs_err": config4["count_err"],
        "library_ms": None,  # torch._int_mm would need the 79 GB unpacked operand
    }
    kernel["max_abs_err"] = max(kernel["max_abs_err"], config4["count_err"])
    print(json.dumps({"kernels": [kernel, ranks["kernel"], segsum_entry, bernoulli_entry(config4)]}))
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
    if sys.argv[1:2] == ["--gang-worker"]:
        sys.exit(gang_worker(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
