"""kmls_bench — the benchmark of the PyTorch and CUDA port
(``kmlserver_tpu_torch``).

One command runs one cell once::

    python3 -m kmls_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the repository root; each configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``),
per-layer metric reader (``metrics/<name>.py``) and roofline count
(``roofline/<kernel>.py``) is a file of its own, found by that name. The
plain reference that decides ``correct`` lives in ``reference/`` and
imports nothing of the port.
"""
