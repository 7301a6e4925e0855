"""kmlserver_tpu_torch — the PyTorch + CUDA port of ``kmlserver_tpu`` for an
NVIDIA H100. Mirrors the reference package's layout (``ops/``, ``mining/``,
``serving/``, ``io/``, ``data/``) and imports nothing of it: artifact
formats, env knobs and served answers are held equal to the reference by
the ``tests/test_torch_*.py`` parity suite."""
