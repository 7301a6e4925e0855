"""The quality loop — counterpart of ``kmlserver_tpu/quality/``. Ported so
far: :mod:`.lifecycle` (the one manifest file set and the delta-chain
compactor). The offline evaluation (``eval.py``) and the blend sweep
(``sweep.py``) are not part of this package yet.
"""
