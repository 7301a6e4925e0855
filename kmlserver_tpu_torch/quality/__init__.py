"""The quality loop — counterpart of ``kmlserver_tpu/quality/``:

- :mod:`.eval` — the deterministic held-out evaluation that the optional
  checkpointed ``eval`` phase runs and publishes as ``quality.report.json``;
- :mod:`.sweep` — the blend-weight sweep whose argmax the engine serves
  under ``KMLS_HYBRID_BLEND_WEIGHT=measured``;
- :mod:`.lifecycle` — the one manifest file set and the delta-chain
  compactor.
"""
