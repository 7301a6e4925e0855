"""Mining resume state on the shared volume — counterpart of
``kmlserver_tpu/mining/checkpoint.py``. Only :func:`heartbeat_dir`
(``:406-409``) is ported; the phase-checkpoint store, its fingerprint and
its quarantine are ROADMAP A4."""

from __future__ import annotations

import os

from ..config import MiningConfig


def heartbeat_dir(cfg: MiningConfig) -> str:
    """Where the dead-rank watchdog's per-rank heartbeat files live —
    under the checkpoint dir so one volume path owns all resume state."""
    return os.path.join(cfg.checkpoint_path, "heartbeats")
