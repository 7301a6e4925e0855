"""Observability — counterpart of ``kmlserver_tpu/observability/``:
per-request span tracing with tail-based retention (``trace``), event-loop
lag feeding the admission ladder (``runtime``), per-kernel cost
attribution (``costmodel``), SLO burn rates (``slo``), the mining job's
textfile telemetry (``jobmetrics``) and the client/server trace join
(``tracejoin``). The series they render are declared in
``serving/metrics.py``'s ``METRIC_REGISTRY``."""

from __future__ import annotations

from .costmodel import KERNEL_COST_SPECS, CostModel
from .runtime import LoopLagMonitor
from .slo import SloTracker
from .trace import SpanRecorder, TraceContext

__all__ = [
    "CostModel",
    "KERNEL_COST_SPECS",
    "LoopLagMonitor",
    "SloTracker",
    "SpanRecorder",
    "TraceContext",
]
