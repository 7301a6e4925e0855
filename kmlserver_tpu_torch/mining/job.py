"""Container entrypoint for the batch mining job — counterpart of
``kmlserver_tpu/mining/job.py``.

Run as ``python -m kmlserver_tpu_torch.mining.job``. Configured by the
reference's environment variables (``BASE_DIR``, ``DATASETS_DIR``,
``MIN_SUPPORT``, ``KMLS_POPCOUNT_*``, ``KMLS_MESH_SHAPE``, ...);
``KMLS_TORCH_DEVICE`` picks the device (default ``cuda``; ``cpu`` runs the
plain PyTorch versions). With ``KMLS_COORDINATOR_ADDRESS``,
``KMLS_NUM_PROCESSES`` and ``KMLS_PROCESS_ID`` set, run one such process
per GPU: they join one ``torch.distributed`` world
(``parallel/distributed.py``), mine over a rank mesh, and rank 0 publishes.

Exit codes follow the reference (kubernetes/job.yaml podFailurePolicy):

- ``0`` success;
- ``64`` a configuration or data error no retry can fix (bad env, rank ≥
  world size, no datasets, invalid CSV, no CUDA device);
- ``75`` resumable: an injected preemption-style crash
  (``FaultInjected``), the publication lease held by or lost to another
  writer, or the volume out of space (``StorageExhaustedError``,
  ``ENOSPC``); the retry resumes from the phase checkpoint;
- ``76`` resumable: the dead-rank watchdog bounded a multi-rank hang;
- ``1`` anything else.
"""

from __future__ import annotations

import errno
import sys
import traceback

from .. import faults
from ..config import MiningConfig, torch_device_from_env
from ..io.artifacts import LeaseHeldError, LeaseLostError, StorageExhaustedError
from ..parallel.distributed import (
    RankWatchdog,
    distributed_env,
    maybe_initialize,
    resolve_mesh,
    shutdown,
)
from ..utils.device import DeviceUnavailableError
from .checkpoint import heartbeat_dir
from .pipeline import run_mining_job
from .vocab import DuplicateArtistURIError

EXIT_OK = 0
EXIT_FATAL_CONFIG = 64  # EX_USAGE: retrying cannot help
EXIT_RESUMABLE = 75  # EX_TEMPFAIL: a retry can succeed
EXIT_RANK_DEAD = 76  # EX_PROTOCOL: watchdog-bounded multi-rank hang

# the codes a k8s retry can make progress on (job.yaml podFailurePolicy)
RETRYABLE_EXIT_CODES = (EXIT_RESUMABLE, EXIT_RANK_DEAD)


def classify_exception(exc: BaseException) -> int:
    """Map an abort to the exit-code contract above (the reference's
    policy, ``kmlserver_tpu/mining/job.py:47-75``)."""
    if isinstance(exc, faults.FaultInjected):
        return EXIT_RESUMABLE  # the chaos stand-in for a preemption
    if isinstance(exc, (LeaseHeldError, LeaseLostError)):
        # another writer is live (or superseded us): back off and retry
        return EXIT_RESUMABLE
    if isinstance(exc, StorageExhaustedError) or (
        isinstance(exc, OSError) and exc.errno == errno.ENOSPC
    ):
        # disk full is an operator condition, not a config bug; must
        # precede the FileNotFoundError branch — both are OSErrors
        return EXIT_RESUMABLE
    fatal = (DuplicateArtistURIError, ValueError, FileNotFoundError, DeviceUnavailableError)
    if isinstance(exc, fatal):
        return EXIT_FATAL_CONFIG
    return 1


def main() -> int:
    watchdog = None
    try:
        cfg = MiningConfig.from_env()
        device = torch_device_from_env()
        guard_s = cfg.collective_timeout_s or 6 * cfg.rank_timeout_s
        # join the multi-rank runtime when configured (no-op alone); must
        # precede the first touch of the device. Torch's own collective
        # timeout sits above the watchdog's guard, so a hang exits 76.
        distributed = maybe_initialize(
            device=device, timeout_s=guard_s + 60 if guard_s > 0 else None
        )
        if distributed and cfg.rank_timeout_s > 0:
            _, num_processes, process_id = distributed_env()
            watchdog = RankWatchdog(
                heartbeat_dir(cfg),
                rank=process_id,
                num_processes=num_processes,
                heartbeat_interval_s=cfg.rank_heartbeat_interval_s,
                timeout_s=cfg.rank_timeout_s,
                collective_timeout_s=cfg.collective_timeout_s or None,
                exit_code=EXIT_RANK_DEAD,
            )
            watchdog.start()
        run_mining_job(
            cfg,
            device=device,
            mesh=resolve_mesh(cfg.mesh_shape, distributed=distributed),
            watchdog=watchdog,
        )
        shutdown()
        return EXIT_OK
    except Exception as exc:
        code = classify_exception(exc)
        traceback.print_exc()
        kind = "resumable" if code in RETRYABLE_EXIT_CODES else (
            "fatal-config" if code == EXIT_FATAL_CONFIG else "unclassified"
        )
        print(f"Job aborted ({kind}): exiting {code}", flush=True)
        return code
    finally:
        if watchdog is not None:
            watchdog.stop()


if __name__ == "__main__":
    sys.exit(main())
