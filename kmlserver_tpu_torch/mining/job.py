"""Container entrypoint for the batch mining job.

Run as ``python -m kmlserver_tpu_torch.mining.job``. Configured by the
reference's environment variables (``BASE_DIR``, ``DATASETS_DIR``,
``MIN_SUPPORT``, ``KMLS_POPCOUNT_*``, ...); ``KMLS_TORCH_DEVICE`` picks the
device (default ``cuda``; ``cpu`` runs the plain PyTorch versions).

Exit codes follow the reference (kubernetes/job.yaml podFailurePolicy):
``0`` success, ``64`` a configuration or data error no retry can fix (bad
env, no datasets, invalid CSV, no CUDA device), ``1`` anything else.
"""

from __future__ import annotations

import sys
import traceback

from ..config import MiningConfig, torch_device_from_env
from ..utils.device import DeviceUnavailableError
from .pipeline import run_mining_job

EXIT_OK = 0
EXIT_FATAL_CONFIG = 64  # EX_USAGE: retrying cannot help


def main() -> int:
    try:
        cfg = MiningConfig.from_env()
        run_mining_job(cfg, device=torch_device_from_env())
        return EXIT_OK
    except Exception as exc:
        traceback.print_exc()
        fatal = (ValueError, FileNotFoundError, DeviceUnavailableError)
        code = EXIT_FATAL_CONFIG if isinstance(exc, fatal) else 1
        print(f"Job aborted: exiting {code}", flush=True)
        return code


if __name__ == "__main__":
    sys.exit(main())
