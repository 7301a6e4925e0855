"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


class DeviceUnavailableError(RuntimeError):
    """A CUDA device was requested and none is present."""


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``. Entry points default to ``cuda``
    and fail loudly when no card is present rather than falling back to the
    CPU: a caller that wants the CPU passes ``device="cpu"`` (or sets
    ``KMLS_TORCH_DEVICE=cpu`` for the ``python -m`` entry points)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            "device='cpu' (or set KMLS_TORCH_DEVICE=cpu) to run on the CPU"
        )
    return dev
