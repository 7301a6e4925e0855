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


def backend_name(device: str | torch.device) -> str:
    """The reference's backend word for ``device``: ``"gpu"`` for a CUDA
    device (what ``jax.default_backend()`` says on an NVIDIA card) and
    ``"cpu"`` for the CPU, so the count dispatch's per-backend rules and
    table cells decide here as the reference would on that device."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "gpu"
    if kind == "cpu":
        return "cpu"
    raise ValueError(f"no backend name for device {str(device)!r}")
