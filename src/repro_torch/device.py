"""Device selection: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """Return the torch device for `name`; never falls back silently.

    Raises RuntimeError when CUDA is asked for and this torch build has no
    usable card, and ValueError for device types the port does not run on.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was asked for but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device type {dev.type!r} (cuda or cpu)")


def synchronize(device: torch.device) -> None:
    """Wait for queued work on `device` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
