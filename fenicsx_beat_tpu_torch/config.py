"""Device and precision policy of the port.

The JAX package picks float64 when x64 is enabled (CPU validation) and
float32 otherwise (the TPU path).  The port makes the same choice from the
device: float32 on CUDA, the production type, and float64 on the CPU,
where the port is validated against the JAX package.  The card is the
default; the CPU runs only when the caller names it.  Nothing here changes
torch's global defaults; every solver carries its own ``device`` and
``dtype``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "default_dtype"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The solver's device.  ``None`` means the card (``cuda``); the CPU
    only when named.  A CUDA device is returned only when CUDA is
    available; otherwise this raises, so a run never lands on the CPU
    without the caller asking for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run on the CPU)"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(dev)!r} (cpu or cuda)")
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """float32 on CUDA (what the kernels take), float64 on the CPU."""
    return torch.float32 if device.type == "cuda" else torch.float64
