"""Device resolution shared by the port's public entry points.

The port runs on the card unless the caller asks for the CPU: every
entry point takes ``device=None``, which means ``torch.device("cuda")``,
and refuses to run silently on the CPU when no CUDA device is present.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA device; anything else is passed to
    ``torch.device``. Raises ``RuntimeError`` when a CUDA device is asked
    for (explicitly or by default) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "present; pass device='cpu' to run the plain PyTorch versions")
    return dev


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A tensor on ``device`` from a tensor, numpy array or Python value
    (numpy dtypes are kept; ``dtype`` converts). A move from the host or
    another device runs under the span ``repro_torch.stage``."""
    if obs.recording() and _moves(x, device):
        with obs.span("stage"):
            return torch.as_tensor(x).to(device=device, dtype=dtype)
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def _moves(x, device) -> bool:
    """Whether ``as_tensor(x, device)`` brings ``x`` from the host or
    another device (a tensor already on ``device`` stays where it is)."""
    if not isinstance(x, torch.Tensor):
        return True
    device = torch.device(device)
    if x.device.type != device.type:
        return True
    index = device.index
    if index is None and device.type == "cuda":
        index = torch.cuda.current_device()
    return index is not None and x.device.index != index


def to_numpy(x) -> np.ndarray:
    """A numpy array from a tensor (copied to the host) or array-like."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
