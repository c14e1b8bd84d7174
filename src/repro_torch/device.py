"""Device resolution shared by the port's entry points, and the two device
chores of the serving layers: entering a CUDA device on a thread, and
bringing an output to the host."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    A default-device call on a machine without a GPU raises; it never falls
    back to the CPU silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the port on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(device: torch.device):
    """Make ``device`` the calling thread's current CUDA device (a no-op off
    CUDA): CUDA's current device is per thread."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def to_host(x) -> np.ndarray:
    """An output (a tensor on any device, or an array) as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
