"""Explicit device resolution.

The port runs where it is told to: `cuda` (the default everywhere) needs a
CUDA device and raises without one; `cpu` runs the plain PyTorch versions
of every device program. Nothing falls back from one to the other.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for a user-facing device argument ("cuda", "cuda:N",
    "cpu" or a torch.device). Raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available (torch.cuda.is_available() is False); pass "
                "device='cpu' to run the plain PyTorch path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use cuda or cpu")
    return dev


def local_devices(device, n: int) -> list:
    """The `n` devices of a `--devices n` run that starts at `device`:
    cuda:i..i+n-1 for `cuda:i` (raises when the machine has fewer), or n
    times the CPU device, over which the windows still go round."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"--devices {n}: need at least one device")
    if dev.type == "cpu":
        return [dev] * n
    have = torch.cuda.device_count()
    if dev.index + n > have:
        raise RuntimeError(f"--devices {n} from {dev} requested but this "
                           f"machine has {have} CUDA device(s)")
    return [torch.device("cuda", dev.index + i) for i in range(n)]


def device_scope(dev: torch.device):
    """Context in which `dev` is the current CUDA device, so that events,
    pinned copies and kernel launches made inside land on its stream;
    nothing to set for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
