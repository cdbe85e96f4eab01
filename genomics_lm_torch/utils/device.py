"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller names another device. With
no device given and no CUDA present they raise: a silent fall back to the
CPU would report CPU numbers under the card's name.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The caller's device, or ``cuda`` when none is given; raises without CUDA."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def check_on_device(module: torch.nn.Module, device: torch.device) -> None:
    """Raise unless ``module``'s parameters live on ``device``."""
    have = module_device(module)
    if have.type != device.type or (
            device.index is not None and have.index != device.index):
        raise ValueError(
            f"model parameters are on {have}, but the entry point runs on "
            f"{device}; move the model with .to({str(device)!r})")


__all__ = ["check_on_device", "module_device", "resolve_device"]
