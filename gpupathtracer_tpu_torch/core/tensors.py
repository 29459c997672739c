"""Moving the port's dataclasses of tensors between devices."""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. Raises RuntimeError when it names
    CUDA and no CUDA device is available: the port's entry points default to
    the card and never fall back to the CPU on their own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def to_device(obj, device):
    """Copy of a dataclass with every tensor field (and every nested
    dataclass's tensor fields) on ``device``. Non-tensor fields are kept."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = to_device(v, device)
    return dataclasses.replace(obj, **changes)
