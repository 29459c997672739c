"""Moving the port's dataclasses of tensors between devices, the cache of
values made from tensors (packs, BVHs), and the clamps and absolute value
of the differentiable path with the JAX package's gradients at their
kinks."""

from __future__ import annotations

import dataclasses
import functools
import weakref

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


class TensorCache:
    """A small LRU of values made from tensors, keyed on the tensors'
    identity and an extra key. An entry holds weakrefs to the tensors
    (against id() reuse after they are freed) and their version counters,
    so an in-place edit of any of them (an optimizer step on a parameter,
    ``add_`` under ``no_grad``) is a miss. An edit made through ``.data``
    bypasses the counter, and the cache cannot see it."""

    def __init__(self, size: int):
        self.size = size
        self._entries: dict[tuple, tuple] = {}

    def get(self, tensors, extra: tuple, make):
        """The value cached for ``tensors`` and ``extra``, else ``make()``."""
        key = tuple(id(x) for x in tensors) + extra
        versions = tuple(x._version for x in tensors)
        entry = self._entries.pop(key, None)
        if entry is not None and entry[1] == versions and all(r() is x for r, x in zip(entry[0], tensors)):
            self._entries[key] = entry  # re-insert: most recently used last
            return entry[2]
        value = make()
        self._entries[key] = (tuple(weakref.ref(x) for x in tensors), versions, value)
        while len(self._entries) > self.size:
            self._entries.pop(next(iter(self._entries)))
        return value

    def clear(self) -> None:
        self._entries.clear()


# torch.clamp passes the whole gradient to x where x equals the bound, and
# torch.abs passes none at 0. The JAX package's jnp.maximum / jnp.clip split
# it in half at a tie, and jnp.abs passes +1 at 0; these helpers take the
# JAX rule. The bounds go in as 0-d CPU tensors, which a CUDA binary op reads
# as a scalar (no fill, no copy), made once per value and dtype.


@functools.lru_cache(maxsize=None)
def _cpu_scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype)


def maximum(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``max(x, bound)``; at a tie half the gradient reaches ``x``."""
    return torch.maximum(x, _cpu_scalar(bound, x.dtype))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``min(max(x, lo), hi)``, ties as ``maximum``."""
    return torch.minimum(maximum(x, lo), _cpu_scalar(hi, x.dtype))


def absolute(x: torch.Tensor) -> torch.Tensor:
    """``|x|``; at 0 the gradient is +1. The where-form only where ``x``
    needs a gradient: it costs two more launches than ``abs``."""
    if x.requires_grad:
        return torch.where(x >= 0, x, -x)
    return x.abs()
