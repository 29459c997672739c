"""Debug modes: numeric hygiene checks.

Counterpart of ``gpupathtracer_tpu/utils/debug.py``:

- ``debug_mode()``: autograd anomaly detection (a backward that makes a NaN
  raises, naming the forward op) and a finite check of every frame that
  ``render_frame`` and ``render_samples`` return inside the block — the
  counterpart of ``jax_debug_nans``. Outside the block the check costs
  nothing (no device sync).
- ``checkify_render(fn)``: wraps a render callable and raises on a
  non-finite result — the counterpart of JAX's ``checkify``.

JAX's ``enable_compile_cache`` has no counterpart: the port compiles no
graphs, and its kernels are built once per source hash into
``gpupathtracer_tpu_torch/build/`` (``ops/_build.py``).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_FINITE_CHECKS = contextvars.ContextVar("finite_checks", default=False)


def _raise_if_not_finite(x: torch.Tensor, what: str) -> None:
    bad = int((~torch.isfinite(x.detach())).sum())
    if bad:
        raise FloatingPointError(f"{what}: {bad} of {x.numel()} values are not finite")


def check_frame(frame: torch.Tensor, what: str) -> torch.Tensor:
    """``frame``, after raising FloatingPointError on a non-finite value
    when ``debug_mode`` is on; unchanged and unchecked otherwise."""
    if _FINITE_CHECKS.get():
        _raise_if_not_finite(frame, what)
    return frame


@contextlib.contextmanager
def debug_mode():
    """Anomaly detection and finite frame checks inside the block."""
    token = _FINITE_CHECKS.set(True)
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        _FINITE_CHECKS.reset(token)


def checkify_render(fn):
    """``fn`` wrapped to raise FloatingPointError when a tensor it returns
    (the result, or an element of a returned tuple or list) holds a
    non-finite value."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for i, x in enumerate(out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(x, torch.Tensor):
                _raise_if_not_finite(x, f"{getattr(fn, '__name__', 'render')} output {i}")
        return out

    return wrapper
