"""Film checkpoints and train-state checkpoints.

Counterpart of ``gpupathtracer_tpu/utils/checkpoint.py``:

- **Film checkpoints**: ``(radiance_sum, samples_done, digest)`` as an
  ``.npz`` with the JAX package's fields and digest, so a film written by
  either package resumes in the other. Global sample ids key the RNG, so a
  resumed render finishes bit-identical to an uninterrupted one.
- **Train checkpoints**: a pickle of ``{"step", "params", "opt_state"}``
  with numpy leaves. Here ``opt_state`` is a ``torch.optim`` state dict
  (``Optimizer.state_dict()``) with every tensor as a numpy array;
  ``tensors_from_numpy`` turns it back for ``Optimizer.load_state_dict``.

Writes are atomic (a temporary file, then a rename), so a kill mid-write
never corrupts the latest checkpoint.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle

import numpy as np
import torch


FILM_VERSION = 1
# The settings that define a film's sample sequence, as the JAX package names them.
_DIGEST_FIELDS = (
    "width", "height", "spp", "bounces", "seed", "jitter", "background", "estimator", "use_shading_normals",
)


def settings_digest(settings) -> str:
    """Stable digest of the render settings that define the sample sequence:
    the first 16 hex digits of the SHA-256 of their ``json.dumps`` (sorted
    keys, ``default=str``), the same text for the same values in both
    packages."""
    payload = json.dumps({k: getattr(settings, k) for k in _DIGEST_FIELDS}, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _atomic_save(path: str, save_fn) -> None:
    tmp = path + ".tmp"
    save_fn(tmp)
    os.replace(tmp, path)


def save_film(path: str, radiance_sum, samples_done: int, settings) -> None:
    """Save a film (the radiance sum (H, W, 3), a tensor or an array, and
    the samples done) for ``settings`` to ``path`` atomically."""
    if isinstance(radiance_sum, torch.Tensor):
        radiance_sum = radiance_sum.detach().cpu().numpy()
    tmp = path + ".tmp.npz"  # np.savez appends .npz to a name without it
    np.savez_compressed(
        tmp,
        version=FILM_VERSION,
        radiance_sum=np.asarray(radiance_sum, np.float32),
        samples_done=np.int64(samples_done),
        digest=settings_digest(settings),
    )
    os.replace(tmp, path)


def load_film(path: str, settings):
    """``(radiance_sum, samples_done)`` (a float32 CPU tensor and an int)
    from ``path``, or None when there is no file, its version differs, or it
    was written for other settings (sample sequences are never mixed)."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != FILM_VERSION or str(z["digest"]) != settings_digest(settings):
            return None
        return torch.from_numpy(np.array(z["radiance_sum"], np.float32)), int(z["samples_done"])


def _map_leaves(obj, fn):
    """``obj`` with ``fn`` applied to every leaf of its dicts, lists and
    tuples."""
    if isinstance(obj, dict):
        return {k: _map_leaves(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_leaves(v, fn) for v in obj)
    return fn(obj)


def numpy_from_tensors(obj):
    """Every tensor in ``obj`` as a numpy array (detached, on the host)."""
    return _map_leaves(obj, lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def tensors_from_numpy(obj):
    """Every numpy array in ``obj`` as a CPU tensor (a copy)."""
    return _map_leaves(obj, lambda x: torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x)


def save_train_state(path: str, params, opt_state, step: int) -> None:
    """Save ``params`` (a dict of tensors or arrays), ``opt_state`` (an
    optimizer's state dict) and ``step`` (the steps done) to ``path``."""
    payload = {"step": int(step), "params": numpy_from_tensors(params), "opt_state": numpy_from_tensors(opt_state)}

    def write(p):
        with open(p, "wb") as f:
            pickle.dump(payload, f)

    _atomic_save(path, write)


def load_train_state(path: str):
    """The payload saved at ``path`` (numpy leaves), or None if there is none."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)
