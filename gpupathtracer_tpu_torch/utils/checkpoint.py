"""Train-state checkpoints for the inverse-rendering loop.

Counterpart of the train-state half of ``gpupathtracer_tpu/utils/checkpoint.py``:
a pickle of ``{"step", "params", "opt_state"}`` with numpy leaves, written
atomically (a temporary file, then a rename), so a kill mid-write never
corrupts the latest checkpoint. Here ``opt_state`` is a ``torch.optim``
state dict (``Optimizer.state_dict()``) with every tensor as a numpy array;
``tensors_from_numpy`` turns it back for ``Optimizer.load_state_dict``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _atomic_save(path: str, save_fn) -> None:
    tmp = path + ".tmp"
    save_fn(tmp)
    os.replace(tmp, path)


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
