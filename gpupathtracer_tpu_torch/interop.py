"""Carrying state across from the JAX package as numpy arrays.

Each function takes a mapping from field name to array (for example
``np.asarray(getattr(jax_obj, name))``) and builds the port's dataclass on
``device``, so both packages can compute on the same scene. Integer fields
become int64 tensors (indices), bools stay bool, floats are float32. A field
that is None on the JAX side (a scene without image textures) is left out of
the mapping and stays None in the port. ``inverse_state_from_numpy`` carries
the inverse-rendering trainer's parameters and optax Adam moments across, so
a JAX checkpoint resumes in the port (``grad.inverse.adam_state`` makes them
the optimizer's state). The edge table and clusters of ``grad/edges.py``
are host-side numpy in both packages: ``edge_table_from_numpy`` and
``edge_clusters_from_numpy`` take them across with the JAX package's
dtypes. The module imports only ``core/`` and ``models/`` (and the packed
scene's dataclass); the two edge functions import ``grad.edges`` when they
are called.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from gpupathtracer_tpu_torch.core.tensors import resolve_device
from gpupathtracer_tpu_torch.models.camera import Camera
from gpupathtracer_tpu_torch.models.materials import MaterialTable
from gpupathtracer_tpu_torch.models.scene import TriangleScene
from gpupathtracer_tpu_torch.ops.packed_intersect import PackedScene


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    elif a.dtype != np.bool_:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)  # copies: JAX's arrays are read-only


def _tensor_fields(cls) -> list[str]:
    return [f.name for f in dataclasses.fields(cls) if f.type in ("torch.Tensor", torch.Tensor)]


def material_table_from_numpy(fields: Mapping[str, np.ndarray], device="cuda") -> MaterialTable:
    """MaterialTable from numpy fields, texture columns included."""
    device = resolve_device(device)
    return MaterialTable(**{k: _tensor(fields[k], device) for k in _tensor_fields(MaterialTable)})


def scene_from_numpy(fields: Mapping[str, np.ndarray], device="cuda") -> TriangleScene:
    """TriangleScene from numpy fields; ``fields["materials"]`` is itself a
    mapping of MaterialTable fields, and ``fields["textures"]``, where
    present, the (T, H, W, 3) image stack."""
    device = resolve_device(device)
    tensors = {k: _tensor(fields[k], device) for k in _tensor_fields(TriangleScene)}
    textures = _tensor(fields["textures"], device) if "textures" in fields else None
    return TriangleScene(
        materials=material_table_from_numpy(fields["materials"], device), textures=textures, **tensors
    )


def camera_from_numpy(fields: Mapping[str, np.ndarray], width: int, height: int, device="cuda") -> Camera:
    device = resolve_device(device)
    return Camera(
        **{k: _tensor(fields[k], device) for k in _tensor_fields(Camera)}, width=width, height=height
    )


def packed_from_numpy(fields: Mapping[str, np.ndarray], tri_block: int, device="cuda") -> PackedScene:
    device = resolve_device(device)
    tensors = {k: _tensor(fields[k], device) for k in _tensor_fields(PackedScene)}
    tensors["block_live"] = tensors["block_live"] > 0
    return PackedScene(**tensors, tri_block=tri_block)


def numpy_fields(obj, names) -> dict[str, np.ndarray]:
    """``{name: np.asarray(getattr(obj, name))}`` for the given names whose
    value is not None."""
    return {n: np.asarray(v) for n in names if (v := getattr(obj, n)) is not None}


def inverse_state_from_numpy(
    params: Mapping[str, np.ndarray], count, mu: Mapping[str, np.ndarray], nu: Mapping[str, np.ndarray],
    device="cuda",
) -> dict:
    """The JAX inverse demo's train state as tensors: ``params``
    (``albedo_logit`` (3,), ``offsets`` (T, 3, 3)) become leaf tensors that
    require a gradient, and optax's ``ScaleByAdamState`` (``count``, the
    first moments ``mu`` and the second moments ``nu``, each a mapping like
    ``params``) becomes Adam's ``step``, ``exp_avg`` and ``exp_avg_sq``.
    Returns ``{"params", "step", "exp_avg", "exp_avg_sq"}``: all the
    arguments of ``grad.inverse.adam_state`` but ``lr``."""
    device = resolve_device(device)
    return {
        "params": {k: _tensor(v, device).requires_grad_() for k, v in params.items()},
        "step": int(np.asarray(count)),
        "exp_avg": {k: _tensor(v, device) for k, v in mu.items()},
        "exp_avg_sq": {k: _tensor(v, device) for k, v in nu.items()},
    }


_EDGE_TABLE_DTYPES = {"tri1": np.int32, "corner": np.int32, "tri2": np.int32, "two_sided": np.bool_}
_EDGE_CLUSTER_DTYPES = {
    "edge_ids": np.int32, "gn_lo": np.float32, "gn_hi": np.float32, "c_lo": np.float32, "c_hi": np.float32,
    "box_lo": np.float32, "box_hi": np.float32, "count": np.int32, "has_boundary": np.bool_,
    "has_two_boundary": np.bool_,
}


def edge_table_from_numpy(fields: Mapping[str, np.ndarray]):
    """EdgeTable from numpy fields (``numpy_fields(jax_table, ...)``)."""
    from gpupathtracer_tpu_torch.grad.edges import EdgeTable  # here: interop sits below grad/

    return EdgeTable(**{k: np.array(fields[k], dtype=t) for k, t in _EDGE_TABLE_DTYPES.items()})


def edge_clusters_from_numpy(fields: Mapping[str, np.ndarray], size: int):
    """EdgeClusters of ``size`` edges a cluster from numpy fields."""
    from gpupathtracer_tpu_torch.grad.edges import EdgeClusters

    return EdgeClusters(size=int(size), **{k: np.array(fields[k], dtype=t) for k, t in _EDGE_CLUSTER_DTYPES.items()})
