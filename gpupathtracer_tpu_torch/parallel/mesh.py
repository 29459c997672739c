"""Process mesh with ("data", "scene") axes.

Counterpart of ``gpupathtracer_tpu/parallel/mesh.py``: ``data`` shards
pixels, ``scene`` shards triangle rows. Ranks lie on the mesh in row-major
order: rank = data index · n_scene + scene index. The mesh carries the
process groups of its two axes (``mesh.get_group("data")``,
``mesh.get_group("scene")``); which device renders is the renderer's
``device``, so two ranks can share one card under gloo.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_data: int | None = None, n_scene: int = 1) -> DeviceMesh:
    """An ``n_data × n_scene`` mesh over every rank of the process group
    (``n_data`` defaults to world size / ``n_scene``; the product must equal
    the world size), of ``mesh_device_type``. Calls ``ensure_group``."""
    ensure_group()
    device_type = mesh_device_type()
    n = dist.get_world_size()
    if n_data is None:
        assert n % n_scene == 0, (n, n_scene)
        n_data = n // n_scene
    assert n_data * n_scene == n, f"mesh {n_data}x{n_scene} != {n} processes"
    return init_device_mesh(device_type, (n_data, n_scene), mesh_dim_names=("data", "scene"))


def ensure_group() -> None:
    """Give a single process that has no process group a one-rank gloo
    group on an in-memory store; leave an existing group as it is."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)


def mesh_device_type() -> str:
    """The device type of a mesh over the process group: "cuda" under nccl
    and "cpu" otherwise (a mesh only carries the groups)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def default_mesh() -> DeviceMesh:
    """Every rank on ``data``: the right default for a scene each rank holds."""
    return make_mesh(n_scene=1)
