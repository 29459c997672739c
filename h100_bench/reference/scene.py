"""The benchmark's own scene builder: a configuration file -> triangles.

Plain PyTorch and NumPy, written from the configuration schema, not from
the program under test. It builds the geometry the program is asked to
render, one module a geometry kind, ``reference/geometry/<kind>.py`` with
``triangles(entry) -> ((F, 3, 3) float32 world-space triangles, two-sided)``
(``sphere``, ``plane``), and the material table of the diffuse and emitting
materials. Each material's ``type`` and ``texture`` and each triangle's
geometry entry stay on the scene, and the estimator
(``reference/<estimator>.py``) refuses what it does not implement: the
reference answers only for what it implements.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math

import numpy as np
import torch

DIFFUSE = "diffuse"
EMITTER = "emitter"


@dataclasses.dataclass
class RefScene:
    """World-space triangles (float32) and their materials."""

    v0: torch.Tensor  # (T, 3)
    e1: torch.Tensor  # (T, 3) v1 - v0
    e2: torch.Tensor  # (T, 3) v2 - v0
    two_sided: torch.Tensor  # (T,) bool
    mat: torch.Tensor  # (T,) int64 row of the material table
    albedo: torch.Tensor  # (M, 3) float32 (diffuse materials)
    emission: torch.Tensor  # (M, 3) float32: emissive colour times intensity
    is_emitter: torch.Tensor  # (M,) bool
    material_types: tuple = ()  # (M,) each material's lower-case ``type``
    textures: tuple = ()  # (M,) each material's ``texture`` entry, or None
    source: torch.Tensor | None = None  # (T,) int64 index of each triangle's geometry entry

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass(frozen=True)
class RefCamera:
    position: tuple
    yaw: float
    pitch: float
    fov_deg: float
    near: float
    far: float
    world_up: tuple
    width: int
    height: int


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def triples(x, default):
    if x is None:
        return tuple(default)
    if isinstance(x, (int, float)):
        return (float(x),) * 3
    return tuple(float(a) for a in x)


def geometry(kind: str):
    """The module ``reference/geometry/<kind>.py`` of a geometry kind."""
    try:
        return importlib.import_module(f"{__package__}.geometry.{kind}")
    except ModuleNotFoundError as e:
        if e.name != f"{__package__}.geometry.{kind}":
            raise
        raise ValueError(f"the reference builds no {kind!r} geometry (reference/geometry/{kind}.py)") from e


def build_scene(cfg: dict, device) -> RefScene:
    """The configuration's triangles and materials on ``device``."""
    mats = cfg["materials"]
    index = {m.get("name", f"material_{i}"): i for i, m in enumerate(mats)}
    tris, two_sided, mat, source = [], [], [], []
    for k, g in enumerate(cfg["geometry"]):
        mid = g.get("material", 0)
        mid = index[mid] if isinstance(mid, str) else int(mid)
        t, sided = geometry(g.get("kind", "mesh")).triangles(g)
        tris.append(t)
        two_sided.append(np.full(len(t), sided))
        mat.append(np.full(len(t), mid, np.int64))
        source.append(np.full(len(t), k, np.int64))
    tri = np.concatenate(tris)
    albedo = np.zeros((len(mats), 3), np.float32)
    emission = np.zeros((len(mats), 3), np.float32)
    is_emitter = np.zeros(len(mats), bool)
    types = tuple(str(m.get("type", DIFFUSE)).lower() for m in mats)
    for i, (m, kind) in enumerate(zip(mats, types)):
        if kind == DIFFUSE:
            albedo[i] = m.get("albedo", (0.5, 0.5, 0.5))
        elif kind == EMITTER:
            # The emitted radiance is the colour times the intensity, one
            # float32 product per channel.
            emission[i] = np.asarray(m.get("emissive_color", (0, 0, 0)), np.float32) * np.float32(
                m.get("intensity", 0.0))
            is_emitter[i] = True
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    v0 = f32(tri[:, 0])
    return RefScene(
        v0=v0,
        e1=f32(tri[:, 1]) - v0,
        e2=f32(tri[:, 2]) - v0,
        two_sided=torch.as_tensor(np.concatenate(two_sided), device=device),
        mat=torch.as_tensor(np.concatenate(mat), device=device),
        albedo=f32(albedo),
        emission=f32(emission),
        is_emitter=torch.as_tensor(is_emitter, device=device),
        material_types=types,
        textures=tuple(m.get("texture") or None for m in mats),
        source=torch.as_tensor(np.concatenate(source), device=device),
    )


def build_camera(cfg: dict) -> RefCamera:
    c, r = cfg.get("camera", {}), cfg.get("render", {})
    return RefCamera(
        position=triples(c.get("position"), (0.0, 0.0, 15.0)),
        yaw=float(c.get("yaw", -90.0)),
        pitch=float(c.get("pitch", 0.0)),
        fov_deg=float(c.get("fov_deg", 70.0)),
        near=float(c.get("near_clip", 0.1)),
        far=float(c.get("far_clip", 1000.0)),
        world_up=triples(c.get("world_up"), (0.0, 1.0, 0.0)),
        width=int(r.get("width", 800)),
        height=int(r.get("height", 800)),
    )


def _normalize(v):
    return v / np.linalg.norm(v)


def camera_matrix(cam: RefCamera) -> np.ndarray:
    """inverse(view) @ inverse(projection), float64: the view is a right-handed
    look-at along the yaw/pitch forward vector, the projection a vertical-fov
    perspective with clip depth in [-1, 1]."""
    yaw, pitch = math.radians(cam.yaw), math.radians(cam.pitch)
    fwd = _normalize(np.array([math.cos(yaw) * math.cos(pitch), math.sin(pitch), math.sin(yaw) * math.cos(pitch)]))
    right = _normalize(np.cross(fwd, cam.world_up))
    up = _normalize(np.cross(right, fwd))
    eye = np.asarray(cam.position, np.float64)
    f = fwd  # normalize(center - eye) with center = eye + fwd
    s = _normalize(np.cross(f, up))
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[0, 3], view[1, 3], view[2, 3] = -s @ eye, -u @ eye, f @ eye
    fov = math.radians(cam.fov_deg)
    h = math.cos(0.5 * fov) / math.sin(0.5 * fov)
    proj = np.zeros((4, 4))
    proj[0, 0] = h * cam.height / cam.width
    proj[1, 1] = h
    proj[2, 2] = -(cam.far + cam.near) / (cam.far - cam.near)
    proj[2, 3] = -(2.0 * cam.far * cam.near) / (cam.far - cam.near)
    proj[3, 2] = -1.0
    return np.linalg.inv(view) @ np.linalg.inv(proj)
