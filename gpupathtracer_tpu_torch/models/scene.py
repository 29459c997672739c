"""Scene construction: geometry descriptions → SoA world-space triangle tensors.

Counterpart of ``gpupathtracer_tpu/models/scene.py``. ``GeometrySpec`` holds
one instance's local-space triangles and TRS; ``build_scene`` pretransforms
them to world space and concatenates every instance into one flat
``TriangleScene``, padded with degenerate ``valid=False`` rows to a multiple
of ``pad_to_multiple``, with the stacked image textures of TEX_IMAGE
materials. Planes are two two-sided triangles (+z normal in object space);
spheres are icospheres.

``build_scene`` is differentiable: a spec's ``vertices``, ``normals``,
``uvs``, ``position``, ``rotation_deg`` or ``scale`` that requires a
gradient passes it on to the scene's tensors (``plane_spec`` and
``mesh_spec`` keep a tensor they are given as it is).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from gpupathtracer_tpu_torch.core import mat4
from gpupathtracer_tpu_torch.core.tensors import resolve_device, to_device
from gpupathtracer_tpu_torch.models.materials import MaterialTable, material_table
from gpupathtracer_tpu_torch.models.obj import MeshData, load_obj


@dataclasses.dataclass(frozen=True)
class GeometrySpec:
    """One geometry instance: local-space triangles + TRS."""

    vertices: torch.Tensor  # (T, 3, 3) local space
    normals: torch.Tensor  # (T, 3, 3) local-space shading normals
    uvs: torch.Tensor  # (T, 3, 2)
    position: torch.Tensor  # (3,)
    rotation_deg: torch.Tensor  # (3,) Euler degrees, glm X*Y*Z order
    scale: torch.Tensor  # (3,)
    mat_id: int = 0
    two_sided: bool = False


@dataclasses.dataclass(frozen=True)
class TriangleScene:
    """Flat world-space SoA triangle scene."""

    v0: torch.Tensor  # (N, 3)
    e1: torch.Tensor  # (N, 3) = v1 - v0
    e2: torch.Tensor  # (N, 3) = v2 - v0
    gn: torch.Tensor  # (N, 3) unit geometric normal = normalize(cross(e1, e2))
    gn_ref: torch.Tensor  # (N, 3) normal matrix @ unit object-space normal, not re-normalized
    n0: torch.Tensor  # (N, 3) world shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # (N, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    geom_id: torch.Tensor  # (N,) int64
    mat_id: torch.Tensor  # (N,) int64
    two_sided: torch.Tensor  # (N,) bool
    valid: torch.Tensor  # (N,) bool — False on padding rows
    materials: MaterialTable
    # Stacked image textures (T, H, W, 3) float32 for TEX_IMAGE materials;
    # None when no image texture is used.
    textures: torch.Tensor | None = None

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    def to(self, device) -> "TriangleScene":
        return to_device(self, device)


_PLANE_TRIS = np.asarray(
    [
        [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0]],
        [[-0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]],
    ],
    np.float32,
)  # CCW: cross(e1, e2) = +z


def _f32(x) -> torch.Tensor:
    """float32 tensor of ``x``; a tensor stays a tensor (with its autograd
    history and device), anything else goes through numpy."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def plane_spec(position, rotation_deg, scale, mat_id=0) -> GeometrySpec:
    """Reference PLANE geometry (unit square at origin, +z normal, two-sided);
    UVs map the square to [0, 1]²."""
    normals = np.broadcast_to(np.asarray([0.0, 0.0, 1.0], np.float32), (2, 3, 3))
    return GeometrySpec(
        vertices=_f32(_PLANE_TRIS),
        normals=_f32(normals.copy()),
        uvs=_f32(_PLANE_TRIS[:, :, :2] + 0.5),
        position=_f32(position),
        rotation_deg=_f32(rotation_deg),
        scale=_f32(scale),
        mat_id=mat_id,
        two_sided=True,
    )


def mesh_spec(
    mesh: MeshData | str,
    position=(0.0, 0.0, 0.0),
    rotation_deg=(0.0, 0.0, 0.0),
    scale=(1.0, 1.0, 1.0),
    mat_id: int = 0,
    two_sided: bool = False,
) -> GeometrySpec:
    """TRIANGLEMESH geometry from an OBJ path or pre-loaded MeshData."""
    if isinstance(mesh, str) or hasattr(mesh, "__fspath__"):
        mesh = load_obj(mesh)
    return GeometrySpec(
        vertices=_f32(mesh.vertices),
        normals=_f32(mesh.normals),
        uvs=_f32(mesh.uvs),
        position=_f32(position),
        rotation_deg=_f32(rotation_deg),
        scale=_f32(scale),
        mat_id=mat_id,
        two_sided=two_sided,
    )


def icosphere(subdivisions: int = 3) -> MeshData:
    """Unit icosphere triangle soup (same vertex and face order as the JAX
    package's ``icosphere``)."""
    t = (1.0 + 5.0**0.5) / 2.0
    verts = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    for _ in range(subdivisions):
        new_faces = []
        verts_list = list(verts)
        cache: dict[tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key in cache:
                return cache[key]
            m = verts_list[a] + verts_list[b]
            verts_list.append(m / np.linalg.norm(m))
            cache[key] = len(verts_list) - 1
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
        verts = np.asarray(verts_list)
    v = np.asarray(verts, np.float32)
    tri = v[np.asarray(faces)].astype(np.float32)  # (F, 3, 3)
    # On a unit sphere the shading normal equals the position.
    return MeshData(vertices=tri, normals=tri.copy(), uvs=np.zeros((len(faces), 3, 2), np.float32))


def sphere_spec(
    position=(0.0, 0.0, 0.0), radius: float = 1.0, mat_id: int = 0, subdivisions: int = 3
) -> GeometrySpec:
    return mesh_spec(
        icosphere(subdivisions), position=position, scale=(radius, radius, radius), mat_id=mat_id
    )


def build_scene(
    specs: Sequence[GeometrySpec],
    materials: MaterialTable | list[dict],
    pad_to_multiple: int = 512,
    textures=None,
    device="cuda",
) -> TriangleScene:
    """Compile geometry specs into one flat world-space TriangleScene on
    ``device``. Padding rows (``valid=False``) are all-zero, so their zero
    determinant means they are never hit. ``textures``: the (T, H, W, 3)
    image stack that TEX_IMAGE materials index, or None."""
    device = resolve_device(device)
    if textures is not None:
        textures = torch.as_tensor(textures, dtype=torch.float32, device=device)
        if textures.dim() != 4 or textures.shape[-1] != 3:
            raise ValueError(f"textures must be (T, H, W, 3), got {tuple(textures.shape)}")
    if isinstance(materials, list):
        materials = material_table(materials, device=device)
    fields: dict[str, list] = {
        k: []
        for k in (
            "v0", "e1", "e2", "gn", "gn_ref", "n0", "n1", "n2",
            "uv0", "uv1", "uv2", "geom_id", "mat_id", "two_sided",
        )
    }
    for gi, spec in enumerate(specs):
        spec_dev = to_device(spec, device)
        m = mat4.trs(spec_dev.position, spec_dev.rotation_deg, spec_dev.scale)
        nm = mat4.normal_matrix(m)
        verts = spec_dev.vertices
        world = mat4.transform_points(m, verts)  # (T, 3, 3)
        wn = mat4.normalize(mat4.transform_vectors(nm, spec_dev.normals))
        e1 = world[:, 1] - world[:, 0]
        e2 = world[:, 2] - world[:, 0]
        local_gn = mat4.normalize(
            torch.linalg.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
        )
        t = world.shape[0]
        fields["v0"].append(world[:, 0])
        fields["e1"].append(e1)
        fields["e2"].append(e2)
        fields["gn"].append(mat4.normalize(torch.linalg.cross(e1, e2)))
        fields["gn_ref"].append(mat4.transform_vectors(nm, local_gn))
        for c in range(3):
            fields[f"n{c}"].append(wn[:, c])
            fields[f"uv{c}"].append(spec_dev.uvs[:, c])
        fields["geom_id"].append(torch.full((t,), gi, dtype=torch.int64, device=device))
        fields["mat_id"].append(torch.full((t,), spec.mat_id, dtype=torch.int64, device=device))
        fields["two_sided"].append(torch.full((t,), spec.two_sided, dtype=torch.bool, device=device))
    out = {k: torch.cat(v) for k, v in fields.items()}
    n = out["v0"].shape[0]
    out["valid"] = torch.ones((n,), dtype=torch.bool, device=device)
    pad = (-n) % pad_to_multiple if pad_to_multiple > 1 else 0
    if pad:
        out = {
            k: torch.cat([v, torch.zeros((pad,) + v.shape[1:], dtype=v.dtype, device=device)])
            for k, v in out.items()
        }
    return TriangleScene(materials=materials, textures=textures, **out)


def reference_scene(scene_resources: str | None = None) -> tuple[list[GeometrySpec], list[dict]]:
    """The reference main()'s hardcoded scene, as the JAX package builds it:
    rocketman.obj rotated (0, 90, 180) and four unit planes scaled 5x at
    z = ±2.5 and y = ±2.5, sharing one red diffuse material, with the
    emitter wired to the +z plane. The mesh is read from
    ``scene_resources`` (default: the config loader's asset directory).
    Returns (specs, materials) for ``build_scene``."""
    import os

    if scene_resources is None:
        from gpupathtracer_tpu_torch.utils.config import DEFAULT_ASSET_DIRS

        scene_resources = DEFAULT_ASSET_DIRS[0]
    mesh = mesh_spec(os.path.join(scene_resources, "rocketman.obj"), rotation_deg=(0.0, 90.0, 180.0), mat_id=0)
    specs = [
        mesh,
        plane_spec((0.0, 0.0, 2.5), (0.0, 0.0, 0.0), (5.0, 5.0, 5.0), mat_id=1),
        plane_spec((0.0, 0.0, -2.5), (0.0, 0.0, 0.0), (5.0, 5.0, 5.0), mat_id=0),
        plane_spec((0.0, -2.5, 0.0), (90.0, 0.0, 0.0), (5.0, 5.0, 5.0), mat_id=0),
        plane_spec((0.0, 2.5, 0.0), (90.0, 0.0, 0.0), (5.0, 5.0, 5.0), mat_id=0),
    ]
    materials = [
        {"type": "diffuse", "albedo": (1.0, 0.0, 0.0)},
        {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
    ]
    return specs, materials
