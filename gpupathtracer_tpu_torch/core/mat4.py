"""glm-convention 4x4 matrix math in float32 torch.

Counterpart of ``gpupathtracer_tpu/core/mat4.py``: model matrix
``T * Rx * Ry * Rz * S`` (Euler degrees), ``lookAtRH``, ``perspectiveFovRH``
with negative-one-to-one clip depth, and the normal matrix
``inverse(transpose(M))``. Row-major: ``M @ v`` with column vector ``v``.
"""

from __future__ import annotations

import torch

from gpupathtracer_tpu_torch.core.tensors import maximum


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def identity() -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32)


def translate(v) -> torch.Tensor:
    """glm::translate(mat4(1), v)."""
    v = _f32(v)
    m = torch.eye(4, dtype=torch.float32, device=v.device)
    m[:3, 3] = v
    return m


def scale(v) -> torch.Tensor:
    """glm::scale(mat4(1), v)."""
    v = _f32(v)
    return torch.diag(torch.cat([v, torch.ones(1, dtype=torch.float32, device=v.device)]))


def _axis_rotation(angle_rad: torch.Tensor, axis: int) -> torch.Tensor:
    c = torch.cos(angle_rad)
    s = torch.sin(angle_rad)
    m = torch.eye(4, dtype=torch.float32, device=angle_rad.device)
    i, j = {0: (1, 2), 1: (2, 0), 2: (0, 1)}[axis]
    m[i, i] = c
    m[i, j] = -s
    m[j, i] = s
    m[j, j] = c
    return m


def rotate_x_deg(deg) -> torch.Tensor:
    return _axis_rotation(torch.deg2rad(_f32(deg)), 0)


def rotate_y_deg(deg) -> torch.Tensor:
    return _axis_rotation(torch.deg2rad(_f32(deg)), 1)


def rotate_z_deg(deg) -> torch.Tensor:
    return _axis_rotation(torch.deg2rad(_f32(deg)), 2)


def trs(position, rotation_deg, scale_v) -> torch.Tensor:
    """Model matrix ``T * Rx * Ry * Rz * S`` (Euler degrees, glm order)."""
    rotation_deg = _f32(rotation_deg)
    r = rotate_x_deg(rotation_deg[0]) @ rotate_y_deg(rotation_deg[1]) @ rotate_z_deg(rotation_deg[2])
    return translate(position) @ r @ scale(scale_v)


def look_at_rh(eye, center, up) -> torch.Tensor:
    """glm::lookAtRH (matrix_transform.inl)."""
    eye, center, up = _f32(eye), _f32(center), _f32(up)
    f = normalize(center - eye)
    s = normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    m = torch.eye(4, dtype=torch.float32, device=eye.device)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -torch.dot(s, eye)
    m[1, 3] = -torch.dot(u, eye)
    m[2, 3] = torch.dot(f, eye)
    return m


def perspective_fov_rh(fov_rad, width, height, z_near, z_far) -> torch.Tensor:
    """glm::perspectiveFovRH with the default NEGATIVE_ONE_TO_ONE clip depth."""
    fov_rad = _f32(fov_rad)
    width = _f32(width, fov_rad.device)
    height = _f32(height, fov_rad.device)
    z_near = _f32(z_near)
    z_far = _f32(z_far)
    h = torch.cos(0.5 * fov_rad) / torch.sin(0.5 * fov_rad)
    w = h * height / width
    m = torch.zeros((4, 4), dtype=torch.float32, device=fov_rad.device)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -(2.0 * z_far * z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    return m


def inverse(m) -> torch.Tensor:
    return torch.linalg.inv(_f32(m))


def normal_matrix(m) -> torch.Tensor:
    """``inverse(transpose(M))`` — the reference's normal transform."""
    return torch.linalg.inv(_f32(m).T)


def transform_points(m, pts) -> torch.Tensor:
    """Apply mat4 to points (..., 3) with w=1 (drops w, no perspective divide)."""
    return _f32(pts) @ m[:3, :3].T + m[:3, 3]


def transform_vectors(m, vecs) -> torch.Tensor:
    """Apply mat4 to direction vectors (..., 3) with w=0."""
    return _f32(vecs) @ m[:3, :3].T


# The squared guard epsilon must be a normal f32 (>= ~1.18e-38) so degenerate
# (zero-area) rows normalize to 0, not NaN.
_NORM_EPS_SQ = 1e-24


def normalize(v, dim: int = -1) -> torch.Tensor:
    """Safe normalize: clamps inside the sqrt, so the zero vector maps to 0."""
    v = _f32(v)
    return v / torch.sqrt(maximum((v * v).sum(dim=dim, keepdim=True), _NORM_EPS_SQ))
