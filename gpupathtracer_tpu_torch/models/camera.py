"""Pinhole camera with the reference renderer's exact ray-generation math.

Counterpart of ``gpupathtracer_tpu/models/camera.py``:

    Px = (x / screenWidth) * 2 - 1          # no half-pixel offset
    Py = 1 - (y / screenHeight) * 2
    wLookAtPoint = invView @ invProj @ (vec4(Px, Py, 1, 1) * farClip)
    dir = normalize(wLookAtPoint.xyz - cameraPos)   # no w divide

Both quirks are the reference's behaviour and are kept; sub-pixel jitter
adds to (x, y) for spp > 1. ``move`` and ``mouse_move`` are the reference
viewer's keyboard and mouse controls.
"""

from __future__ import annotations

import dataclasses

import torch

from gpupathtracer_tpu_torch.core import mat4
from gpupathtracer_tpu_torch.core.tensors import clip, resolve_device, to_device


@dataclasses.dataclass(frozen=True)
class Camera:
    position: torch.Tensor  # (3,)
    yaw: torch.Tensor  # () degrees
    pitch: torch.Tensor  # () degrees
    world_up: torch.Tensor  # (3,)
    fov_deg: torch.Tensor  # () full vertical fov in degrees
    near_clip: torch.Tensor  # ()
    far_clip: torch.Tensor  # ()
    width: int = 800
    height: int = 800

    @classmethod
    def create(
        cls,
        position=(0.0, 0.0, 15.0),
        yaw=-90.0,
        pitch=0.0,
        world_up=(0.0, 1.0, 0.0),
        fov_deg=70.0,
        near_clip=0.1,
        far_clip=1000.0,
        width=800,
        height=800,
        device="cuda",
    ) -> "Camera":
        device = resolve_device(device)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        return cls(
            position=f32(position),
            yaw=f32(yaw),
            pitch=f32(pitch),
            world_up=f32(world_up),
            fov_deg=f32(fov_deg),
            near_clip=f32(near_clip),
            far_clip=f32(far_clip),
            width=int(width),
            height=int(height),
        )

    def to(self, device) -> "Camera":
        return to_device(self, device)


def camera_basis(cam: Camera):
    """forward/right/up from yaw/pitch (reference UpdateBasisAxis)."""
    yaw = torch.deg2rad(cam.yaw)
    pitch = torch.deg2rad(cam.pitch)
    front = torch.stack(
        [torch.cos(yaw) * torch.cos(pitch), torch.sin(pitch), torch.sin(yaw) * torch.cos(pitch)]
    )
    forward = mat4.normalize(front)
    right = mat4.normalize(torch.linalg.cross(forward, cam.world_up))
    up = mat4.normalize(torch.linalg.cross(right, forward))
    return forward, right, up


def view_matrix(cam: Camera) -> torch.Tensor:
    """lookAtRH(position, position + forward, up)."""
    forward, _, up = camera_basis(cam)
    return mat4.look_at_rh(cam.position, cam.position + forward, up)


def projection_matrix(cam: Camera) -> torch.Tensor:
    """perspectiveFovRH(radians(fov), W, H, near, far)."""
    return mat4.perspective_fov_rh(
        torch.deg2rad(cam.fov_deg), float(cam.width), float(cam.height),
        cam.near_clip, cam.far_clip,
    )


def generate_rays_for_pixels(cam: Camera, pixel_idx: torch.Tensor, jitter_uv=None):
    """Primary rays for row-major pixel ids (R,) int64; returns
    ``(origins, directions)``, each (R, 3). ``jitter_uv`` (R, 2) in [0, 1)
    offsets each ray inside its pixel."""
    w, h = cam.width, cam.height
    inv_view = mat4.inverse(view_matrix(cam))
    inv_proj = mat4.inverse(projection_matrix(cam))

    xs = (pixel_idx % w).to(torch.float32)
    ys = torch.div(pixel_idx, w, rounding_mode="floor").to(torch.float32)
    if jitter_uv is not None:
        xs = xs + jitter_uv[:, 0]
        ys = ys + jitter_uv[:, 1]
    px = (xs / float(w)) * 2.0 - 1.0
    py = 1.0 - (ys / float(h)) * 2.0

    # vec4(Px, Py, 1, 1) * farClip, then invProj, then invView; .xyz with no
    # perspective divide.
    ones = torch.ones_like(px)
    clip = torch.stack([px, py, ones, ones], dim=-1) * cam.far_clip
    look_at = clip @ (inv_view @ inv_proj).T  # (R, 4)
    dirs = mat4.normalize(look_at[:, :3] - cam.position[None, :])
    origins = cam.position[None, :].expand_as(dirs)
    return origins, dirs


def generate_rays(cam: Camera, jitter_uv=None):
    """Primary rays for the full pixel grid, row-major pixel order."""
    pixel_idx = torch.arange(cam.height * cam.width, device=cam.position.device)
    return generate_rays_for_pixels(cam, pixel_idx, jitter_uv)


def mouse_move(cam: Camera, dx: float, dy: float, constrain_pitch: bool = True) -> Camera:
    """Mouse look (reference ProcessMouseMovement): yaw += dx·0.2,
    pitch += dy·0.2, pitch clamped to ±89°."""
    sensitivity = 0.2
    yaw = cam.yaw + dx * sensitivity
    pitch = cam.pitch + dy * sensitivity
    if constrain_pitch:
        pitch = clip(pitch, -89.0, 89.0)
    return dataclasses.replace(cam, yaw=yaw, pitch=pitch)


def move(cam: Camera, direction: int) -> Camera:
    """Keyboard controls (reference ProcessKeyboard): 0..5 move forward,
    backward, left, right, up, down by 0.2; 6/7 yaw -/+ 0.5°; 8/9 pitch
    +/- 0.5°; 10 resets to the reference's start pose."""
    velocity = 0.2
    forward, right, up = camera_basis(cam)
    pos, yaw, pitch = cam.position, cam.yaw, cam.pitch
    if direction == 0:
        pos = pos + forward * velocity
    elif direction == 1:
        pos = pos - forward * velocity
    elif direction == 2:
        pos = pos - right * velocity
    elif direction == 3:
        pos = pos + right * velocity
    elif direction == 4:
        pos = pos + up * velocity
    elif direction == 5:
        pos = pos - up * velocity
    elif direction == 6:
        yaw = yaw - 0.5
    elif direction == 7:
        yaw = yaw + 0.5
    elif direction == 8:
        pitch = pitch + 0.5
    elif direction == 9:
        pitch = pitch - 0.5
    elif direction == 10:
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=pos.device)
        return dataclasses.replace(cam, position=f32([0.0, 0.0, 15.0]), yaw=f32(-90.0), pitch=f32(0.0))
    return dataclasses.replace(cam, position=pos, yaw=yaw, pitch=pitch)
