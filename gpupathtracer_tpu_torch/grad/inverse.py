"""Inverse rendering (config 5): recover scene parameters from a target
image through pixel gradients.

Counterpart of ``run_inverse_demo`` in ``gpupathtracer_tpu/grad/inverse.py``:
a Lambertian icosphere lit by an emissive backdrop
(``scenes/config5_invert_target.toml``). Adam recovers the sphere's albedo
(through a sigmoid of a logit) and per-vertex offsets of its triangle soup
from the target rendering, on an L2 image loss through ``render_frame``
with the NEE estimator and detached sampling (see ``grad/__init__.py``).
The edge-sampled demos of the JAX module (``run_silhouette_demo``,
``run_camera_demo``) need its boundary term and are not ported.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gpupathtracer_tpu_torch.core.tensors import resolve_device
from gpupathtracer_tpu_torch.models.camera import Camera
from gpupathtracer_tpu_torch.models.materials import material_table
from gpupathtracer_tpu_torch.models.scene import GeometrySpec, build_scene, icosphere, plane_spec
from gpupathtracer_tpu_torch.render.renderer import RenderSettings, render_frame
from gpupathtracer_tpu_torch.utils import checkpoint as ckpt

# The trainer's parameters, in the order the optimizer holds them.
PARAM_NAMES = ("albedo_logit", "offsets")


@dataclasses.dataclass
class InverseResult:
    loss_history: list
    albedo_error: float
    vertex_error: float
    final_loss: float


def _demo_setup(width=96, height=96, spp=8, bounces=2, subdivisions=2, device="cuda"):
    """``(settings, camera, make_scene, sphere_mesh)`` of the demo, with
    ``make_scene(albedo (3,), vertex_offsets (T, 3, 3))`` differentiable in
    both."""
    device = resolve_device(device)
    settings = RenderSettings(
        width=width, height=height, spp=spp, bounces=bounces, seed=1234,
        tri_block=512, intersector="auto", estimator="nee",
    )
    camera = Camera.create(position=(0.0, 0.0, 6.0), fov_deg=45.0, width=width, height=height, device=device)
    sphere_mesh = icosphere(subdivisions)
    backdrop = plane_spec((0.0, 0.0, 8.0), (0.0, 0.0, 0.0), (30.0, 30.0, 30.0), mat_id=1)
    base = material_table(
        [
            {"type": "diffuse"},
            {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 3.0},
        ],
        device=device,
    )
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    vertices = f32(sphere_mesh.vertices) * 1.2
    normals, uvs = f32(sphere_mesh.normals), f32(sphere_mesh.uvs)

    def make_scene(albedo, vertex_offsets):
        sphere = GeometrySpec(
            vertices=vertices + vertex_offsets, normals=normals, uvs=uvs, position=f32(np.zeros(3)),
            rotation_deg=f32(np.zeros(3)), scale=f32(np.ones(3)), mat_id=0,
        )
        materials = dataclasses.replace(base, albedo=torch.cat([albedo[None], base.albedo[1:]]))
        return build_scene([sphere, backdrop], materials, pad_to_multiple=512, device=device)

    return settings, camera, make_scene, sphere_mesh


def make_optimizer(params: dict, lr: float) -> torch.optim.Adam:
    """Adam over ``params[name]`` for ``PARAM_NAMES``, with optax's ``adam``
    defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam([params[k] for k in PARAM_NAMES], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def adam_state(params: dict, lr: float, step: int, exp_avg: dict, exp_avg_sq: dict) -> dict:
    """The state dict of ``make_optimizer(params, lr)`` after ``step`` steps
    with first moments ``exp_avg`` and second moments ``exp_avg_sq`` (dicts
    like ``params``), as ``utils.checkpoint.save_train_state`` takes it.
    ``interop.inverse_state_from_numpy`` gives these arguments from a JAX
    checkpoint."""
    opt = make_optimizer(params, lr)
    for k in PARAM_NAMES:
        opt.state[params[k]] = {
            "step": torch.tensor(float(step), dtype=torch.float32),
            "exp_avg": exp_avg[k],
            "exp_avg_sq": exp_avg_sq[k],
        }
    return opt.state_dict()


def _demo_problem(width, height, spp, bounces, subdivisions, device):
    """The demo's setup, its target image (rendered at the true albedo and
    the sphere squashed by 15% along y) and the truth."""
    settings, camera, make_scene, sphere_mesh = _demo_setup(width, height, spp, bounces, subdivisions, device)
    device = camera.position.device
    true_albedo = torch.tensor([0.2, 0.55, 0.85], device=device)
    base = torch.as_tensor(sphere_mesh.vertices, device=device) * 1.2
    true_offsets = base * torch.tensor([0.0, -0.15, 0.0], device=device)
    with torch.no_grad():
        target = render_frame(make_scene(true_albedo, true_offsets), camera, settings, device=device)
    return settings, camera, make_scene, sphere_mesh, target, true_albedo, true_offsets


def run_inverse_demo(
    steps: int = 100,
    out_dir: str | None = None,
    lr: float = 2e-2,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    width: int = 96,
    height: int = 96,
    spp: int = 8,
    bounces: int = 2,
    subdivisions: int = 2,
    device="cuda",
):
    """Optimize albedo and vertex offsets to match the target image on
    ``device`` (the card unless the caller passes ``device="cpu"``).

    With ``checkpoint_path``, (params, optimizer state, step) are saved
    atomically every ``checkpoint_every`` steps (``utils/checkpoint.py``)
    and a rerun resumes at the first missing step. Step ``i`` renders with
    seed ``i``, so an interrupted and resumed run is bit-identical to an
    uninterrupted one. Returns the JAX demo's result dict; with ``out_dir``
    it also writes ``target.png`` and ``recovered.png`` there.
    """
    device = resolve_device(device)
    settings, camera, make_scene, sphere_mesh, target, true_albedo, true_offsets = _demo_problem(
        width, height, spp, bounces, subdivisions, device
    )
    params = {
        "albedo_logit": torch.zeros(3, device=device, requires_grad=True),  # sigmoid -> albedo in (0, 1)
        "offsets": torch.zeros(sphere_mesh.vertices.shape, device=device, requires_grad=True),
    }
    opt = make_optimizer(params, lr)

    start_step = 0
    if checkpoint_path:
        loaded = ckpt.load_train_state(checkpoint_path)
        if loaded is not None:
            with torch.no_grad():
                for k in PARAM_NAMES:
                    params[k].copy_(torch.as_tensor(loaded["params"][k]))
            opt.load_state_dict(ckpt.tensors_from_numpy(loaded["opt_state"]))
            start_step = int(loaded["step"])

    def loss_fn(seed):
        albedo = torch.sigmoid(params["albedo_logit"])
        img = render_frame(make_scene(albedo, params["offsets"]), camera, settings, seed=seed, device=device)
        return ((img - target) ** 2).mean()

    history = []
    for i in range(start_step, steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(i)
        loss.backward()
        opt.step()
        if i % 10 == 0 or i == steps - 1:
            history.append((i, loss.item()))
        if checkpoint_path and ((i + 1) % checkpoint_every == 0 or i == steps - 1):
            ckpt.save_train_state(checkpoint_path, params, opt.state_dict(), i + 1)
    if not history:  # resumed past the end: report the current loss
        with torch.no_grad():
            history.append((steps - 1, loss_fn(max(steps - 1, 0)).item()))

    with torch.no_grad():
        albedo = torch.sigmoid(params["albedo_logit"])
        albedo_err = (albedo - true_albedo).abs().max().item()
        vert_err = (params["offsets"] - true_offsets).abs().mean().item()
    result = {
        "steps": steps,
        "final_loss": history[-1][1],
        "albedo_recovered": [round(float(x), 4) for x in albedo.tolist()],
        "albedo_true": [float(x) for x in true_albedo.tolist()],
        "albedo_max_err": round(albedo_err, 4),
        "vertex_offset_mae": round(vert_err, 5),
        "loss_history": history,
    }
    if out_dir:
        from gpupathtracer_tpu_torch.render.film import to_u8
        from gpupathtracer_tpu_torch.utils.image import write_png

        os.makedirs(out_dir, exist_ok=True)
        with torch.no_grad():
            final = render_frame(make_scene(albedo, params["offsets"]), camera, settings, device=device)
        write_png(os.path.join(out_dir, "target.png"), to_u8(target))
        write_png(os.path.join(out_dir, "recovered.png"), to_u8(final))
    return result
