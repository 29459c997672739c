"""Inverse rendering (config 5): recover scene parameters from a target
image through pixel gradients.

Counterpart of ``run_inverse_demo`` in ``gpupathtracer_tpu/grad/inverse.py``:
a Lambertian icosphere lit by an emissive backdrop
(``scenes/config5_invert_target.toml``). Adam recovers the sphere's albedo
(through a sigmoid of a logit) and per-vertex offsets of its triangle soup
from the target rendering, on an L2 image loss through ``render_frame``
with the NEE estimator and detached sampling (see ``grad/__init__.py``).

``run_silhouette_demo`` and ``run_camera_demo`` recover an occluder's scale
and the camera's pose where the detached gradient is exactly zero (a black
quad on a uniform emitter): all the signal is silhouette motion, which the
edge-sampled boundary term (``grad/edges.py``) carries.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gpupathtracer_tpu_torch.core.tensors import resolve_device
from gpupathtracer_tpu_torch.grad.edges import _grad_of, build_edge_table, value_and_grad_with_edges
from gpupathtracer_tpu_torch.models.camera import Camera
from gpupathtracer_tpu_torch.models.materials import material_table
from gpupathtracer_tpu_torch.models.scene import GeometrySpec, build_scene, icosphere, plane_spec
from gpupathtracer_tpu_torch.ops import threefry
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


_QUAD = np.asarray(
    [
        [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0]],
        [[-0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]],
    ],
    np.float32,
)  # CCW, +z normal: faces a camera on +z


def _edge_demo_setup(width, height, spp, device):
    """``(camera, settings, occluder_scene(scale))`` of the edge demos: a
    black quad scaled by ``scale`` at the origin before an emitter backdrop
    at z = -2, seen from (0, 0, 4); naive, one bounce, blocks of 8."""
    camera = Camera.create(position=(0.0, 0.0, 4.0), fov_deg=45.0, width=width, height=height, device=device)
    settings = RenderSettings(
        width=width, height=height, spp=spp, bounces=1, tri_block=8,
        estimator="naive", intersector="auto", jitter=True,
    )
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    quad, normals = f32(_QUAD), f32(np.broadcast_to([0.0, 0.0, 1.0], (2, 3, 3)))
    backdrop = plane_spec((0.0, 0.0, -2.0), (0.0, 0.0, 0.0), (40.0, 40.0, 40.0), mat_id=1)
    materials = material_table(
        [
            {"type": "diffuse", "albedo": (0.0, 0.0, 0.0)},
            {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
        ],
        device=device,
    )

    def occluder_scene(scale):
        occ = GeometrySpec(
            vertices=quad * scale, normals=normals, uvs=f32(np.zeros((2, 3, 2))), position=f32(np.zeros(3)),
            rotation_deg=f32(np.zeros(3)), scale=f32(np.ones(3)), mat_id=0,
        )
        return build_scene([occ, backdrop], materials, pad_to_multiple=8, device=device)

    return camera, settings, occluder_scene


def _write_pair(out_dir, target, final):
    from gpupathtracer_tpu_torch.render.film import to_u8
    from gpupathtracer_tpu_torch.utils.image import write_png

    os.makedirs(out_dir, exist_ok=True)
    write_png(os.path.join(out_dir, "target.png"), to_u8(target))
    write_png(os.path.join(out_dir, "recovered.png"), to_u8(final))


@dataclasses.dataclass
class EdgeDemoProblem:
    """One edge demo's optimisation problem: the leaves ``params`` (a
    tensor, or a dict with ``camera_fn``), the scene and camera they feed,
    the target and its loss, and the edge table. ``value_and_grad`` is one
    step's gradient, the demo's own or, with ``settings``, under other
    render settings (the plain versions) with the same key."""

    params: object
    scene_fn: object
    camera: Camera
    camera_fn: object
    settings: RenderSettings
    target: torch.Tensor
    table: object
    device: torch.device

    def image_loss(self, img):
        return ((img - self.target) ** 2).mean()

    def value_and_grad(self, key, n_samples: int, settings: RenderSettings | None = None):
        return value_and_grad_with_edges(
            self.image_loss, self.scene_fn, self.params, self.camera, settings or self.settings, self.table, key,
            n_samples=n_samples, trace_spp=2, camera_fn=self.camera_fn, device=self.device,
        )


def silhouette_problem(width=64, height=64, spp=16, true_scale=0.72, init_scale=1.1, device="cuda"):
    """The silhouette demo's problem: the quad's scale, from ``init_scale``
    towards the render at ``true_scale``."""
    device = resolve_device(device)
    camera, settings, scene_fn = _edge_demo_setup(width, height, spp, device)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    with torch.no_grad():
        target = render_frame(scene_fn(f32(true_scale)), camera, settings, device=device)
    table = build_edge_table(scene_fn(f32(init_scale)))
    return EdgeDemoProblem(f32(init_scale).requires_grad_(), scene_fn, camera, None, settings, target, table, device)


def camera_problem(width=64, height=64, spp=16, true_dx=0.3, true_dz=0.45, device="cuda"):
    """The camera demo's problem: the camera's x and z translation, from 0
    towards the render at (``true_dx``, ``true_dz``); the occluder at scale
    0.72 stays."""
    device = resolve_device(device)
    base_cam, settings, occluder_scene = _edge_demo_setup(width, height, spp, device)
    scene = occluder_scene(0.72)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=device)
    z_axis = torch.tensor([0.0, 0.0, 1.0], device=device)

    def camera_fn(p):
        return dataclasses.replace(base_cam, position=base_cam.position + x_axis * p["dx"] + z_axis * p["dz"])

    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    with torch.no_grad():
        target = render_frame(scene, camera_fn({"dx": f32(true_dx), "dz": f32(true_dz)}), settings, device=device)
    params = {"dx": f32(0.0).requires_grad_(), "dz": f32(0.0).requires_grad_()}
    # The camera moves, the scene does not.
    return EdgeDemoProblem(params, lambda _p: scene, base_cam, camera_fn, settings, target, build_edge_table(scene),
                           device)


def _detached_gradient(problem: EdgeDemoProblem):
    """The interior term alone at the problem's start."""
    pr = problem

    def loss(p):
        cam = pr.camera_fn(p) if pr.camera_fn is not None else pr.camera
        return pr.image_loss(render_frame(pr.scene_fn(p), cam, pr.settings, device=pr.device))

    return _grad_of(loss, pr.params)


def run_silhouette_demo(
    steps: int = 40,
    lr: float = 3e-2,
    width: int = 64,
    height: int = 64,
    spp: int = 16,
    true_scale: float = 0.72,
    init_scale: float = 1.1,
    edge_samples: int = 1024,
    out_dir: str | None = None,
    device="cuda",
):
    """Recover an occluder's scale from a target image on ``device``: the
    task detached sampling cannot move (the occluder is black, so every
    interior gradient is exactly zero and all the signal is silhouette
    motion). Adam at ``lr`` on the mean squared image error, the gradient
    from ``value_and_grad_with_edges`` with ``edge_samples`` edge samples
    and 2 trace samples, the keys split from ``PRNGKey(3)`` each step.
    Returns the JAX demo's result dict."""
    pr = silhouette_problem(width, height, spp, true_scale, init_scale, device)
    s = pr.params
    opt = torch.optim.Adam([s], lr=lr, betas=(0.9, 0.999), eps=1e-8)  # optax's adam defaults
    key = threefry.PRNGKey(3, device=pr.device)
    detached_g0 = _detached_gradient(pr).item()
    history = []
    for i in range(steps):
        key, k = threefry.split(key)
        loss, g = pr.value_and_grad(k, edge_samples)
        s.grad = g
        opt.step()
        if i % 5 == 0 or i == steps - 1:
            history.append((i, loss.item(), round(s.item(), 4)))
    result = {
        "task": "silhouette_scale_recovery",
        "true_scale": true_scale,
        "recovered_scale": round(s.item(), 4),
        "scale_error": round(abs(s.item() - true_scale), 4),
        "detached_gradient_at_init": detached_g0,  # 0: the boundary term carries all the signal
        "history": history,
    }
    if out_dir:
        with torch.no_grad():
            _write_pair(out_dir, pr.target, render_frame(pr.scene_fn(s), pr.camera, pr.settings, device=pr.device))
    return result


def run_camera_demo(
    steps: int = 60,
    lr: float = 2e-2,
    width: int = 64,
    height: int = 64,
    spp: int = 16,
    true_dx: float = 0.3,
    true_dz: float = 0.45,
    edge_samples: int = 2048,
    out_dir: str | None = None,
    device="cuda",
):
    """Recover the camera's x and z translation from a target image on
    ``device``: the detached interior gradient is exactly zero (a black
    occluder on a uniform emitter), and all the signal is the silhouette's
    sweep (dx shifts it, dz scales it), carried by ``camera_fn`` in
    ``value_and_grad_with_edges``. Adam at ``lr``, keys split from
    ``PRNGKey(9)`` each step. Returns the JAX demo's result dict."""
    pr = camera_problem(width, height, spp, true_dx, true_dz, device)
    params = pr.params
    detached_g0 = _detached_gradient(pr)
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    key = threefry.PRNGKey(9, device=pr.device)
    history = []
    for i in range(steps):
        key, k = threefry.split(key)
        loss, g = pr.value_and_grad(k, edge_samples)
        for name, v in params.items():
            v.grad = g[name]
        opt.step()
        if i % 5 == 0 or i == steps - 1:
            history.append((i, loss.item(), round(params["dx"].item(), 4), round(params["dz"].item(), 4)))
    dx, dz = params["dx"].item(), params["dz"].item()
    result = {
        "task": "camera_pose_recovery",
        "true": {"dx": true_dx, "dz": true_dz},
        "recovered": {"dx": round(dx, 4), "dz": round(dz, 4)},
        "dx_error": round(abs(dx - true_dx), 4),
        "dz_error": round(abs(dz - true_dz), 4),
        # 0: the boundary term carries all the camera signal here.
        "detached_gradient_at_init": {k: v.item() for k, v in detached_g0.items()},
        "history": history,
    }
    if out_dir:
        with torch.no_grad():
            img = render_frame(pr.scene_fn(params), pr.camera_fn(params), pr.settings, device=pr.device)
            _write_pair(out_dir, pr.target, img)
    return result


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
