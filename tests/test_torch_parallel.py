"""The port's distributed renderer (``parallel/``) on the CPU: one spawn of
four gloo processes renders every mesh shape (4×1, 2×2, 1×4), scene
strategy and estimator; every rank's frame must equal the single-process
``render_frame`` bit for bit, and the 4×1 gradient of mean(frame) in the
albedo and ``v0`` must equal ``render_frame``'s within rtol 1e-5. The
scene's rows split so that one of four shards holds only padding.

That single-process reference is itself held to the JAX package on the
same scene and settings: its frames to the image bar of JAX's
``render_frame`` (Pallas searches in interpret mode, as
``tests/test_torch_render.py``), its gradient to ``jax.grad`` of the same
loss within ``tests/test_torch_grad.py``'s bar. The spawned ranks import
no JAX; the fixture does, inside."""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from gpupathtracer_tpu_torch.models import scene as t_scene
from gpupathtracer_tpu_torch.models.camera import Camera
from gpupathtracer_tpu_torch.render.renderer import RenderSettings, render_frame

WORLD = 4
MESHES = [(4, 1), (2, 2), (1, 4)]
STRATEGIES = ("allgather", "ring", "ulysses")
ESTIMATORS = ("naive", "nee")
SIZE = 24
CASES = [(m, s, e) for m in MESHES for s in STRATEGIES for e in ESTIMATORS]
JOIN_TIMEOUT_S = 120


CAMERA = dict(position=(0.0, 0.2, 3.0), width=SIZE, height=SIZE)
# Two packs: the pure data-parallel frames take the second pack and its
# any-hit search on the scan bounces, as render_frame does.
SETTINGS = dict(width=SIZE, height=SIZE, spp=2, bounces=3, tri_block=64, tri_block_secondary=128)


def _scene(pkg=t_scene, **kw):
    """A red icosphere (80 rows) over a gray floor under an emitter: 84
    rows padded to 128, so the last of four 32-row shards is all padding.
    ``pkg`` is either package's ``models.scene``."""
    return pkg.build_scene(
        [pkg.sphere_spec((0.0, 0.0, 0.0), 0.8, mat_id=0, subdivisions=1),
         pkg.plane_spec((0.0, -0.8, 0.0), (90.0, 0.0, 0.0), (6.0, 6.0, 6.0), mat_id=2),
         pkg.plane_spec((0.0, 1.5, 0.0), (90.0, 0.0, 0.0), (2.0, 2.0, 2.0), mat_id=1)],
        [{"type": "diffuse", "albedo": (0.9, 0.2, 0.1)},
         {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 4.0},
         {"type": "diffuse", "albedo": (0.6, 0.6, 0.6)}],
        pad_to_multiple=128, **kw,
    )


def _camera():
    return Camera.create(**CAMERA, device="cpu")


def _settings(estimator):
    return RenderSettings(**SETTINGS, estimator=estimator)


def _leaves(scene):
    v0 = scene.v0.detach().clone().requires_grad_()
    albedo = scene.materials.albedo.detach().clone().requires_grad_()
    leaf = dataclasses.replace(scene, v0=v0, materials=dataclasses.replace(scene.materials, albedo=albedo))
    return leaf, (albedo, v0)


def _worker(rank, init_method, out_dir):
    import torch.distributed as dist

    from gpupathtracer_tpu_torch.parallel.mesh import default_mesh, make_mesh
    from gpupathtracer_tpu_torch.parallel.multihost import gather_image, init_distributed
    from gpupathtracer_tpu_torch.parallel.render import render_frame_distributed

    torch.set_num_threads(1)
    init_distributed(init_method=init_method, world_size=WORLD, rank=rank, device="cpu")
    scene, camera = _scene(device="cpu"), _camera()
    frames = {}
    for n_data, n_scene in MESHES:
        mesh = make_mesh(n_data, n_scene)
        for (m, strategy, estimator) in CASES:
            if m == (n_data, n_scene):
                frames[(m, strategy, estimator)] = render_frame_distributed(
                    scene, camera, _settings(estimator), mesh, scene_strategy=strategy, device="cpu")
    leaf, leaves = _leaves(scene)
    mesh = default_mesh()
    loss = render_frame_distributed(leaf, camera, _settings("nee"), mesh, device="cpu").mean()
    grads = torch.autograd.grad(loss, leaves)
    extra = {"default_mesh": tuple(mesh.mesh.shape),
             "gather_full": torch.from_numpy(gather_image(frames[((4, 1), "allgather", "naive")]))}
    torch.save({"frames": frames, "grads": grads, **extra}, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def distributed(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    ctx = mp.start_processes(_worker, args=(f"file://{out}/store", str(out)), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD} ranks did not finish within {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def reference():
    """``render_frame``'s frames and 4×1 gradient, each held to the JAX
    package's on the same scene and settings."""
    import jax
    import jax.numpy as jnp
    from test_torch_grad import assert_grad_close
    from test_torch_render import assert_image_bar

    from gpupathtracer_tpu.models import scene as j_scene
    from gpupathtracer_tpu.models.camera import Camera as JCamera
    from gpupathtracer_tpu.render.renderer import RenderSettings as JSettings
    from gpupathtracer_tpu.render.renderer import render_frame as j_render

    scene, camera = _scene(device="cpu"), _camera()
    frames = {e: render_frame(scene, camera, _settings(e), device="cpu") for e in ESTIMATORS}
    leaf, leaves = _leaves(scene)
    grads = torch.autograd.grad(render_frame(leaf, camera, _settings("nee"), device="cpu").mean(), leaves)

    js, jc = _scene(j_scene), JCamera.create(**CAMERA)
    jst = {e: JSettings(**SETTINGS, estimator=e, intersector="pallas") for e in ESTIMATORS}
    for e in ESTIMATORS:
        want = np.asarray(j_render(js, jc, jst[e]))
        assert want.mean() > 0.02
        assert_image_bar(frames[e].numpy(), want)

    def j_loss(albedo, v0):
        leaf = js.replace(v0=v0, materials=js.materials.replace(albedo=albedo))
        return jnp.mean(j_render(leaf, jc, jst["nee"]))

    j_grads = jax.grad(j_loss, argnums=(0, 1))(js.materials.albedo, js.v0)
    for name, got, want in zip(("albedo", "v0"), grads, j_grads):
        assert_grad_close(got, want, name)
    return frames, grads


@pytest.mark.parametrize("mesh,strategy,estimator", CASES, ids=[f"{m[0]}x{m[1]}-{s}-{e}" for m, s, e in CASES])
def test_distributed_frame_equals_render_frame(distributed, reference, mesh, strategy, estimator):
    want = reference[0][estimator]
    assert want.mean() > 0.02
    for rank, result in enumerate(distributed):
        got = result["frames"][(mesh, strategy, estimator)]
        assert got.shape == want.shape
        differ = int((got != want).any(dim=-1).sum())
        assert differ == 0, f"rank {rank}: {differ} pixels differ"


@pytest.mark.parametrize("leaf", ["albedo", "v0"])
def test_distributed_gradient_equals_render_frame(distributed, reference, leaf):
    i = ("albedo", "v0").index(leaf)
    want = reference[1][i].numpy()
    assert np.abs(want).max() > 0
    for result in distributed:
        got = result["grads"][i].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_default_mesh_and_gather_image(distributed, reference):
    want = reference[0]["naive"].numpy()
    for result in distributed:
        assert result["default_mesh"] == (WORLD, 1)
        np.testing.assert_array_equal(result["gather_full"].numpy(), want)


def test_single_process_mesh_renders_render_frame():
    """One process without a group: ``init_distributed`` does nothing and
    ``make_mesh`` makes a one-rank gloo group; the frame is
    ``render_frame``'s."""
    import torch.distributed as dist

    from gpupathtracer_tpu_torch.parallel.mesh import make_mesh
    from gpupathtracer_tpu_torch.parallel.multihost import init_distributed
    from gpupathtracer_tpu_torch.parallel.render import render_frame_distributed

    assert not dist.is_initialized()
    init_distributed(device="cpu")
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(1, 1)
        scene, camera = _scene(device="cpu"), _camera()
        got = render_frame_distributed(scene, camera, _settings("naive"), mesh, device="cpu")
        assert torch.equal(got, render_frame(scene, camera, _settings("naive"), device="cpu"))
    finally:
        dist.destroy_process_group()
