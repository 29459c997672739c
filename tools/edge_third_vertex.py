"""The edge's "third vertex" in the primary boundary term, on the CPU.

Both packages' ``primary_edge_gradient`` (and ``shadow_edge_gradient``)
orient an edge's screen normal away from the front owner's third vertex,
taken as corner ``(corner + 2) % 3`` of that owner. ``corner`` numbers the
corners of ``tri1``; where the front owner is ``tri2`` it indexes another
triangle's corners, and for 2 of 3 such edges the "third" vertex is an
endpoint of the edge. Its projection then lies on the edge's screen line,
and n̂ is the direction of a rounding residual: the sample's f_in and f_out
are traced at noise-chosen sides.

    python3 tools/edge_third_vertex.py

Prints three JSON lines. First, tests/test_torch_edges.py's sphere case (a
grey icosphere(2) before an emitter backdrop over a floor, 24x24, spp 2,
2 bounces, NEE, key 5, 512 samples): the samples whose third vertex is an
endpoint, and how many of them land on the film. Second, the same case
with the loss cotangent unmasked, through both packages (the JAX package
on the CPU, ~40 s to compile): the two gradients and the samples whose
nudged screen points differ by more than 1e-3 px. Third, the bias: the
port's primary term of mean(image) in the scale of a black icosphere(2)
before the emitter (48x48, spp 16, 1 bounce, 4 keys x 4,096 samples), as
ported and with the third vertex taken as the sum of the owner's corners
less the edge's endpoints, beside the central finite difference (h 0.05).
A CPU run: no number here is a device time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpupathtracer_tpu_torch.grad import edges  # noqa: E402
from gpupathtracer_tpu_torch.models.camera import Camera  # noqa: E402
from gpupathtracer_tpu_torch.models.scene import build_scene, plane_spec, sphere_spec  # noqa: E402
from gpupathtracer_tpu_torch.ops import threefry  # noqa: E402
from gpupathtracer_tpu_torch.render.renderer import RenderSettings, render_frame  # noqa: E402

EMITTER = {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0}


def sphere_scene(s, albedo, floor: bool):
    sphere = dataclasses.replace(sphere_spec(subdivisions=2), scale=torch.stack([s, s, s]))
    specs = [sphere, plane_spec((0.0, 0.0, -2.0), (0.0, 0.0, 0.0), (40.0, 40.0, 40.0), mat_id=1)]
    materials = [{"type": "diffuse", "albedo": albedo}, EMITTER]
    if floor:
        specs.append(plane_spec((0.0, -1.2, 0.0), (90.0, 0.0, 0.0), (6.0, 6.0, 6.0), mat_id=2))
        materials.append({"type": "diffuse", "albedo": albedo})
    return build_scene(specs, materials, pad_to_multiple=128 if floor else 8, device="cpu")


def degenerate_samples(scene, table, cam, key, n_samples):
    """The sample ids whose third vertex is an edge endpoint, and their
    screen points, drawn as primary_edge_gradient draws them."""
    tri1, corner = torch.as_tensor(table.tri1).long(), torch.as_tensor(table.corner).long()
    va, vb = edges.edge_endpoints(scene, tri1, corner)
    is_sil, interior = edges.silhouette_flags(scene, table, cam.position)
    usable = is_sil & (edges._clip_w(cam, va) > cam.near_clip) & (edges._clip_w(cam, vb) > cam.near_clip)
    weight = torch.where(usable, torch.linalg.norm(edges.screen_xy(cam, vb) - edges.screen_xy(cam, va), dim=-1), 0.0)
    k_pick, k_s, _ = threefry.split(key, 3)
    pick = threefry.categorical(k_pick, edges._safe_logits(weight, weight.sum()), shape=(n_samples,))
    s = threefry.uniform(k_s, (n_samples,))[:, None]
    it = interior[pick]
    corners = torch.stack([scene.v0[it], scene.v0[it] + scene.e1[it], scene.v0[it] + scene.e2[it]], dim=1)
    third = corners[torch.arange(n_samples), (corner[pick] + 2) % 3]
    near = lambda a, b: (a - b).abs().amax(-1) < 1e-5
    bad = near(third, va[pick]) | near(third, vb[pick])
    xy = edges.screen_xy(cam, (1.0 - s) * va[pick] + s * vb[pick])
    return torch.nonzero(bad)[:, 0].tolist(), xy[bad], int((it != tri1[pick]).sum())


def jax_against_port():
    """Both packages' primary term on the sphere case with the unmasked
    cotangent of tests/test_torch_edges.py, recording every sample's
    nudged screen points."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from gpupathtracer_tpu.grad import edges as j_edges
    from gpupathtracer_tpu.models import camera as j_camera
    from gpupathtracer_tpu.models import scene as j_scene
    from gpupathtracer_tpu.render.renderer import RenderSettings as JSettings

    def j_sphere(s):
        sphere = dataclasses.replace(j_scene.sphere_spec(subdivisions=2), scale=jnp.stack([s, s, s]))
        specs = [sphere, j_scene.plane_spec((0.0, 0.0, -2.0), (0.0, 0.0, 0.0), (40.0, 40.0, 40.0), mat_id=1),
                 j_scene.plane_spec((0.0, -1.2, 0.0), (90.0, 0.0, 0.0), (6.0, 6.0, 6.0), mat_id=2)]
        grey = {"type": "diffuse", "albedo": (0.6, 0.55, 0.5)}
        return j_scene.build_scene(specs, [grey, EMITTER, grey], pad_to_multiple=128)

    kw = dict(width=24, height=24, spp=2, bounces=2, tri_block=128, estimator="nee")
    cot = np.random.default_rng(1).normal(size=(24, 24, 3)).astype(np.float32)
    points = {"jax": [], "port": []}

    def recording(module, name):
        inner = module._trace_at_screen

        def trace(scene, cam, settings, xy, key, spp):
            points[name].append(np.asarray(xy))
            return inner(scene, cam, settings, xy, key, spp)

        module._trace_at_screen = trace

    recording(j_edges, "jax")
    recording(edges, "port")
    jc = j_camera.Camera.create(position=(0.0, 0.3, 4.0), fov_deg=45.0, width=24, height=24)
    g_jax = j_edges.primary_edge_gradient(
        j_sphere, jnp.float32(1.0), jc, JSettings(**kw), jnp.asarray(cot),
        j_edges.build_edge_table(j_sphere(jnp.float32(1.0)), native=False), jax.random.PRNGKey(5),
        n_samples=512, trace_spp=2,
    )
    tc = Camera.create(position=(0.0, 0.3, 4.0), fov_deg=45.0, width=24, height=24, device="cpu")
    t_fn = lambda s: sphere_scene(s, (0.6, 0.55, 0.5), floor=True)
    g_port = edges.primary_edge_gradient(
        t_fn, torch.tensor(1.0), tc, RenderSettings(**kw), torch.as_tensor(cot),
        edges.build_edge_table(t_fn(torch.tensor(1.0))), threefry.PRNGKey(5), n_samples=512, trace_spp=2, device="cpu",
    )
    apart = np.abs(points["jax"][0] - points["port"][0]).max(-1)
    moved = np.nonzero(apart > 1e-3)[0]
    return {"case": "the sphere case, cotangent unmasked", "grad_jax": float(g_jax), "grad_port": g_port.item(),
            "samples_nudged_apart": moved.tolist(), "their_distance_px": apart[moved].tolist()}


def with_true_third_vertex():
    """primary_edge_gradient with the third vertex taken as the sum of the
    owner's corners less the edge's endpoints."""
    src = open(edges.__file__).read()
    old = "third = pts_i[torch.arange(n_samples, device=device), (corner[pick] + 2) % 3]"
    if old not in src:
        raise RuntimeError("grad/edges.py no longer takes the third vertex as corner (corner + 2) % 3")
    mod = types.ModuleType("edges_true_third")
    sys.modules[mod.__name__] = mod  # its dataclasses look their module up
    exec(compile(src.replace(old, "third = pts_i.sum(1) - va_p - vb_p"), mod.__name__, "exec"), mod.__dict__)
    return mod.primary_edge_gradient


def main():
    cam = Camera.create(position=(0.0, 0.3, 4.0), fov_deg=45.0, width=24, height=24, device="cpu")
    scene = sphere_scene(torch.tensor(1.0), (0.6, 0.55, 0.5), floor=True)
    table = edges.build_edge_table(scene)
    ids, xy, owner_tri2 = degenerate_samples(scene, table, cam, threefry.PRNGKey(5), 512)
    on_film = ((xy >= 0) & (xy < 24)).all(-1)
    print(json.dumps({"case": "tests/test_torch_edges.py sphere, key 5, 512 samples",
                      "samples_front_owner_tri2": owner_tri2, "samples_third_is_endpoint": len(ids),
                      "on_film": int(on_film.sum()), "sample_ids": ids}), flush=True)
    print(json.dumps(jax_against_port()), flush=True)

    size = 48
    cam = Camera.create(position=(0.0, 0.0, 4.0), fov_deg=45.0, width=size, height=size, device="cpu")
    settings = RenderSettings(width=size, height=size, spp=16, bounces=1, tri_block=8, jitter=True)
    scene_fn = lambda s: sphere_scene(s, (0.0, 0.0, 0.0), floor=False)
    table = edges.build_edge_table(scene_fn(torch.tensor(1.0)))
    cot = torch.full((size, size, 3), 1.0 / (size * size * 3))
    true_third = with_true_third_vertex()
    runs = {"as_ported": [], "true_third_vertex": []}
    for k in range(4):
        for name, fn in (("as_ported", edges.primary_edge_gradient), ("true_third_vertex", true_third)):
            runs[name].append(fn(scene_fn, torch.tensor(1.0), cam, settings, cot, table, threefry.PRNGKey(k),
                                 n_samples=4096, trace_spp=2, device="cpu").item())
    loss = lambda s: render_frame(scene_fn(torch.tensor(s)), cam, settings, device="cpu").mean().item()
    fd = (loss(1.05) - loss(0.95)) / 0.1
    print(json.dumps({"case": "black icosphere(2) before the emitter, 48x48 spp 16, 4 keys x 4096 samples",
                      "finite_difference": fd, **{k: {"mean": float(np.mean(v)), "runs": v} for k, v in runs.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
