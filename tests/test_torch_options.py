"""The port's render options against the JAX package on the CPU: mirror and
glass (with Schlick Fresnel and total internal reflection), Russian
roulette, NEE and MIS on a scene with both, the normal AOVs, the
"mask" and "hybrid" compaction modes (bit-equal to "permute", resident and
streamed), ``render_samples`` chunks, the sampling helpers and a gradient
through glass and mirror.

Scenes are built in both packages from the same specs (``plane_spec``,
``mesh_spec`` of an ``icosphere``), since the JAX tests' OBJ files are not
in the repo; the JAX side runs its Pallas searches in interpret mode. Bars:
the image bar (``test_torch_render.assert_image_bar``), exact equality where
the arithmetic is the same, and for gradients rtol 1e-4, atol 1e-6·max|g|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_grad import RTOL, assert_grad_close
from test_torch_render import _resized, assert_image_bar
from test_torch_stream import force_streamed, is_streamed

from gpupathtracer_tpu.models import scene as j_scene
from gpupathtracer_tpu.models.camera import Camera as JCamera
from gpupathtracer_tpu.ops import sampling as j_sampling
from gpupathtracer_tpu.render.renderer import RenderSettings as JSettings
from gpupathtracer_tpu.render.renderer import render_frame as j_render
from gpupathtracer_tpu.render.renderer import render_samples as j_render_samples
from gpupathtracer_tpu_torch.models import scene as t_scene
from gpupathtracer_tpu_torch.models.camera import Camera as TCamera
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.ops import sampling as t_sampling
from gpupathtracer_tpu_torch.render.renderer import RenderSettings, render_frame, render_samples

EMITTER = {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0}
GLASS = {"type": "glass", "refractive_index": 1.5, "transmittance_color": (0.95, 0.97, 1.0)}


def _mirror_specs(m):
    """tests/test_integrator.py's mirror scene: a mirror tilted 45° about x
    above an emitter floor, with a diffuse sphere beside it."""
    return [m.plane_spec((0, 0, 0), (45.0, 0.0, 0.0), (4, 4, 4), mat_id=0),
            m.plane_spec((0, -8.0, 0), (90.0, 0.0, 0.0), (40, 40, 40), mat_id=1),
            m.sphere_spec(position=(1.2, 0.0, 1.0), radius=0.6, mat_id=2, subdivisions=1)]


_MIRROR_MATS = [{"type": "mirror", "specular_color": (0.9, 0.8, 0.7)}, EMITTER,
                {"type": "diffuse", "albedo": (0.6, 0.5, 0.4)}]


def _glass_specs(m):
    """tests/test_integrator.py's glass scene: a two-sided glass icosphere
    inside a two-sided emitter sphere."""
    return [m.mesh_spec(m.icosphere(2), mat_id=0, two_sided=True),
            m.mesh_spec(m.icosphere(2), scale=(20.0, 20.0, 20.0), mat_id=1, two_sided=True)]


def _mixed_specs(m):
    """A diffuse floor and ball, a mirror wall, a glass ball and an emitter
    panel above."""
    return [m.plane_spec((0.0, -1.0, 0.0), (90.0, 0.0, 0.0), (8.0, 8.0, 8.0), mat_id=0),
            m.plane_spec((0.0, 0.5, -2.5), (0.0, 0.0, 0.0), (3.0, 3.0, 3.0), mat_id=1),
            m.mesh_spec(m.icosphere(1), position=(-0.6, -0.2, 0.3), scale=(0.8, 0.8, 0.8), mat_id=2, two_sided=True),
            m.sphere_spec(position=(0.9, -0.4, 0.6), radius=0.5, mat_id=0, subdivisions=1),
            m.plane_spec((0.0, 3.0, 0.0), (90.0, 0.0, 0.0), (3.0, 3.0, 3.0), mat_id=3)]


_MIXED_MATS = [{"type": "diffuse", "albedo": (0.7, 0.6, 0.5)},
               {"type": "mirror", "specular_color": (0.9, 0.85, 0.8)}, GLASS,
               {"type": "emitter", "emissive_color": (1.0, 0.95, 0.9), "intensity": 4.0}]

SCENES = {
    "mirror": (_mirror_specs, _MIRROR_MATS, (0.0, 0.0, 5.0), 60.0),
    "glass": (_glass_specs, [GLASS, EMITTER], (0.0, 0.0, 5.0), 40.0),
    "mixed": (_mixed_specs, _MIXED_MATS, (0.0, 0.5, 5.0), 55.0),
}
SIZE = 12
KW = dict(width=SIZE, height=SIZE, spp=2, bounces=4, tri_block=64)


def _scenes(name):
    specs, mats, position, fov = SCENES[name]
    js = j_scene.build_scene(specs(j_scene), mats, pad_to_multiple=64)
    ts = t_scene.build_scene(specs(t_scene), mats, pad_to_multiple=64, device="cpu")
    jc = JCamera.create(position=position, fov_deg=fov, width=SIZE, height=SIZE)
    tc = TCamera.create(position=position, fov_deg=fov, width=SIZE, height=SIZE, device="cpu")
    return (js, jc), (ts, tc)


@pytest.mark.parametrize(
    "name,change",
    [
        ("mirror", {}),
        ("glass", {"bounces": 6}),
        ("mixed", {}),
        ("mixed", {"estimator": "nee"}),
        ("mixed", {"estimator": "mis", "tri_block_secondary": 128}),
        ("mixed", {"rr_start": 1}),
        ("mixed", {"estimator": "mis", "rr_start": 2}),
        ("mixed", {"use_shading_normals": True, "jitter": False}),
    ],
)
def test_mirror_glass_render_matches_jax(name, change, record_property):
    (js, jc), (ts, tc) = _scenes(name)
    want = np.asarray(j_render(js, jc, JSettings(**{**KW, **change}, intersector="pallas")))
    got = render_frame(ts, tc, RenderSettings(**{**KW, **change}), device="cpu").numpy()
    assert want.mean() > 0.05
    record_property("max_abs_diff", float(np.abs(got - want).max()))
    assert_image_bar(got, want)
    if change.get("estimator", "naive") == "naive":
        # Same arithmetic, no light sampling: the same image to the bit.
        np.testing.assert_array_equal(got, want)


def test_glass_sphere_lets_the_backdrop_through():
    """The straight-through glass ball in an emitter sphere renders close to
    Le = 2 (tests/test_integrator.py's check), and some lanes refract."""
    (_, _), (ts, tc) = _scenes("glass")
    img = render_frame(ts, tc, RenderSettings(**{**KW, "bounces": 6}), device="cpu")
    assert torch.isfinite(img).all() and (img >= 0).all()
    np.testing.assert_allclose(img.mean().item(), 2.0 * 0.96, rtol=0.08)


@pytest.mark.parametrize("mode", ["mask", "hybrid"])
@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize("change", [{}, {"estimator": "nee", "tri_block_secondary": 128}], ids=["naive", "nee"])
def test_compact_modes_equal_permute(mode, streamed, change, monkeypatch):
    """Per-lane results do not depend on the lane's position: mask and
    hybrid give the permute image to the bit. The streamed case forces the
    packs onto the streamed route."""
    if streamed:
        force_streamed(monkeypatch, budget=4096)
    (_, _), (ts, tc) = _scenes("mixed")
    st = RenderSettings(**{**KW, **change})
    assert is_streamed(tpi.pack_scene(ts, tri_block=64)) == streamed
    want = render_frame(ts, tc, st, device="cpu")
    got = render_frame(ts, tc, dataclasses.replace(st, compact_mode=mode), device="cpu")
    assert torch.equal(got, want)


def test_mask_mode_passes_the_live_mask_without_permuting(monkeypatch):
    """In mask mode the scan bounces hand the live mask to the closest-hit
    search (dead lanes in place) and shadow rays reach the any-hit search
    uncompacted, with max_t = 0 on dead lanes."""
    (_, _), (ts, tc) = _scenes("mixed")
    seen = {"alive": [], "maxt": []}
    closest, anyhit = tpi.closest_hit_reference, tpi.occluded_reference

    def closest_stub(order, enter, feats, alive, *rest, **kw):
        seen["alive"].append(alive.clone())
        return closest(order, enter, feats, alive, *rest, **kw)

    def anyhit_stub(order, enter, feats, maxt, *rest, **kw):
        seen["maxt"].append(maxt.clone())
        return anyhit(order, enter, feats, maxt, *rest, **kw)

    monkeypatch.setattr(tpi, "closest_hit", closest_stub)
    monkeypatch.setattr(tpi, "occluded", anyhit_stub)
    st = RenderSettings(**{**KW, "spp": 1, "estimator": "nee", "tri_block_secondary": 128, "compact_mode": "mask"})
    render_frame(ts, tc, st, device="cpu")
    r = SIZE * SIZE
    scan_alive = [a[:r] for a in seen["alive"][2:]]  # after bounce 0's search and its shadow rays
    assert len(seen["maxt"]) == st.bounces - 1
    # Dead lanes sit between live ones: no permutation moved them to the back.
    assert any(bool((~a[:-1].bool() & a[1:].bool()).any()) for a in scan_alive)
    assert all(bool((m[:r] == 0).any()) and bool((m[:r] > 0).any()) for m in seen["maxt"])


@pytest.mark.parametrize("aov", ["normal", "normal_unit"])
@pytest.mark.parametrize("config", ["config5_invert_target.toml", "config3_icosphere.toml"])
def test_normal_aovs_match_jax_exactly(config, aov):
    (js, jc, jst), (ts_, tc, tst) = _resized(config, 16, 1)
    want = np.asarray(j_render(js, jc, dataclasses.replace(jst, aov=aov)))
    got = render_frame(ts_, tc, dataclasses.replace(tst, aov=aov), device="cpu").numpy()
    assert (want > 0).any()
    np.testing.assert_array_equal(got, want)


def test_normal_aov_takes_one_search(monkeypatch):
    (_, _, _), (ts_, tc, tst) = _resized("config3_icosphere.toml", 16, 4)
    calls = []
    plain = tpi.closest_hit_reference
    monkeypatch.setattr(tpi, "closest_hit", lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    render_frame(ts_, tc, dataclasses.replace(tst, aov="normal"), device="cpu")
    assert len(calls) == 1


@pytest.mark.parametrize("name,chunks", [("mixed", (1, 2, 1)), ("config5", (3, 1))])
def test_render_samples_chunks_sum_to_the_frame(name, chunks):
    """Chunks over a partition of [0, spp), summed in order, equal
    render_frame · spp within atol 1e-6 (the JAX package's bar); each chunk
    meets the image bar against JAX's render_samples of the same range."""
    if name == "config5":
        (js, jc, jst), (ts, tc, tst) = _resized("config5_invert_target.toml", 12, sum(chunks))
    else:
        (js, jc), (ts, tc) = _scenes(name)
        jst = JSettings(**{**KW, "spp": sum(chunks)}, intersector="pallas")
        tst = RenderSettings(**{**KW, "spp": sum(chunks)})
    total, start = torch.zeros((tst.height, tst.width, 3)), 0
    for n in chunks:
        chunk = render_samples(ts, tc, tst, start, n, device="cpu")
        want = np.asarray(j_render_samples(js, jc, jst, jnp.uint32(start), n))
        assert_image_bar(chunk.numpy() / n, want / n)
        total, start = total + chunk, start + n
    frame = render_frame(ts, tc, tst, device="cpu")
    np.testing.assert_allclose(total.numpy() / tst.spp, frame.numpy(), atol=1e-6, rtol=0)


def test_bench_loss_gradients_through_glass_and_mirror_match_jax():
    """The bench loss (mean image) in v0 and the albedo on the mixed scene,
    NEE with two packs, against jax.grad (rtol 1e-4, atol 1e-6·max|g|)."""
    (js, jc), (ts, tc) = _scenes("mixed")
    kw = {**KW, "spp": 1, "bounces": 3, "estimator": "nee", "tri_block_secondary": 128}

    def j_loss(v0, albedo):
        scene = js.replace(v0=v0, materials=js.materials.replace(albedo=albedo))
        return jnp.mean(j_render(scene, jc, JSettings(**kw, intersector="pallas")))

    want_loss, want = jax.value_and_grad(j_loss, argnums=(0, 1))(js.v0, js.materials.albedo)
    v0 = ts.v0.clone().requires_grad_()
    albedo = ts.materials.albedo.clone().requires_grad_()
    scene = dataclasses.replace(ts, v0=v0, materials=dataclasses.replace(ts.materials, albedo=albedo))
    img = render_frame(scene, tc, RenderSettings(**kw), device="cpu")
    img.mean().backward()
    np.testing.assert_allclose(img.mean().item(), float(want_loss), rtol=RTOL)
    assert int((np.asarray(want[0]) != 0).any(axis=-1).sum()) > 10
    for g, w, n in zip((v0.grad, albedo.grad), want, ("v0", "albedo")):
        assert_grad_close(g, w, n)


def _directions(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("fn", ["reflect", "refract", "fresnel_schlick", "normalize_dir", "cosine_hemisphere_pdf"])
def test_sampling_helpers_match_jax(fn):
    """The glass and mirror helpers on numpy-seeded inputs, total internal
    reflection included, equal the JAX package's to the bit; refract and
    normalize_dir within 1.2e-7 (one ulp at 1): torch's CPU sqrt is not
    correctly rounded (1 ulp off numpy's and XLA's on ~0.6% of inputs)."""
    rng = np.random.default_rng(5)
    n = 4096
    d, nrm = _directions(rng, n), _directions(rng, n)
    nrm = np.where((d * nrm).sum(-1, keepdims=True) > 0, -nrm, nrm)  # facing against d
    eta = rng.choice(np.asarray([1 / 1.5, 1.5, 1 / 2.4], np.float32), size=(n, 1))
    cos_i = rng.uniform(0, 1, n).astype(np.float32)
    eta_i = rng.choice(np.asarray([1.0, 1.5], np.float32), size=n)
    eta_t = np.where(eta_i == 1.0, np.float32(1.5), np.float32(1.0))
    v = (rng.normal(size=(n, 3)) * 10.0 ** rng.uniform(-13, 2, (n, 1))).astype(np.float32)
    args = {
        "reflect": (d, nrm), "refract": (d, nrm, eta), "fresnel_schlick": (cos_i, eta_i, eta_t),
        "normalize_dir": (v,), "cosine_hemisphere_pdf": (cos_i,),
    }[fn]
    want = getattr(j_sampling, fn)(*(jnp.asarray(a) for a in args))
    got = getattr(t_sampling, fn)(*(torch.from_numpy(a) for a in args))
    if fn == "refract":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert 0 < int(got[1].sum()) < n  # some lanes reflect totally
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1.2e-7)
    elif fn == "normalize_dir":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1.2e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
