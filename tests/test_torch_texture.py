"""The port's textured albedo, PPM reader, texture columns and UV
interpolation against the JAX package, on inputs drawn with numpy."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.models import materials as j_materials
from gpupathtracer_tpu.ops.intersect import resolve_hits as j_resolve_hits
from gpupathtracer_tpu.utils.config import load_scene_file as j_load
from gpupathtracer_tpu.utils.image import read_ppm as j_read_ppm
from gpupathtracer_tpu_torch import interop
from gpupathtracer_tpu_torch.models import materials as t_materials
from gpupathtracer_tpu_torch.models.materials import MaterialTable
from gpupathtracer_tpu_torch.models.scene import TriangleScene
from gpupathtracer_tpu_torch.ops.intersect import resolve_hits as t_resolve_hits
from gpupathtracer_tpu_torch.utils.config import load_scene_file as t_load
from gpupathtracer_tpu_torch.utils.image import read_ppm as t_read_ppm

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")
STAND_IN = os.path.join(SCENES, "config8_icosphere.toml")


def _lanes(rng, r, t_rows):
    """Random per-ray texture inputs: every kind, UVs beyond [0, 1] on both
    sides (wrap addressing), out-of-range texture ids (clamped)."""
    return dict(
        base=rng.uniform(size=(r, 3)).astype(np.float32),
        tex_kind=rng.integers(0, 3, size=r),
        tex_id=rng.integers(-1, t_rows + 1, size=r),
        checker_color=rng.uniform(size=(r, 3)).astype(np.float32),
        checker_scale=rng.choice([1.0, 2.5, 8.0], size=r).astype(np.float32),
        uv=rng.uniform(-1.5, 2.5, size=(r, 2)).astype(np.float32),
    )


@pytest.mark.parametrize(
    "tex_shape",
    [
        None,  # checker only
        (1, 32, 32),  # the stand-in's stack: JAX takes its one-hot factorized branch
        (2, 16, 48),  # W*3 > 128: JAX takes the flat 4-tap gather, as the port does
    ],
)
def test_textured_albedo_matches_jax(tex_shape):
    rng = np.random.default_rng(11)
    t_rows = tex_shape[0] if tex_shape else 1
    lanes = _lanes(rng, 4096, t_rows)
    textures = None if tex_shape is None else rng.uniform(size=tex_shape + (3,)).astype(np.float32)
    order = ("base", "tex_kind", "tex_id", "checker_color", "checker_scale", "uv")
    want = j_materials.textured_albedo(
        *(jnp.asarray(lanes[k], jnp.int32 if k in ("tex_kind", "tex_id") else None) for k in order),
        None if textures is None else jnp.asarray(textures),
    )
    got = t_materials.textured_albedo(
        *(torch.as_tensor(lanes[k]) for k in order), None if textures is None else torch.as_tensor(textures)
    )
    # The factorized and 4-tap lookups agree to rounding (association order
    # of the four taps differs); the checker and the flat gather are exact.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    if tex_shape is not None:
        image = lanes["tex_kind"] == j_materials.TEX_IMAGE
        assert image.sum() > 1000 and np.abs(got.numpy()[image] - lanes["base"][image]).max() > 0.1


def test_read_ppm_matches_jax(tmp_path):
    plaid = os.path.join(SCENES, "textures", "plaid32.ppm")
    np.testing.assert_array_equal(t_read_ppm(plaid), j_read_ppm(plaid))
    # Comments, values above maxval (clamped), several triples per line.
    p = tmp_path / "odd.ppm"
    p.write_text("P3 # header\n3 2\n255\n0 1 2  300 4 5 # row 0\n6 7 8\n9 10 11 12 13 14 255 0 999\n")
    got = t_read_ppm(str(p))
    np.testing.assert_array_equal(got, j_read_ppm(str(p)))
    assert got.shape == (2, 3, 3) and got.dtype == np.uint8 and got[0, 1, 0] == 255


def test_stand_in_texture_stack_and_columns_match_jax():
    js, _, _ = j_load(STAND_IN)
    ts, _, _ = t_load(STAND_IN, device="cpu")
    np.testing.assert_array_equal(ts.textures.numpy(), np.asarray(js.textures))
    assert tuple(ts.textures.shape) == (1, 32, 32, 3)
    for name in ("tex_kind", "tex_id", "checker_color", "checker_scale"):
        np.testing.assert_array_equal(getattr(ts.materials, name).numpy(), np.asarray(getattr(js.materials, name)))


def test_material_table_texture_columns_match_jax():
    mats = [
        {"type": "diffuse", "albedo": (0.2, 0.3, 0.4), "texture": "checker"},  # default color and scale
        {"type": "diffuse", "texture": "checker", "checker_color": (0.9, 0.1, 0.1), "checker_scale": 3.0},
        {"type": "diffuse", "texture": "image", "texture_id": 2},
        {"type": "emitter", "emissive_color": (1.0, 1.0, 1.0), "intensity": 2.0},
    ]
    want = j_materials.material_table(mats)
    got = t_materials.material_table(mats, device="cpu")
    for f in dataclasses.fields(MaterialTable):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)), err_msg=f.name)
    for pkg in (j_materials, None):
        with pytest.raises(ValueError, match="texture kind"):
            if pkg is None:
                t_materials.material_table([{"texture": "marble"}], device="cpu")
            else:
                pkg.material_table([{"texture": "marble"}])


def test_resolve_hits_uvs_match_jax():
    """UVs interpolated at the hits of rays aimed at random points of the
    stand-in's floor and sphere."""
    js, _, _ = j_load(STAND_IN)
    fields = interop.numpy_fields(js, [f.name for f in dataclasses.fields(TriangleScene) if f.name != "materials"])
    fields["materials"] = interop.numpy_fields(js.materials, [f.name for f in dataclasses.fields(MaterialTable)])
    ts = interop.scene_from_numpy(fields, device="cpu")
    assert ts.textures is not None
    rng = np.random.default_rng(3)
    live = np.flatnonzero(np.asarray(js.valid))
    floor = np.flatnonzero((np.asarray(js.geom_id) == 0) & np.asarray(js.valid))  # the sphere's UVs are all zero
    tri = np.concatenate([rng.choice(live, size=1500), rng.choice(floor, size=1500)])
    b = rng.dirichlet((1.0, 1.0, 1.0), size=3000).astype(np.float32)
    v0, e1, e2 = (np.asarray(x)[tri] for x in (js.v0, js.e1, js.e2))
    target = v0 + b[:, 1:2] * e1 + b[:, 2:3] * e2
    o = np.asarray([0.0, 1.2, 4.5], np.float32) + rng.normal(size=(3000, 3)).astype(np.float32) * 0.1
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = j_resolve_hits(jnp.asarray(o), jnp.asarray(d), js, jnp.asarray(tri, jnp.int32), need_sn=False, need_uv=True)
    got = t_resolve_hits(torch.as_tensor(o), torch.as_tensor(d), ts, torch.as_tensor(tri), need_sn=False, need_uv=True)
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(want.uv), rtol=1e-5, atol=1e-5)
    assert np.asarray(want.uv).std() > 0.1  # the floor's UVs vary
    assert t_resolve_hits(torch.as_tensor(o), torch.as_tensor(d), ts, torch.as_tensor(tri), need_uv=False).uv is None
