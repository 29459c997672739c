"""The bench loss (the mean image with respect to ``v0`` and albedo,
``gpupathtracer_tpu/bench.py``) differentiated by the port and by
``jax.grad`` of the JAX package's ``render_frame``: on config 5 and the
config 3 stand-in at small size, resident and streamed, with the tolerance
of ``tests/test_torch_grad.py`` (rtol 1e-4, atol 1e-6·max|g|)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_grad import RTOL, assert_grad_close
from test_torch_render import _resized
from test_torch_stream import force_streamed, is_streamed

from gpupathtracer_tpu.render.renderer import render_frame as j_render
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.render.renderer import render_frame


def _bench_loss_grads(config, size, spp, change):
    """Loss and gradients of the bench loss in both packages."""
    (js, jc, jst), (ts_, tc, tst) = _resized(config, size, spp)
    jst, tst = dataclasses.replace(jst, **change), dataclasses.replace(tst, **change)

    def j_loss(v0, albedo):
        scene = js.replace(v0=v0, materials=js.materials.replace(albedo=albedo))
        return jnp.mean(j_render(scene, jc, jst))

    want_loss, want = jax.value_and_grad(j_loss, argnums=(0, 1))(js.v0, js.materials.albedo)
    v0 = ts_.v0.clone().requires_grad_()
    albedo = ts_.materials.albedo.clone().requires_grad_()
    scene = dataclasses.replace(ts_, v0=v0, materials=dataclasses.replace(ts_.materials, albedo=albedo))
    img = render_frame(scene, tc, tst, device="cpu")
    img.mean().backward()
    return img, float(want_loss), want, (v0.grad, albedo.grad)


@pytest.mark.parametrize(
    "config,size,spp,change",
    [
        ("config5_invert_target.toml", 16, 2, {}),
        ("config5_invert_target.toml", 16, 2, {"estimator": "nee"}),
        ("config3_icosphere.toml", 16, 1, {}),
        # Two packs: the scan bounces' shadow rays take the any-hit search.
        ("config3_icosphere.toml", 16, 1, {"estimator": "nee"}),
    ],
)
def test_bench_loss_gradients_match_jax(config, size, spp, change):
    img, want_loss, want, got = _bench_loss_grads(config, size, spp, change)
    np.testing.assert_allclose(img.mean().item(), want_loss, rtol=RTOL)
    for g, w, name in zip(got, want, ("v0", "albedo")):
        assert_grad_close(g, w, name)


@pytest.mark.parametrize("change", [{}, {"estimator": "nee"}])
def test_streamed_bench_loss_gradients_match_jax(change, monkeypatch):
    """The same on the streamed route (K3 and K4's plain versions here),
    forced at small size as ``tests/test_torch_stream.py`` forces it."""
    force_streamed(monkeypatch, budget=1 << 20)
    assert is_streamed(tpi.pack_scene(_resized("config3_icosphere.toml", 8, 1)[1][0], tri_block=128))
    img, want_loss, want, got = _bench_loss_grads("config3_icosphere.toml", 12, 1, change)
    np.testing.assert_allclose(img.mean().item(), want_loss, rtol=RTOL)
    for g, w, name in zip(got, want, ("v0", "albedo")):
        assert_grad_close(g, w, name)
