"""The camera term of the port's edge-sampled boundary gradient and the
silhouette and camera demos of ``grad/inverse.py`` against the JAX
package's, and their CLI (``invert --mode silhouette|camera``).

The scene is the demos': a black quad before a uniform emitter backdrop, at
16x16, spp 2, blocks of 8, naive, one bounce. The camera term
(``camera_fn`` in dx and yaw) is held to rtol 1e-3 and atol 1e-6 * max|g|
of the JAX gradient (``tests/test_torch_edges.py`` says why); the demos'
first 3 steps to the loss within rtol 1e-4 and the parameters within 1e-3.
The detached gradient at the start is exactly 0 in both demos: all their
signal is silhouette motion. Each JAX reference is computed once.
"""

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_edges import DEMO_SIZE, DEMO_SPP, _cameras, _cot, _settings, assert_grad_close, quad_scene

from gpupathtracer_tpu.grad import edges as je
from gpupathtracer_tpu.grad import inverse as ji
from gpupathtracer_tpu.models import scene as jsn
from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch.grad import edges as te
from gpupathtracer_tpu_torch.grad import inverse as ti
from gpupathtracer_tpu_torch.models import scene as tsn
from gpupathtracer_tpu_torch.ops import threefry

DEMO_KW = dict(steps=3, width=DEMO_SIZE, height=DEMO_SIZE, spp=DEMO_SPP)
CAMERA_PARAMS = {"dx": 0.1, "yaw": 2.0}


def _camera_fn(cam, xp, replace):
    return lambda p: replace(cam, position=cam.position + xp.asarray([1.0, 0.0, 0.0]) * p["dx"], yaw=cam.yaw + p["yaw"])


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX demos (3 steps each) and the camera term in dx and yaw."""
    refs = {"silhouette demo": ji.run_silhouette_demo(**DEMO_KW), "camera demo": ji.run_camera_demo(**DEMO_KW)}
    jc, _ = _cameras(DEMO_SIZE, position=(0.0, 0.0, 4.0))
    jst, _ = _settings(width=DEMO_SIZE, height=DEMO_SIZE, spp=DEMO_SPP, bounces=1, tri_block=8, jitter=True)
    scene = quad_scene(jsn, jnp, jnp.float32(0.72))
    refs["camera"] = je.primary_edge_gradient(
        lambda p: scene, {k: jnp.float32(v) for k, v in CAMERA_PARAMS.items()}, jc, jst,
        jnp.asarray(_cot(DEMO_SIZE, 2)), je.build_edge_table(scene, native=False), jax.random.PRNGKey(9),
        n_samples=2048, trace_spp=2, camera_fn=_camera_fn(jc, jnp, lambda c, **kw: c.replace(**kw)),
    )
    return refs


def test_camera_boundary_gradient_matches_jax(jax_refs):
    """camera_fn in dx and yaw: samples from the detached camera, the
    gradient through the differentiable projection."""
    _, tc = _cameras(DEMO_SIZE, position=(0.0, 0.0, 4.0))
    _, tst = _settings(width=DEMO_SIZE, height=DEMO_SIZE, spp=DEMO_SPP, bounces=1, tri_block=8, jitter=True)
    scene = quad_scene(tsn, torch, torch.tensor(0.72))
    got = te.primary_edge_gradient(
        lambda p: scene, {k: torch.tensor(v) for k, v in CAMERA_PARAMS.items()}, tc, tst,
        torch.as_tensor(_cot(DEMO_SIZE, 2)), te.build_edge_table(scene), threefry.PRNGKey(9), n_samples=2048,
        trace_spp=2, camera_fn=_camera_fn(tc, torch, dataclasses.replace), device="cpu",
    )
    for k in CAMERA_PARAMS:
        assert abs(float(jax_refs["camera"][k])) > 0, k
        assert_grad_close(got[k], jax_refs["camera"][k], k)


@pytest.mark.parametrize("name", ["silhouette demo", "camera demo"])
def test_demos_match_jax(jax_refs, name):
    """The first 3 steps at 16x16, spp 2: the loss history within rtol 1e-4,
    the parameters within 1e-3, and a detached gradient of exactly 0."""
    demo = ti.run_silhouette_demo if name == "silhouette demo" else ti.run_camera_demo
    got, want = demo(**DEMO_KW, device="cpu"), jax_refs[name]
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1], w[1], rtol=1e-4)
        np.testing.assert_allclose(g[2:], w[2:], atol=1e-3)
    assert got["detached_gradient_at_init"] == want["detached_gradient_at_init"]
    if name == "silhouette demo":
        assert got["detached_gradient_at_init"] == 0.0
        np.testing.assert_allclose(got["recovered_scale"], want["recovered_scale"], atol=1e-3)
    else:
        assert got["detached_gradient_at_init"] == {"dx": 0.0, "dz": 0.0}
        np.testing.assert_allclose(list(got["recovered"].values()), list(want["recovered"].values()), atol=1e-3)


@pytest.mark.parametrize("mode", ["silhouette", "camera"])
def test_cli_invert_modes(mode, tmp_path):
    """``invert --mode silhouette|camera`` on the CPU prints the demo's
    result as JSON and writes the target and recovered images."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--device", "cpu", "invert", "--mode", mode, "--steps", "1", "--spp", "2",
                       "--out", str(tmp_path)])
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and len(result["history"]) == 1
    g0 = result["detached_gradient_at_init"]
    assert g0 == (0.0 if mode == "silhouette" else {"dx": 0.0, "dz": 0.0})
    assert sorted(os.listdir(tmp_path)) == ["recovered.png", "target.png"]


def test_cli_invert_defaults_to_the_card():
    """Without ``--device`` the demos ask for the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["invert", "--mode", "silhouette", "--steps", "1"])
