"""The port's config 5 trainer (``grad/inverse.py``) against the JAX
package's ``run_inverse_demo`` at ``tests/test_inverse.py``'s small size:
the target image, the first step's gradients, the trajectory, a resume
from the port's own checkpoint and from a JAX checkpoint carried across by
``interop.inverse_state_from_numpy`` and ``grad.inverse.adam_state``.

Adam's first step is lr·sign(g), so an entry whose gradient is zero within
float32 rounding (|g| <= 1e-6·max|g|, the gradient tolerance of
``tests/test_torch_grad.py``; for example a vertex component along which
the image is flat, such as a move within the triangle's own plane) takes a step of about ±lr whose sign is rounding noise in either package.
So the parameters are judged by the share of offset entries off by more
than 1e-3 among the entries whose gradient at that step is clear of zero:
under 1%. The noise-level entries (20 of the 720 offset entries at step 0;
``tools/inverse_trajectory.py`` follows both trajectories) are left out of
that share, and the loss is compared where both packages hold the same
parameters: at the first step, and at the JAX parameters of the later
steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_grad import assert_grad_close
from test_torch_render import assert_image_bar

from gpupathtracer_tpu.grad import inverse as j_inverse
from gpupathtracer_tpu.render.renderer import render_frame as j_render
from gpupathtracer_tpu.utils.checkpoint import load_train_state as j_load_state
from gpupathtracer_tpu_torch import interop
from gpupathtracer_tpu_torch.grad import inverse as t_inverse
from gpupathtracer_tpu_torch.render.renderer import render_frame
from gpupathtracer_tpu_torch.utils import checkpoint as t_ckpt

SMALL = dict(width=32, height=32, spp=2, bounces=2, subdivisions=1)
LR = 5e-2
LOSS_RTOL = 1e-3
OFF = 1e-3  # an offset entry is off when it differs by more than this
OFF_SHARE = 0.01  # ... and under this share of the clear entries may be


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX demo run to steps 1, 2 and 3 through its checkpoint, its
    target, and a jitted (loss, gradient) of its step."""
    ck = str(tmp_path_factory.mktemp("jax") / "train.pkl")
    states, history = {}, []
    for steps in (1, 2, 3):
        history += j_inverse.run_inverse_demo(steps=steps, lr=LR, checkpoint_path=ck, **SMALL)["loss_history"]
        states[steps] = j_load_state(ck)
    settings, camera, make_scene, mesh = j_inverse._demo_setup(**SMALL)
    true_offsets = jnp.asarray(mesh.vertices) * 1.2 * jnp.asarray([0.0, -0.15, 0.0])
    target = j_render(make_scene(jnp.asarray([0.2, 0.55, 0.85]), true_offsets), camera, settings)

    @jax.jit
    def value_and_grad(p, seed):
        def loss(p):
            img = j_render(make_scene(jax.nn.sigmoid(p["albedo_logit"]), p["offsets"]), camera, settings, seed=seed)
            return jnp.mean((img - target) ** 2)

        return jax.value_and_grad(loss)(p)

    return {"states": states, "history": dict(history), "target": np.asarray(target), "value_and_grad": value_and_grad}


def _jax_params(state):
    return {k: jnp.asarray(np.asarray(v)) for k, v in state["params"].items()}


def _zeros(shape_of):
    return {k: jnp.zeros_like(v) for k, v in shape_of.items()}


def _port_problem():
    return t_inverse._demo_problem(**SMALL, device="cpu")


def _port_loss(problem, params, seed):
    settings, camera, make_scene, _, target, _, _ = problem
    img = render_frame(make_scene(torch.sigmoid(params["albedo_logit"]), params["offsets"]), camera, settings,
                       seed=seed, device="cpu")
    return ((img - target) ** 2).mean()


def _off_share_among_clear(got, want, grad):
    """Share of the offset entries off by more than OFF, among those whose
    gradient is clear of zero (|g| > 1e-6·max|g|), and the count of noise-level ones."""
    grad = np.asarray(grad)
    clear = np.abs(grad) > 1e-6 * np.abs(grad).max()
    off = np.abs(np.asarray(got) - np.asarray(want)) > OFF
    return off[clear].mean(), int((~clear & (grad != 0)).sum())


def test_target_image_matches_jax(jax_run):
    target = _port_problem()[4]
    assert_image_bar(target.numpy(), jax_run["target"])


def test_first_step_gradients_match_jax(jax_run):
    problem = _port_problem()
    params = {k: torch.zeros(v.shape, requires_grad=True) for k, v in jax_run["states"][1]["params"].items()}
    loss = _port_loss(problem, params, 0)
    loss.backward()
    want_loss, want = jax_run["value_and_grad"](_zeros(_jax_params(jax_run["states"][1])), jnp.uint32(0))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    for k in params:
        assert_grad_close(params[k].grad, want[k], k)


def test_trainer_follows_jax(jax_run, tmp_path):
    """Step 0's loss, the parameters after step 1, and the port's loss at
    the JAX parameters of steps 1 and 2."""
    ck = str(tmp_path / "train.pkl")
    first = t_inverse.run_inverse_demo(steps=1, lr=LR, checkpoint_path=ck, device="cpu", **SMALL)
    (_, loss0), = first["loss_history"]
    np.testing.assert_allclose(loss0, jax_run["history"][0], rtol=LOSS_RTOL)
    want1 = jax_run["states"][1]["params"]
    got1 = t_ckpt.load_train_state(ck)["params"]
    np.testing.assert_allclose(got1["albedo_logit"], want1["albedo_logit"], atol=OFF)
    _, g0 = jax_run["value_and_grad"](_zeros(_jax_params(jax_run["states"][1])), jnp.uint32(0))
    share, noise = _off_share_among_clear(got1["offsets"], want1["offsets"], g0["offsets"])
    assert share < OFF_SHARE, (share, noise)
    problem = _port_problem()
    for step in (1, 2):
        p = {k: torch.as_tensor(np.asarray(v)) for k, v in jax_run["states"][step]["params"].items()}
        with torch.no_grad():
            np.testing.assert_allclose(_port_loss(problem, p, step).item(), jax_run["history"][step], rtol=LOSS_RTOL)


def test_checkpoint_resume_bit_identical(tmp_path):
    """As tests/test_inverse.py: an interrupted and resumed run ends on the
    uninterrupted run's parameters and optimizer state, bit for bit."""
    ck_a, ck_b = str(tmp_path / "a.pkl"), str(tmp_path / "b.pkl")
    t_inverse.run_inverse_demo(steps=4, lr=LR, checkpoint_path=ck_a, device="cpu", **SMALL)
    t_inverse.run_inverse_demo(steps=2, lr=LR, checkpoint_path=ck_b, device="cpu", **SMALL)
    assert t_ckpt.load_train_state(ck_b)["step"] == 2
    t_inverse.run_inverse_demo(steps=4, lr=LR, checkpoint_path=ck_b, device="cpu", **SMALL)
    a, b = t_ckpt.load_train_state(ck_a), t_ckpt.load_train_state(ck_b)
    assert a["step"] == b["step"] == 4
    for k in t_inverse.PARAM_NAMES:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
    for i, sa in a["opt_state"]["state"].items():
        for name, v in sa.items():
            np.testing.assert_array_equal(v, b["opt_state"]["state"][i][name])


def test_jax_checkpoint_continues_in_the_port(jax_run, tmp_path):
    """The JAX step-2 checkpoint, carried by interop, resumes in the port:
    step 2's loss equals the JAX run's, and the step lands on the JAX step-3
    parameters within the bar."""
    state = jax_run["states"][2]
    adam = state["opt_state"][0]  # optax adam: (ScaleByAdamState, EmptyState)
    as_numpy = lambda tree: {k: np.asarray(v) for k, v in tree.items()}
    carried = interop.inverse_state_from_numpy(
        as_numpy(state["params"]), np.asarray(adam.count), as_numpy(adam.mu), as_numpy(adam.nu), device="cpu"
    )
    ck = str(tmp_path / "carried.pkl")
    t_ckpt.save_train_state(ck, carried["params"], t_inverse.adam_state(lr=LR, **carried), state["step"])
    result = t_inverse.run_inverse_demo(steps=3, lr=LR, checkpoint_path=ck, device="cpu", **SMALL)
    (step, loss), = result["loss_history"]
    assert step == 2
    np.testing.assert_allclose(loss, jax_run["history"][2], rtol=LOSS_RTOL)
    got = t_ckpt.load_train_state(ck)["params"]
    want = jax_run["states"][3]["params"]
    np.testing.assert_allclose(got["albedo_logit"], want["albedo_logit"], atol=OFF)
    _, g2 = jax_run["value_and_grad"](_jax_params(state), jnp.uint32(2))
    share, noise = _off_share_among_clear(got["offsets"], want["offsets"], g2["offsets"])
    assert share < OFF_SHARE, (share, noise)


def test_trainer_writes_pngs(tmp_path):
    from PIL import Image

    result = t_inverse.run_inverse_demo(steps=1, lr=LR, out_dir=str(tmp_path), device="cpu", **SMALL)
    assert np.isfinite(result["final_loss"])
    for name in ("target.png", "recovered.png"):
        img = np.asarray(Image.open(tmp_path / name))
        assert img.shape == (SMALL["height"], SMALL["width"], 3) and img.max() > 0
