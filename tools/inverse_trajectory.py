"""Follows the config 5 trainer of the port and of the JAX package side by
side on the CPU, at tests/test_inverse.py's small size (32x32, spp 2,
2 bounces, icosphere 1, lr 5e-2), to show where their trajectories part.

    python3 tools/inverse_trajectory.py [STEPS]

Prints one JSON line for step 0's gradients (the offset entries whose JAX
gradient is zero, noise-level (0 < |g| <= 1e-6 max|g|) or clear of zero,
and how many noise-level ones have the opposite sign in the port), then one
per step s = 1..STEPS (default 3), each package run to s steps through its
own checkpoint: the share of offset entries that differ by more than 1e-3
(all, and among those whose step-0 gradient is clear of zero) and the two
losses of step s - 1; last, the port's loss at the JAX parameters after
STEPS steps against the JAX loss there (seed STEPS). A CPU run: no number
here is a device time.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpupathtracer_tpu.grad import inverse as j_inverse  # noqa: E402
from gpupathtracer_tpu.render.renderer import render_frame as j_render  # noqa: E402
from gpupathtracer_tpu.utils.checkpoint import load_train_state as j_load  # noqa: E402
from gpupathtracer_tpu_torch.grad import inverse as t_inverse  # noqa: E402
from gpupathtracer_tpu_torch.render.renderer import render_frame  # noqa: E402
from gpupathtracer_tpu_torch.utils.checkpoint import load_train_state as t_load  # noqa: E402

SMALL = dict(width=32, height=32, spp=2, bounces=2, subdivisions=1)
LR = 5e-2


def main() -> None:
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    settings, camera, make_scene, mesh = j_inverse._demo_setup(**SMALL)
    true_offsets = jnp.asarray(mesh.vertices) * 1.2 * jnp.asarray([0.0, -0.15, 0.0])
    target = j_render(make_scene(jnp.asarray([0.2, 0.55, 0.85]), true_offsets), camera, settings)

    @jax.jit
    def value_and_grad(p, seed):
        def loss(p):
            img = j_render(make_scene(jax.nn.sigmoid(p["albedo_logit"]), p["offsets"]), camera, settings, seed=seed)
            return jnp.mean((img - target) ** 2)

        return jax.value_and_grad(loss)(p)

    problem = t_inverse._demo_problem(**SMALL, device="cpu")
    t_settings, t_camera, t_make_scene, _, t_target, _, _ = problem

    def port_value_and_grad(p, seed):
        p = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in p.items()}
        img = render_frame(t_make_scene(torch.sigmoid(p["albedo_logit"]), p["offsets"]), t_camera, t_settings,
                           seed=seed, device="cpu")
        loss = ((img - t_target) ** 2).mean()
        loss.backward()
        return loss.item(), {k: v.grad.numpy() for k, v in p.items()}

    zeros = {"albedo_logit": jnp.zeros(3), "offsets": jnp.zeros(mesh.vertices.shape)}
    _, g0 = value_and_grad(zeros, jnp.uint32(0))
    _, tg0 = port_value_and_grad(zeros, 0)
    g = np.asarray(g0["offsets"])
    noise = (g != 0) & (np.abs(g) <= 1e-6 * np.abs(g).max())
    clear = np.abs(g) > 1e-6 * np.abs(g).max()
    print(json.dumps({"step0_offset_entries": int(g.size), "zero": int((g == 0).sum()), "noise_level": int(noise.sum()),
                      "clear": int(clear.sum()),
                      "noise_level_opposite_sign": int((np.sign(tg0["offsets"]) != np.sign(g))[noise].sum())}),
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        j_ck, t_ck = os.path.join(tmp, "jax.pkl"), os.path.join(tmp, "port.pkl")
        for s in range(1, steps + 1):
            j_hist = j_inverse.run_inverse_demo(steps=s, lr=LR, checkpoint_path=j_ck, **SMALL)["loss_history"]
            t_hist = t_inverse.run_inverse_demo(steps=s, lr=LR, checkpoint_path=t_ck, device="cpu", **SMALL)["loss_history"]
            j_params, t_params = j_load(j_ck)["params"], t_load(t_ck)["params"]
            off = np.abs(np.asarray(j_params["offsets"]) - t_params["offsets"]) > 1e-3
            row = {"step": s, "offsets_off_share": float(off.mean()), "offsets_off_share_clear": float(off[clear].mean()),
                   "jax_loss": j_hist[-1][1], "port_loss": t_hist[-1][1]}
            print(json.dumps(row), flush=True)
        # the port's loss at the JAX parameters of the last step, against JAX's there
        p = {k: jnp.asarray(np.asarray(v)) for k, v in j_load(j_ck)["params"].items()}
        jl, _ = value_and_grad(p, jnp.uint32(steps))
        tl, _ = port_value_and_grad(p, steps)
        print(json.dumps({"loss_at_jax_params_step": steps, "jax": float(jl), "port": tl,
                          "rel_diff": abs(tl - float(jl)) / float(jl)}), flush=True)


if __name__ == "__main__":
    main()
