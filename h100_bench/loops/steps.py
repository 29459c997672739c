"""Inverse-rendering steps: ``render_frame`` with the scene's ``v0`` and
material albedo as leaves, the mean squared error to a target frame,
``torch.autograd.grad`` in both leaves and one ``torch.optim.Adam`` step on
the albedo.

Traffic parameters: ``spp``; ``lr``, Adam's step size; ``target_scale``,
the range of the seeded per-channel factors that scale the albedo of the
target frame, which set-up renders; ``checked_steps``, the first steps,
which set-up takes through the window's own call and the check follows.

Compared, over the checked steps (``check.gap`` for the gaps):

- ``diverged_px_share`` of the target and of the first step's image;
- ``loss_gap``, the largest gap of a step's loss;
- ``grad_gap``, the largest gap of a leaf's first gradient (the albedo's
  as Adam got it, ``exp_avg / (1 - beta1)``) among the leaves whose
  reference gradient is not nought;
- ``nought_leaf_grad``: a leaf whose first gradient in the reference is
  nought (under ``NOUGHT`` of the median leaf's, as ``v0``'s: the naive
  radiance is a product of albedos and emission) is held to the same rule
  in the program: the largest norm of such a leaf's first gradient over the
  median leaf's;
- ``change_gap``, the gap of the albedo's change after the checked steps.
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

from h100_bench import check, drive, faults

NOUGHT = 1e-3  # a leaf's gradient under this share of the median leaf's is nought to rounding


class Loop(drive.Program):
    """Inverse-rendering steps; set-up takes the first ``checked_steps``."""

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        t = self.traffic
        scene = self.scene
        self.v0 = scene.v0.detach().clone().requires_grad_()
        self.albedo = scene.materials.albedo.detach().clone().requires_grad_()
        self.leaf_scene = dataclasses.replace(
            scene, v0=self.v0, materials=dataclasses.replace(scene.materials, albedo=self.albedo))
        rng = drive.seed_stream(seed, "target")
        lo, hi = t["target_scale"]
        self.factors = [float(x) for x in rng.uniform(lo, hi, 3)]
        self.target_seed = drive.draw_seed(rng)
        f = torch.tensor(self.factors, dtype=torch.float32, device=device)
        target_scene = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, albedo=scene.materials.albedo * f[None, :]))
        with torch.no_grad():
            self.target = self.render_frame(target_scene, self.camera, self.settings, seed=self.target_seed,
                                            device=device)
        self.opt = torch.optim.Adam([self.albedo], lr=float(t["lr"]))
        self.theta0 = self.albedo.detach().clone()
        self.losses, self.step_seeds = [], []
        self.image1 = self.grad1 = None
        self.v0_grad1 = 0.0
        for k in range(int(t["checked_steps"])):
            image, loss, g_v0 = self.step()
            self.losses.append(loss)
            if k == 0:
                self.image1 = image.detach()
                self.v0_grad1 = check.norm(g_v0)
                state = self.opt.state.get(self.albedo, {})
                beta1 = self.opt.param_groups[0]["betas"][0]
                # The first gradient as the optimizer got it: exp_avg = (1 - beta1) g.
                self.grad1 = (state["exp_avg"] / (1 - beta1)).clone() if "exp_avg" in state else \
                    torch.zeros_like(self.theta0)
        self.theta_checked = self.albedo.detach().clone()

    def step(self):
        s = drive.draw_seed(self.item_seeds)
        self.step_seeds.append(s)
        with torch.profiler.record_function("h100_bench.step"):
            image = self.render_frame(self.leaf_scene, self.camera, self.settings, seed=s, device=self.device)
            loss = ((image - self.target) ** 2).mean()
            with torch.profiler.record_function("h100_bench.backward"):
                g_v0, g_albedo = torch.autograd.grad(loss, (self.v0, self.albedo), allow_unused=True)
            self.albedo.grad = g_albedo
            self.opt.step()
            value = float(loss)
        drive.sync(self.device)
        return image, value, g_v0

    def item(self, i: int) -> None:
        self.step()

    def record(self) -> dict:
        n = int(self.traffic["checked_steps"])
        return {"target": self.target.detach(), "target_seed": self.target_seed, "factors": self.factors,
                "image1": self.image1, "losses": self.losses, "step_seeds": self.step_seeds[:n],
                "grads1": {"albedo": check.norm(self.grad1), "v0": self.v0_grad1},
                "theta0": self.theta0, "theta_checked": self.theta_checked,
                "lr": float(self.traffic["lr"]), "betas": self.opt.param_groups[0]["betas"],
                "eps": self.opt.param_groups[0]["eps"]}


def judge(cell, record: dict, device):
    """``(numbers, work)`` for the steps the loop took in set-up: the
    reference renders its own target and follows the same steps with its
    own Adam, ``v0`` a leaf in its first step."""
    t = cell.traffic
    ref = check.reference(cell, device)
    spp = int(t["spp"])
    h, w = ref.camera.height, ref.camera.width
    pixels = torch.arange(h * w, device=device)
    stats = ref.stats()
    f = torch.tensor(record["factors"], dtype=torch.float32, device=device)
    with torch.no_grad():
        target = ref.trace(pixels, record["target_seed"], spp, albedo=ref.scene.albedo * f[None, :]) / spp
    diverged = check.diverged(record["target"].reshape(-1, 3), target)
    theta = ref.scene.albedo.detach().clone().requires_grad_()
    theta0 = theta.detach().clone()
    v0 = ref.scene.v0.detach().clone().requires_grad_()
    m, v = torch.zeros_like(theta0), torch.zeros_like(theta0)
    (b1, b2), eps, lr = record["betas"], record["eps"], record["lr"]
    losses, grads1 = [], None
    for k, seed in enumerate(record["step_seeds"], start=1):
        scene = dataclasses.replace(ref.scene, v0=v0) if k == 1 else None
        image = ref.trace(pixels, seed, spp, scene=scene, albedo=theta, count_rays=int(t["work_rays"]),
                          stats=stats) / spp
        if k == 1:
            diverged += check.diverged(record["image1"].reshape(-1, 3), image.detach())
        loss = ((image.reshape(h, w, 3) - target.reshape(h, w, 3)) ** 2).mean()
        if k == 1:
            g, g_v0 = torch.autograd.grad(loss, (theta, v0), allow_unused=True)
            grads1 = {"albedo": check.norm(g), "v0": check.norm(g_v0)}
        else:
            (g,) = torch.autograd.grad(loss, (theta,))
        losses.append(float(loss))
        with torch.no_grad():
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            m_hat, v_hat = m / (1 - b1 ** k), v / (1 - b2 ** k)
            theta -= lr * m_hat / (v_hat.sqrt() + eps)
    median = statistics.median(grads1.values())
    nought = {k for k, n in grads1.items() if n < NOUGHT * median}
    got = record["grads1"]
    numbers = {
        "diverged_px_share": diverged / (2 * h * w),
        "loss_gap": max(check.gap(p, r) for p, r in zip(record["losses"], losses)),
        "grad_gap": max(check.gap(got[k], grads1[k], median) for k in grads1 if k not in nought),
        "nought_leaf_grad": max((got[k] / max(median, 1e-30) for k in nought), default=0.0),
        "change_gap": check.gap(check.norm(record["theta_checked"] - record["theta0"]),
                                check.norm(theta.detach() - theta0)),
    }
    return numbers, stats


FAULTS = {"unchanged_state": faults.unchanged_state, "half_batch": faults.half_batch,
          "altered_answer": faults.altered_answer, "stray_gradient": faults.stray_gradient}
