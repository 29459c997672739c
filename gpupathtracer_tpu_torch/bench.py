"""Rays/s harness of the port: ``python -m gpupathtracer_tpu_torch.bench``.

Counterpart of ``gpupathtracer_tpu/bench.py``. ``main`` runs everything
below, prints one compact JSON line last (``metric``, ``value``, ``unit``,
``vs_baseline``, ``config``, ``fwd_bwd_rays_per_sec``, ``detail``) and
writes the whole result to ``BENCH_DETAIL_torch.json`` at the root of the
checkout. The CLI's ``benchmark`` verb runs the headline and the spec-spp
frame (``--full``: everything) and prints the whole result as its last
line, with no detail file, as the JAX package's verb does:

- the headline: forward rays/s of config 3 (``config3_wahoo.toml`` where
  ``utils/config.py`` finds its mesh, else the stand-in
  ``scenes/config3_icosphere.toml``, named in ``config``), and the
  forward+backward rays/s of the bench loss, mean(image) in ``v0`` and the
  material albedo, followed by the JAX package's precision ladder: the
  forward rows ``fwd_exact_precision`` (``kernel_precision="highest"``) and
  ``fwd_high_precision`` ("high");
- ``configs``: forward and forward+backward rays/s for every config of the
  JAX package's suite and the three stand-ins ``config{3,6,8}_icosphere``;
  a config whose mesh is absent gets an ``{"error": ...}`` entry;
- ``kernel``: K1 on 640,000 coherent camera rays, 640,000 incoherent rays,
  and the incoherent rays behind the origin-key sort, as ray-triangle tests
  a second (``kernel_inputs`` makes the pack and the rays), each at
  "highest" and, as the JAX package's ``mixed_*`` keys, at "mixed";
- ``full_spp``: one frame at the config's own spp, summed over 32-sample
  chunks of ``render_samples``.

Timing: a warm-up, then the median of ``iters`` calls, each with its own
seed and ending in a scalar read on the host (which waits for the card).
Rays = W·H·spp·bounces path segments; NEE shadow rays are not counted.
``vs_baseline`` divides by ``BASELINE_RAYS_PER_SEC``, a number of the
port's own on the card (``baseline`` in the result says which).

Budgets, as the JAX harness's: ``FIREFLY_BENCH_BUDGET_S`` (default 2400 s)
is checked before every row after the headline, and a row past it is
recorded as skipped; ``FIREFLY_SKIP_SPEC_SPP=1`` skips the spec-spp rows.
The compact line is printed as soon as the headline is measured and again,
complete, at the end.

Runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

from gpupathtracer_tpu_torch.core.tensors import resolve_device
from gpupathtracer_tpu_torch.models.camera import Camera, generate_rays
from gpupathtracer_tpu_torch.models.scene import build_scene, sphere_spec
from gpupathtracer_tpu_torch.ops import packed_intersect
from gpupathtracer_tpu_torch.ops.plucker import K, NSCALARS
from gpupathtracer_tpu_torch.render.renderer import render_frame, render_samples
from gpupathtracer_tpu_torch.utils.config import load_config, load_scene_file, parse_config
from gpupathtracer_tpu_torch.utils.metrics import log_runtime_event

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "scenes")

# main() nulls the compact line's "detail" when this write fails, so that an
# older file is never read as this run's.
DETAIL_PATH = os.path.join(ROOT, "BENCH_DETAIL_torch.json")

# The port's first naive frame on the card, before K1's redesign: the
# config 3 stand-in at 800x800, spp 4, 4 bounces in 0.116 s (ROADMAP.md,
# "Recent", the entry of PRs 1-3; CHANGES.md, PR 1).
BASELINE_RAYS_PER_SEC = 88.4e6
BASELINE = {
    "rays_per_sec": BASELINE_RAYS_PER_SEC,
    "what": "forward rays/s of the port's first naive frame: config3_icosphere.toml, 800x800, spp 4, "
            "4 bounces, K1 before its redesign",
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    "source": "ROADMAP.md, section Recent, the entry of PRs 1-3; CHANGES.md, PR 1",
}

# (config file, bench spp): the JAX package's suite, then the stand-ins.
CONFIG_SUITE = [
    ("config1_triangle.toml", 16),
    ("config2_cornell.toml", 4),
    ("config3_wahoo.toml", 4),
    ("config4_occlusion.toml", 4),
    ("config5_invert_target.toml", 8),
    ("config6_bigscene.toml", 2),
    ("config7_hugescene.toml", 1),
    ("config8_textured.toml", 4),
    ("config3_icosphere.toml", 4),
    ("config6_icosphere.toml", 2),
    ("config8_icosphere.toml", 4),
]

# The precision ladder that follows the fwd+bwd row, as the JAX package's:
# (result key, kernel_precision) of each forward row.
PRECISION_LADDER = (("fwd_exact_precision", "highest"), ("fwd_high_precision", "high"))

# Configs whose own spp gets one full run (besides the headline's).
SPEC_SPP_SUITE = ["config2_cornell.toml", "config4_occlusion.toml"]


def headline_scene() -> str:
    """``scenes/config3_wahoo.toml`` when the config loader finds its mesh,
    else the stand-in ``scenes/config3_icosphere.toml``."""
    path = os.path.join(SCENES, "config3_wahoo.toml")
    try:
        parse_config(load_config(path), SCENES)
    except FileNotFoundError:
        return os.path.join(SCENES, "config3_icosphere.toml")
    return path


def _timed(step, iters: int, warmup: int = 1):
    """``(median seconds of iters calls, seconds of the warm-up calls)``."""
    t0 = time.perf_counter()
    for i in range(max(warmup, 1)):
        step(i)
    warmup_s = time.perf_counter() - t0
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        step(100 + i)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), warmup_s


def _rays(settings) -> int:
    return settings.width * settings.height * settings.spp * settings.bounces


def _bench_frame(scene, camera, settings, iters: int, warmup: int = 1, device="cuda") -> dict:
    """Forward rays/s of ``render_frame``."""

    def step(i):
        return float(render_frame(scene, camera, settings, seed=1000 + i, device=device).sum())

    dt, warmup_s = _timed(step, iters, warmup)
    return {
        "rays_per_sec": _rays(settings) / dt,
        "median_s": dt,
        "warmup_s": warmup_s,
        "spp": settings.spp,
        "bounces": settings.bounces,
        "resolution": [settings.width, settings.height],
    }


def bench_leaves(scene):
    """The scene with ``v0`` and the material albedo as fresh leaves that
    require a gradient: ``(scene, (v0, albedo))``."""
    v0 = scene.v0.detach().clone().requires_grad_()
    albedo = scene.materials.albedo.detach().clone().requires_grad_()
    leaf = dataclasses.replace(scene, v0=v0, materials=dataclasses.replace(scene.materials, albedo=albedo))
    return leaf, (v0, albedo)


def bench_loss_grads(scene, leaves, camera, settings, seed=None, device="cuda"):
    """The bench's loss, mean(image), and its gradients in ``leaves`` (from
    ``bench_leaves``); zeros where no gradient reaches (the naive
    estimator's ``v0``)."""
    loss = render_frame(scene, camera, settings, seed=seed, device=device).mean()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]


def _bench_backward(scene, camera, settings, iters: int, warmup: int = 1, device="cuda") -> dict:
    """Forward+backward rays/s: the gradient of mean(image) in ``v0`` and
    the albedo through the whole estimator, at the forward bench's spp."""
    leaf, leaves = bench_leaves(scene)

    def step(i):
        _, (g_v0, g_albedo) = bench_loss_grads(leaf, leaves, camera, settings, seed=i, device=device)
        return float(g_v0.reshape(-1)[0] + g_albedo.reshape(-1)[0])

    dt, warmup_s = _timed(step, iters, warmup)
    return {"rays_per_sec": _rays(settings) / dt, "median_s": dt, "warmup_s": warmup_s, "spp": settings.spp}


def kernel_inputs(device="cuda"):
    """The inputs of ``_bench_kernel``: ``(packed, (o_c, d_c), (o_i, d_i))``.
    The pack is the config 3 stand-in's mesh (a radius-2 icosphere at
    subdivision 4) at tri_block 128; the coherent rays are an 800x800
    camera's; the incoherent rays, as many, have origins uniform in
    [-6, 6]^3 and directions uniform on the sphere, from seed 0."""
    device = resolve_device(device)
    scene = build_scene([sphere_spec((0.0, 0.0, 0.0), 2.0, subdivisions=4)], [{"type": "diffuse"}],
                        pad_to_multiple=512, device=device)
    packed = packed_intersect.pack_scene(scene, tri_block=128)
    cam = Camera.create(position=(0.0, 1.0, 12.0), fov_deg=50.0, width=800, height=800, device=device)
    o_c, d_c = generate_rays(cam)
    r = o_c.shape[0]
    rng = np.random.default_rng(0)
    o_i = torch.as_tensor(rng.uniform(-6, 6, (r, 3)), dtype=torch.float32, device=device)
    di = rng.normal(size=(r, 3)).astype(np.float32)
    d_i = torch.as_tensor(di / np.linalg.norm(di, axis=1, keepdims=True), device=device)
    return packed, (o_c, d_c), (o_i, d_i)


def _bench_kernel(iters: int = 3, device="cuda") -> dict:
    """K1 on ``kernel_inputs``: the coherent rays, the incoherent rays, and
    the incoherent rays behind the origin-key sort, at "highest" and (the
    ``mixed_*`` keys, as the JAX package's) at "mixed". Tests/s count every
    (ray, packed row) pair, as if no block were culled.
    ``dense_tflops_incoherent`` is the FLOP of that dense product over
    the incoherent call's time: the kernel skips the culled blocks and the
    pack's zero slots, so it is a dense-equivalent rate and not a share of
    any peak."""
    packed, (o_c, d_c), (o_i, d_i) = kernel_inputs(device)
    search = partial(packed_intersect.intersect_packed, packed=packed)
    mixed = partial(search, precision="mixed")

    def timed(fn, o, d):
        return _timed(lambda i: float(fn(o + i * 1e-6, d).t[::4096].sum()), iters)[0]

    def sorted_ms(precision):
        fn = packed_intersect.make_sorted_intersect(search, packed, key_mode="origin", precision=precision)
        return timed(fn, o_i, d_i) * 1e3

    dt_c = timed(search, o_c, d_c)
    dt_i = timed(search, o_i, d_i)
    dt_cm = timed(mixed, o_c, d_c)
    dt_im = timed(mixed, o_i, d_i)
    n_rows = packed.w.shape[0] * packed.tri_block
    tests = o_c.shape[0] * n_rows
    return {
        "scene_rows": n_rows,
        "coherent_tests_per_s": tests / dt_c,
        "incoherent_tests_per_s": tests / dt_i,
        "coherent_ms": dt_c * 1e3,
        "incoherent_ms": dt_i * 1e3,
        "mixed_coherent_ms": dt_cm * 1e3,
        "mixed_incoherent_ms": dt_im * 1e3,
        "mixed_coherent_tests_per_s": tests / dt_cm,
        "mixed_incoherent_tests_per_s": tests / dt_im,
        "incoherent_sorted_ms": sorted_ms("highest"),
        "mixed_incoherent_sorted_ms": sorted_ms("mixed"),
        "dense_tflops_incoherent": 2.0 * tests * K * NSCALARS / dt_i / 1e12,
    }


def _bench_full_spp(scene, camera, settings, spec_spp: int, chunk: int = 32, device="cuda") -> dict:
    """One frame at the config's own spp, summed over ``chunk``-sample
    ``render_samples`` calls: one chunk as the warm-up, then one timed pass
    (minutes at 1,024 spp, so no median)."""
    full = dataclasses.replace(settings, spp=spec_spp)

    def chunk_sum(s0, n, seed):
        return float(render_samples(scene, camera, full, s0, n, seed=seed, device=device).sum())

    t0 = time.perf_counter()
    chunk_sum(0, min(chunk, spec_spp), 500)
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for s0 in range(0, spec_spp, chunk):
        chunk_sum(s0, min(chunk, spec_spp - s0), 501)
    dt = time.perf_counter() - t0
    return {"rays_per_sec": _rays(full) / dt, "median_s": dt, "warmup_s": warmup_s, "spp": spec_spp,
            "chunked": chunk}


def _card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device's name where nvidia-smi cannot be run."""
    if device.type != "cuda":
        return str(device)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def _error(e: Exception) -> dict:
    return {"error": f"{type(e).__name__}: {e}"[:200]}


def run_benchmark(
    scene_path: str | None = None,
    warmup: int = 1,
    iters: int = 3,
    spp: int = 4,
    backward: bool = True,
    full_suite: bool = True,
    device="cuda",
) -> dict:
    """The headline, then (``backward``) its fwd+bwd, then (``full_suite``)
    the suite and the kernel rows, then the spec-spp rows; see the module
    docstring. Prints the compact line of the headline as soon as it is
    measured."""
    device = resolve_device(device)
    t_start = time.perf_counter()
    budget_s = float(os.environ.get("FIREFLY_BENCH_BUDGET_S", "2400"))
    skip_spec = os.environ.get("FIREFLY_SKIP_SPEC_SPP") == "1"
    over_budget = lambda: time.perf_counter() - t_start > budget_s
    skipped = lambda: {"skipped": "bench budget exceeded"}
    row_iters = max(iters - 1, 1)

    scene_path = scene_path or headline_scene()
    scene, camera, settings = load_scene_file(scene_path, device=device)
    spec_spp = settings.spp
    settings = dataclasses.replace(settings, spp=spp)
    head = _bench_frame(scene, camera, settings, iters, warmup, device)
    result = {
        "metric": "rays_per_sec_chip_fwd",
        "value": head["rays_per_sec"],
        "unit": "rays/s",
        "vs_baseline": head["rays_per_sec"] / BASELINE_RAYS_PER_SEC,
        "config": os.path.basename(scene_path),
        "median_s": head["median_s"],
        "warmup_s": head["warmup_s"],
        "spp": settings.spp,
        "bounces": settings.bounces,
        "resolution": [settings.width, settings.height],
        "device": _card(device),
        "baseline": BASELINE,
    }
    print(json.dumps(compact(result, None)), flush=True)

    if backward:
        result["fwd_bwd"] = skipped() if over_budget() else _bench_backward(
            scene, camera, settings, iters, warmup, device)
        # The JAX package's precision ladder on the same frame ("auto" is
        # "highest" here; on a TPU the JAX package's headline is "mixed").
        for key, precision in PRECISION_LADDER:
            st = dataclasses.replace(settings, kernel_precision=precision)
            result[key] = skipped() if over_budget() else _bench_frame(scene, camera, st, iters, warmup, device)

    if full_suite:
        configs = {}
        for fname, cfg_spp in CONFIG_SUITE:
            path = os.path.join(SCENES, fname)
            if os.path.abspath(path) == os.path.abspath(scene_path):
                configs[fname] = {**head, "fwd_bwd": result.get("fwd_bwd")}
                continue
            if over_budget():
                configs[fname] = skipped()
                continue
            try:  # one config's failure (a missing mesh) must not end the suite
                sc, cam, st = load_scene_file(path, device=device)
                st = dataclasses.replace(st, spp=cfg_spp)
                entry = _bench_frame(sc, cam, st, row_iters, warmup, device)
                entry["fwd_bwd"] = _bench_backward(sc, cam, st, row_iters, warmup, device)
            except Exception as e:
                entry = _error(e)
            configs[fname] = entry
        result["configs"] = configs
        try:
            result["kernel"] = skipped() if over_budget() else _bench_kernel(row_iters, device)
        except Exception as e:
            result["kernel"] = _error(e)

    if spec_spp > spp and not skip_spec:
        try:
            result["full_spp"] = skipped() if over_budget() else _bench_full_spp(
                scene, camera, settings, spec_spp, device=device)
        except Exception as e:
            result["full_spp"] = _error(e)
    if full_suite and not skip_spec:
        for fname in SPEC_SPP_SUITE:
            path = os.path.join(SCENES, fname)
            if os.path.abspath(path) == os.path.abspath(scene_path):
                continue
            try:
                if over_budget():
                    entry = skipped()
                else:
                    sc, cam, st = load_scene_file(path, device=device)
                    if st.spp <= 4:
                        continue
                    entry = _bench_full_spp(sc, cam, st, st.spp, device=device)
            except Exception as e:
                entry = _error(e)
            result.setdefault("configs", {}).setdefault(fname, {})["full_spp"] = entry
    return result


def compact(result: dict, detail: str | None) -> dict:
    """The one line a caller parses: the headline's keys of the JAX harness."""
    return {
        "metric": result["metric"],
        "value": result["value"],
        "unit": result["unit"],
        "vs_baseline": result["vs_baseline"],
        "config": result.get("config"),
        "fwd_bwd_rays_per_sec": (result.get("fwd_bwd") or {}).get("rays_per_sec"),
        "detail": detail,
    }


def main() -> None:
    """Run the whole bench, write the result to ``DETAIL_PATH`` and print
    its compact line last; an unwritable path nulls ``detail`` and warns on
    stderr."""
    result = run_benchmark()
    detail = os.path.basename(DETAIL_PATH)
    try:
        with open(DETAIL_PATH, "w") as f:
            json.dump(result, f, indent=1)
    except OSError as e:
        print(f"warning: could not write {DETAIL_PATH}: {e}", file=sys.stderr)
        log_runtime_event({"event": "bench_detail_write_failed", "path": DETAIL_PATH, "error": str(e)})
        detail = None  # an existing detail file is not this run's
    print(json.dumps(compact(result, detail)), flush=True)


if __name__ == "__main__":
    main()
