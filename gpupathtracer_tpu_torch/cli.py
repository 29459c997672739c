"""Command line of the PyTorch + CUDA port: render, benchmark, view, invert.

    python -m gpupathtracer_tpu_torch.cli [--device cuda|cpu] render SCENE --out x.ppm
    python -m gpupathtracer_tpu_torch.cli benchmark [--scene SCENE] [--full]
    python -m gpupathtracer_tpu_torch.cli view SCENE [--live] --out DIR
    python -m gpupathtracer_tpu_torch.cli invert --mode albedo

Counterpart of ``gpupathtracer_tpu/cli.py``. ``--device`` comes before the
verb and defaults to the card; without one the command raises instead of
running on the CPU. ``render`` writes a PPM or a PNG by the output's suffix
and takes the progressive path (``render/progressive.py``) with
``--checkpoint`` or ``--chunk-spp``. ``benchmark`` runs the rays/s bench
(``bench.py``): the headline and the spec-spp frame, with ``--full`` also
its fwd+bwd, the per-config suite and the kernel rows, and prints the whole
result as one JSON line, last (``python -m gpupathtracer_tpu_torch.bench``
writes the detail file and prints the compact line instead). ``view``
renders a turntable of PNG frames (``--gif`` also writes them as
``turntable.gif``, which needs PIL), or with ``--live`` runs the live
preview (``render/live.py``).
``invert --mode albedo`` runs the config 5 trainer; ``--mode silhouette``
and ``--mode camera`` run the edge-sampled demos (``grad/inverse.py``),
which recover an occluder's scale and the camera's pose from the boundary
term alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import torch


def _scene_and_settings(args, **overrides):
    from gpupathtracer_tpu_torch.utils.config import load_scene_file

    scene, camera, settings = load_scene_file(args.scene, device=args.device)
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return scene, camera, dataclasses.replace(settings, **overrides) if overrides else settings


def cmd_render(args) -> int:
    from gpupathtracer_tpu_torch.render import film
    from gpupathtracer_tpu_torch.render.renderer import render_frame
    from gpupathtracer_tpu_torch.utils.image import write_image
    from gpupathtracer_tpu_torch.utils.profiling import trace

    scene, camera, settings = _scene_and_settings(
        args, spp=args.spp, aov=args.aov, estimator=args.estimator, intersector=args.intersector
    )
    t0 = time.perf_counter()
    with trace(args.profile_dir):
        if args.checkpoint or args.chunk_spp:
            from gpupathtracer_tpu_torch.render.progressive import render_progressive

            img = render_progressive(
                scene, camera, settings, chunk_spp=args.chunk_spp or 16, checkpoint_path=args.checkpoint,
                metrics_path=args.metrics, device=args.device,
            )
        else:
            img = render_frame(scene, camera, settings, device=args.device)
        u8 = film.to_u8(img, gamma=args.gamma)  # waits for the card
    t1 = time.perf_counter()
    write_image(args.out, u8)
    radiance = settings.aov == "radiance"
    rays = settings.width * settings.height * (settings.spp * settings.bounces if radiance else 1)
    print(
        f"rendered {settings.width}x{settings.height} spp={settings.spp} bounces={settings.bounces} "
        f"on {args.device} in {t1 - t0:.3f}s ({rays / (t1 - t0) / 1e6:.1f} Mrays/s incl. setup) -> {args.out}"
    )
    return 0


def cmd_benchmark(args) -> int:
    from gpupathtracer_tpu_torch.bench import run_benchmark

    result = run_benchmark(scene_path=args.scene, warmup=args.warmup, iters=args.iters, backward=args.full,
                           full_suite=args.full, device=args.device)
    print(json.dumps(result))
    return 0


def cmd_view(args) -> int:
    """A turntable orbit written as PNG frames (with ``--gif`` also as
    ``turntable.gif``, 120 ms a frame, looping; PIL is imported only then),
    or with ``--live`` the live progressive preview driven by stdin commands
    (w/s/a/d/q/e, left/right/up/down, ``mouse dx dy``, r, quit)."""
    scene, camera, settings = _scene_and_settings(args, spp=args.spp)
    if args.live:
        from gpupathtracer_tpu_torch.render.live import live_view

        print(
            f"live preview -> {args.out}/live.png"
            + (f" (http://127.0.0.1:{args.http})" if args.http else "")
            + "; commands on stdin: w/s/a/d/q/e left/right/up/down 'mouse dx dy' r quit",
            flush=True,
        )
        _, spp_done = live_view(
            scene, camera, settings, args.out, chunk_spp=args.chunk_spp, max_spp=args.max_spp,
            http_port=args.http, gamma=args.gamma, device=args.device,
        )
        print(f"live view done ({spp_done} spp at exit)")
        return 0

    from gpupathtracer_tpu_torch.render import film
    from gpupathtracer_tpu_torch.render.renderer import render_frame
    from gpupathtracer_tpu_torch.utils.image import write_png

    os.makedirs(args.out, exist_ok=True)
    x0, y0, z0 = camera.position.tolist()
    # Orbit about the world-up axis through the origin at the camera's radius.
    radius = math.hypot(x0, z0)
    base_angle = math.atan2(z0, x0)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=camera.position.device)
    frames = []
    t0 = time.perf_counter()
    for i in range(args.frames):
        ang = base_angle + 2.0 * math.pi * i / args.frames
        cam = dataclasses.replace(
            camera,
            position=f32([radius * math.cos(ang), y0, radius * math.sin(ang)]),
            yaw=f32(math.degrees(ang) + 180.0),  # look back at the origin
        )
        frame_path = os.path.join(args.out, f"frame_{i:04d}.png")
        u8 = film.to_u8(render_frame(scene, cam, settings, device=args.device), gamma=args.gamma)
        write_png(frame_path, u8)
        frames.append(u8)
        print(f"frame {i + 1}/{args.frames} -> {frame_path}", flush=True)
    if args.gif:
        from PIL import Image

        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(
            os.path.join(args.out, "turntable.gif"),
            save_all=True, append_images=imgs[1:], duration=120, loop=0,
        )
    print(f"{args.frames} frames in {time.perf_counter() - t0:.1f}s -> {args.out}")
    return 0


def cmd_invert(args) -> int:
    from gpupathtracer_tpu_torch.grad.inverse import run_camera_demo, run_inverse_demo, run_silhouette_demo

    if args.mode in ("silhouette", "camera"):
        demo = run_silhouette_demo if args.mode == "silhouette" else run_camera_demo
        print(json.dumps(demo(steps=args.steps, out_dir=args.out, spp=args.spp, device=args.device)))
        return 0
    result = run_inverse_demo(
        steps=args.steps, out_dir=args.out, checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every, width=args.size, height=args.size, spp=args.spp,
        subdivisions=args.subdivisions, device=args.device,
    )
    print(json.dumps(result))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gpupathtracer_tpu_torch.cli", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda; cpu runs the plain versions)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene config to an image file")
    pr.add_argument("scene", help="scene config (.toml/.json)")
    pr.add_argument("--out", default="render.png", help="output image; .ppm writes a PPM, else a PNG")
    pr.add_argument("--spp", type=int, default=None)
    pr.add_argument("--aov", default=None, choices=["radiance", "normal", "normal_unit"])
    pr.add_argument("--gamma", type=float, default=None)
    pr.add_argument("--estimator", default=None, choices=["naive", "nee", "mis"])
    pr.add_argument("--intersector", default=None, choices=["auto", "pallas", "plucker", "brute"])
    pr.add_argument("--checkpoint", default=None, help="film checkpoint path (.npz); resumes if present")
    pr.add_argument("--chunk-spp", type=int, default=None, help="progressive chunk size")
    pr.add_argument("--metrics", default=None, help="JSONL metrics stream path")
    pr.add_argument("--profile-dir", default=None, help="torch.profiler Chrome trace output dir")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("benchmark", help="run the rays/sec benchmark")
    pb.add_argument("--scene", default=None, help="headline scene (default: config 3, or its stand-in)")
    pb.add_argument("--warmup", type=int, default=1)
    pb.add_argument("--iters", type=int, default=3)
    pb.add_argument("--full", action="store_true",
                    help="also run fwd+bwd, the per-config suite and the kernel microbenchmark")
    pb.set_defaults(fn=cmd_benchmark)

    pv = sub.add_parser("view", help="viewer: turntable orbit, or --live preview")
    pv.add_argument("scene")
    pv.add_argument("--out", default="turntable")
    pv.add_argument("--frames", type=int, default=12)
    pv.add_argument("--spp", type=int, default=None)
    pv.add_argument("--gamma", type=float, default=2.2)
    pv.add_argument("--gif", action="store_true", help="also write the frames as turntable.gif (needs PIL)")
    pv.add_argument("--live", action="store_true", help="progressive live preview")
    pv.add_argument("--http", type=int, default=None, help="serve the live page on this port")
    pv.add_argument("--chunk-spp", type=int, default=2, help="samples per refinement chunk")
    pv.add_argument("--max-spp", type=int, default=None, help="refinement cap per camera pose")
    pv.set_defaults(fn=cmd_view)

    pi = sub.add_parser("invert", help="inverse-rendering demo (config 5)")
    pi.add_argument(
        "--mode", default="albedo", choices=["albedo", "silhouette", "camera"],
        help="albedo = recover albedo and vertex offsets (detached gradients); silhouette = an occluder's "
        "scale, camera = the camera's x/z offset (edge-sampled boundary gradients)",
    )
    pi.add_argument("--steps", type=int, default=100)
    pi.add_argument("--out", default=None)
    pi.add_argument("--checkpoint", default=None, help="train-state checkpoint path (.pkl); resumes if present")
    pi.add_argument("--checkpoint-every", type=int, default=1)
    pi.add_argument("--size", type=int, default=96, help="square image size")
    pi.add_argument("--spp", type=int, default=8)
    pi.add_argument("--subdivisions", type=int, default=2)
    pi.set_defaults(fn=cmd_invert)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
