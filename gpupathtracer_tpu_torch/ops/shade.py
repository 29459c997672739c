"""The naive shade step as one CUDA launch (``csrc/shade.cu``).

``naive_shade`` computes what ``render/integrator.py``'s shade step
computes for the naive estimator with the PCG sampler over diffuse and
emitter materials: the hit attributes of the winning rows, the background
and emitter terms, the oriented normal, the bounce's PCG fold and draws,
the cosine-weighted scatter, roulette and the next state's rays,
throughput, radiance and flags. On the card it is one launch in place of
the ops route's ~140 dispatched torch ops, with the same numbers (the
kernel's source says how). The integrator takes it only where no input
carries a gradient (``integrator.shade_route``); it has no backward.

The launch runs inside an op of the dispatcher (``firefly_shade::naive``,
CUDA tensors only), so that ``torch.profiler`` links the kernel to the
caller's ``render.shade`` span, as the PCG sampler's launches are linked
(``ops/sampling.py``). ``_build.launch_counts["shade"]`` counts launches.
"""

from __future__ import annotations

import torch

from gpupathtracer_tpu_torch.ops import _build

# The kernel's flags.
HAS_EMIT, HAS_DIFFUSE, SHADING_NORMALS, ROULETTE = 1, 2, 4, 8
_GEOMETRY = ("v0", "e1", "e2", "n0", "n1", "n2")


def _naive_launch(o, d, throughput, radiance, alive, tri, hit, keys, v0, e1, e2, n0, n1, n2, mat_id, mat_type,
                  albedo, emissive, intensity, bg_r: float, bg_g: float, bg_b: float, bounce: int, flags: int):
    r, dev = d.shape[0], d.device
    f32, i64, rows3 = torch.float32, torch.int64, (r, 3)
    if o.dtype != f32 or o.shape != rows3 or o.stride(1) != 1 or o.stride(0) not in (0, 3) or o.device != dev:
        raise ValueError(f"the shade kernel takes o as float32 (R, 3) on {dev} with rows 0 or 3 floats apart")
    normals = (n0, n1, n2) if flags & SHADING_NORMALS else (None, None, None)
    if flags & SHADING_NORMALS and any(x is None for x in normals):
        raise ValueError("the shade kernel takes n0, n1 and n2 with shading normals")
    m = mat_type.shape[0]
    geometry = [(x, what, f32, (None, 3)) for x, what in zip((v0, e1, e2, *normals), _GEOMETRY) if x is not None]
    for x, what, dtype, shape in ((d, "d", f32, rows3), (throughput, "throughput", f32, rows3),
                                  (radiance, "radiance", f32, rows3), (alive, "alive", torch.bool, (r,)),
                                  (hit, "hit", torch.bool, (r,)), (tri, "tri", i64, (r,)), (keys, "keys", i64, (r, 4)),
                                  *geometry, (mat_id, "mat_id", i64, (v0.shape[0],)),
                                  (mat_type, "the material types", i64, (None,)), (albedo, "the albedos", f32, (m, 3)),
                                  (emissive, "the emissive colors", f32, (m, 3)),
                                  (intensity, "the intensities", f32, (m,))):
        _build.check("the shade kernel", x, what, dtype, shape, dev, aligned=x is keys)
    out = [torch.empty(rows3, dtype=f32, device=dev) for _ in range(4)]
    out += [torch.empty((r,), dtype=torch.bool, device=dev) for _ in range(2)]
    out.append(torch.empty((r,), dtype=f32, device=dev))
    if r:
        _build.launch(_build.SHADE, "shade_naive_launch", dev, o, o.stride(0), d, throughput, radiance, alive, tri,
                      hit, keys, v0, e1, e2, *normals, mat_id, mat_type, albedo, emissive, intensity, *out, r, bg_r,
                      bg_g, bg_b, int(bounce) & 0xFFFFFFFF, flags)
    return tuple(out)


_OPS = torch.library.Library("firefly_shade", "DEF")
_OPS.define("naive(Tensor o, Tensor d, Tensor throughput, Tensor radiance, Tensor alive, Tensor tri, Tensor hit, "
            "Tensor keys, Tensor v0, Tensor e1, Tensor e2, Tensor? n0, Tensor? n1, Tensor? n2, Tensor mat_id, "
            "Tensor mat_type, Tensor albedo, Tensor emissive, Tensor intensity, float bg_r, float bg_g, "
            "float bg_b, int bounce, int flags) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
_OPS.impl("naive", _naive_launch, "CUDA")
_naive_kernel = torch.ops.firefly_shade.naive.default


def naive_shade(o, d, throughput, radiance, alive, hit, keys, scene, background, bounce: int, has_emit: bool,
                has_diffuse: bool, shading_normals: bool, roulette: bool):
    """One launch of the naive shade step over the R lanes of a bounce:
    ``(o, d, throughput, radiance, alive, prev_nee, prev_pdf)`` of the next
    state. ``hit`` is the bounce's ``Hit`` (its ``tri`` and ``hit``), ``keys``
    the lanes' PCG keys (int64 (R, 4)), ``background`` three floats.
    ``has_emit`` and ``has_diffuse`` say which of the two types the
    material set holds (a lane of any other type keeps its ray and
    throughput); ``roulette`` plays Russian roulette at this bounce.
    CUDA tensors only; raises on what the kernel does not take."""
    if o.stride(-1) != 1 or o.stride(0) not in (0, 3):
        o = o.contiguous()  # the kernel reads rows 3 floats apart, or the camera's one expanded row
    m = scene.materials
    flags = ((HAS_EMIT if has_emit else 0) | (HAS_DIFFUSE if has_diffuse else 0)
             | (SHADING_NORMALS if shading_normals else 0) | (ROULETTE if roulette else 0))
    n0, n1, n2 = (scene.n0, scene.n1, scene.n2) if shading_normals else (None, None, None)
    bg_r, bg_g, bg_b = (float(c) for c in background)
    return _naive_kernel(o, d.contiguous(), throughput.contiguous(), radiance.contiguous(), alive.contiguous(),
                         hit.tri.contiguous(), hit.hit.contiguous(), keys, scene.v0, scene.e1, scene.e2, n0, n1, n2,
                         scene.mat_id, m.type, m.albedo, m.emissive_color, m.intensity, bg_r, bg_g, bg_b, bounce,
                         flags)
