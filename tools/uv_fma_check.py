"""Settle the pixels of the config 8 stand-in (16x16, spp 1) where the
port's CPU render and the JAX package's differ by more than the image bar's
3e-2: is it XLA's fused multiply-add in the UV interpolation of
``resolve_hits``?

    python3 tools/uv_fma_check.py

Runs on the CPU, both packages. Prints:
1. the pixels where the two renders differ by more than 3e-2;
2. on the camera rays' hits, the UV ``w*uv0 + u*uv1 + v*uv2`` of the JAX
   package's jitted ``resolve_hits`` against four ways of forming it from
   the same (u, v): plain products and sums, and three FMA chains
   (emulated in float64, one rounding per FMA), with the share of lanes each
   matches to the bit;
3. the port's render again with its UV formed as each chain, and the pixels
   that still differ from JAX's render by more than 3e-2;
4. the camera rays: the share of lanes whose direction equals the JAX
   package's jitted ``generate_rays_for_pixels`` to the bit, and at each
   pixel of 1. the UV of the hit and the checker cell floor(UV·scale) on
   both sides (each from its own camera ray).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gpupathtracer_tpu.models.camera import Camera as JCamera  # noqa: E402
from gpupathtracer_tpu.models.camera import generate_rays as j_rays  # noqa: E402
from gpupathtracer_tpu.models.camera import generate_rays_for_pixels as j_rays_for_pixels  # noqa: E402
from gpupathtracer_tpu.ops.intersect import intersect_brute as j_brute  # noqa: E402
from gpupathtracer_tpu.ops.intersect import resolve_hits as j_resolve  # noqa: E402
from gpupathtracer_tpu.render.renderer import render_frame as j_render  # noqa: E402
from gpupathtracer_tpu.utils.config import load_scene_file as j_load  # noqa: E402
from gpupathtracer_tpu_torch.models.camera import generate_rays as t_rays  # noqa: E402
from gpupathtracer_tpu_torch.ops.intersect import resolve_hits as t_resolve  # noqa: E402
from gpupathtracer_tpu_torch.render import integrator  # noqa: E402
from gpupathtracer_tpu_torch.render.renderer import render_frame  # noqa: E402
from gpupathtracer_tpu_torch.utils.config import load_scene_file as t_load  # noqa: E402

SCENE = os.path.join(ROOT, "scenes", "config8_icosphere.toml")
SIZE = 16
OFF = 3e-2  # the image bar's per-pixel threshold


def fma(a, b, c):
    """float32 fma(a, b, c) = round(a*b + c): the float32 product is exact
    in float64, so one float64 add and one rounding to float32."""
    return (a.double() * b.double() + c.double()).float()


CHAINS = {
    "plain": lambda w, u, v, a, b, c: w * a + u * b + v * c,
    "fma(v,c, fma(u,b, w*a))": lambda w, u, v, a, b, c: fma(v, c, fma(u, b, w * a)),
    "fma(v,c, fma(w,a, u*b))": lambda w, u, v, a, b, c: fma(v, c, fma(w, a, u * b)),
    "fma(v,c, w*a + u*b)": lambda w, u, v, a, b, c: fma(v, c, w * a + u * b),
}


def main() -> None:
    js, jc, jst = j_load(SCENE)
    ts, tc, tst = t_load(SCENE, device="cpu")
    jc = JCamera.create(position=jc.position, yaw=jc.yaw, pitch=jc.pitch, fov_deg=jc.fov_deg, width=SIZE, height=SIZE)
    tc = dataclasses.replace(tc, width=SIZE, height=SIZE)
    jst = dataclasses.replace(jst, width=SIZE, height=SIZE, spp=1, intersector="pallas")
    tst = dataclasses.replace(tst, width=SIZE, height=SIZE, spp=1)
    want = np.asarray(j_render(js, jc, jst))
    got = render_frame(ts, tc, tst, device="cpu").numpy()
    # NEE's light sums differ in the last bits on most pixels; a flipped
    # checker cell moves a pixel by far more.
    differ = lambda img: [list(map(int, p)) for p in np.argwhere(np.abs(img - want).max(-1) > OFF)]
    off = differ(got)
    print(f"pixels (row, col) off by > {OFF}, port vs JAX:", json.dumps(off))

    # The camera rays' hits, and the UV of JAX's jitted resolve_hits.
    o, d = j_rays(jc)
    tri = j_brute(o, d, js, tri_block=128).tri
    attrs = jax.jit(lambda o, d, tri: j_resolve(o, d, js, tri, need_sn=False, need_uv=True))(o, d, tri)
    hit = np.asarray(tri) >= 0
    u, v = (torch.from_numpy(np.asarray(attrs.bary[:, i])) for i in (0, 1))
    w = 1.0 - u - v
    idx = np.maximum(np.asarray(tri), 0)
    rows = [torch.from_numpy(np.asarray(x)[idx]) for x in (js.uv0, js.uv1, js.uv2)]
    jax_uv = torch.from_numpy(np.asarray(attrs.uv))
    print(f"camera-ray hits: {int(hit.sum())} of {hit.size}")
    for name, chain in CHAINS.items():
        uv = chain(w[:, None], u[:, None], v[:, None], *rows)
        same = (uv == jax_uv).all(dim=-1).numpy()[hit].mean()
        print(f"  UV as {name}: equals JAX's jitted UV on {same:.4f} of the hit lanes")

    # The port's render with its UV formed as each chain.
    resolve = integrator.resolve_hits

    def with_chain(chain):
        def patched(o, d, scene, tri, need_sn=True, need_uv=True):
            a = resolve(o, d, scene, tri, need_sn=need_sn, need_uv=need_uv)
            if not need_uv:
                return a
            k = tri.clamp(min=0)
            u, v = a.bary[:, 0:1], a.bary[:, 1:2]
            uv = chain(1.0 - u - v, u, v, *(x.index_select(0, k) for x in (scene.uv0, scene.uv1, scene.uv2)))
            return dataclasses.replace(a, uv=uv)

        return patched

    for name, chain in CHAINS.items():
        integrator.resolve_hits = with_chain(chain)
        try:
            img = render_frame(ts, tc, tst, device="cpu").numpy()
        finally:
            integrator.resolve_hits = resolve
        print(f"  port render with UV as {name}: pixels off by > {OFF} from JAX: {json.dumps(differ(img))}")

    # The camera rays of each package (the JAX ones as its jitted frame
    # makes them), and the UV each side's own ray hits at the pixels of 1.
    jd = np.asarray(jax.jit(lambda c: j_rays_for_pixels(c, jnp.arange(SIZE * SIZE, dtype=jnp.uint32)))(jc)[1])
    to, td = t_rays(tc)
    print(f"camera-ray directions equal to JAX's jitted ones on {(td.numpy() == jd).all(-1).mean():.4f} of the "
          f"lanes; max |diff| {np.abs(td.numpy() - jd).max():.3e}")
    t_tri = torch.from_numpy(np.asarray(j_brute(jnp.asarray(to.numpy()), jnp.asarray(td.numpy()), js,
                                                tri_block=128).tri)).long()
    t_uv = t_resolve(to, td, ts, t_tri, need_sn=False, need_uv=True).uv
    j_tri = j_brute(o, jnp.asarray(jd), js, tri_block=128).tri
    j_uv = np.asarray(jax.jit(lambda o, d, tri: j_resolve(o, d, js, tri, need_sn=False, need_uv=True).uv)(
        o, jnp.asarray(jd), j_tri))
    for r, c in off:
        i = r * SIZE + c
        scale = float(ts.materials.checker_scale[ts.mat_id[t_tri[i]]])
        print(f"  pixel ({r}, {c}): UV port {t_uv[i].tolist()} (cell {np.floor(t_uv[i].numpy() * scale).tolist()}), "
              f"JAX {j_uv[i].tolist()} (cell {np.floor(j_uv[i] * scale).tolist()}), checker scale {scale}")


if __name__ == "__main__":
    main()
