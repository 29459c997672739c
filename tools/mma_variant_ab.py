"""Times the closest hits' tensor-core route (K1 and K3 at "high" and
"mixed") against a variant built from a patched copy of csrc/, on one
card, at the main paths' shapes: "separate", the three products of a
split scalar in separate accumulators, folded as hh + (hl + lh) in f32
(the JAX package's grouping in `_dot_high`), where the kernels chain them
through the tensor cores' accumulator, small products first.

    python3 tools/mma_variant_ab.py

Inputs as chip_smoke.py's phases 3 and 9 build them (the config 3
stand-in's camera and bounce-1 rays at tb 128 and 512 for K1, the config 6
stand-in's at tb 256 and 1024 for K3). For each kernel, input and mode it
runs the sides in the order kernels, separate, separate, kernels and
prints one JSON line a run: the median ms of 5, and against the plain
version at that mode the share of rays on the same triangle, the largest
|dt| and |dt| / t where it agrees. Prints the card's name and power limit
first, each side's ptxas registers, and a JSON summary (the median ms of
each side) last.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from gpupathtracer_tpu_torch.ops import _build  # noqa: E402
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi  # noqa: E402
from gpupathtracer_tpu_torch.utils.config import load_scene_file  # noqa: E402

CHAIN = """        mma_bf16(s[m][sc], a.hi[m][win][0], a.hi[m][win][1], bl);
        mma_bf16_acc(s[m][sc], a.lo[m][win][0], a.lo[m][win][1], bh);
        mma_bf16_acc(s[m][sc], a.hi[m][win][0], a.hi[m][win][1], bh);"""
SEPARATE = """        float hh[4], hl[4], lh[4];
        mma_bf16(hh, a.hi[m][win][0], a.hi[m][win][1], bh);
        mma_bf16(hl, a.hi[m][win][0], a.hi[m][win][1], bl);
        mma_bf16(lh, a.lo[m][win][0], a.lo[m][win][1], bh);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[m][sc][e] = hh[e] + (hl[e] + lh[e]);"""
VARIANTS = {"separate": [(CHAIN, SEPARATE)]}
LIBS = ("closest_hit", "closest_hit_streamed")
ORDER = ("kernels", "separate", "separate", "kernels")
MODES = ("high", "mixed")


def build_variant(name: str, patches) -> dict:
    """K1's and K3's libraries built from a copy of csrc/ with ``patches``
    applied to stream_stage.cuh, loaded as _build.library loads them."""
    out = tempfile.mkdtemp(prefix=f"{name}_", dir=_build.BUILD_DIR)
    try:
        shutil.copytree(_build.CSRC, os.path.join(out, "csrc"))
        header = os.path.join(out, "csrc", "stream_stage.cuh")
        with open(header) as f:
            text = f.read()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"stream_stage.cuh no longer holds what variant {name} replaces: {old[:60]!r}")
            text = text.replace(old, new)
        with open(header, "w") as f:
            f.write(text)
        libs = {}
        for lib in LIBS:
            so = os.path.join(out, f"lib{lib}.so")
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
                                   os.path.join(out, "csrc", f"{lib}.cu")], capture_output=True, text=True, check=True)
            mma = {e: u for e, u in cs.ptxas_usage(proc.stderr).items() if "_mma_kernel" in e}
            print(f"variant {name} {lib}: {json.dumps(mma)}", flush=True)
            loaded = ctypes.CDLL(so)
            getattr(loaded, f"{lib}_launch").argtypes = _build.KERNELS[lib]
            getattr(loaded, f"{lib}_error_string").restype = ctypes.c_char_p
            libs[lib] = loaded
        return libs
    finally:
        shutil.rmtree(out)  # the loaded libraries stay mapped


def compare(label: str, kernel, plain, args, packed, variants: dict, times: dict) -> None:
    device = args[0].device
    real = _build.library
    tri = lambda bi: torch.where(bi >= 0, packed.tri_map[bi.long().clamp(min=0)], -1)
    for mode in MODES:
        bt_r, bi_r = plain(*args, precision=mode)
        for side in ORDER:
            if side in variants:
                _build.library = lambda name, side=side: variants[side][name] if name in LIBS else real(name)
            try:
                bt, bi = kernel(*args, precision=mode)
                ms = cs.median_ms(lambda: kernel(*args, precision=mode), device)
            finally:
                _build.library = real
            agree = tri(bi) == tri(bi_r)
            same = agree & (bi_r >= 0)
            dt = (bt[same] - bt_r[same]).abs()
            row = {"kernel": label, "precision": mode, "side": side, "ms": ms,
                   "same_tri": agree.double().mean().item(), "max_abs_dt": dt.max().item(),
                   "max_rel_dt": (dt / bt_r[same].abs()).max().item()}
            print(json.dumps(row), flush=True)
            times.setdefault(f"{label} {mode}", {}).setdefault(side, []).append(ms)


def main() -> None:
    cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    reports = _build.build(LIBS)
    for lib in LIBS:
        _build.library(lib)
        mma = {e: u for e, u in cs.ptxas_usage(reports[lib]).items() if "_mma_kernel" in e}
        print(f"kernels {lib}: {json.dumps(mma)}", flush=True)
    variants = {name: build_variant(name, patches) for name, patches in VARIANTS.items()}
    times: dict = {}
    scene, camera, settings = load_scene_file(cs.SCENE, device=device)
    settings = dataclasses.replace(settings, spp=4)
    p1, p2 = (tpi.pack_scene(scene, tri_block=tb) for tb in (settings.tri_block, settings.tri_block_secondary))
    (o, d), (o2, d2) = cs.main_path_rays(scene, camera, settings, p1)
    for label, oo, dd, p in (("K1 camera", o, d, p1), ("K1 bounce-1", o2, d2, p2)):
        compare(label, tpi.closest_hit, tpi.closest_hit_reference,
                tpi.prepare_rays(oo, dd, p) + (p.w, tpi.DEFAULT_RAY_TILE), p, variants, times)
    scene, camera, settings = load_scene_file(cs.STREAM_SCENE, device=device)
    settings = dataclasses.replace(settings, spp=2)
    p1, p2 = (tpi.pack_scene(scene, tri_block=tb) for tb in (settings.tri_block, settings.tri_block_secondary))
    (o, d), (o2, d2) = cs.main_path_rays(scene, camera, settings, p1)
    for label, oo, dd, p in (("K3 camera", o, d, p1), ("K3 bounce-1", o2, d2, p2)):
        compare(label, tpi.closest_hit_streamed, tpi.closest_hit_streamed_reference,
                tpi.prepare_rays_streamed(oo, dd, p) + (tpi.STREAM_RAY_TILE,), p, variants, times)
    print(json.dumps({k: {side: statistics.median(v) for side, v in sides.items()} for k, sides in times.items()}),
          flush=True)


if __name__ == "__main__":
    main()
