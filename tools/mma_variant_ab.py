"""Times the tensor-core route against variants built from a patched copy
of csrc/, on one card, at the main paths' shapes:

- closest: K1 and K3 at "high" and "mixed" against "separate", the three
  products of a split scalar in separate accumulators, folded as
  hh + (hl + lh) in f32 (the JAX package's grouping in `_dot_high`), where
  the kernels chain them through the tensor cores' accumulator, small
  products first;
- anyhit: K2 and K4 at "high", "mixed" and "default" against
  "ntile_vote", which votes after every n-tile (whether the warp still has
  an open ray, then the quads' ORs) where the kernels vote once per chunk,
  and against "stages4" and "stages5", rings of 4 and 5 chunk stages where
  the kernels have 3.

    python3 tools/mma_variant_ab.py [closest|anyhit]   (both by default)

Inputs as chip_smoke.py's phases 3, 6, 9 and 11 build them (the config 3
stand-in's camera and bounce-1 rays at tb 128 and 512 for K1, the config 6
stand-in's at tb 256 and 1024 for K3, the bounce-1 NEE shadow rays of the
config 8 stand-in for K2 and of the config 6 stand-in for K4). For each
kernel, input and mode it runs the sides in the order kernels, variant,
variant, kernels and prints one JSON line a run: the median ms of 5, and
against the plain version at that mode the share of rays on the same
triangle, the largest |dt| and |dt| / t where it agrees (closest hits) or
the share of equal flags (any hits). Prints the card's name and power
limit first, each side's ptxas registers, and a JSON summary (the median
ms of each side) last.
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
CHUNK_VOTE = """  bool open = false;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) open |= !occ[m][h] && mt[m][h] > 0.0f;
  }
  if (!__any_sync(0xffffffffu, open)) return;
  bool hit[MT][2] = {};
  for (int nt = g; 8 * nt < cw; nt += groups) {
    float s[MT][NS][4];"""
NTILE_VOTE = """  for (int nt = g; 8 * nt < cw; nt += groups) {
    bool open = false;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) open |= !occ[m][h] && mt[m][h] > 0.0f;
    }
    if (!__any_sync(0xffffffffu, open)) break;
    bool hit[MT][2] = {};
    float s[MT][NS][4];"""
CHUNK_OR = """          hit[m][h] |= in && blocks_ray(s[m][0][e], s[m][1][e], s[m][2][e], s[m][3][e], s[m][4][e], mt[m][h]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {"""
NTILE_OR = """          hit[m][h] |= in && blocks_ray(s[m][0][e], s[m][1][e], s[m][2][e], s[m][3][e], s[m][4][e], mt[m][h]);
        }
      }
    }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {"""
CHUNK_END = """      occ[m][h] |= (quad & 0xfu) && mt[m][h] > 0.0f;
    }
  }
}"""
NTILE_END = """      occ[m][h] |= (quad & 0xfu) && mt[m][h] > 0.0f;
    }
  }
  }
}"""
CLOSEST = ("closest_hit", "closest_hit_streamed")
ANYHIT = ("occlusion", "occlusion_streamed")
# Variant -> (the libraries it changes, its patches of stream_stage.cuh).
STAGES = "constexpr int STAGES = 3;"
VARIANTS = {"separate": (CLOSEST, [(CHAIN, SEPARATE)]),
            "ntile_vote": (ANYHIT, [(CHUNK_VOTE, NTILE_VOTE), (CHUNK_OR, NTILE_OR), (CHUNK_END, NTILE_END)]),
            "stages4": (ANYHIT, [(STAGES, STAGES.replace("3", "4"))]),
            "stages5": (ANYHIT, [(STAGES, STAGES.replace("3", "5"))])}
MODES = ("high", "mixed")
ANYHIT_MODES = ("high", "mixed", "default")


def build_variant(name: str, libs, patches) -> dict:
    """The libraries ``libs`` built from a copy of csrc/ with ``patches``
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
        loaded_libs = {}
        for lib in libs:
            so = os.path.join(out, f"lib{lib}.so")
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
                                   os.path.join(out, "csrc", f"{lib}.cu")], capture_output=True, text=True, check=True)
            mma = {e: u for e, u in cs.ptxas_usage(proc.stderr).items() if "_mma_kernel" in e}
            print(f"variant {name} {lib}: {json.dumps(mma)}", flush=True)
            loaded = ctypes.CDLL(so)
            getattr(loaded, f"{lib}_launch").argtypes = _build.LAUNCHES[lib][f"{lib}_launch"]
            getattr(loaded, f"{lib}_error_string").restype = ctypes.c_char_p
            loaded_libs[lib] = loaded
        return loaded_libs
    finally:
        shutil.rmtree(out)  # the loaded libraries stay mapped


def compare(label: str, kernel, plain, args, packed, variant: str, libs: dict, times: dict) -> None:
    """The kernels against ``variant`` (its loaded ``libs``) on ``args``; a
    closest hit with its ``packed``, an any hit with None."""
    device = args[0].device
    real = _build.library
    tri = lambda bi: torch.where(bi >= 0, packed.tri_map[bi.long().clamp(min=0)], -1)
    for mode in MODES if packed is not None else ANYHIT_MODES:
        want = plain(*args, precision=mode)
        for side in ("kernels", variant, variant, "kernels"):
            if side == variant:
                _build.library = lambda name: libs[name] if name in libs else real(name)
            try:
                got = kernel(*args, precision=mode)
                ms = cs.median_ms(lambda: kernel(*args, precision=mode), device)
            finally:
                _build.library = real
            row = {"kernel": label, "precision": mode, "side": side, "ms": ms}
            if packed is None:
                row["same_flag"] = (got == want).double().mean().item()
            else:
                (bt, bi), (bt_r, bi_r) = got, want
                agree = tri(bi) == tri(bi_r)
                same = agree & (bi_r >= 0)
                dt = (bt[same] - bt_r[same]).abs()
                row.update(same_tri=agree.double().mean().item(), max_abs_dt=dt.max().item(),
                           max_rel_dt=(dt / bt_r[same].abs()).max().item())
            print(json.dumps(row), flush=True)
            times.setdefault(f"{label} {mode}", {}).setdefault(side if side == variant else f"kernels ({variant})",
                                                               []).append(ms)


def main() -> None:
    which = sys.argv[1:] or ["closest", "anyhit"]
    if any(w not in ("closest", "anyhit") for w in which):
        raise SystemExit(f"usage: {sys.argv[0]} [closest|anyhit]")
    cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    names = [n for n, (libs, _) in VARIANTS.items() if ("closest" if libs is CLOSEST else "anyhit") in which]
    libs = sorted({lib for n in names for lib in VARIANTS[n][0]})
    reports = _build.build(libs)
    for lib in libs:
        _build.library(lib)
        mma = {e: u for e, u in cs.ptxas_usage(reports[lib]).items() if "_mma_kernel" in e}
        print(f"kernels {lib}: {json.dumps(mma)}", flush=True)
    variants = {n: build_variant(n, *VARIANTS[n]) for n in names}
    times: dict = {}
    if "closest" in which:
        scene, camera, settings = load_scene_file(cs.SCENE, device=device)
        settings = dataclasses.replace(settings, spp=4)
        p1, p2 = (tpi.pack_scene(scene, tri_block=tb) for tb in (settings.tri_block, settings.tri_block_secondary))
        (o, d), (o2, d2) = cs.main_path_rays(scene, camera, settings, p1)
        for label, oo, dd, p in (("K1 camera", o, d, p1), ("K1 bounce-1", o2, d2, p2)):
            compare(label, tpi.closest_hit, tpi.closest_hit_reference,
                    tpi.prepare_rays(oo, dd, p) + (p.w, tpi.DEFAULT_RAY_TILE), p, "separate", variants["separate"],
                    times)
        scene, camera, settings = load_scene_file(cs.STREAM_SCENE, device=device)
        settings = dataclasses.replace(settings, spp=2)
        p1, p2 = (tpi.pack_scene(scene, tri_block=tb) for tb in (settings.tri_block, settings.tri_block_secondary))
        (o, d), (o2, d2) = cs.main_path_rays(scene, camera, settings, p1)
        for label, oo, dd, p in (("K3 camera", o, d, p1), ("K3 bounce-1", o2, d2, p2)):
            compare(label, tpi.closest_hit_streamed, tpi.closest_hit_streamed_reference,
                    tpi.prepare_rays_streamed(oo, dd, p) + (tpi.STREAM_RAY_TILE,), p, "separate",
                    variants["separate"], times)
    if "anyhit" in which:
        anyhit = [n for n in names if VARIANTS[n][0] is ANYHIT]
        scene, camera, settings = load_scene_file(cs.NEE_SCENE, device=device)
        settings = dataclasses.replace(settings, spp=4)
        p1, p2 = (tpi.pack_scene(scene, tri_block=tb) for tb in (settings.tri_block, settings.tri_block_secondary))
        args = cs.nee_shadow_inputs(scene, camera, settings, p1, p2, "occluded_reference")
        for name in anyhit:
            compare("K2 shadow", tpi.occluded, tpi.occluded_reference, args, None, name, variants[name], times)
        scene, camera, settings = load_scene_file(cs.STREAM_SCENE, device=device)
        nee = dataclasses.replace(settings, spp=2, estimator="nee")
        p1, p2 = (tpi.pack_scene(scene, tri_block=tb) for tb in (nee.tri_block, nee.tri_block_secondary))
        args = cs.nee_shadow_inputs(scene, camera, nee, p1, p2, "occluded_streamed_reference")
        for name in anyhit:
            compare("K4 shadow", tpi.occluded_streamed, tpi.occluded_streamed_reference, args, None, name,
                    variants[name], times)
    print(json.dumps({k: {side: statistics.median(v) for side, v in sides.items()} for k, sides in times.items()}),
          flush=True)


if __name__ == "__main__":
    main()
