"""Holds the closest-hit kernels of two checkouts to the same bits on one
card: K1 (the config 3 stand-in) and K3 (the config 6 stand-in) at each
precision, on chip_smoke.py's main-path rays (sample 0's camera rays on the
first pack, its bounce-1 rays on the second), launched as an untraced frame
launches them (no test counter).

    python3 tools/kernel_parity_ab.py PARENT CHANGE

PARENT and CHANGE are checkouts (``tools/ab_smoke.py unpack``). Each side
runs in a process of its own from its checkout and saves its outputs (some
160 MB) in a temporary directory; the comparison prints one line a case
and exits non-zero unless best_t and best_i are bit-equal in every case.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

PRECISIONS = ("highest", "high", "mixed", "default")

_SIDE = r"""
import sys, torch
sys.path.insert(0, ".")
import chip_smoke
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.utils.config import load_scene_file
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for name, path in (("K1", chip_smoke.SCENE), ("K3", chip_smoke.STREAM_SCENE)):
    scene, camera, settings = load_scene_file(path, device="cuda")
    packs = [tpi.pack_scene(scene, tri_block=tb) for tb in (settings.tri_block, settings.tri_block_secondary)]
    streamed = tpi.route(packs[0].w.shape[0], packs[0].tri_block).streamed
    for i, ((o, d), pack) in enumerate(zip(chip_smoke.main_path_rays(scene, camera, settings, packs[0]), packs)):
        if streamed:
            args = tpi.prepare_rays_streamed(o, d, pack) + (tpi.STREAM_RAY_TILE,)
            kernel = tpi.closest_hit_streamed
        else:
            args = tpi.prepare_rays(o, d, pack) + (pack.w, tpi.DEFAULT_RAY_TILE)
            kernel = tpi.closest_hit
        for p in sys.argv[2].split(","):
            bt, bi = kernel(*args, precision=p)
            out[f"{name} rays {i} {p}"] = (bt.cpu(), bi.cpu())
torch.save(out, sys.argv[1])
"""


def main(argv) -> int:
    parent, change = (os.path.abspath(a) for a in argv[:2])
    import torch

    results = {}
    with tempfile.TemporaryDirectory() as out:
        for side, root in (("parent", parent), ("change", change)):
            path = os.path.join(out, f"{side}.pt")
            subprocess.run([sys.executable, "-c", _SIDE, path, ",".join(PRECISIONS)], cwd=root, check=True)
            results[side] = torch.load(path)
    ok = True
    for case, (bt, bi) in results["parent"].items():
        ct, ci = results["change"][case]
        same = torch.equal(bt.view(torch.int32), ct.view(torch.int32)) and torch.equal(bi, ci)
        ok &= same
        print(f"{case}: {'bit-equal' if same else 'DIFFERENT'} ({bt.numel()} lanes, {int((bi >= 0).sum())} hits)")
    print("all bit-equal" if ok else "outputs differ")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
