"""The operands and the arithmetic of the tensor-core route (K1-K4 at
"high", "mixed" and "default"; ``csrc/stream_stage.cuh``), on the CPU,
where the kernels cannot run.

The kernels stage ``_kernel_operands(w, precision)``: bf16(w) and
bf16(w - bf16(w)) as column windows of 8 feature rows per (block, scalar,
column), and multiply each window by the ray's features over the same rows
on ``mma.sync.m16n8k8``. Here: the windows equal ``split_bf16(w)`` element
by element; every live slot lies in its scalar's window and every other
window row is 0; the header's window table is the Python one; the split is
made once per pack and anew after an in-place edit; and the exact window
products, summed in float64, give ``_decision_scalars``' scalars at each
bf16 mode (and the JAX package's ``_decision_dot`` at "high" and "mixed")
within 2 ulps of the sum of |products|: the tensor cores sum the same
products as the plain version's f32 matmuls, in another order. The any
hits' epilogue, modelled in numpy on those products by the fragment
layout, covers every (ray, column) once and gives ``occluded_reference``'s
flags to the flag bar.
"""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_intersect import random_scene, to_port

from gpupathtracer_tpu.ops import pallas_intersect as jpi
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.ops.plucker import K, LIVE_SLOTS, NSCALARS, pack_rays

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "gpupathtracer_tpu_torch",
                      "csrc", "stream_stage.cuh")
BF16_MODES = ("high", "mixed", "default")
TB = 64
ULPS = 2


@pytest.fixture(scope="module")
def case():
    """A random scene's pack at tri_block 64 and 500 random rays' features."""
    js, o, d = random_scene(seed=31, pad=128, rays=500)
    packed = tpi.pack_scene(to_port(js), tri_block=TB)
    return packed, pack_rays(torch.as_tensor(o), torch.as_tensor(d))


def window_rows(s: int) -> range:
    return range(tpi.MMA_WINDOW_START[s], tpi.MMA_WINDOW_START[s] + tpi.MMA_WINDOW)


@pytest.mark.parametrize("mode", BF16_MODES)
def test_mma_operands_equal_split_bf16(case, mode):
    """At every (block, scalar, column, window row) the staged hi and lo
    are ``split_bf16(w)``'s value of that slot, as real bf16 tensors in the
    (nb, 5, tb, 8) layout; "default" stages hi only, and w itself comes
    first (HIGHEST and MIXED's D|num rows)."""
    packed, _ = case
    w = packed.w
    w_, hi, lo = tpi._kernel_operands(w, mode)
    nb, tb = w.shape[0], w.shape[2] // NSCALARS
    assert w_ is w
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.is_contiguous() and lo.is_contiguous()
    assert tuple(hi.shape) == tuple(lo.shape) == (nb, NSCALARS, tb, tpi.MMA_WINDOW)
    assert (lo is hi) == (mode == "default")
    want_hi, want_lo = tpi.split_bf16(w)
    for s in range(NSCALARS):
        for r, k in enumerate(window_rows(s)):
            cols = slice(s * tb, (s + 1) * tb)
            assert torch.equal(hi[:, s, :, r].float(), want_hi[:, k, cols]), (s, k)
            if mode != "default":
                assert torch.equal(lo[:, s, :, r].float(), want_lo[:, k, cols]), (s, k)
    assert lo.float().abs().sum() > 0 and hi.float().abs().sum() > 0


def test_live_slots_lie_in_their_windows(case):
    """Every LIVE_SLOTS entry lies in its scalar's window; every other row
    of a window is exactly 0 in the pack's windows (and, past feature row
    9, in the rays' features); and the header's window table, read as text,
    is the Python one."""
    packed, feats = case
    live = set(LIVE_SLOTS)
    for s, k in LIVE_SLOTS:
        assert k in window_rows(s), (s, k)
    windows = tpi.mma_windows(packed.w)
    for s in range(NSCALARS):
        for r, k in enumerate(window_rows(s)):
            if (s, k) not in live:
                assert not windows[:, s, :, r].any(), (s, k)
    assert windows.abs().sum() > 0
    assert not feats[:, 10:].any()
    with open(HEADER) as f:
        text = f.read()
    assert re.search(rf"constexpr int WIN = {tpi.MMA_WINDOW};", text)
    starts = re.search(r"constexpr int window_start\(int s\) \{ return s == 4 \? (\d+) : 0; \}", text)
    assert starts and tpi.MMA_WINDOW_START == (0, 0, 0, 0, int(starts.group(1)))


def test_mma_operands_are_split_once_per_pack(case):
    """One split serves all three modes and every search of a pack (the
    padded w of the streamed route included); an in-place edit of w makes
    it anew."""
    packed, _ = case
    tp = dataclasses.replace(packed, w=packed.w.clone())
    ops = {mode: tpi._kernel_operands(tp.w, mode) for mode in BF16_MODES}
    assert ops["high"][1] is ops["mixed"][1] is ops["default"][1] is ops["default"][2]
    assert ops["high"][2] is ops["mixed"][2]
    assert all(a is b for a, b in zip(ops["high"], tpi._kernel_operands(tp.w, "high")))
    assert tpi._kernel_operands(tp.w, "highest") == (tp.w, tp.w, tp.w)
    bpc = tp.w.shape[0] + 1
    padded = tpi._pad_blocks(tp, bpc).w
    first = tpi._kernel_operands(padded, "mixed")
    assert all(a is b for a, b in zip(first, tpi._kernel_operands(tpi._pad_blocks(tp, bpc).w, "mixed")))
    assert not first[1][-1].float().any() and not first[2][-1].float().any()
    tp.w.mul_(2.0)
    again = tpi._kernel_operands(tp.w, "high")
    assert again[1] is not ops["high"][1] and again[2] is not ops["high"][2]
    assert torch.equal(again[1].float(), 2 * ops["high"][1].float())
    edited = tpi._kernel_operands(tpi._pad_blocks(tp, bpc).w, "mixed")
    assert edited[1] is not first[1] and torch.equal(edited[1][:-1].float(), again[1].float())


def ray_windows(feats: torch.Tensor) -> dict:
    """The rays' A operand of the tensor-core route, as the kernels load it
    (RayFragments): per scalar, its window of feature rows, with rows past
    the window's live rows (6 and 7 of window 0, 10-13 of num's) set to 0;
    float64 of the f32 features, and their bf16 hi and lo."""
    hi, lo = tpi.split_bf16(feats)
    out = {}
    for name, x in (("f", feats), ("hi", hi), ("lo", lo)):
        wins = []
        for s in range(NSCALARS):
            k0 = tpi.MMA_WINDOW_START[s]
            win = x[:, k0 : k0 + tpi.MMA_WINDOW].double().clone()
            win[:, (6 if s < 4 else 10) - k0 :] = 0.0
            wins.append(win)
        out[name] = torch.stack(wins, 1)  # (R, 5, 8)
    return out


def window_sums(a: torch.Tensor, b: torch.Tensor):
    """(R, nb, 5, tb): sum over each window of a (R, 5, 8) times b
    (nb, 5, tb, 8), in float64 (each product exact), and the sum of
    |products|."""
    return (torch.einsum("rsk,bsck->rbsc", a, b.double()),
            torch.einsum("rsk,bsck->rbsc", a.abs(), b.double().abs()))


@pytest.mark.parametrize("mode", BF16_MODES)
def test_window_products_give_the_decision_scalars(case, mode):
    """The exact products of each window summed in float64 (the three
    chains of a split scalar, and "mixed"'s D and num from the f32 rows)
    give ``_decision_scalars``' scalars at ``mode`` within 2 ulps (float32)
    of the sum of |products| over all three chains; at "high" and "mixed"
    the JAX package's ``_decision_dot`` too."""
    packed, feats = case
    w = packed.w
    nb, tb = w.shape[0], w.shape[2] // NSCALARS
    _, whi, wlo = tpi._kernel_operands(w, mode)
    a = ray_windows(feats)
    hh, mag = window_sums(a["hi"], whi)
    if mode == "default":
        want = hh
    else:
        hl, mag_hl = window_sums(a["hi"], wlo)
        lh, mag_lh = window_sums(a["lo"], whi)
        want, mag = hh + (hl + lh), mag + mag_hl + mag_lh
    if mode == "mixed":
        exact, mag_exact = window_sums(a["f"], tpi.mma_windows(w))
        want[:, :, 3:], mag[:, :, 3:] = exact[:, :, 3:], mag_exact[:, :, 3:]
    blk = torch.arange(nb)
    got = torch.stack(tpi._decision_scalars(feats[None].expand(nb, -1, -1), w, blk, tb, mode), 2)
    got = got.permute(1, 0, 2, 3).double()  # (R, nb, 5, tb)
    ulp = torch.as_tensor(np.spacing(mag.numpy().astype(np.float32)).astype(np.float64))
    err = (got - want).abs()
    assert (err <= ULPS * ulp).all(), (err / ulp).max().item()
    assert mag.max() > 1.0 and (want != 0).double().mean() > 0.5
    if mode != "default":
        jw = jnp.asarray(w.numpy())
        jf = jnp.asarray(feats.numpy())
        js = np.stack([np.asarray(jpi._decision_dot(jf, jw[b], mode, tb)) for b in range(nb)], 1)
        js = torch.as_tensor(js.reshape(feats.shape[0], nb, NSCALARS, tb)).double()
        assert ((js - want).abs() <= ULPS * ulp).all(), ((js - want).abs() / ulp).max().item()


@pytest.mark.parametrize("library", sorted(tpi.LAUNCH_MMA))
def test_mma_launch_shapes_are_whole_warps(library):
    """For every ray tile the wrappers accept, the tensor-core route's
    launch shape gives each column group ray_tile / (16·m_tiles) whole
    warps and the CTA at most the kernel's launch bound
    (``MMA_MAX_THREADS``); the main paths' tiles (128 for K1 and K2, 64
    for K3 and K4) take one m-tile a warp. Every kernel's bf16 modes take
    the route, "highest" none."""
    for ray_tile in range(32, 1025, 32):
        for mode in BF16_MODES:
            threads, groups, mt = tpi.launch_shape(library, ray_tile, mode)
            assert mt in (1, 2) and ray_tile % (16 * mt) == 0, (ray_tile, mt)
            assert groups >= 1 and threads == groups * ray_tile // (16 * mt) * 32, (ray_tile, groups)
            assert threads <= tpi.MMA_MAX_THREADS[library][mt], (ray_tile, threads)
        assert tpi.launch_shape(library, ray_tile) == tpi.launch_shape(library, ray_tile, "highest")
    main_tile = tpi.STREAM_RAY_TILE if library.endswith("_streamed") else tpi.DEFAULT_RAY_TILE
    assert tpi.launch_shape(library, main_tile, "high")[2] == 1
    assert all(tpi.mma_route(library, mode) for mode in BF16_MODES) and not tpi.mma_route(library, "highest")
    assert sorted(tpi.LAUNCH_MMA) == sorted(tpi.LAUNCH)


def blocks_ray(s: np.ndarray, mt: np.ndarray) -> np.ndarray:
    """stream_stage.cuh's ``blocks_ray`` in float32: s (..., 5, cols), mt
    (..., 1); an accepted hit with t in (EPSILON, mt), division-free, the
    products rounded on their own."""
    eps = np.float32(tpi.EPSILON)
    s0, s1, s2, dd, num = (s[..., k, :] for k in range(NSCALARS))
    edge = np.maximum(np.maximum(s0, s1), s2)
    return (edge <= 0) & (dd <= -eps) & (num < eps * dd) & (num > mt * dd)


def fragment_flags(blocked: np.ndarray, mt: np.ndarray, ray_tile: int, groups: int, m_tiles: int, chunk: int):
    """The any hits' flags as the tensor-core route folds them
    (``mma_chunk_any``): ``blocked`` (tiles, ray_tile, nb, tb) per (ray,
    packed column) and ``mt`` (tiles, ray_tile). Group g, warp v of the
    group and lane l hold rays v·16·m_tiles + 16 m + 8 h + l // 4 and, of
    each staged chunk, columns 8 nt + 2 (l % 4) + {0, 1} of n-tiles nt = g,
    g + groups, ... where 8 nt + 2 (l % 4) lies inside the chunk. A thread
    ORs its columns over the chunk's n-tiles, the quad ORs its 4 lanes
    after the chunk (one warp vote), a thread's flag ORs over the chunks
    and blocks, and the groups OR through the shared word, which only a
    quad's first lane sets; only maxt > 0 is ever set. Returns the
    flags (tiles, ray_tile) and, per chunk width, how often each (ray,
    column) is evaluated."""
    tiles, _, nb, tb = blocked.shape
    wpg = ray_tile // (16 * m_tiles)
    g, v, lane, m, h, j, x = np.ix_(range(groups), range(wpg), range(32), range(m_tiles), range(2),
                                    range(-(-chunk // 8 // groups) + 1), range(2))
    ray = v * 16 * m_tiles + 16 * m + 8 * h + lane // 4
    quads = np.broadcast_to(ray, np.broadcast_shapes(g.shape, ray.shape))[..., 0, 0]  # the ray of (g, v, lane, m, h)
    occ = np.zeros((tiles, ray_tile), bool)
    cover = {}
    for c0 in range(0, tb, chunk):
        cw = min(chunk, tb - c0)
        nt = g + groups * j
        inside = 8 * nt + 2 * (lane % 4) < cw
        col = 8 * nt + 2 * (lane % 4) + x
        shape = np.broadcast_shapes(ray.shape, col.shape, inside.shape)
        r_, c_, in_ = (np.broadcast_to(a, shape) for a in (ray, col, inside))
        counts = np.zeros((ray_tile, cw), int)
        np.add.at(counts, (r_[in_], c_[in_]), 1)
        cover[cw] = counts
        for b in range(nb):
            hit = blocked[:, r_, b, c0 + np.minimum(c_, cw - 1)] & in_  # (tiles, *shape)
            hit = hit.any(axis=(-2, -1))  # a thread's columns of the chunk
            hit = hit.reshape(tiles, groups, wpg, 8, 4, m_tiles, 2).any(axis=4, keepdims=True)  # the quad's vote
            hit = np.broadcast_to(hit, (tiles, groups, wpg, 8, 4, m_tiles, 2)).reshape(tiles, groups, wpg, 32,
                                                                                         m_tiles, 2)
            # The groups, through the shared word that each quad's first lane sets.
            np.logical_or.at(occ, (slice(None), quads[:, :, ::4]), hit[:, :, :, ::4])
    return occ & (mt > 0), cover


@pytest.mark.parametrize("mode", BF16_MODES)
def test_anyhit_fragment_epilogue_gives_the_reference_flags(case, mode):
    """The any hits' epilogue on the tensor-core route, in numpy: the exact
    window products (as above, rounded once to float32) through
    ``blocks_ray``, folded by the fragment layout at K2's and K4's main-path
    launch shapes and at two m-tiles a warp. Every (ray, column) of a chunk
    is evaluated exactly once, and the flags meet the flag bar against
    ``occluded_reference`` at the same mode over every block (at least
    99.95% equal), with no maxt = 0 lane occluded."""
    packed, feats = case
    w = packed.w
    nb, tb = w.shape[0], w.shape[2] // NSCALARS
    rays = 1024  # whole tiles of every shape below; padded lanes have zero features and maxt = 0
    fpad = torch.cat([feats, feats.new_zeros((rays - feats.shape[0], K))])
    rng = np.random.default_rng(8)
    mt = rng.uniform(0.0, 12.0, rays).astype(np.float32)
    mt[rng.uniform(size=rays) < 0.1] = 0.0
    mt[feats.shape[0]:] = 0.0
    _, whi, wlo = tpi._kernel_operands(w, mode)
    a = ray_windows(fpad)
    s = window_sums(a["hi"], whi)[0]
    if mode != "default":
        s = s + (window_sums(a["hi"], wlo)[0] + window_sums(a["lo"], whi)[0])
    if mode == "mixed":
        s[:, :, 3:] = window_sums(a["f"], tpi.mma_windows(w))[0][:, :, 3:]
    blocked = blocks_ray(s.numpy().astype(np.float32), mt[:, None, None])  # (rays, nb, tb)

    ref_tile = tpi.DEFAULT_RAY_TILE
    rt = rays // ref_tile
    order = torch.arange(nb, dtype=torch.int32).repeat(rt, 1)
    ref = tpi.occluded_reference(order, torch.zeros((rt, nb)), fpad, torch.as_tensor(mt), w, ref_tile,
                                 precision=mode).numpy().astype(bool)
    assert 0.05 < ref[: feats.shape[0]].mean() < 0.95
    with open(os.path.join(os.path.dirname(HEADER), "decision.cuh")) as f:
        chunk = int(re.search(r"constexpr int CHUNK = (\d+);", f.read()).group(1))
    for library, ray_tile in (("occlusion", tpi.DEFAULT_RAY_TILE), ("occlusion_streamed", tpi.STREAM_RAY_TILE),
                              ("occlusion", 1024)):
        _, groups, m_tiles = tpi.launch_shape(library, ray_tile, mode)
        occ, cover = fragment_flags(blocked.reshape(-1, ray_tile, nb, tb), mt.reshape(-1, ray_tile), ray_tile,
                                    groups, m_tiles, chunk)
        assert all((c == 1).all() for c in cover.values()), (library, ray_tile)
        occ = occ.reshape(-1)
        assert (occ == ref).mean() >= 0.9995, (library, ray_tile, int((occ != ref).sum()))
        assert not occ[mt == 0].any()
