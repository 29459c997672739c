"""The port's staged wavefront (``parallel/pipeline.py``) on the CPU: one
spawn of four gloo processes renders every case through
``render_frame_pipelined``, and every rank's frame must equal the
single-process ``render_frame`` bit for bit: (stages, microbatches) (4, 4),
(4, 8) and (2, 2) (the last on a mesh of ranks 0–1 with bounces 2), NEE at
(4, 4), and compact modes "mask" and "hybrid" at (4, 4), naive and NEE.
The searches are counted per rank on one NEE frame: stage k applies its
bounce M times a sample and skips the steps where it holds no microbatch.

The (4, 4) naive and NEE frames are also held to the JAX package's
``render_frame_pipelined`` on 4 of the 8 virtual CPU devices: naive to the
bit on every pixel where the port's ``render_frame`` equals JAX's, NEE to
the image bar. The scene is ``tests/test_torch_parallel.py``'s; the spawned
ranks import no JAX."""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from test_torch_parallel import CAMERA, JOIN_TIMEOUT_S, _camera, _scene
from test_torch_render import assert_image_bar

from gpupathtracer_tpu_torch.render.integrator import IntegratorOptions, dead_path_state
from gpupathtracer_tpu_torch.render.renderer import RenderSettings, render_frame

WORLD = 4
SIZE = 24
BASE = dict(width=SIZE, height=SIZE, spp=2, tri_block=64, tri_block_secondary=128)
# (stages, microbatches, estimator, compact_mode)
CASES = [
    (4, 4, "naive", "permute"),
    (4, 8, "naive", "permute"),
    (2, 2, "naive", "permute"),
    (4, 4, "nee", "permute"),
    (4, 4, "naive", "mask"),
    (4, 4, "naive", "hybrid"),
    (4, 4, "nee", "mask"),
    (4, 4, "nee", "hybrid"),
]
COUNTED = (4, 4, "nee", "permute")
SEARCHES = ("closest_hit_reference", "occluded_reference")


def _settings(n_pipe, estimator, compact_mode="permute"):
    return RenderSettings(**BASE, bounces=n_pipe, estimator=estimator, compact_mode=compact_mode)


def _count_searches(counts):
    """Count the plain searches' calls in ``counts`` (the kernels' plain
    versions run on CPU tensors; one call per kernel launch on the card)."""
    from gpupathtracer_tpu_torch.ops import packed_intersect

    for name in SEARCHES:
        fn = getattr(packed_intersect, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*args, **kw)

        setattr(packed_intersect, name, counted)


def _worker(rank, init_method, out_dir):
    import torch.distributed as dist

    from gpupathtracer_tpu_torch.parallel.multihost import init_distributed
    from gpupathtracer_tpu_torch.parallel.pipeline import make_pipe_mesh, render_frame_pipelined

    torch.set_num_threads(1)
    init_distributed(init_method=init_method, world_size=WORLD, rank=rank, device="cpu")
    meshes = {4: make_pipe_mesh(4), 2: make_pipe_mesh(2)}  # every rank creates both groups
    counts = dict.fromkeys(SEARCHES, 0)
    _count_searches(counts)
    scene, camera = _scene(device="cpu"), _camera()
    frames, launches = {}, None
    for case in CASES:
        n_pipe, m, estimator, mode = case
        if rank >= n_pipe:
            continue
        for name in counts:
            counts[name] = 0
        frames[case] = render_frame_pipelined(scene, camera, _settings(n_pipe, estimator, mode),
                                              meshes[n_pipe], microbatches=m, device="cpu")
        if case == COUNTED:
            launches = dict(counts)
    torch.save({"frames": frames, "launches": launches}, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _jax_reference():
    """JAX's ``render_frame_pipelined`` at (4, 4), naive and NEE, and JAX's
    ``render_frame`` naive, on the same scene and settings (the plain
    Plücker search, as ``tests/test_pipeline.py``)."""
    import jax

    from gpupathtracer_tpu.models import scene as j_scene
    from gpupathtracer_tpu.models.camera import Camera as JCamera
    from gpupathtracer_tpu.parallel.pipeline import make_pipe_mesh as j_mesh
    from gpupathtracer_tpu.parallel.pipeline import render_frame_pipelined as j_pipelined
    from gpupathtracer_tpu.render.renderer import RenderSettings as JSettings
    from gpupathtracer_tpu.render.renderer import render_frame as j_render

    js, jc = _scene(j_scene), JCamera.create(**CAMERA)
    mesh = j_mesh(4, devices=jax.devices()[:4])
    st = {e: JSettings(**BASE, bounces=4, estimator=e, intersector="plucker") for e in ("naive", "nee")}
    out = {e: np.asarray(j_pipelined(js, jc, st[e], mesh, microbatches=4)) for e in st}
    out["render_frame naive"] = np.asarray(j_render(js, jc, st["naive"]))
    return out


@pytest.fixture(scope="module")
def pipelined(tmp_path_factory):
    """Every rank's frames and search counts, the single-process
    ``render_frame`` of each case, and the JAX references (computed while
    the ranks run)."""
    out = tmp_path_factory.mktemp("pipe")
    ctx = mp.start_processes(_worker, args=(f"file://{out}/store", str(out)), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        scene, camera = _scene(device="cpu"), _camera()
        single = {}
        for n_pipe, _, estimator, mode in CASES:
            key = (n_pipe, estimator, mode)
            if key not in single:
                single[key] = render_frame(scene, camera, _settings(n_pipe, estimator, mode), device="cpu")
        jax_frames = _jax_reference()
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD} ranks did not finish within {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(WORLD)]
    return ranks, single, jax_frames


@pytest.mark.parametrize("case", CASES, ids=[f"{s}x{m}-{e}-{c}" for s, m, e, c in CASES])
def test_pipelined_frame_equals_render_frame(pipelined, case):
    ranks, single, _ = pipelined
    n_pipe, _, estimator, mode = case
    want = single[(n_pipe, estimator, mode)]
    assert want.mean() > 0.02
    for rank, result in enumerate(ranks[:n_pipe]):
        got = result["frames"][case]
        assert got.shape == want.shape
        differ = int((got != want).any(dim=-1).sum())
        assert differ == 0, f"rank {rank}: {differ} pixels differ"


def test_pipelined_launches_follow_the_skip_rule(pipelined):
    """Per sample, stage k applies its bounce once for each of the M
    microbatches: stage 0 two closest-hit searches a bounce (the hit and
    its thresholded shadow rays), the later stages one closest hit and one
    any-hit search (the second pack)."""
    ranks, _, _ = pipelined
    spp, m = BASE["spp"], COUNTED[1]
    for k, result in enumerate(ranks):
        want = {"closest_hit_reference": spp * m * (2 if k == 0 else 1),
                "occluded_reference": 0 if k == 0 else spp * m}
        assert result["launches"] == want, f"stage {k}"


@pytest.mark.parametrize("estimator", ["naive", "nee"])
def test_pipelined_frame_matches_jax(pipelined, estimator):
    ranks, single, jax_frames = pipelined
    got = ranks[WORLD - 1]["frames"][(4, 4, estimator, "permute")].numpy()
    want = jax_frames[estimator]
    assert want.mean() > 0.02
    if estimator == "naive":
        same = (single[(4, "naive", "permute")].numpy() == jax_frames["render_frame naive"]).all(axis=-1)
        assert same.mean() > 0.9
        np.testing.assert_array_equal(got[same], want[same])
    assert_image_bar(got, want)


def test_dead_path_state_equals_jax():
    from gpupathtracer_tpu.render.integrator import dead_path_state as j_dead

    keys = np.random.default_rng(3).integers(0, 2**32, size=(5, 4), dtype=np.uint32)
    want = j_dead(5, keys)
    got = dead_path_state(5, torch.from_numpy(keys.astype(np.int64)), "cpu")
    for f, w in zip(dataclasses.fields(got), want):
        g = getattr(got, f.name)
        assert g.dtype == {np.dtype(np.float32): torch.float32, np.dtype(bool): torch.bool,
                           np.dtype(np.uint32): torch.int64}[np.asarray(w).dtype], f.name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype), err_msg=f.name)


def test_one_stage_pipeline_and_its_checks():
    """One process without a group: a one-stage pipe mesh renders
    ``render_frame``'s frame; bounces other than the stage count, and rays
    that do not divide into the microbatches, raise."""
    import torch.distributed as dist

    from gpupathtracer_tpu_torch.parallel.pipeline import make_pipe_mesh, render_frame_pipelined, trace_paths_pipelined

    assert not dist.is_initialized()
    try:
        mesh = make_pipe_mesh(1)
        scene, camera = _scene(device="cpu"), _camera()
        settings = _settings(1, "nee")
        got = render_frame_pipelined(scene, camera, settings, mesh, microbatches=3, device="cpu")
        assert torch.equal(got, render_frame(scene, camera, settings, device="cpu"))
        with pytest.raises(ValueError, match="one bounce per pipe stage"):
            render_frame_pipelined(scene, camera, _settings(2, "naive"), mesh, device="cpu")
        o = torch.zeros((10, 3))
        d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(10, 1)
        with pytest.raises(ValueError, match="not divisible by 4 microbatches"):
            trace_paths_pipelined(scene, o, d, torch.zeros((10, 4), dtype=torch.int64),
                                  IntegratorOptions(bounces=1), mesh, microbatches=4)
        with pytest.raises(ValueError, match="pipe stages"):
            make_pipe_mesh(2)
    finally:
        dist.destroy_process_group()
