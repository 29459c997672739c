"""The shade step's routes on the CPU: the predicate that picks the fused
kernel (``integrator.shade_route``) on each of its conditions, CPU frames
that always take the ops route, the kernel op's registration and argument
checks, and the build rules of ``csrc/shade.cu``. The kernel itself runs
only on the card (``tests/test_torch_cuda.py``)."""

import dataclasses
import os

import pytest
import torch

from gpupathtracer_tpu_torch.ops import _build, shade
from gpupathtracer_tpu_torch.render import integrator
from gpupathtracer_tpu_torch.render.integrator import IntegratorOptions, shade_route
from gpupathtracer_tpu_torch.render.renderer import render_frame
from gpupathtracer_tpu_torch.utils.config import load_scene_file

SCENE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes", "config3_icosphere.toml")
CUDA = torch.device("cuda")  # a device object needs no card

NAIVE = IntegratorOptions(material_set=(0, 1))
CASES = {
    "naive diffuse and emitter": (NAIVE, CUDA, "fused"),
    "cpu": (NAIVE, torch.device("cpu"), "ops"),
    "nee": (dataclasses.replace(NAIVE, estimator="nee"), CUDA, "ops"),
    "mis": (dataclasses.replace(NAIVE, estimator="mis"), CUDA, "ops"),
    "threefry": (dataclasses.replace(NAIVE, rng="threefry"), CUDA, "ops"),
    "textured": (dataclasses.replace(NAIVE, textured=True), CUDA, "ops"),
    "mirror": (dataclasses.replace(NAIVE, material_set=(0, 1, 2)), CUDA, "ops"),
    "glass": (dataclasses.replace(NAIVE, material_set=(1, 3)), CUDA, "ops"),
    "every type": (IntegratorOptions(), CUDA, "ops"),
    "diffuse only": (dataclasses.replace(NAIVE, material_set=(1,)), CUDA, "fused"),
    "emitter only": (dataclasses.replace(NAIVE, material_set=(0,)), CUDA, "fused"),
    "roulette and shading normals": (dataclasses.replace(NAIVE, rr_start=1, use_shading_normals=True), CUDA,
                                     "fused"),
    "brute intersector": (dataclasses.replace(NAIVE, intersector="brute"), CUDA, "fused"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_shade_route_on_each_condition(case):
    options, device, want = CASES[case]
    assert shade_route(options, device, (torch.zeros(3), None)) == want


@pytest.mark.parametrize("grad_mode", [True, False], ids=["grad", "no_grad"])
def test_shade_route_with_an_input_that_requires_a_gradient(grad_mode):
    """An input that requires a gradient sends the step to the ops route,
    which carries it, unless grad mode is off."""
    leaf = torch.zeros(3, requires_grad=True)
    with torch.set_grad_enabled(grad_mode):
        route = shade_route(NAIVE, CUDA, (torch.zeros(3), None, leaf))
    assert route == ("ops" if grad_mode else "fused")


def test_cpu_frames_take_the_ops_route(monkeypatch):
    """A naive frame on CPU tensors never reaches the kernel: every
    render.shade span records the ops route, and nothing is launched."""
    from torch.profiler import ProfilerActivity, profile

    def refuse(*args, **kwargs):
        raise AssertionError("the fused shade step ran on the CPU")

    monkeypatch.setattr(integrator, "naive_shade", refuse)
    scene, camera, settings = load_scene_file(SCENE, device="cpu")
    camera = dataclasses.replace(camera, width=12, height=12)
    settings = dataclasses.replace(settings, width=12, height=12, spp=2)
    before = _build.launch_counts["shade"]
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        img = render_frame(scene, camera, settings, device="cpu")
    spans = [e for e in prof.events() if e.name == "render.shade"]
    assert len(spans) == settings.spp * settings.bounces
    assert all(list(e.concrete_inputs) == [integrator.SHADE_ROUTES.index("ops")] for e in spans)
    assert _build.launch_counts["shade"] == before
    assert torch.isfinite(img).all()


def test_shade_op_takes_card_tensors_only():
    """The launch is a dispatcher op with a CUDA kernel alone, so the
    profiler links it to the caller's render.shade span."""
    op = "firefly_shade::naive"
    assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(op, "CPU")
    assert shade._naive_kernel is torch.ops.firefly_shade.naive.default


def _launch_args(r=8, m=3, n=4):
    f = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    return dict(o=f(r, 3), d=f(r, 3), throughput=f(r, 3), radiance=f(r, 3), alive=torch.ones(r, dtype=torch.bool),
                tri=torch.zeros(r, dtype=torch.int64), hit=torch.ones(r, dtype=torch.bool),
                keys=torch.zeros((r, 4), dtype=torch.int64), v0=f(n, 3), e1=f(n, 3), e2=f(n, 3), n0=None, n1=None,
                n2=None, mat_id=torch.zeros(n, dtype=torch.int64), mat_type=torch.zeros(m, dtype=torch.int64),
                albedo=f(m, 3), emissive=f(m, 3), intensity=f(m), bg_r=0.0, bg_g=0.0, bg_b=0.0, bounce=0,
                flags=shade.HAS_EMIT | shade.HAS_DIFFUSE)


BAD = {
    "o with rows 6 floats apart": lambda a: {"o": torch.zeros(8, 6)[:, :3]},
    "d of another length": lambda a: {"d": torch.zeros(9, 3)},
    "d not contiguous": lambda a: {"d": torch.zeros(3, 8).t()},
    "float64 throughput": lambda a: {"throughput": a["throughput"].double()},
    "int alive": lambda a: {"alive": a["alive"].int()},
    "int32 rows": lambda a: {"tri": a["tri"].int()},
    "keys of 3 words": lambda a: {"keys": torch.zeros((8, 3), dtype=torch.int64)},
    "keys off a 16-byte boundary": lambda a: {"keys": torch.zeros(8 * 4 + 1, dtype=torch.int64)[1:].view(8, 4)},
    "shading normals missing": lambda a: {"flags": shade.SHADING_NORMALS},
    "mat_id of another length": lambda a: {"mat_id": torch.zeros(5, dtype=torch.int64)},
    "albedo of 2 channels": lambda a: {"albedo": torch.zeros(3, 2)},
    "intensity of another length": lambda a: {"intensity": torch.zeros(4)},
}


@pytest.mark.parametrize("case", list(BAD))
def test_shade_kernel_refuses_what_it_does_not_take(case):
    """The wrapper raises ValueError before it builds or launches anything
    (so on the CPU too) on inputs of another dtype, shape or layout."""
    args = _launch_args()
    args.update(BAD[case](args))
    before = _build.launch_counts["shade"]
    with pytest.raises(ValueError):
        shade._naive_launch(**args)
    assert _build.launch_counts["shade"] == before


def test_shade_kernel_refuses_tensors_on_two_devices():
    args = _launch_args()
    args["v0"] = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="every tensor"):
        shade._naive_launch(**args)


def test_shade_library_build_rules(monkeypatch, tmp_path):
    """The shade step builds without contracted multiply-adds, the searches
    and the sampler with the common flags; the sampler and the shade step
    include the one PCG header, whose edit rebuilds both; neither source
    defines the words itself."""
    assert "-fmad=false" in _build.flags(_build.SHADE)
    assert all("-fmad=false" not in _build.flags(n) for n in _build.LAUNCHES if n != _build.SHADE)
    assert set(_build.LAUNCHES[_build.SHADE]) == {"shade_naive_launch"}
    for name in (_build.PCG, _build.SHADE):
        with open(_build.source(name)) as f:
            text = f.read()
        assert '#include "pcg.cuh"' in text and "pcg4d(Words v)" not in text and "GOLDEN =" not in text
    before = {n: _build.library_path(n) for n in (_build.PCG, _build.SHADE, "closest_hit")}
    edited = tmp_path / "pcg.cuh"
    edited.write_text(open(_build.PCG_HEADER).read() + "\n// edited\n")
    monkeypatch.setitem(_build.INCLUDES, _build.PCG, [str(edited)])
    monkeypatch.setitem(_build.INCLUDES, _build.SHADE, [str(edited)])
    after = {n: _build.library_path(n) for n in before}
    assert after[_build.PCG] != before[_build.PCG] and after[_build.SHADE] != before[_build.SHADE]
    assert after["closest_hit"] == before["closest_hit"]
