"""The port's rays/s harness (``gpupathtracer_tpu_torch/bench.py``) on the
CPU, modelled on ``tests/test_bench_contract.py``: stdout's last line is
one compact JSON object with the JAX harness's keys, the detail goes to
its file (or the line says it did not), ``vs_baseline`` divides by the
port's own baseline, the budget skips rows, and the timed rows count rays
as W·H·spp·bounces."""

import ast
import dataclasses
import json
import os

import pytest
import torch

import gpupathtracer_tpu.bench as j_bench
from gpupathtracer_tpu_torch import bench
from gpupathtracer_tpu_torch.utils.config import load_scene_file

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")

FAKE = {
    "metric": "rays_per_sec_chip_fwd",
    "value": 1.4e8,
    "unit": "rays/s",
    "vs_baseline": 1.58,
    "config": "config3_icosphere.toml",
    "fwd_bwd": {"rays_per_sec": 5.6e7},
    "configs": {"config%d" % i: {"rays_per_sec": 1e6, "pad": "x" * 512} for i in range(11)},
}


def _jax_kernel_keys() -> list[str]:
    """The keys of the JAX package's ``_bench_kernel`` row, read from its
    source."""
    with open(j_bench.__file__) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_bench_kernel")
    out = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "out")
    return [k.value for k in out.value.keys]


JAX_KERNEL_KEYS = _jax_kernel_keys()


def _last_json(out: str) -> dict:
    line = out.strip().splitlines()[-1]
    assert len(line) < 1000, "the line a caller parses must stay compact"
    return json.loads(line)


def test_main_prints_the_jax_compact_line(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(j_bench, "run_benchmark", lambda **kw: dict(FAKE))
    monkeypatch.setattr(j_bench, "DETAIL_PATH", str(tmp_path / "jax_detail.json"))
    j_bench.main()
    want = _last_json(capsys.readouterr().out)

    monkeypatch.setattr(bench, "run_benchmark", lambda **kw: dict(FAKE))
    detail = tmp_path / "BENCH_DETAIL_torch.json"
    monkeypatch.setattr(bench, "DETAIL_PATH", str(detail))
    bench.main()
    got = _last_json(capsys.readouterr().out)
    assert list(got) == list(want)
    assert got["value"] == FAKE["value"] and got["fwd_bwd_rays_per_sec"] == 5.6e7
    assert got["detail"] == "BENCH_DETAIL_torch.json"
    with open(detail) as f:
        assert json.load(f)["configs"]["config0"]["rays_per_sec"] == 1e6


def test_main_flags_an_unwritable_detail_path(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(bench, "run_benchmark", lambda **kw: dict(FAKE))
    monkeypatch.setattr(bench, "DETAIL_PATH", str(tmp_path / "no_such_dir" / "d.json"))
    bench.main()
    cap = capsys.readouterr()
    assert _last_json(cap.out)["detail"] is None
    assert "could not write" in cap.err


def test_vs_baseline_is_the_ports_and_the_headline_flushes_first(monkeypatch, capsys):
    """The headline row is faked at twice the port's baseline: vs_baseline
    is 2 and the result names its baseline; the headline's compact line is
    printed before the run ends."""
    fake_rate = 2 * bench.BASELINE_RAYS_PER_SEC
    monkeypatch.setattr(bench, "_bench_frame", lambda *a, **kw: {"rays_per_sec": fake_rate, "median_s": 1.0,
                                                                  "warmup_s": 1.0})
    monkeypatch.setenv("FIREFLY_SKIP_SPEC_SPP", "1")
    result = bench.run_benchmark(backward=False, full_suite=False, device="cpu")
    assert result["vs_baseline"] == 2.0
    assert bench.BASELINE_RAYS_PER_SEC == 88.4e6 != j_bench.ROUND1_RAYS_PER_SEC
    assert result["baseline"]["rays_per_sec"] == bench.BASELINE_RAYS_PER_SEC
    assert "H100" in result["baseline"]["card"] and "700" in result["baseline"]["card"]
    assert result["config"] == os.path.basename(bench.headline_scene())
    assert result["device"] == "cpu"
    early = _last_json(capsys.readouterr().out)
    assert early["vs_baseline"] == 2.0 and early["detail"] is None


def test_backward_adds_the_precision_ladder(monkeypatch):
    """With ``backward``, the fwd+bwd row is followed by the JAX package's
    ladder: the forward frame at "highest" and at "high", under JAX's keys
    and in JAX's order."""
    precisions = []

    def frame(scene, camera, settings, *a, **kw):
        precisions.append(settings.kernel_precision)
        return {"rays_per_sec": 1.0, "median_s": 1.0, "warmup_s": 1.0}

    monkeypatch.setattr(bench, "_bench_frame", frame)
    monkeypatch.setattr(bench, "_bench_backward", lambda *a, **kw: {"rays_per_sec": 1.0})
    monkeypatch.setenv("FIREFLY_SKIP_SPEC_SPP", "1")
    result = bench.run_benchmark(backward=True, full_suite=False, device="cpu")
    keys = [k for k in result if k in ("fwd_bwd", "fwd_exact_precision", "fwd_high_precision")]
    assert keys == ["fwd_bwd", "fwd_exact_precision", "fwd_high_precision"]
    assert precisions == ["auto", "highest", "high"]
    assert result["fwd_high_precision"]["rays_per_sec"] == 1.0


def test_budget_skips_every_row_after_the_headline(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_bench_frame", lambda *a, **kw: {"rays_per_sec": 1.0, "median_s": 1.0,
                                                                  "warmup_s": 1.0})
    monkeypatch.setenv("FIREFLY_BENCH_BUDGET_S", "0")
    monkeypatch.delenv("FIREFLY_SKIP_SPEC_SPP", raising=False)
    scene = os.path.join(SCENES, "config3_icosphere.toml")
    result = bench.run_benchmark(scene_path=scene, device="cpu")
    skipped = {"skipped": "bench budget exceeded"}
    assert result["fwd_bwd"] == skipped and result["kernel"] == skipped and result["full_spp"] == skipped
    assert result["fwd_exact_precision"] == result["fwd_high_precision"] == skipped
    assert [name for name, _ in bench.CONFIG_SUITE] == list(result["configs"])
    for name, row in result["configs"].items():
        if name == "config3_icosphere.toml":  # the headline's own row
            assert row["rays_per_sec"] == 1.0 and row["fwd_bwd"] == skipped
        elif name in bench.SPEC_SPP_SUITE:
            assert row == {**skipped, "full_spp": skipped}, name
        else:
            assert row == skipped, name


@pytest.mark.parametrize("config", ["config3_icosphere.toml", "config8_icosphere.toml"])
def test_timed_rows_count_rays(config):
    """A real forward and fwd+bwd row at 16×16 on the CPU: rays/s × median
    seconds = W·H·spp·bounces."""
    scene, camera, settings = load_scene_file(os.path.join(SCENES, config), device="cpu")
    camera = dataclasses.replace(camera, width=16, height=16)
    settings = dataclasses.replace(settings, width=16, height=16, spp=2)
    rays = 16 * 16 * 2 * settings.bounces
    fwd = bench._bench_frame(scene, camera, settings, iters=1, device="cpu")
    assert fwd["rays_per_sec"] * fwd["median_s"] == pytest.approx(rays, rel=1e-9)
    assert (fwd["spp"], fwd["bounces"], fwd["resolution"]) == (2, settings.bounces, [16, 16])
    bwd = bench._bench_backward(scene, camera, settings, iters=1, device="cpu")
    assert bwd["rays_per_sec"] * bwd["median_s"] == pytest.approx(rays, rel=1e-9)
    leaf, leaves = bench.bench_leaves(scene)
    loss, grads = bench.bench_loss_grads(leaf, leaves, camera, settings, seed=3, device="cpu")
    assert loss.item() > 0 and all(torch.isfinite(g).all() for g in grads)
    assert grads[1].abs().sum() > 0


def test_kernel_inputs_are_the_jax_bench_kernels():
    """``kernel_inputs`` makes JAX ``_bench_kernel``'s rays (its camera, and
    as many incoherent rays from seed 0 as the camera has pixels) on the
    config 3 stand-in's mesh packed at tri_block 128, whose pack has the
    shape JAX's has."""
    import jax.numpy as jnp
    import numpy as np

    from gpupathtracer_tpu.models.camera import Camera as JCamera
    from gpupathtracer_tpu.models.camera import generate_rays as j_generate_rays
    from gpupathtracer_tpu.models.scene import build_scene as j_build_scene
    from gpupathtracer_tpu.models.scene import sphere_spec as j_sphere_spec
    from gpupathtracer_tpu.ops import pallas_intersect as pi

    packed, (o_c, d_c), (o_i, d_i) = bench.kernel_inputs("cpu")
    jo, jd = j_generate_rays(JCamera.create(position=(0.0, 1.0, 12.0), fov_deg=50.0, width=800, height=800))
    np.testing.assert_allclose(o_c.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d_c.numpy(), np.asarray(jd), atol=1e-6)
    r = 800 * 800
    assert o_i.shape == d_i.shape == (r, 3)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(o_i.numpy(), np.asarray(jnp.asarray(rng.uniform(-6, 6, (r, 3)), jnp.float32)))
    di = rng.normal(size=(r, 3)).astype(np.float32)
    np.testing.assert_array_equal(d_i.numpy(), di / np.linalg.norm(di, axis=1, keepdims=True))
    j_scene = j_build_scene([j_sphere_spec((0.0, 0.0, 0.0), 2.0, subdivisions=4)], [{"type": "diffuse"}],
                            pad_to_multiple=512)
    assert tuple(packed.w.shape) == tuple(pi.pack_scene(j_scene, tri_block=128).w.shape)


def test_bench_kernel_counts_tests(monkeypatch):
    """``_bench_kernel`` on the CPU at a 32×24 camera: tests/s × seconds =
    rays × packed rows, for the coherent and the incoherent call, and the
    keys of the row."""
    create = bench.Camera.create
    monkeypatch.setattr(bench.Camera, "create", lambda **kw: create(**{**kw, "width": 32, "height": 24}))
    row = bench._bench_kernel(iters=1, device="cpu")
    assert set(row) == {"scene_rows", "coherent_tests_per_s", "incoherent_tests_per_s", "coherent_ms",
                        "incoherent_ms", "mixed_coherent_ms", "mixed_incoherent_ms", "mixed_coherent_tests_per_s",
                        "mixed_incoherent_tests_per_s", "incoherent_sorted_ms", "mixed_incoherent_sorted_ms",
                        "dense_tflops_incoherent"}
    tests = 32 * 24 * row["scene_rows"]
    for prefix in ("", "mixed_"):
        for rays in ("coherent", "incoherent"):
            rate, ms = row[f"{prefix}{rays}_tests_per_s"], row[f"{prefix}{rays}_ms"]
            assert rate * ms / 1e3 == pytest.approx(tests, rel=1e-9)
    assert row["incoherent_sorted_ms"] > 0 and row["mixed_incoherent_sorted_ms"] > 0
    # The JAX package's kernel row has every key of the port's but the v5e
    # probes' (ROADMAP.md, "Deliberately not ported").
    v5e = {"mfu_vs_bf16_peak", "vpu_peak_ops_per_s", "epilogue_ops_per_pair", "vpu_roofline_frac_incoherent_mixed",
           "precision_note"}
    assert set(row) - {"incoherent_sorted_ms"} <= set(JAX_KERNEL_KEYS) - v5e
