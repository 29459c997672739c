"""The port's entry point on the CPU: the ``firefly`` CLI (render to PPM and
PNG, progressive and checkpointed rendering, view and its live preview,
invert), film checkpoints that resume across the two packages, the metrics
stream, a killed and resumed render, the camera controls against the JAX
package's, the live preview and its HTTP page, and the debug and profiling
hooks.

Scene configs are the repo's stand-ins, rewritten at 16×16 or less as JSON
files in the test's directory."""

import dataclasses
import json
import os
import signal
import struct
import subprocess
import sys
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import assert_image_bar

from gpupathtracer_tpu.models import camera as j_camera
from gpupathtracer_tpu.render.renderer import render_frame as j_render
from gpupathtracer_tpu.render.renderer import render_samples as j_render_samples
from gpupathtracer_tpu.utils import checkpoint as j_ckpt
from gpupathtracer_tpu.utils import image as j_image
from gpupathtracer_tpu.utils.config import load_scene_file as j_load
from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch.models import camera as t_camera
from gpupathtracer_tpu_torch.render import live
from gpupathtracer_tpu_torch.render.film import to_u8
from gpupathtracer_tpu_torch.render.progressive import render_progressive
from gpupathtracer_tpu_torch.render.renderer import render_frame, render_samples
from gpupathtracer_tpu_torch.utils import checkpoint as t_ckpt
from gpupathtracer_tpu_torch.utils import debug, profiling
from gpupathtracer_tpu_torch.utils.config import load_config
from gpupathtracer_tpu_torch.utils.config import load_scene_file as t_load
from gpupathtracer_tpu_torch.utils.image import read_ppm, write_ppm
from gpupathtracer_tpu_torch.utils.metrics import read_events

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "scenes")


def small_config(tmp_path, config="config5_invert_target.toml", size=16, **render) -> str:
    """``scenes/<config>`` at ``size``×``size`` (and the ``render`` changes)
    as a JSON config in ``tmp_path``; assets resolve from ``scenes/``."""
    cfg = load_config(os.path.join(SCENES, config))
    cfg["render"] = {**cfg.get("render", {}), "width": size, "height": size, **render}
    cfg["asset_dirs"] = [SCENES]
    path = str(tmp_path / f"{os.path.splitext(config)[0]}_{size}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _cpu(*args):
    return cli.main(["--device", "cpu", *args])


@pytest.mark.parametrize("suffix", ["ppm", "png"])
def test_cli_render_writes_the_frame(tmp_path, capsys, suffix):
    cfg = small_config(tmp_path, spp=2)
    out = str(tmp_path / f"x.{suffix}")
    assert _cpu("render", cfg, "--out", out) == 0
    assert "rendered 16x16 spp=2" in capsys.readouterr().out
    scene, camera, settings = t_load(cfg, device="cpu")
    want = to_u8(render_frame(scene, camera, settings, device="cpu"))
    if suffix == "ppm":
        np.testing.assert_array_equal(read_ppm(out), want)
    else:
        with open(out, "rb") as f:
            head = f.read(24)
        assert head[:8] == b"\x89PNG\r\n\x1a\n" and struct.unpack(">II", head[16:24]) == (16, 16)


def test_cli_normal_aov_and_estimator_flags(tmp_path):
    cfg = small_config(tmp_path, config="config8_icosphere.toml", size=12, spp=1)
    for flags in (["--aov", "normal_unit"], ["--estimator", "mis", "--intersector", "plucker"]):
        assert _cpu("render", cfg, "--out", str(tmp_path / "x.ppm"), *flags) == 0
        img = read_ppm(str(tmp_path / "x.ppm"))
        assert img.shape == (12, 12, 3) and img.max() > 0


def test_cli_checkpointed_resume(tmp_path, capsys):
    """Progressive with a checkpoint through the CLI: the image equals the
    one-shot frame's, a rerun resumes from the finished film (no chunk
    rendered) and writes the same file, and the metrics stream has one
    event a chunk."""
    cfg = small_config(tmp_path)
    ck, metrics = str(tmp_path / "film.npz"), str(tmp_path / "m.jsonl")
    args = ["render", cfg, "--spp", "4", "--chunk-spp", "2", "--checkpoint", ck, "--metrics", metrics]
    assert _cpu(*args, "--out", str(tmp_path / "a.ppm")) == 0
    assert os.path.exists(ck) and len(read_events(metrics)) == 2
    assert _cpu(*args, "--out", str(tmp_path / "b.ppm")) == 0
    capsys.readouterr()
    assert len(read_events(metrics)) == 2  # nothing left to render
    a, b = read_ppm(str(tmp_path / "a.ppm")), read_ppm(str(tmp_path / "b.ppm"))
    np.testing.assert_array_equal(a, b)
    scene, camera, settings = t_load(cfg, device="cpu")
    settings = dataclasses.replace(settings, spp=4)
    np.testing.assert_array_equal(a, to_u8(render_frame(scene, camera, settings, device="cpu")))


def test_progressive_equals_the_frame_and_resumes_bit_identical(tmp_path):
    """chunk_spp 1 equals render_frame within atol 1e-6 (the JAX package's
    bar); a film saved after 2 of 4 samples and finished equals the
    uninterrupted progressive image to the bit."""
    scene, camera, settings = t_load(small_config(tmp_path, spp=4), device="cpu")
    prog = render_progressive(scene, camera, settings, chunk_spp=1, device="cpu")
    np.testing.assert_allclose(prog.numpy(), render_frame(scene, camera, settings, device="cpu").numpy(),
                               atol=1e-6, rtol=0)
    path = str(tmp_path / "film.npz")
    t_ckpt.save_film(path, render_samples(scene, camera, settings, 0, 2, device="cpu"), 2, settings)
    chunks = []
    resumed = render_progressive(scene, camera, settings, chunk_spp=1, checkpoint_path=path,
                                 on_chunk=chunks.append, device="cpu")
    assert [int(f.sample_count) for f in chunks] == [3, 4]
    assert torch.equal(resumed, prog)
    assert t_ckpt.load_film(path, settings)[1] == 4


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_film_checkpoints_resume_across_packages(tmp_path, writer):
    """A film of samples [0, 3) written by one package's save_film is
    finished by the other's progressive render; the result meets the image
    bar against the writer's own one-shot frame."""
    from gpupathtracer_tpu.render.progressive import render_progressive as j_progressive

    cfg = small_config(tmp_path, spp=6, bounces=2)
    js, jc, jst = j_load(cfg)
    ts, tc, tst = t_load(cfg, device="cpu")
    path = str(tmp_path / "film.npz")
    if writer == "jax":
        j_ckpt.save_film(path, np.asarray(j_render_samples(js, jc, jst, jnp.uint32(0), 3)), 3, jst)
        got = render_progressive(ts, tc, tst, chunk_spp=2, checkpoint_path=path, device="cpu").numpy()
        want = np.asarray(j_render(js, jc, jst))
    else:
        t_ckpt.save_film(path, render_samples(ts, tc, tst, 0, 3, device="cpu"), 3, tst)
        got = j_progressive(js, jc, jst, chunk_spp=2, checkpoint_path=path)
        want = render_frame(ts, tc, tst, device="cpu").numpy()
    assert j_ckpt.load_film(path, jst)[1] == t_ckpt.load_film(path, tst)[1] == 6
    assert want.mean() > 0.05
    assert_image_bar(got, want)


@pytest.mark.parametrize("change", [{}, {"seed": 999}, {"background": (0.1, 0.2, 0.3)}, {"estimator": "mis"},
                                    {"use_shading_normals": True, "jitter": False}])
def test_film_digest_matches_jax_and_rejects_other_settings(tmp_path, change):
    from gpupathtracer_tpu.render.renderer import RenderSettings as JSettings
    from gpupathtracer_tpu_torch.render.renderer import RenderSettings

    base = dict(width=16, height=16, spp=8, bounces=2)
    jst, tst = JSettings(**base, **change), RenderSettings(**base, **change)
    assert t_ckpt.settings_digest(tst) == j_ckpt.settings_digest(jst)
    path = str(tmp_path / "film.npz")
    t_ckpt.save_film(path, torch.ones((16, 16, 3)), 4, tst)
    assert t_ckpt.load_film(path, tst)[1] == 4
    other = RenderSettings(**{**base, **change, "seed": 7})
    assert t_ckpt.load_film(path, other) is None


_WORKER = """
import os, signal, sys
import numpy as np
sys.path.insert(0, {repo!r})
from gpupathtracer_tpu_torch.render.progressive import render_progressive
from gpupathtracer_tpu_torch.utils import checkpoint as ckpt
from gpupathtracer_tpu_torch.utils.config import load_scene_file

# Die hard (SIGKILL, no clean-up) right after the second checkpoint write.
if os.environ.get("INJECT_FAULT") == "1":
    orig_save, state = ckpt.save_film, {{"n": 0}}
    def killing_save(*args):
        orig_save(*args)
        state["n"] += 1
        if state["n"] == 2:
            os.kill(os.getpid(), signal.SIGKILL)
    ckpt.save_film = killing_save

scene, camera, settings = load_scene_file(sys.argv[1], device="cpu")
img = render_progressive(scene, camera, settings, chunk_spp=1, checkpoint_path=sys.argv[2], device="cpu")
np.save(sys.argv[3], img.numpy())
"""


def test_sigkill_resume_bit_identical(tmp_path):
    """A render killed after its second of six checkpoints, rerun with the
    same arguments, finishes bit-identical to an uninterrupted run
    (tests/test_fault_injection.py, on the port)."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=ROOT))
    cfg = small_config(tmp_path, spp=6, bounces=2)
    ck, out, clean = str(tmp_path / "film.npz"), str(tmp_path / "resumed.npy"), str(tmp_path / "clean.npy")
    env = {k: v for k, v in os.environ.items() if k != "INJECT_FAULT"}
    run = lambda *a, **e: subprocess.run([sys.executable, str(worker), cfg, *a], env={**env, **e},
                                         capture_output=True, timeout=300)
    p = run(ck, out, INJECT_FAULT="1")
    assert p.returncode == -signal.SIGKILL, p.stderr.decode()[-2000:]
    assert os.path.exists(ck) and not os.path.exists(out)
    assert t_ckpt.load_film(ck, t_load(cfg, device="cpu")[2])[1] == 2
    p = run(ck, out)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    p = run(str(tmp_path / "other.npz"), clean)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    np.testing.assert_array_equal(np.load(out), np.load(clean))


@pytest.mark.parametrize("command", list(range(11)) + ["mouse"])
def test_camera_controls_match_jax(command):
    kw = dict(position=(0.5, 1.0, 3.0), yaw=-80.0, pitch=10.0)
    jc, tc = j_camera.Camera.create(**kw), t_camera.Camera.create(**kw, device="cpu")
    if command == "mouse":
        jc, tc = j_camera.mouse_move(jc, 12.0, 500.0), t_camera.mouse_move(tc, 12.0, 500.0)
        assert float(tc.pitch) == 89.0
    else:
        jc, tc = j_camera.move(jc, command), t_camera.move(tc, command)
    for field in ("position", "yaw", "pitch"):
        np.testing.assert_allclose(getattr(tc, field).numpy(), np.asarray(getattr(jc, field)), rtol=1e-6, atol=1e-6)


def _live_scene(tmp_path):
    return t_load(small_config(tmp_path, size=12, spp=8, bounces=2), device="cpu")


def test_live_refines_to_max_spp(tmp_path):
    out = str(tmp_path / "live")
    scene, camera, settings = _live_scene(tmp_path)
    _, spp = live.live_view(scene, camera, settings, out, chunk_spp=2, max_spp=6, command_source=lambda: [],
                            device="cpu")
    assert spp == 6
    status = json.load(open(os.path.join(out, "status.json")))
    assert status["spp"] == 6 and status["frame"] == 3
    with open(os.path.join(out, "live.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_live_camera_command_restarts_accumulation(tmp_path):
    """'w' moves the camera forward by 0.2 and resets the film: the two
    chunks after the move hold 2 × 2 samples."""
    scene, camera, settings = _live_scene(tmp_path)
    feed = iter([[], ["w"], [], ["quit"]])
    cam, spp = live.live_view(scene, camera, settings, str(tmp_path / "live"), chunk_spp=2, max_spp=100,
                              command_source=lambda: next(feed, ["quit"]), device="cpu")
    expected = t_camera.move(camera, 0).position
    np.testing.assert_allclose(cam.position.numpy(), expected.numpy())
    assert spp == 4


def test_apply_command_mouse_reset_and_unknown():
    cam = t_camera.Camera.create(position=(0.5, 0.5, 3.0), device="cpu")
    assert float(live.apply_command(cam, "mouse 10 0").yaw) != float(cam.yaw)
    np.testing.assert_allclose(live.apply_command(cam, "r").position.numpy(), [0.0, 0.0, 15.0])
    assert live.apply_command(cam, "bogus") is None and live.apply_command(cam, "mouse x y") is None


def test_live_http_serves_the_page(tmp_path):
    """The page is fetched from 127.0.0.1 while the loop runs."""
    out = str(tmp_path / "live")
    scene, camera, settings = _live_scene(tmp_path)
    fetched, calls = {}, {"n": 0}

    def source():
        calls["n"] += 1
        if calls["n"] == 2:
            port = json.load(open(os.path.join(out, "server.json")))["port"]
            for name in ("index.html", "status.json"):
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/{name}", timeout=5) as r:
                    fetched[name] = r.read().decode()
            return ["quit"]
        return []

    live.live_view(scene, camera, settings, out, chunk_spp=1, max_spp=8, command_source=source, http_port=0,
                   device="cpu")
    assert "firefly live" in fetched["index.html"] and json.loads(fetched["status.json"])["spp"] == 1


def test_cli_view_turntable_and_live(tmp_path, monkeypatch, capsys):
    cfg = small_config(tmp_path, size=8, spp=1)
    out = str(tmp_path / "turn")
    assert _cpu("view", cfg, "--frames", "2", "--out", out) == 0
    assert sorted(os.listdir(out)) == ["frame_0000.png", "frame_0001.png"]
    # --live reads stdin; feed it a move and then the end of input.
    feed = iter([["d"], [], ["quit"]])
    monkeypatch.setattr(live, "stdin_commands", lambda: lambda: next(feed))
    assert _cpu("view", cfg, "--live", "--out", str(tmp_path / "live"), "--chunk-spp", "1", "--max-spp", "4") == 0
    assert "live view done (2 spp at exit)" in capsys.readouterr().out


def _fake_turntable(monkeypatch) -> dict:
    """Replace ``render_frame`` in both packages' renderer modules with one
    deterministic image per camera yaw (whole degrees, so that the two
    packages' float32 yaws give the same image); returns the yaws seen,
    by package."""
    from gpupathtracer_tpu.render import renderer as j_renderer
    from gpupathtracer_tpu_torch.render import renderer as t_renderer

    yaws = {"jax": [], "torch": []}

    def fake(pkg):
        def render(scene, cam, settings, *args, **kw):
            yaw = float(np.asarray(cam.yaw))
            yaws[pkg].append(yaw)
            shape = (settings.height, settings.width, 3)
            img = np.random.default_rng(round(yaw) % 360).uniform(0.0, 1.2, shape).astype(np.float32)
            return torch.from_numpy(img) if pkg == "torch" else img

        return render

    monkeypatch.setattr(j_renderer, "render_frame", fake("jax"))
    monkeypatch.setattr(t_renderer, "render_frame", fake("torch"))
    return yaws


def test_cli_view_gif_matches_jax(tmp_path, monkeypatch):
    """``view --gif`` on the same frames: equal PNG frames and a
    byte-identical ``turntable.gif`` (2 frames, 120 ms each, looping)."""
    image = pytest.importorskip("PIL.Image")
    from gpupathtracer_tpu import cli as j_cli

    yaws = _fake_turntable(monkeypatch)
    cfg = small_config(tmp_path, size=8, spp=1)
    j_out, t_out = tmp_path / "jax", tmp_path / "torch"
    assert j_cli.main(["view", cfg, "--frames", "2", "--gif", "--out", str(j_out)]) == 0
    assert _cpu("view", cfg, "--frames", "2", "--gif", "--out", str(t_out)) == 0
    assert len(yaws["torch"]) == len(yaws["jax"]) == 2
    np.testing.assert_allclose(yaws["torch"], yaws["jax"], atol=1e-3)
    assert sorted(os.listdir(t_out)) == sorted(os.listdir(j_out)) == [
        "frame_0000.png", "frame_0001.png", "turntable.gif"]
    for name in ("frame_0000.png", "frame_0001.png"):
        with image.open(t_out / name) as got, image.open(j_out / name) as want:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert (t_out / "turntable.gif").read_bytes() == (j_out / "turntable.gif").read_bytes()
    with image.open(t_out / "turntable.gif") as gif:
        assert (gif.n_frames, gif.info["duration"], gif.info["loop"]) == (2, 120, 0)


def test_cli_view_gif_of_real_frames(tmp_path):
    image = pytest.importorskip("PIL.Image")
    cfg = small_config(tmp_path, size=8, spp=1)
    out = tmp_path / "turn"
    assert _cpu("view", cfg, "--frames", "2", "--spp", "1", "--gif", "--out", str(out)) == 0
    with image.open(out / "turntable.gif") as gif:
        assert (gif.n_frames, gif.size) == (2, (8, 8))


def test_cli_view_gif_without_pil_raises_after_the_frames(tmp_path, monkeypatch):
    """Without PIL, ``view --gif`` raises ImportError once the PNG frames
    are written, in both packages. The JAX package's ``write_png`` needs PIL
    itself, so its verb writes its frames with the port's writer, which
    does not, to reach its GIF branch."""
    from gpupathtracer_tpu import cli as j_cli
    from gpupathtracer_tpu_torch.utils.image import write_png

    _fake_turntable(monkeypatch)
    monkeypatch.setattr(j_image, "write_png", write_png)
    cfg = small_config(tmp_path, size=8, spp=1)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for name, main in (("jax", j_cli.main), ("torch", lambda argv: _cpu(*argv))):
        out = tmp_path / name
        with pytest.raises(ImportError):
            main(["view", cfg, "--frames", "2", "--gif", "--out", str(out)])
        assert sorted(os.listdir(out)) == ["frame_0000.png", "frame_0001.png"], name


def test_cli_invert_albedo(tmp_path, capsys):
    assert _cpu("invert", "--steps", "2", "--size", "8", "--spp", "1", "--subdivisions", "1",
                "--out", str(tmp_path)) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["steps"] == 2 and np.isfinite(result["final_loss"])
    assert os.path.exists(tmp_path / "recovered.png")


def test_cli_defaults_to_the_card(tmp_path):
    """With no --device the CLI asks for the card; without one it raises
    instead of rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["render", small_config(tmp_path), "--out", str(tmp_path / "x.ppm")])


def test_write_ppm_matches_jax(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    write_ppm(str(tmp_path / "t.ppm"), img)
    j_image.write_ppm(str(tmp_path / "j.ppm"), img)
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()
    np.testing.assert_array_equal(read_ppm(str(tmp_path / "t.ppm")), img)


def test_debug_mode_and_checkify_raise_on_non_finite_frames(tmp_path):
    scene, camera, settings = t_load(small_config(tmp_path, size=8, spp=1, bounces=2), device="cpu")
    bad = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, intensity=torch.full_like(scene.materials.intensity, float("nan"))))
    assert not torch.isfinite(render_frame(bad, camera, settings, device="cpu")).all()  # unchecked outside
    with debug.debug_mode():
        assert torch.isfinite(render_frame(scene, camera, settings, device="cpu")).all()
        with pytest.raises(FloatingPointError, match="render_frame"):
            render_frame(bad, camera, settings, device="cpu")
    checked = debug.checkify_render(render_frame)
    assert torch.isfinite(checked(scene, camera, settings, device="cpu")).all()
    with pytest.raises(FloatingPointError):
        checked(bad, camera, settings, device="cpu")


def test_profiling_trace_timer_and_scope(tmp_path):
    scene, camera, settings = _live_scene(tmp_path)
    timer = profiling.Timer()
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.scope("frame"):
            img = render_frame(scene, camera, settings, device="cpu")
    stats = timer.stop(rays=100)
    assert profiling.force(img) == float(img.reshape(-1)[0])
    assert stats["seconds"] > 0 and stats["rays_per_sec"] > 0
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert any(e.get("name") == "frame" for e in trace["traceEvents"])


def test_cli_render_takes_the_brute_intersector(tmp_path):
    """``--intersector brute`` (a choice of the JAX package's CLI): the PPM is
    the brute-force render's."""
    cfg = small_config(tmp_path, spp=1)
    out = str(tmp_path / "brute.ppm")
    assert _cpu("render", cfg, "--intersector", "brute", "--out", out) == 0
    scene, camera, settings = t_load(cfg, device="cpu")
    want = to_u8(render_frame(scene, camera, dataclasses.replace(settings, intersector="brute"), device="cpu"))
    np.testing.assert_array_equal(read_ppm(out), want)


def _fake_run(seen: dict, pkg: str, result: dict):
    """A ``run_benchmark`` that records its keywords under ``seen[pkg]``
    and returns a copy of ``result``."""

    def run(**kw):
        seen[pkg] = kw
        return dict(result)

    return run


@pytest.mark.parametrize("full", [False, True], ids=["default", "full"])
def test_cli_benchmark_prints_its_json(tmp_path, monkeypatch, capsys, full):
    """The ``benchmark`` verb hands ``run_benchmark`` the keywords that the
    JAX package's verb hands its own (``backward`` and ``full_suite`` both
    from ``--full``), and ``--device`` besides, and prints the whole result
    as its last line, as JAX's does; neither writes a detail file."""
    from gpupathtracer_tpu import bench as j_bench
    from gpupathtracer_tpu import cli as j_cli
    from gpupathtracer_tpu_torch import bench

    seen = {}
    fake = {"metric": "rays_per_sec_chip_fwd", "value": 1.0e8, "unit": "rays/s", "vs_baseline": 1.13,
            "config": "x.toml", "fwd_bwd": {"rays_per_sec": 4.0e7}, "full_spp": {"rays_per_sec": 9.0e7}}
    for pkg, module in (("jax", j_bench), ("torch", bench)):
        monkeypatch.setattr(module, "run_benchmark", _fake_run(seen, pkg, fake))
        monkeypatch.setattr(module, "DETAIL_PATH", str(tmp_path / f"{pkg}_detail.json"))
    flags = ["benchmark", "--scene", "x.toml", "--iters", "2"] + (["--full"] if full else [])
    assert j_cli.main(flags) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert cli.main(["--device", "cpu", *flags]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert seen["jax"] == {"scene_path": "x.toml", "warmup": 1, "iters": 2, "backward": full, "full_suite": full}
    assert seen["torch"] == {**seen["jax"], "device": "cpu"}
    assert got == want and json.loads(got) == fake
    assert os.listdir(tmp_path) == []


def test_bench_main_keeps_its_detail_file_and_compact_line(tmp_path, monkeypatch, capsys):
    """``python -m gpupathtracer_tpu_torch.bench`` runs ``run_benchmark``
    with its defaults (fwd+bwd and the suite), as JAX's ``bench.main`` does,
    writes the whole result to the detail file and prints the compact line
    last."""
    from gpupathtracer_tpu import bench as j_bench
    from gpupathtracer_tpu_torch import bench

    seen = {}
    fake = {"metric": "rays_per_sec_chip_fwd", "value": 1.0e8, "unit": "rays/s", "vs_baseline": 1.13,
            "config": "x.toml", "fwd_bwd": {"rays_per_sec": 4.0e7}, "configs": {"x.toml": {}}}
    for pkg, module in (("jax", j_bench), ("torch", bench)):
        monkeypatch.setattr(module, "run_benchmark", _fake_run(seen, pkg, fake))
        monkeypatch.setattr(module, "DETAIL_PATH", str(tmp_path / f"{pkg}_detail.json"))
    j_bench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    bench.main()
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen == {"jax": {}, "torch": {}}
    assert got == {**want, "detail": "torch_detail.json"} and want["detail"] == "jax_detail.json"
    assert (got["value"], got["fwd_bwd_rays_per_sec"]) == (1.0e8, 4.0e7)
    with open(tmp_path / "torch_detail.json") as f:
        assert json.load(f) == fake
