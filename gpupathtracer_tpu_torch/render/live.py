"""Live progressive preview: the reference's GLFW viewer loop without GL.

Counterpart of ``gpupathtracer_tpu/render/live.py``. The camera model's
``move`` and ``mouse_move`` (the reference's keyboard and mouse controls)
drive a progressive-refinement loop:

- samples accumulate chunk by chunk into a film (``render_samples``, the
  machinery of checkpointed rendering);
- after every chunk the running mean is written atomically to ``live.png``
  and ``status.json`` in the output directory; an auto-reloading image
  viewer, or the built-in HTTP page (``http_port``), shows it;
- camera commands (stdin lines or any injected source) apply between
  chunks; a camera change restarts accumulation at sample 0.

Commands: w/s/a/d/q/e (move), left/right/up/down (yaw/pitch),
``mouse DX DY``, r (reset), quit.
"""

from __future__ import annotations

import json
import os
import threading
import time

from gpupathtracer_tpu_torch.models.camera import Camera, mouse_move, move
from gpupathtracer_tpu_torch.render.film import Film, to_u8
from gpupathtracer_tpu_torch.render.renderer import RenderSettings, render_samples
from gpupathtracer_tpu_torch.utils.image import write_png

_KEYMAP = {
    "w": 0, "s": 1, "a": 2, "d": 3, "q": 4, "e": 5,
    "left": 6, "right": 7, "up": 8, "down": 9, "r": 10,
}

_INDEX_HTML = """<!doctype html>
<title>firefly live</title>
<body style="margin:0;background:#111;display:grid;place-items:center;height:100vh">
<div><img id="v" style="image-rendering:pixelated;max-width:95vw"/>
<pre id="s" style="color:#9a9">connecting...</pre></div>
<script>
async function tick(){
  document.getElementById('v').src = 'live.png?' + Date.now();
  try {
    const r = await fetch('status.json?' + Date.now());
    document.getElementById('s').textContent = JSON.stringify(await r.json());
  } catch (e) {}
}
setInterval(tick, 500); tick();
</script>
"""


def stdin_commands():
    """A non-blocking poller of stdin lines (POSIX select): the default
    command source of ``view --live``. End of input reads as "quit"."""
    import select
    import sys

    def poll():
        cmds = []
        while select.select([sys.stdin], [], [], 0)[0]:
            line = sys.stdin.readline()
            if not line:
                cmds.append("quit")
                break
            line = line.strip().lower()
            if line:
                cmds.append(line)
        return cmds

    return poll


def _serve(out_dir: str, port: int):
    import functools
    import http.server

    class Handler(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args, **kwargs):  # quiet
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), functools.partial(Handler, directory=out_dir))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _atomic_png(path: str, u8) -> None:
    tmp = path + ".tmp.png"
    write_png(tmp, u8)
    os.replace(tmp, path)


def apply_command(camera: Camera, cmd: str) -> Camera | None:
    """One viewer command → the new camera, or None if it is not a camera
    command."""
    if cmd in _KEYMAP:
        return move(camera, _KEYMAP[cmd])
    if cmd.startswith("mouse"):
        parts = cmd.split()
        if len(parts) == 3:
            try:
                return mouse_move(camera, float(parts[1]), float(parts[2]))
            except ValueError:
                return None
    return None


def live_view(
    scene,
    camera: Camera,
    settings: RenderSettings,
    out_dir: str,
    chunk_spp: int = 2,
    max_spp: int | None = None,
    command_source=None,
    http_port: int | None = None,
    gamma: float = 2.2,
    idle_sleep: float = 0.25,
    device="cuda",
):
    """Run the live loop on ``device``; returns ``(final_camera,
    samples_accumulated)``.

    ``command_source()`` returns the pending command strings without
    blocking; None reads stdin interactively. ``max_spp`` bounds the
    refinement per camera pose: an injected source ends the loop there (a
    headless run), stdin idles until the next command. ``http_port`` serves
    the output directory on 127.0.0.1 (0 = a free port, written to
    ``server.json``)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "index.html"), "w") as f:
        f.write(_INDEX_HTML)
    httpd = None
    if http_port is not None:
        httpd = _serve(out_dir, http_port)
        with open(os.path.join(out_dir, "server.json"), "w") as f:
            json.dump({"port": httpd.server_address[1]}, f)

    interactive = command_source is None
    poll = stdin_commands() if interactive else command_source
    h, w = settings.height, settings.width
    film = Film.zeros(h, w, device="cpu")
    frame_idx = 0
    try:
        while True:
            moved = quit_now = False
            for cmd in poll():
                if cmd == "quit":
                    quit_now = True
                    break
                new_cam = apply_command(camera, cmd)
                if new_cam is not None:
                    camera, moved = new_cam, True
            if quit_now:
                break
            if moved:
                film = Film.zeros(h, w, device="cpu")

            done = int(film.sample_count)
            if max_spp is not None and done >= max_spp:
                if not interactive:
                    break
                time.sleep(idle_sleep)
                continue

            n = chunk_spp if max_spp is None else min(chunk_spp, max_spp - done)
            t0 = time.perf_counter()
            chunk = render_samples(scene, camera, settings, done, n, device=device).detach().cpu()
            dt = time.perf_counter() - t0
            film = film.add_samples(chunk, n)
            frame_idx += 1

            _atomic_png(os.path.join(out_dir, "live.png"), to_u8(film.to_image(), gamma=gamma))
            status = {
                "spp": int(film.sample_count),
                "frame": frame_idx,
                "chunk_seconds": round(dt, 3),
                "rays_per_sec": round(w * h * n * settings.bounces / max(dt, 1e-9), 1),
                "camera": {
                    "position": [round(float(x), 3) for x in camera.position.tolist()],
                    "yaw": round(float(camera.yaw), 2),
                    "pitch": round(float(camera.pitch), 2),
                },
            }
            tmp = os.path.join(out_dir, "status.json.tmp")
            with open(tmp, "w") as f:
                json.dump(status, f)
            os.replace(tmp, os.path.join(out_dir, "status.json"))
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
    return camera, int(film.sample_count)
