"""Progressive, checkpointed, restartable rendering.

Counterpart of ``gpupathtracer_tpu/render/progressive.py``: renders
``settings.spp`` samples in chunks (``render_samples``) and sums them into a
float32 film on the host. After every ``checkpoint_every`` chunks, and after
the last, the film is saved (``utils/checkpoint.py``); a killed job rerun
with the same arguments resumes at the first missing sample and finishes
bit-identical to an uninterrupted run (global sample ids key the RNG). Each
chunk appends a ``chunk`` event (samples done, seconds, rays/s) to the
metrics stream.
"""

from __future__ import annotations

import torch

from gpupathtracer_tpu_torch.render.film import Film
from gpupathtracer_tpu_torch.render.renderer import RenderSettings, render_samples
from gpupathtracer_tpu_torch.utils import checkpoint as ckpt
from gpupathtracer_tpu_torch.utils.metrics import log_event
from gpupathtracer_tpu_torch.utils.profiling import Timer


def render_progressive(
    scene,
    camera,
    settings: RenderSettings,
    chunk_spp: int = 16,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    metrics_path: str | None = None,
    on_chunk=None,
    device="cuda",
) -> torch.Tensor:
    """Render ``settings.spp`` samples on ``device`` in chunks of
    ``chunk_spp``; returns the mean image (H, W, 3), a float32 CPU tensor.

    ``on_chunk(film)`` is called after every chunk with the running film
    (CPU tensors), the hook a live preview refreshes from."""
    h, w = settings.height, settings.width
    film = Film.zeros(h, w, device="cpu")
    if checkpoint_path:
        loaded = ckpt.load_film(checkpoint_path, settings)
        if loaded is not None:
            film = Film(radiance_sum=loaded[0], sample_count=torch.tensor(float(loaded[1])))

    chunk_idx = 0
    while int(film.sample_count) < settings.spp:
        done = int(film.sample_count)
        n = min(chunk_spp, settings.spp - done)
        timer = Timer()
        chunk = render_samples(scene, camera, settings, done, n, device=device).detach().cpu()
        stats = timer.stop(rays=w * h * n * settings.bounces)
        film = film.add_samples(chunk, n)
        done += n
        chunk_idx += 1
        if metrics_path:
            log_event(metrics_path, {"event": "chunk", "samples_done": done, "chunk_spp": n, **stats})
        if checkpoint_path and (chunk_idx % checkpoint_every == 0 or done >= settings.spp):
            ckpt.save_film(checkpoint_path, film.radiance_sum, done, settings)
        if on_chunk is not None:
            on_chunk(film)
    return film.to_image()
