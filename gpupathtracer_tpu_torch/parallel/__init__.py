"""Multi-process rendering over ``torch.distributed``.

Counterpart of ``gpupathtracer_tpu/parallel/``: a process mesh with
``("data", "scene")`` axes (``mesh.py``), process-group set-up and frame
assembly (``multihost.py``), the distributed renderer (``render.py``):
pixels shard over ``data``, triangle rows over ``scene``, and a frame equals
``render_frame``'s on every rank; and the staged wavefront
(``pipeline.py``): bounce k on stage k of a ``("pipe",)`` mesh, equal to
``render_frame``'s too.
"""
