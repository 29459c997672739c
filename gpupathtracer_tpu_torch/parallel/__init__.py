"""Multi-process rendering over ``torch.distributed``.

Counterpart of ``gpupathtracer_tpu/parallel/``: a process mesh with
``("data", "scene")`` axes (``mesh.py``), process-group set-up and frame
assembly (``multihost.py``), and the distributed renderer (``render.py``):
pixels shard over ``data``, triangle rows over ``scene``, and a frame equals
``render_frame``'s on every rank.
"""
