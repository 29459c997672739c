"""PyTorch + CUDA port of gpupathtracer_tpu.

The JAX package (``gpupathtracer_tpu``) is the reference this package is held
against; module names mirror its layout so each counterpart is easy to find.
This package imports ``torch`` and never ``jax``. The four packed ray
searches (closest hit and any hit, resident and streamed) run as
hand-written CUDA kernels on Hopper (``csrc/``), each with a plain PyTorch
version beside it that CPU tensors use; the host builders (OBJ, BVH, edge
table) are C++ (``csrc/firefly_native.cpp``, ``native.py``).

Covered: the render path that ``render_frame`` drives for all four
materials (emitter, diffuse, mirror, glass), with the naive, NEE and MIS
estimators, Russian roulette, checker and image textures, the normal AOVs
and the three compaction modes, on resident and streamed packs, or with
the brute and BVH intersectors; its gradients, the edge-sampled boundary
term and the trainers; progressive and checkpointed rendering, the live
preview and the command line (``python -m gpupathtracer_tpu_torch.cli``);
and the multi-process renderer over ``torch.distributed``
(``parallel/``). Not ported yet: the pipelined demo
(``parallel/pipeline.py``) and the benchmark.
"""

__version__ = "0.1.0"

from gpupathtracer_tpu_torch.models.camera import Camera  # noqa: F401
from gpupathtracer_tpu_torch.models.materials import BxdfType, MaterialTable  # noqa: F401
from gpupathtracer_tpu_torch.models.scene import TriangleScene  # noqa: F401
