"""PyTorch + CUDA port of gpupathtracer_tpu.

The JAX package (``gpupathtracer_tpu``) is the reference this package is held
against; module names mirror its layout so each counterpart is easy to find.
This package imports ``torch`` and never ``jax``. The four packed ray
searches (closest hit and any hit, resident and streamed) run as
hand-written CUDA kernels on Hopper (``csrc/``), each with a plain PyTorch
version beside it that CPU tensors use.

Covered so far: the render path that ``render_frame`` drives for all four
materials (emitter, diffuse, mirror, glass), with the naive, NEE and MIS
estimators, Russian roulette, checker and image textures, the normal AOVs
and the three compaction modes, on resident and streamed packs; its
gradients and the config 5 trainer; progressive and checkpointed rendering,
the live preview and the command line (``python -m
gpupathtracer_tpu_torch.cli``). The BVH and brute intersectors, threefry,
the edge-sampled boundary term and the multi-device renderers raise
``NotImplementedError`` or are not ported yet.
"""
