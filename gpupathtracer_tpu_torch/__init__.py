"""PyTorch + CUDA port of gpupathtracer_tpu.

The JAX package (``gpupathtracer_tpu``) is the reference this package is held
against; module names mirror its layout so each counterpart is easy to find.
This package imports ``torch`` and never ``jax``. The four packed ray
searches (closest hit and any hit, resident and streamed) run as
hand-written CUDA kernels on Hopper (``csrc/``), each with a plain PyTorch
version beside it that CPU tensors use.

Covered so far: the render path that ``render_frame`` drives for emitter
and diffuse materials, with the naive, NEE and MIS estimators and checker
and image textures, on resident and streamed packs. Options outside it
raise ``NotImplementedError``.
"""
