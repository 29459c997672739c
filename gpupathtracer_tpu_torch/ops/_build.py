"""Builds and loads the port's CUDA kernel libraries.

Each kernel source in ``csrc/`` (``closest_hit.cu``, ``occlusion.cu``,
``closest_hit_streamed.cu``, ``occlusion_streamed.cu``; all include
``stream_stage.cuh``, which includes ``decision.cuh``) has a plain C
interface. ``nvcc`` compiles it for Hopper (``sm_90a``) into its own
shared library in ``gpupathtracer_tpu_torch/build/`` at first use, and the
library is loaded with ``ctypes``. The file name carries a hash of the
source, the shared headers and the flags, so an edit rebuilds. Nothing is
built or loaded when this module is imported.

The host library ``csrc/firefly_native.cpp`` (the OBJ parser, BVH builder
and edge-table builder of ``native.py``) is built the same way by the host
C++ compiler (``build_host``), with ``-ffp-contract=off`` so that no sum is
fused into a multiply-add the Python builders do not make.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
HEADERS = [os.path.join(CSRC, "decision.cuh"), os.path.join(CSRC, "stream_stage.cuh")]
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# Kernel name -> its launch function's argument types: device pointers (w
# and its bf16 operands w_hi and w_lo among them; K3 also init_t, init_i
# and done; K1 and K3 last the test counter, null for none), then rt, nb
# (resident) or rt, nc, bpc (streamed), then tb, ray_tile, groups, rays a
# thread or m-tiles a warp, the precision, for K3 its traversal modes
# (modes, budget, subtiles, fresh), then the stream.
KERNELS = {
    "closest_hit": [_P] * 10 + [_I] * 7 + [_P],
    "occlusion": [_P] * 8 + [_I] * 7 + [_P],
    "closest_hit_streamed": [_P] * 14 + [_I] * 12 + [_P],
    "occlusion_streamed": [_P] * 9 + [_I] * 8 + [_P],
}
# Every library also exports ``<name>_occupancy``: resident CTAs per SM at
# a launch shape, -1 if the kernel does not take it. It takes the launch's
# ray_tile, groups, rays a thread or m-tiles a warp, precision (and for K3
# modes) ints; here, their count.
OCCUPANCY = {"closest_hit": 4, "occlusion": 4, "closest_hit_streamed": 5, "occlusion_streamed": 4}


HOST_SOURCE = os.path.join(CSRC, "firefly_native.cpp")
HOST_CXX = "c++"
# No -march=native: the library's name keys on the source and the flags,
# not on the CPU, and the build directory may be carried to another host.
HOST_CXX_FLAGS = ["-O3", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17", "-Wall"]


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        # CUDA_HOME / CUDA_PATH, else the toolkit's default install location.
        from torch.utils.cpp_extension import CUDA_HOME

        path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source(name)] + HEADERS:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=tuple(KERNELS)) -> dict[str, str]:
    """Compile the named kernel libraries into ``BUILD_DIR``, one ``nvcc``
    per source, all started together. Returns ptxas's resource report
    (registers, shared memory, spills) per name; raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    try:
        for name in names:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, source(name)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            jobs[name] = (proc, tmp)
        reports, failed = {}, []
        for name, (proc, tmp) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {source(name)} failed with code {proc.returncode}:\n{err}")
            else:
                os.replace(tmp, library_path(name))  # atomic: no reader sees a partial file
                reports[name] = err
        if failed:
            raise RuntimeError("\n".join(failed))
        return reports
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if it is missing."""
    path = library_path(name)
    if not os.path.exists(path):
        build((name,))
    lib = ctypes.CDLL(path)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = KERNELS[name]
    launch.restype = ctypes.c_int
    errstr = getattr(lib, f"{name}_error_string")
    errstr.argtypes = [ctypes.c_int]
    errstr.restype = ctypes.c_char_p
    occupancy = getattr(lib, f"{name}_occupancy")
    occupancy.argtypes = [_I] * OCCUPANCY[name]
    occupancy.restype = ctypes.c_int
    return lib


def host_library_path() -> str:
    h = hashlib.sha256(" ".join([HOST_CXX, *HOST_CXX_FLAGS]).encode())
    with open(HOST_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfirefly_native-{h.hexdigest()[:16]}.so")


def build_host() -> str:
    """Compile ``csrc/firefly_native.cpp`` with the host C++ compiler into
    ``BUILD_DIR`` (to a temporary name, then moved into place, so processes
    building at once never load a partial file). Returns the library's path;
    raises RuntimeError with the compiler's message if the build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([HOST_CXX, *HOST_CXX_FLAGS, "-o", tmp, HOST_SOURCE],
                                  capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"{HOST_CXX} could not be run to build {HOST_SOURCE}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{HOST_CXX} {HOST_SOURCE} failed with code {proc.returncode}:\n{proc.stderr}")
        path = host_library_path()
        os.replace(tmp, path)
        return path
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
