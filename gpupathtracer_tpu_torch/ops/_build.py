"""Builds and loads the port's CUDA kernel libraries.

Each kernel source in ``csrc/`` (the searches ``closest_hit.cu``,
``occlusion.cu``, ``closest_hit_streamed.cu``, ``occlusion_streamed.cu``,
which all include ``stream_stage.cuh``, which includes ``decision.cuh``; the
PCG sampler's ``pcg.cu`` and the naive shade step's ``shade.cu``, which both
include ``pcg.cuh``; the searches' schedule ``schedule.cu``) has a plain C
interface. ``nvcc`` compiles it for
Hopper (``sm_90a``) into its own shared library in
``gpupathtracer_tpu_torch/build/`` at first use, and the library is loaded
with ``ctypes``. The file name carries a hash of the source, the shared
headers it includes and the flags, so an edit rebuilds. Nothing is built or
loaded when this module is imported.

The host library ``csrc/firefly_native.cpp`` (the OBJ parser, BVH builder
and edge-table builder of ``native.py``) is built the same way by the host
C++ compiler (``build_host``), with ``-ffp-contract=off`` so that no sum is
fused into a multiply-add the Python builders do not make.

Every kernel launch of the port goes through ``launch``, which counts it in
``launch_counts``, and every tensor a kernel takes is checked by ``check``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
HEADERS = [os.path.join(CSRC, "decision.cuh"), os.path.join(CSRC, "stream_stage.cuh")]
PCG_HEADER = os.path.join(CSRC, "pcg.cuh")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I, _I64, _U32, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32, ctypes.c_float
# Library name -> its launch functions -> their argument types. A search
# has one: device pointers (w and its bf16 operands w_hi and w_lo among
# them; K3 also init_t, init_i and done; K1, K3 and K4 last the test
# counter, null for none), then rt, nb (resident) or rt, nc, bpc (streamed), then tb,
# ray_tile, groups, rays a thread or m-tiles a warp, the precision, for K3
# its traversal modes (modes, budget, subtiles, fresh), then the stream.
# The PCG sampler's ``pcg.cu`` has three: input and output pointers, the
# lane count, the seed, sample and stream words as unsigned 32-bit ints or
# the draw's word count, then the stream. The shade step's ``shade.cu`` has
# one: o and its row stride, 18 more input and 7 output pointers, the lane
# count, the background's three floats, the bounce, the flags, the stream.
# The schedule's ``schedule.cu`` has one: o and its row stride, d, the lane
# input and its kind, the three block inputs, 7 output pointers and the
# sort's scratch, the lane count, rt, ray_tile, nb, bpc, the stream.
LAUNCHES = {
    "closest_hit": {"closest_hit_launch": [_P] * 10 + [_I] * 7 + [_P]},
    "occlusion": {"occlusion_launch": [_P] * 8 + [_I] * 7 + [_P]},
    "closest_hit_streamed": {"closest_hit_streamed_launch": [_P] * 14 + [_I] * 12 + [_P]},
    "occlusion_streamed": {"occlusion_streamed_launch": [_P] * 10 + [_I] * 8 + [_P]},
    "pcg": {
        "pcg_path_keys_launch": [_P, _P, _I64, _U32, _U32, _P],
        "pcg_fold_launch": [_P, _P, _I64, _U32, _P],
        "pcg_uniform_launch": [_P, _P, _I64, _I, _P],
    },
    "shade": {"shade_naive_launch": [_P, _I64] + [_P] * 25 + [_I64, _F, _F, _F, _U32, _I, _P]},
    "schedule": {"tile_schedule_launch": [_P, _I64, _P, _P, _I] + [_P] * 11 + [_I64, _I, _I, _I, _I, _P]},
}
PCG = "pcg"
SHADE = "shade"
SCHEDULE = "schedule"
# The searches, which include HEADERS, also export ``<name>_occupancy``:
# resident CTAs per SM at a launch shape, -1 if the kernel does not take it.
# It takes the launch's ray_tile, groups, rays a thread or m-tiles a warp,
# precision (and for K3 modes) ints; here, their count. ``pcg.cu``,
# ``shade.cu`` and ``schedule.cu`` include none of HEADERS, so they build in
# seconds and an edit to the searches does not rebuild them.
OCCUPANCY = {"closest_hit": 4, "occlusion": 4, "closest_hit_streamed": 5, "occlusion_streamed": 4}
# Kernel launches made so far in this process, by library (``launch``).
launch_counts = dict.fromkeys(LAUNCHES, 0)
# The shared headers each library includes, and the flags it adds to
# NVCC_FLAGS: the shade step is built without contracting a product and a
# sum into one fused multiply-add, so that each float operation rounds as
# the torch op it replaces does.
INCLUDES = {**{name: HEADERS for name in OCCUPANCY}, PCG: [PCG_HEADER], SHADE: [PCG_HEADER]}
EXTRA_FLAGS = {SHADE: ["-fmad=false"]}


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


def flags(name: str) -> list[str]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for path in [source(name)] + INCLUDES.get(name, []):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=tuple(LAUNCHES)) -> dict[str, str]:
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
                [nvcc, *flags(name), "-Xptxas", "-v", "-o", tmp, source(name)],
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
    for fn, argtypes in LAUNCHES[name].items():
        launch = getattr(lib, fn)
        launch.argtypes = argtypes
        launch.restype = ctypes.c_int
    if name in OCCUPANCY:
        occupancy = getattr(lib, f"{name}_occupancy")
        occupancy.argtypes = [_I] * OCCUPANCY[name]
        occupancy.restype = ctypes.c_int
    errstr = getattr(lib, f"{name}_error_string")
    errstr.argtypes = [ctypes.c_int]
    errstr.restype = ctypes.c_char_p
    return lib


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call launch function ``fn`` of kernel library ``name`` with ``args``
    (a tensor passes its data pointer, None a null pointer) and the current
    stream of ``device``, making ``device`` current for the call if it is
    not; count the launch in ``launch_counts[name]``. Raises RuntimeError
    with the library's message if CUDA refused the launch."""
    lib = library(name)
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = getattr(lib, fn)(*args, stream)
    else:
        with torch.cuda.device(device):
            err = getattr(lib, fn)(*args, stream)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")
    launch_counts[name] += 1


def check(kernel: str, x: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple, device=None,
          aligned: bool = False) -> None:
    """Raise ValueError unless ``x`` is what ``kernel`` takes as ``what``: a
    contiguous ``dtype`` tensor of ``shape`` (a None entry: any size), on
    ``device`` unless that is None, starting on a 16-byte boundary if
    ``aligned`` (the kernels read such tensors in 16-byte pieces)."""
    if x.dtype != dtype or x.dim() != len(shape) or any(s is not None and s != n for s, n in zip(shape, x.shape)):
        want = str(tuple("N" if s is None else s for s in shape)).replace("'", "")
        raise ValueError(f"{kernel}: {what} must be {str(dtype).removeprefix('torch.')} {want}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {what} must be contiguous")
    if device is not None and x.device != device:
        raise ValueError(f"{kernel}: every tensor must be on {device}, {what} is on {x.device}")
    if aligned and x.data_ptr() % 16:
        raise ValueError(f"{kernel}: {what} must start on a 16-byte boundary")


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
