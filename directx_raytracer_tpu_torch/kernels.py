"""The hand-written CUDA kernel library: its build, its binding and its
launches.

The sources in ``csrc/`` (the binning kernel, ``closest_hit``, ``any_hit``,
the precision micro's fold, the path tracer's keyed draws, the shadow
batch's keys and rays, and the wavefront compaction's keys and gather) are
compiled with nvcc on first use, one nvcc per source in parallel, into one
shared library in ``_build/`` next to this module, named by a hash of the
flags and the sources, and bound with ctypes.  The wrappers that own each
kernel's shapes and its plain torch twin live with their callers
(``bvh/cuda_intersect.py``, ``ops/draws.py``, ``ops/shading.py``,
``render/wavefront.py``, ``tools/precision_micro.py``); they validate their
operands with ``check_tensor`` and launch through ``launch``, which counts
each launch in ``utils.trace.COUNTS`` under ``launch.<kernel>``.  A CPU
tensor never reaches the library: the wrappers take their twins for it.

This module imports nothing of ``ops``, ``bvh`` or ``render``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .utils import trace

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("bin_clusters.cu", "closest_hit.cu", "any_hit.cu",
           "precision_micro.cu", "pt_draws.cu", "shadow_batch.cu", "compact.cu")
HEADERS = ("walk.cuh",)  # included by closest_hit.cu and any_hit.cu
# -Xptxas -v reports each kernel's registers, shared memory and spills into
# the build log.  No --use_fast_math: the kernels need IEEE divides and
# unflushed denormals.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libdxrt_kernels_{h.hexdigest()[:16]}.so"


def build_kernels() -> tuple[Path, float]:
    """Compile csrc/*.cu into one shared library unless the library for
    these exact sources and flags exists: one nvcc per source, all started
    together, then one link.  Returns (path, seconds spent building, 0.0 if
    nothing was built).  The compilers' output goes to the ``.log`` file
    beside the library."""
    so = _library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(CSRC / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for name, obj in zip(SOURCES, objs)]
    log = [f"{name}:\n{proc.communicate()[0]}"
           for name, proc in zip(SOURCES, procs)]
    failed = [name for name, proc in zip(SOURCES, procs) if proc.returncode]
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log.append(f"link:\n{link.stdout}{link.stderr}")
        if link.returncode:
            failed = ["link"]
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           + "\n".join(log))
    os.replace(tmp, so)
    return so, seconds


@functools.cache
def _lib() -> ctypes.CDLL:
    so, _ = build_kernels()
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dxrt_bin_lists.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.dxrt_bin_lists.restype = i
    lib.dxrt_closest_hit.argtypes = [p] * 13 + [i, i, i, i, i, f, i, p]
    lib.dxrt_closest_hit.restype = i
    lib.dxrt_any_hit.argtypes = [p] * 13 + [i, i, i, i, f, i, p]
    lib.dxrt_any_hit.restype = i
    lib.dxrt_precision_fold.argtypes = [p, p, p, i, i, p]
    lib.dxrt_precision_fold.restype = i
    u = ctypes.c_uint32
    lib.dxrt_pt_draws.argtypes = [p, i, u, u, u, u, i, i, i, i, i, p, p]
    lib.dxrt_pt_draws.restype = i
    lib.dxrt_shadow_keys.argtypes = [p, i, p, i, p, p, p, i, p, p, p]
    lib.dxrt_shadow_keys.restype = i
    lib.dxrt_shadow_rays.argtypes = ([p, i, p, i] + [p] * 6
                                     + [i, i, i, f, f] + [p] * 4)
    lib.dxrt_shadow_rays.restype = i
    lib.dxrt_compact_keys.argtypes = ([p, i, p, i, p] * 2 + [i, i] + [p] * 3
                                      + [i, i, p, p])
    lib.dxrt_compact_keys.restype = i
    lib.dxrt_compact_gather.argtypes = ([p, i, p, i, p, i, p] * 2 + [i, p, p, i, i]
                                        + [p] * 5)
    lib.dxrt_compact_gather.restype = i
    lib.dxrt_error_string.argtypes = [i]
    lib.dxrt_error_string.restype = ctypes.c_char_p
    return lib


def check_tensor(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's pointer operand must be."""
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_launch(lib: ctypes.CDLL, kernel: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib.dxrt_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")


def launch(kernel: str, entry: str, device, *args) -> None:
    """Call the library's ``entry`` with ``args`` and the current stream of
    ``device``, raise on the CUDA error it returns, else count the launch
    as ``launch.<kernel>`` ("bin_clusters" the binning kernel's dense mode,
    "bin_clusters_super" its superblock mode, "closest_hit_exec"
    closest_hit's counting build, "precision_micro.<variant>" the micro's
    fold); the plain twins never count."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    check_launch(lib, kernel, err)
    trace.count("launch." + kernel)
