"""Build and load the hand-written CUDA kernels (``csrc/megakernel.cu``).

The source is compiled with ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds.  The build happens at first use, into ``build/`` beside the
package (``RT_TORCH_BUILD_DIR`` overrides), under a name that hashes the
source and the flags, so an edited source never loads a stale library.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["NVCC_FLAGS", "SceneArgs", "build", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "megakernel.cu")

# exact IEEE division/sqrt and no FMA contraction: the kernels keep the
# op order of the plain versions and of the JAX reference
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None
BUILD_LOG = {"seconds": None, "ptxas": "", "path": None}


class SceneArgs(ctypes.Structure):
    """Mirror of ``struct SceneArgs`` in ``megakernel.cu``: pointers
    first, then ints, then floats (natural alignment on both sides)."""

    _fields_ = [
        ("cam", ctypes.c_void_p),
        ("lights", ctypes.c_void_p),
        ("mats", ctypes.c_void_p),
        ("tri", ctypes.c_void_p),
        ("norm", ctypes.c_void_p),
        ("ids", ctypes.c_void_p),
        ("obj", ctypes.c_void_p),
        ("aabb", ctypes.c_void_p),
        ("cand_meta", ctypes.c_void_p),
        ("cand_stream", ctypes.c_void_p),
        ("n_lights", ctypes.c_int),
        ("n_objects", ctypes.c_int),
        ("num_blocks", ctypes.c_int),
        ("block_size", ctypes.c_int),
        ("diffuse_bounce", ctypes.c_int),
        ("cpuonly", ctypes.c_int),
        ("shadow_samples", ctypes.c_int),
        ("cand_chunk", ctypes.c_int),
        ("det_eps", ctypes.c_float),
        ("tmin", ctypes.c_float),
        ("shadow_eps", ctypes.c_float),
        ("shadow_tmin", ctypes.c_float),
    ]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def build() -> str:
    """Compile ``megakernel.cu`` (if not already built) and return the
    path of the shared library."""
    import time

    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    out_dir = os.environ.get("RT_TORCH_BUILD_DIR",
                             os.path.join(os.path.dirname(_PKG), "build"))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"librt_megakernel_{digest.hexdigest()[:12]}.so")
    BUILD_LOG["path"] = path
    if os.path.exists(path):
        BUILD_LOG["seconds"] = 0.0
        return path
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.time()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    BUILD_LOG["seconds"] = time.time() - t0
    BUILD_LOG["ptxas"] = proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    return path


def load():
    """The loaded kernel library with its argtypes declared."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        vp, i, sp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(SceneArgs)
        lib.rt_emit.argtypes = [sp, vp, vp, vp, i, i, i, i, vp, vp, vp]
        lib.rt_bounce_step.argtypes = [sp, vp, vp, i, i, vp, vp, vp]
        lib.rt_resume.argtypes = [sp, vp, vp, i, i, i, vp, vp, vp, vp]
        lib.rt_render.argtypes = [sp, vp, vp, vp, i, i, i, i, i, i, i,
                                  vp, vp, vp, vp]
        lib.rt_closest.argtypes = [sp, vp, vp, vp, i, i, vp, i, vp, vp, vp,
                                   vp, vp, vp, vp]
        lib.rt_occluded.argtypes = [sp, vp, vp, vp, vp, i, vp, vp]
        for fn in (lib.rt_emit, lib.rt_bounce_step, lib.rt_resume,
                   lib.rt_render, lib.rt_closest, lib.rt_occluded):
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib
