"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds.  ``megakernel.cu`` holds kernels A-F, ``block_stream.cu`` the
streamed kernels G, I and H, ``segment_accum.cu`` kernel J, ``probes.cu``
the TPU probes P1-P3 (``probes/``); the first two include
``trace_common.cuh``.  The build happens at first use, into
``build/`` beside the package (``RT_TORCH_BUILD_DIR`` overrides), under a
name that hashes the source, the shared headers and the flags, so an
edited source never loads a stale library;
``build_all`` starts one ``nvcc`` per source at once.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["NVCC_FLAGS", "SOURCES", "SceneArgs", "build", "build_all", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("megakernel", "block_stream", "segment_accum", "probes")

# exact IEEE division/sqrt and no FMA contraction: the kernels keep the
# op order of the plain versions and of the JAX reference
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS = {}
# per source: build seconds (0.0 when cached), ptxas output, library path
BUILD_LOG = {name: {"seconds": None, "ptxas": "", "path": None}
             for name in SOURCES}


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


def _target(name: str):
    """(source path, library path) of one kernel source."""
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}")
    csrc = os.path.join(_PKG, "csrc")
    src = os.path.join(csrc, f"{name}.cu")
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(csrc, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    out_dir = os.environ.get("RT_TORCH_BUILD_DIR",
                             os.path.join(os.path.dirname(_PKG), "build"))
    os.makedirs(out_dir, exist_ok=True)
    return src, os.path.join(out_dir,
                             f"librt_{name}_{digest.hexdigest()[:12]}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every source in ``names`` that is not built yet, one
    ``nvcc`` process each, all started together -> {name: library path}."""
    procs, paths = {}, {}
    t0 = time.time()
    for name in names:
        src, path = _target(name)
        paths[name] = path
        BUILD_LOG[name]["path"] = path
        if os.path.exists(path):
            if BUILD_LOG[name]["seconds"] is None:
                BUILD_LOG[name]["seconds"] = 0.0  # built before this process
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        BUILD_LOG[name]["seconds"] = time.time() - t0
        BUILD_LOG[name]["ptxas"] = err
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc failed ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, paths[name])  # atomic: no reader sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(name: str = "megakernel") -> str:
    """Compile ``csrc/<name>.cu`` (if not already built) and return the
    path of its shared library."""
    return build_all((name,))[name]


def _declare(name: str, lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "megakernel":
        sp = ctypes.POINTER(SceneArgs)
        lib.rt_emit.argtypes = [sp, vp, vp, vp, i, i, i, i, vp, vp, vp, vp,
                                vp, vp, i, vp]
        lib.rt_bounce_step.argtypes = [sp, vp, vp, i, i, vp, vp, vp, vp]
        lib.rt_resume.argtypes = [sp, vp, vp, i, i, i, vp, vp, vp, vp]
        lib.rt_render.argtypes = [sp, vp, vp, vp, i, i, i, i, i, i, i,
                                  vp, vp, vp, vp]
        lib.rt_closest.argtypes = [sp, vp, vp, vp, i, i, vp, i, vp, vp, vp,
                                   vp, vp, vp, vp, vp, vp, vp]
        lib.rt_occluded.argtypes = [sp, vp, vp, vp, vp, i, vp, vp, vp, vp]
        lib.rt_bounce_groups.argtypes = [vp, vp]
        lib.rt_binned_chunks.argtypes = [vp, vp]
        lib.rt_fused_fits.argtypes = [i, i, i, i, i, vp]
        fns = (lib.rt_emit, lib.rt_bounce_step, lib.rt_resume,
               lib.rt_render, lib.rt_closest, lib.rt_occluded,
               lib.rt_bounce_groups, lib.rt_binned_chunks, lib.rt_fused_fits)
    elif name == "block_stream":
        f = ctypes.c_float
        lib.rt_streamed.argtypes = [vp] * 8 + [i] * 5 + [f, i] + [vp] * 6
        lib.rt_blockmajor.argtypes = ([vp] * 7 + [i] * 7 + [f, i]
                                      + [vp] * 6)
        fns = (lib.rt_streamed, lib.rt_blockmajor)
    elif name == "segment_accum":
        lib.rt_segment_accum.argtypes = [vp, vp, vp, vp, i, i, i, vp, vp, vp]
        fns = (lib.rt_segment_accum,)
    else:
        lib.rt_toy_mask.argtypes = [i, vp, vp, i, i, i, i, vp, vp]
        lib.rt_probe_floor.argtypes = [i, i, i, vp]
        lib.rt_sel7.argtypes = [vp, vp, i, i, i, vp, vp]
        lib.rt_mm22.argtypes = [vp, vp, i, i, i, i, vp, vp, vp, i, vp]
        lib.rt_dyn_reads.argtypes = [i, vp, i, i, vp, vp]
        fns = (lib.rt_toy_mask, lib.rt_probe_floor, lib.rt_sel7, lib.rt_mm22,
               lib.rt_dyn_reads)
    for fn in fns:
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p


def load(name: str = "megakernel"):
    """The loaded library of ``csrc/<name>.cu`` with its argtypes
    declared."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(build(name))
            _declare(name, lib)
            _LIBS[name] = lib
        return _LIBS[name]
