"""ctypes binding for the native PNG writer (io/csrc/fast_image.c).

The reference writes renders through native C (vendored
``stb_image_write.h``; ``HW1/src/render.cpp:119-125``,
``GPUandCPU/src/main.cu:426-433``); this is the framework's native
equivalent, built on demand with the system C compiler like
``io.fast_obj``.  Quantization stays in Python (dialect-specific
255.99f rules), so decoded pixels are byte-identical to the Pillow
fallback — tests assert the round trip.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["write_png_native", "native_available"]

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "fast_image.c")
_LIB_PATH = os.path.join(os.path.dirname(__file__), "csrc", "_fast_image.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        try:
            return ctypes.CDLL(_LIB_PATH)
        except OSError:
            pass  # corrupt/ABI-stale cache: fall through and rebuild
    for cc in ("cc", "gcc", "clang"):
        # compile to a private temp file then os.replace (atomic on
        # POSIX), so concurrent processes never load a half-written .so
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                [cc, "-O2", "-fPIC", "-shared", "-o", tmp, _SRC],
                check=True, capture_output=True,
            )
            os.replace(tmp, _LIB_PATH)
            return ctypes.CDLL(_LIB_PATH)
        except (OSError, subprocess.CalledProcessError):
            continue
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
    _build_failed = True
    return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = _build()
            if lib is not None:
                lib.fi_write_png_rgb8.restype = ctypes.c_int
                lib.fi_write_png_rgb8.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_ubyte),
                ]
            _lib = lib
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def write_png_native(path: str, data: np.ndarray) -> bool:
    """Write (H, W, 3) uint8 pixels as PNG via the native writer.

    Returns False (caller falls back to Pillow) when no C compiler is
    available or the write fails.
    """
    lib = _get_lib()
    if lib is None:
        return False
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    h, w, c = arr.shape
    assert c == 3
    rc = lib.fi_write_png_rgb8(
        path.encode(), int(w), int(h),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return rc == 0
