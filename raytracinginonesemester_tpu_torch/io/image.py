"""Image output/input: PNG quantization + a PPM P6 (binary) codec.

PNG quantization reproduces the three encodings used by the reference:

- HW1: ``255.99f * c`` with clamp-above-1 only (``HW1/src/render.cpp:119-124``
  after ``clamp`` in ``HW1/include/raytracer.h:12-18``),
- CPUOnly: full [0,1] clamp then ``255.99f * c``
  (``CPUOnly/src/render.cpp:157-163``),
- GPUandCPU: ``255.0f * min(c, 1)`` (``GPUandCPU/src/main.cu:426-430``).

The PPM P6 codec is a re-implementation of the reference's standalone
``ppm_p6`` library (``HW1/ppm_p6_lib/include/ppm_p6.hpp:36-87``, impl
``src/ppm_p6.cpp:128-372``): 8-bit and 16-bit (MSB-first) maxval, optional
gamma-2 (sqrt) encode, optional vertical flip, and a comment-tolerant header
parser on read.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

__all__ = [
    "quantize",
    "write_png",
    "read_png",
    "write_ppm_p6",
    "read_ppm_p6",
]


def quantize(image: np.ndarray, mode: str = "cpuonly") -> np.ndarray:
    """Linear float RGB (H, W, 3) in [0,1]-ish -> uint8.

    ``mode``:
      - ``"cpuonly"``/``"hw1"``: clamp to [0,1] then ``255.99 * c``
        (HW1 only clamps above, but negative radiance never occurs there,
        so a single clamped implementation covers both).
      - ``"gpu"``: ``255.0 * min(c, 1)``.
    """
    img = np.asarray(image, dtype=np.float32)
    if mode in ("cpuonly", "hw1"):
        c = np.clip(img, 0.0, 1.0)
        return (255.99 * c).astype(np.uint8)
    if mode == "gpu":
        c = np.minimum(img, 1.0)
        return (255.0 * c).astype(np.uint8)
    raise ValueError(f"unknown quantize mode: {mode!r}")


def write_png(path: str, image: np.ndarray, mode: str = "cpuonly") -> None:
    """Write a linear float (H, W, 3) image as PNG (stb_image_write analog).

    Encoding goes through the native C writer (``io.fast_image``, the
    analog of the reference's vendored stb) when a compiler is
    available, else Pillow — decoded pixels are byte-identical either
    way (quantization happens here in Python in both cases).
    """
    data = image if image.dtype == np.uint8 else quantize(image, mode)
    from .fast_image import write_png_native

    if write_png_native(path, data):
        return
    from PIL import Image

    Image.fromarray(data, mode="RGB").save(path)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced RGB or RGBA PNG as (H, W, 3) uint8,
    with zlib and numpy only (the goldens' format; anything else
    raises)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, colour "
                         f"type {ctype}, interlace {interlace})")
    bpp = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.int32)
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):  # undo the per-row filters (PNG spec 9.2)
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros_like(line)
            for i in range(w * bpp):
                a = cur[i - bpp] if i >= bpp else 0
                c = prev[i - bpp] if i >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + prev[i]) // 2
                elif ftype == 4:
                    p = a + prev[i] - c
                    pa, pb, pc = abs(p - a), abs(p - prev[i]), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        prev[i] if pb <= pc else c)
                else:
                    raise ValueError(f"{path}: bad filter type {ftype}")
                cur[i] = (line[i] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.reshape(h, w, bpp)[..., :3].astype(np.uint8)


# ----------------------------------------------------------------------
# PPM P6
# ----------------------------------------------------------------------


def _float_to_sample(linear: np.ndarray, maxval: int, clamp: bool, gamma2: bool) -> np.ndarray:
    """Vectorized ``float_to_sample`` (``ppm_p6.cpp:136-154``)."""
    x = np.asarray(linear, dtype=np.float64)
    if gamma2:
        x = np.sqrt(np.maximum(x, 0.0))
    if clamp:
        x = np.clip(x, 0.0, 1.0)
    scaled = np.rint(x * float(maxval))  # lround = round-half-away; rint is
    # round-half-even, which differs only on exact .5 ties of the float64
    # product — practically unreachable from f32 radiance inputs.
    return np.clip(scaled, 0, maxval).astype(np.uint16)


def write_ppm_p6(
    path: str,
    image: np.ndarray,
    maxval: int = 255,
    clamp: bool = True,
    gamma2: bool = True,
    flip_y: bool = False,
) -> None:
    """Write linear float RGB (H, W, 3) as binary PPM P6.

    Matches ``ppm_p6::write_p6`` (``ppm_p6.cpp:257-...``): 8-bit when
    ``maxval < 256`` else 16-bit MSB-first; ``gamma2`` applies sqrt before
    scaling; ``flip_y`` writes rows bottom-to-top.
    """
    img = np.asarray(image)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("image must be (H, W, 3)")
    if not (1 <= maxval <= 65535):
        raise ValueError("maxval must be in [1, 65535]")
    samples = _float_to_sample(img, maxval, clamp, gamma2)
    if flip_y:
        samples = samples[::-1]
    h, w, _ = samples.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n{maxval}\n".encode("ascii"))
        if maxval < 256:
            f.write(samples.astype(np.uint8).tobytes())
        else:
            f.write(samples.astype(">u2").tobytes())


_TOKEN_RE = re.compile(rb"(?:\s|#[^\n]*\n)*([^\s#]+)")


def read_ppm_p6(path: str) -> Tuple[np.ndarray, int]:
    """Read a binary PPM P6; returns (linear float64 (H, W, 3) in [0,1], maxval).

    Header parsing skips whitespace and ``#`` comments anywhere between
    tokens, like ``ppm_p6::read_p6`` (``ppm_p6.cpp:22-127``).  Samples are
    normalized by ``maxval`` (``sample_to_float``, ``ppm_p6.cpp:157-159``);
    no gamma decode is applied (matching the reference).
    """
    with open(path, "rb") as f:
        data = f.read()

    pos = 0
    tokens = []
    while len(tokens) < 4:
        m = _TOKEN_RE.match(data, pos)
        if not m:
            raise ValueError(f"{path}: truncated PPM header")
        tokens.append(m.group(1))
        pos = m.end()
    if tokens[0] != b"P6":
        raise ValueError(f"{path}: not a P6 file (magic {tokens[0]!r})")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if w <= 0 or h <= 0 or not (1 <= maxval <= 65535):
        raise ValueError(f"{path}: bad PPM header {w}x{h} maxval={maxval}")
    # Exactly one whitespace byte separates the header from binary data.
    body = data[pos + 1 :]
    count = w * h * 3
    if maxval < 256:
        raw = np.frombuffer(body, dtype=np.uint8, count=count)
    else:
        raw = np.frombuffer(body, dtype=">u2", count=count)
    img = raw.reshape(h, w, 3).astype(np.float64) / float(maxval)
    return img, maxval
