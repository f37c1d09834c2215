"""Reference of the render cells: the radiance of sampled pixels of the
frames that the timed window rendered, and the comparison that decides
``correct``.

A sample is (sample index, x, y): frame f of a call that started at
sample index s is sample s + f of every pixel.  The reference traces each
sampled pixel anew from the scene's files, by brute force
(``tracer.py``).
"""

from __future__ import annotations

import torch

from . import tracer

# a channel value off by more than this counts as bad: two steps of an
# 8-bit image
BAD_STEP = 2.0 / 255.0


def pixels(arrays, samples, jitter: str, device, dtype=torch.float32,
           block: int = 16384) -> torch.Tensor:
    """Radiance (N, 3) float32 on the host of ``samples`` (int64 (N, 3):
    sample index, x, y), computed in ``dtype``."""
    sc = tracer.scene_tensors(arrays, device, dtype)
    out = []
    with torch.no_grad():
        for a in range(0, samples.shape[0], block):
            s, x, y = samples[a:a + block].to(device).unbind(1)
            o, d, seeds = tracer.pixel_rays(sc, x, y, s, jitter)
            out.append(tracer.trace(sc, o, d, seeds).float().cpu())
    return torch.cat(out)


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The numbers compared: ``bad_share``, the share of channel values
    off by more than two 8-bit steps, and ``mean_abs``, the mean absolute
    difference; a NaN counts as off."""
    diff = (got.float() - want.float()).abs()
    return {"bad_share": float((~(diff <= BAD_STEP)).float().mean()),
            "mean_abs": float(diff.mean())}
