"""Progressive and resumable forward rendering.

Port of ``raytracinginonesemester_tpu.render.progressive``.  The
reference renders one-shot (``query.cu:39-65``); here ``spp`` renders in
chunks of ``chunk`` samples, the running radiance SUM is kept on the
host, and (accumulator, next sample) can be persisted after every chunk
so that an interrupted render resumes where it stopped.

Sample seeds are absolute (``make_rng_seed(x, y, sample)``,
``query.h:44-48``) through ``render_scene``'s ``sample_offset``, so the
image does not depend on the chunking; with ``chunk=1`` the host adds
replay the one-shot render's accumulation order, so the result equals
``render_scene(scene)`` at the same spp bit for bit.  Larger chunks
reassociate the float32 sums and match to about an ulp.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np

from .renderer import DEFAULT_RAY_TILE, render_scene

__all__ = ["render_progressive", "save_render_state", "load_render_state"]

_STATE_FILE = "render_state.npz"


def save_render_state(directory: str, accum: np.ndarray,
                      next_sample: int) -> str:
    """Persist the progressive accumulator; returns the file path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _STATE_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # write, then rename into place
        np.savez(f, accum=accum, next_sample=np.int64(next_sample))
    os.replace(tmp, path)
    return path


def load_render_state(directory: str) -> Optional[Tuple[np.ndarray, int]]:
    """Load (accum, next_sample), or None if no state exists."""
    path = os.path.join(directory, _STATE_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return z["accum"].copy(), int(z["next_sample"])


def render_progressive(
    scene,
    spp: Optional[int] = None,
    chunk: int = 1,
    jitter_mode: str = "auto",
    ray_tile: int = DEFAULT_RAY_TILE,
    state_dir: Optional[str] = None,
    on_chunk: Optional[Callable[[int, np.ndarray], None]] = None,
) -> np.ndarray:
    """Render ``spp`` samples (default ``scene.spp``) in ``chunk``-sample
    calls on the scene's device -> the normalized (H, W, 3) float32
    image (numpy).

    ``state_dir`` enables resume: the accumulator is persisted after
    every chunk, and a new call with the same ``state_dir`` continues
    after the last completed chunk.  ``on_chunk(done_spp, preview)`` is
    called after each chunk with the current normalized preview."""
    total = int(scene.spp if spp is None else spp)
    if total <= 0:
        raise ValueError(f"spp must be positive, got {total}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")

    accum, start = None, 0
    if state_dir is not None:
        state = load_render_state(state_dir)
        if state is not None:
            accum, start = state
            if start >= total:  # already complete at this spp
                return accum / np.float32(total)

    s = start
    while s < total:
        c = min(chunk, total - s)
        part = render_scene(scene, jitter_mode=jitter_mode, ray_tile=ray_tile,
                            spp_override=c, sample_offset=s,
                            normalize=False).cpu().numpy()
        accum = part if accum is None else accum + part
        s += c
        if state_dir is not None:
            save_render_state(state_dir, accum, s)
        if on_chunk is not None:
            on_chunk(s, accum / np.float32(s))
    return accum / np.float32(total)
