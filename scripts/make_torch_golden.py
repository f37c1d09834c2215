"""Render the reference images that ``chip_smoke.py`` holds the PyTorch
port's card renders against.

Runs the JAX package on the CPU in Pallas interpret mode, on the
two-frog test scene (``tests/_torch_parity.py``) at 128x64, frames 0 and
1 (sample offsets 0 and 1, spp 1):

- ``tests/goldens/torch_two_frog_128x64.npy``: depth 3, diffuse bounces,
  through ``render_tiles_wavefront_frames`` (the staged wavefront);
- ``tests/goldens/torch_two_frog_terminal_128x64.npy``: diffuse off (a
  terminal scene: primary hit and direct light only), through the
  monolithic ``render_tiles``.

Each is (2, 64, 128, 3) float32.

    python scripts/make_torch_golden.py
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("RT_BLOCK_SIZE", "128")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np  # noqa: E402

from _torch_parity import jax_two_frog  # noqa: E402
from raytracinginonesemester_tpu.ops.megakernel import render_tiles  # noqa: E402
from raytracinginonesemester_tpu.ops.wavefront import (  # noqa: E402
    render_tiles_wavefront_frames)
from raytracinginonesemester_tpu.render.renderer import (  # noqa: E402
    _swizzled_grid, _unswizzle)

W, H, FRAMES = 128, 64, 2


def _save(name, frames, hp, wp):
    img = np.stack([np.asarray(_unswizzle(frames[f], W, H, hp, wp))
                    for f in range(FRAMES)]).astype(np.float32)
    out = os.path.join(REPO, "tests", "goldens", name)
    np.save(out, img)
    print(f"wrote {out} {img.shape}")


def main():
    xs, ys, (hp, wp) = _swizzled_grid(W, H)
    scene = jax_two_frog(width=W, height=H, max_bounces=3,
                         diffuse_bounce=True)
    acc = render_tiles_wavefront_frames(scene, xs, ys, FRAMES, 0,
                                        interpret=True, capacity_tiles=8)
    _save("torch_two_frog_128x64.npy", acc, hp, wp)

    terminal = jax_two_frog(width=W, height=H, max_bounces=3,
                            diffuse_bounce=False)
    assert terminal.terminal_only
    acc = [render_tiles(terminal, xs, ys, 1, f, interpret=True)
           for f in range(FRAMES)]
    _save("torch_two_frog_terminal_128x64.npy", acc, hp, wp)


if __name__ == "__main__":
    main()
