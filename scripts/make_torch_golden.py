"""Render the reference image that ``chip_smoke.py`` holds the PyTorch
port's card render against.

Runs the JAX package on the CPU in Pallas interpret mode: the two-frog
test scene (``tests/_torch_parity.py``) at 128x64, depth 3, diffuse
bounces, frames 0 and 1 of ``render_tiles_wavefront_frames``.  Writes
``tests/goldens/torch_two_frog_128x64.npy``, (2, 64, 128, 3) float32.

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
from raytracinginonesemester_tpu.ops.wavefront import (  # noqa: E402
    render_tiles_wavefront_frames)
from raytracinginonesemester_tpu.render.renderer import (  # noqa: E402
    _swizzled_grid, _unswizzle)

W, H, FRAMES = 128, 64, 2


def main():
    scene = jax_two_frog(width=W, height=H, max_bounces=3,
                         diffuse_bounce=True)
    xs, ys, (hp, wp) = _swizzled_grid(W, H)
    acc = render_tiles_wavefront_frames(scene, xs, ys, FRAMES, 0,
                                        interpret=True, capacity_tiles=8)
    img = np.stack([np.asarray(_unswizzle(acc[f], W, H, hp, wp))
                    for f in range(FRAMES)]).astype(np.float32)
    out = os.path.join(REPO, "tests", "goldens", "torch_two_frog_128x64.npy")
    np.save(out, img)
    print(f"wrote {out} {img.shape}")


if __name__ == "__main__":
    main()
