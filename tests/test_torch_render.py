"""Whole-frame parity of the PyTorch port with the JAX package.

The port's ``render_scene_frames`` (plain kernel versions on the CPU)
against the JAX package's ``render_tiles_wavefront_frames`` with the
Pallas kernels in interpret mode, on the very same block-grid planes:
quantized images pass ``assert_images_close`` and the linear images
agree within 1e-4 (last-ulp differences of XLA:CPU's FMA contraction,
amplified by bounces; see ``test_torch_megakernel.py``).
"""

import os

import numpy as np
import pytest
import torch

from raytracinginonesemester_tpu.io.image import quantize
from raytracinginonesemester_tpu.ops.wavefront import (
    render_tiles_wavefront_frames as j_frames)
from raytracinginonesemester_tpu.render.renderer import (
    _swizzled_grid as j_grid, _unswizzle as j_unswizzle)
from raytracinginonesemester_tpu_torch.ops.megakernel import launch_counts
from raytracinginonesemester_tpu_torch.ops.wavefront import (
    render_tiles_wavefront_frames as t_frames)
from raytracinginonesemester_tpu_torch.render.renderer import (
    _swizzled_grid as t_grid, _unswizzle as t_unswizzle, render_scene,
    render_scene_frames)

from _torch_parity import REPO, jax_two_frog, one_torch_thread, torch_from_jax
from conftest import assert_images_close

W, H, FRAMES = 64, 32, 2


@pytest.fixture(scope="module")
def scenes():
    js = jax_two_frog(width=W, height=H, max_bounces=3, diffuse_bounce=True)
    return js, torch_from_jax(js)


# cap=4 of 8 tiles stages the ladder; cap=2 is tighter than the alive
# wavefront and takes the overflow (resume) branch
@pytest.mark.parametrize("cap", [4, 2])
def test_frames_match_jax(scenes, cap):
    js, ts = scenes
    xs, ys, (hp, wp) = j_grid(W, H)
    acc = j_frames(js, xs, ys, FRAMES, 0, interpret=True, capacity_tiles=cap)
    want = np.stack([np.asarray(j_unswizzle(acc[f], W, H, hp, wp))
                     for f in range(FRAMES)])
    got = render_scene_frames(ts, FRAMES, "wang", 0, capacity_tiles=cap)
    assert tuple(got.shape) == (FRAMES, H, W, 3)
    got = got.numpy()
    assert np.abs(got - want).max() <= 1e-4
    for f in range(FRAMES):
        assert_images_close(quantize(got[f], "gpu"), quantize(want[f], "gpu"),
                            context=f"frame {f} cap {cap}")
    assert want.std() > 0.05  # lit, shadowed and sky pixels all present
    assert launch_counts() == {"emit": 0, "bounce_step": 0, "resume": 0,
                              "render": 0}


def test_images_do_not_depend_on_ray_order(scenes):
    """A shuffled pixel stream puts every ray in another tile and sort
    position; the image must be bit-identical."""
    _, ts = scenes
    xs, ys, (hp, wp) = t_grid(W, H)
    base = t_frames(ts, xs, ys, 1, 5, capacity_tiles=4)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(xs.numel()))
    shuf = t_frames(ts, xs[perm], ys[perm], 1, 5, capacity_tiles=4)
    unshuf = torch.empty_like(shuf)
    unshuf[:, perm] = shuf
    torch.testing.assert_close(unshuf, base, rtol=0, atol=0)


def test_capacity_does_not_change_the_image(scenes):
    """Full width (no capacity), a staged capacity and an overflowing
    one give the same frames."""
    _, ts = scenes
    imgs = [render_scene_frames(ts, 1, "wang", 3, capacity_tiles=c)
            for c in (None, 4, 1)]
    for img in imgs[1:]:
        torch.testing.assert_close(img, imgs[0], rtol=0, atol=0)


def test_render_scene_averages_frames(scenes):
    _, ts = scenes
    frames = render_scene_frames(ts, 2, "wang", 7, capacity_tiles=4)
    img = render_scene(ts, "wang", spp_override=2, sample_offset=7,
                       capacity_tiles=4)
    torch.testing.assert_close(img, (frames[0] + frames[1]) / 2.0,
                               rtol=0, atol=0)
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()


def test_reference_image_for_the_card(monkeypatch):
    """The reference ``chip_smoke.py`` holds the card's render against
    (rendered by the JAX package, ``scripts/make_torch_golden.py``) also
    holds for the port's plain versions, at the production block size."""
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    from _torch_parity import two_frog_config

    ref = np.load(os.path.join(REPO, "tests/goldens/torch_two_frog_128x64.npy"))
    monkeypatch.setenv("RT_BLOCK_SIZE", "512")
    scene = build_scene(two_frog_config(SceneConfig, SceneNodeConfig, Transform,
                                        width=128, height=64), device="cpu")
    got = render_scene_frames(scene, ref.shape[0], "wang", 0).numpy()
    assert np.abs(got - ref).max() <= 1e-4
    for f in range(ref.shape[0]):
        assert_images_close(quantize(got[f], "gpu"), quantize(ref[f], "gpu"))
