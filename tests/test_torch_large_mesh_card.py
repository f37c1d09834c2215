"""The 1,270,912-triangle frog on the card, with no JAX: this file runs
on the card with ``--noconftest``.

The frog subdivided 3 levels (2,483 blocks of 512, over the plane
budget) at 1920x1080, depth 8, diffuse, wang: ``render_scene_frames``
takes the wavefront with kernels A and B and launches no E-I, and its
frame is ``assert_images_close`` to the staged integrator's G/I frame
on the same sample.  The bound that does bind the fused kernels, the
block AABBs they stage in a CTA's shared memory, is the library's own
answer (``rt_fused_fits``), held here against its launches."""

import ctypes
import dataclasses

import pytest
import torch

from raytracinginonesemester_tpu_torch.io.image import quantize
from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.render import renderer as tr

from _torch_parity import (assert_images_close,  # noqa: F401
                           one_torch_thread, regridded, staged_image)


@pytest.mark.cuda
def test_cuda_large_frog_fused_frame_matches_staged_g_and_i():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    scene = regridded(tr.frog_scene(1920, 1080, device="cuda"), 3)
    assert scene.geometry.num_triangles == 1_270_912
    assert scene.accel.num_blocks == 2483 and not bk.fits_vmem(scene.accel)
    tmk.reset_launch_counts()
    bk.reset_launch_counts()
    tr.reset_route_counts()
    got = tr.render_scene_frames(scene, 1, "wang", sample_offset=7)[0]
    assert tr.route_counts() == {"wavefront": 1}
    fused = tmk.launch_counts()
    assert fused["emit"] >= 1 and fused["bounce_step"] >= 1
    assert not any(bk.launch_counts().values())
    want = staged_image(scene, "wang", sample_offset=7)
    counts = bk.launch_counts()
    assert counts["closest_streamed"] >= 1 and counts["occluded_streamed"] >= 1
    assert counts["closest"] == counts["occluded"] == 0
    assert_images_close(quantize(got.cpu().numpy(), "gpu"),
                        quantize(want.cpu().numpy(), "gpu"),
                        context="1080p large frog: A/B vs G/I")


@pytest.mark.cuda
@pytest.mark.parametrize("cpuonly", [0, 1])
def test_cuda_the_fused_kernels_shared_memory_bound(cpuonly):
    """The frog's light and material, the binned plan's chunks: the library
    takes 2,483 blocks and refuses 16,384; at the last grid it takes,
    kernels D and C prepare their launches (no rays); past it, a scene
    keeps the staged integrator."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    from raytracinginonesemester_tpu_torch.ops._native import SceneArgs, load
    from raytracinginonesemester_tpu_torch.ops.binned import CHUNK

    lib = load()

    def fits(blocks):
        out = ctypes.c_int(-1)
        assert lib.rt_fused_fits(blocks, 1, 1, CHUNK, cpuonly,
                                 ctypes.byref(out)) == 0
        return out.value == 1

    lo, hi = 2483, 16384
    assert fits(lo) and not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    # 24 bytes a block, of 227 KiB less the chunk buffers and the
    # kernels' static arrays
    assert 7000 < lo < (227 * 1024 - 2 * 4 * 12 * CHUNK) // 24
    args = SceneArgs(n_lights=1, n_objects=1, num_blocks=lo, cpuonly=cpuonly,
                     cand_chunk=CHUNK, cand_meta=1, cand_stream=1)
    assert lib.rt_render(ctypes.byref(args), None, None, None, 0,
                         tmk.RAY_TILE, 1, 0, 0, 0, 8, None, None, None,
                         None) == 0
    assert lib.rt_resume(ctypes.byref(args), None, None, 0, tmk.RAY_TILE, 8,
                         None, None, None, None) == 0
    scene = tr.frog_scene(64, 32, device="cuda")
    assert (scene.lights.num_lights, scene.materials.kd.shape[0]) == (1, 1)
    if cpuonly:
        scene = dataclasses.replace(scene, dialect="cpuonly")
    big = dataclasses.replace(scene, accel=dataclasses.replace(
        scene.accel, tri=torch.empty(9, hi, 1, device="cuda")))
    assert tmk.megakernel_ineligible_reason(scene, "wang") is None
    assert tmk.megakernel_ineligible_reason(big, "wang") == (
        f"{hi} blocks' AABBs exceed the fused kernels' shared memory")
