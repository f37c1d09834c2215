"""Kernel A's shadow-walk tally (``ops.megakernel.shadow_walk_counts``)
and the cpuonly kernels at 32 disk samples, with no JAX: this file runs
on the card with ``--noconftest``.

On the CPU: the tally's device buffer keeps its sum across folds.  On the
card: A, B, C and D of the cpuonly dialect with a 32-sample area light
(radius 0.15, diffuse, depth 8; the fused route of scenes of more than 16
samples) equal their plain versions exactly; the tally reads twice the
plain count after two emits; and neither the tally nor the route counter
adds a copy to the host to a render call."""

import dataclasses
import os

import pytest
import torch

from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.render import renderer as tr
from raytracinginonesemester_tpu_torch.scene.build import build_scene
from raytracinginonesemester_tpu_torch.scene.config import load_scene_config

from _torch_parity import REPO, one_torch_thread  # noqa: F401

W, H = 128, 64
OFFSET = 912_345


def test_the_walk_tally_folds_its_slots():
    """Each emit writes its counts into the next pair of the tally's
    buffer, which folds into the total when full: the sum is kept across
    folds (a CPU buffer stands in for the card's)."""
    tally = tmk._WalkTally("cpu")
    written = 0
    for k in range(2 * tmk._WALK_SLOTS + 5):
        counts = tally.next_counts()
        counts.copy_(torch.tensor([k, 7], dtype=torch.int32))
        written += k
    assert tally.read() == written


def _soft_mirror(device):
    path = os.path.join(REPO, "tests/assets/scenes/cpuonly_mirror.json")
    cfg = dataclasses.replace(
        load_scene_config(path), pixel_width=W, pixel_height=H,
        max_bounces=8, diffuse_bounce=True)
    cfg = dataclasses.replace(cfg, lights=[
        {**l, "radius": 0.15, "shadow_samples": 32} for l in cfg.lights])
    return build_scene(cfg, scene_path=path, device=device)


@pytest.mark.cuda
def test_cuda_soft_kernels_match_plain_and_tally_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    from torch.profiler import ProfilerActivity, profile

    ts = _soft_mirror("cuda")
    kw = tmk.megakernel_kwargs(ts, "center")
    nj = {k: v for k, v in kw.items() if k != "jitter"}
    plain_kw = {k: v for k, v in nj.items() if k != "dialect"}
    rows = tmk._scene_rows(ts, ts.accel)
    xs, ys, _ = tr._swizzled_grid(W, H, device="cuda")
    xs_p, ys_p, n, _ = tmk._pad_tiles(xs, ys)
    work = torch.ones(xs_p.numel() // tmk.RAY_TILE, dtype=torch.bool,
                      device="cuda")
    stats = {}
    pst, prng = tmk.emit_tiles_plain(rows, xs_p, ys_p, work, OFFSET,
                                     ts.diffuse_bounce, dialect="cpuonly",
                                     jitter="center", stats=stats,
                                     **plain_kw)
    tmk.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            st, rng = tmk.emit_tiles(ts, xs_p, ys_p, OFFSET, rows=rows, **kw)
        torch.cuda.synchronize()
    copies = [e for e in prof.events() if "Memcpy DtoH" in e.name]
    assert not copies, [e.name for e in copies]
    assert tmk.shadow_walk_counts() == {"cuda:0": 2 * stats["walks"]}
    assert stats["walks"] > 0
    for a, b in ((st, pst), (rng, prng)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    b_k = tmk.bounce_step_tiles(ts, st, rng, rows=rows, **nj)
    b_p = tmk.bounce_step_tiles_plain(rows, st, rng, ts.diffuse_bounce,
                                      dialect="cpuonly", **plain_kw)
    for a, b in zip(b_k, b_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    r_k = tmk.resume_tiles(ts, st, rng, rows=rows, **nj)
    r_p = tmk.resume_tiles_plain(rows, st, rng, ts.max_bounces,
                                 ts.diffuse_bounce, dialect="cpuonly",
                                 **plain_kw)
    for a, b in zip(r_k, r_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    d_k = tmk.render_tiles(ts, xs, ys, 1, OFFSET, rows=rows, **kw)
    d_p = tmk.render_tiles_plain(rows, xs_p, ys_p, work, 1, OFFSET,
                                 ts.max_bounces, False, ts.diffuse_bounce,
                                 dialect="cpuonly", jitter="center",
                                 **plain_kw)
    torch.testing.assert_close(
        d_k, torch.stack([c.reshape(-1)[:n] for c in d_p], dim=1),
        rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_the_counters_add_no_copy_to_a_call():
    """A render call on the staged wavefront copies to the host what the
    wavefront reads (its overflow and alive reads), and no more when the
    tally and the route counter count it: the copies equal the sync
    spans' reads, with the counters' state left on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    from torch.profiler import ProfilerActivity, profile

    ts = _soft_mirror("cuda")
    tr.render_scene_frames(ts, 2, capacity_tiles=8)  # warm: builds, plan
    tmk.reset_launch_counts()
    tr.reset_route_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.render_scene_frames(ts, 2, capacity_tiles=8)
        torch.cuda.synchronize()
    events = prof.events()
    copies = sum("Memcpy DtoH" in e.name for e in events)
    reads = sum(e.name.startswith("rt.sync.") for e in events
                if e.device_type == torch.autograd.DeviceType.CPU)
    assert copies == reads > 0, (copies, reads)
    assert tr.route_counts() == {"wavefront": 1}
    assert tmk.shadow_walk_counts()["cuda:0"] > 0
