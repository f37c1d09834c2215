"""Kernel A's shadow-walk tally (``ops.megakernel.shadow_walk_counts``)
and the cpuonly kernels at 32 disk samples, with no JAX: this file runs
on the card with ``--noconftest``.

On the CPU: the tally's device buffer keeps its sums across folds.  On
the card: A, B, C and D of the cpuonly dialect with a 32-sample area
light (radius 0.15, diffuse, depth 8; the fused route of scenes of more
than 16 samples) equal their plain versions exactly; the walk and group
tallies read twice the plain counts after two emits; and neither the
tally nor the route counter adds a copy to the host to a render call.
B and C with two lights equal their plain versions exactly and count
their soft groups as the plain versions do (``bounce_group_counts``),
with no copy to the host.  On both: the headline frog lists the walks it
listed before the soft groups, and no group; its B and C count no
group."""

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
    """Each emit writes its five counts into the next row of the tally's
    buffer, which folds into the total when full: the sums of the walks
    (single entries and the groups' sample walks) and of the groups are
    kept across folds (a CPU buffer stands in for the card's)."""
    tally = tmk._WalkTally("cpu")
    walks = groups = 0
    for k in range(2 * tmk._WALK_SLOTS + 5):
        counts = tally.next_counts()
        counts.copy_(torch.tensor([k, 7, k % 3, 9, 2 * k],
                                  dtype=torch.int32))
        walks += 3 * k
        groups += k % 3
    assert tally.read() == (walks, groups)


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
def test_cuda_the_group_tally_reads_the_plain_groups_without_a_copy():
    """Kernel A's soft groups (a ray and area light some of whose 32
    disk samples' segments pass a block's slab test: one entry, walked
    together) are counted on the card: after two emits the group tally
    reads twice the plain count, with no copy to the host in the
    profiler's session, and a group lists from 1 to 32 of the walks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    from torch.profiler import ProfilerActivity, profile

    ts = _soft_mirror("cuda")
    kw = tmk.megakernel_kwargs(ts, "center")
    plain_kw = {k: v for k, v in kw.items()
                if k not in ("jitter", "dialect")}
    rows = tmk._scene_rows(ts, ts.accel)
    xs, ys, _ = tr._swizzled_grid(W, H, device="cuda")
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    work = torch.ones(xs_p.numel() // tmk.RAY_TILE, dtype=torch.bool,
                      device="cuda")
    stats = {}
    tmk.emit_tiles_plain(rows, xs_p, ys_p, work, OFFSET, ts.diffuse_bounce,
                         dialect="cpuonly", jitter="center", stats=stats,
                         **plain_kw)
    tmk.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            tmk.emit_tiles(ts, xs_p, ys_p, OFFSET, rows=rows, **kw)
        torch.cuda.synchronize()
    copies = [e for e in prof.events() if "Memcpy DtoH" in e.name]
    assert not copies, [e.name for e in copies]
    assert tmk.shadow_group_counts() == {"cuda:0": 2 * stats["groups"]}
    assert 0 < stats["groups"] <= stats["walks"] <= 32 * stats["groups"]


def _two_lights(samples, point, device):
    """Two-frog at W x H through a 135 mm lens, cpuonly: two area lights
    of ``samples`` disk samples, or an area light and a point light."""
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    from _torch_parity import two_frog_config

    cfg = dataclasses.replace(
        two_frog_config(SceneConfig, SceneNodeConfig, Transform, width=W,
                        height=H, dialect="cpuonly"), focal_length_mm=135.0)
    radii = (0.15, 0.0 if point else 0.15)
    cfg = dataclasses.replace(cfg, lights=[
        {**l, "radius": r, "shadow_samples": samples}
        for l, r in zip(cfg.lights, radii)])
    return build_scene(cfg, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("samples,point", [(64, False), (32, True)])
def test_cuda_groups_of_two_lights_match_plain(samples, point):
    """Kernel A with two lights: two area lights of 64 disk samples (a
    group walks in two passes of 32, the second light's group after the
    first's draws), or an area light of 32 and a point light (a group
    and a single walk in one emit): state and rng equal the plain
    version's exactly, and the tallies its walks and groups.  (At 40
    samples 12 radiance values of 131,072 part from the plain version's
    by an ulp, with or without the groups: PERF.md §7 K2.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    ts = _two_lights(samples, point, "cuda")
    kw = tmk.megakernel_kwargs(ts, "wang")
    plain_kw = {k: v for k, v in kw.items()
                if k not in ("jitter", "dialect")}
    rows = tmk._scene_rows(ts, ts.accel)
    xs, ys, _ = tr._swizzled_grid(W, H, device="cuda")
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    work = torch.ones(xs_p.numel() // tmk.RAY_TILE, dtype=torch.bool,
                      device="cuda")
    stats = {}
    pst, prng = tmk.emit_tiles_plain(rows, xs_p, ys_p, work, OFFSET,
                                     ts.diffuse_bounce, dialect="cpuonly",
                                     jitter="wang", stats=stats, **plain_kw)
    tmk.reset_launch_counts()
    st, rng = tmk.emit_tiles(ts, xs_p, ys_p, OFFSET, rows=rows, **kw)
    for a, b in ((st, pst), (rng, prng)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tmk.shadow_walk_counts() == {"cuda:0": stats["walks"]}
    assert tmk.shadow_group_counts() == {"cuda:0": stats["groups"]}
    assert 0 < stats["groups"] < stats["walks"]


@pytest.mark.cuda
@pytest.mark.parametrize("samples,point", [(64, False), (32, True)])
def test_cuda_bounce_groups_of_two_lights_match_plain(samples, point):
    """Kernels B and C with two lights (two area lights of 64 disk
    samples, two passes of 32 a group; or an area light of 32 and a point
    light), on A's state: state, rng and radiance equal the plain
    versions' exactly, and ``bounce_group_counts()`` reads the groups
    and sample walks the plain versions count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    ts = _two_lights(samples, point, "cuda")
    kw = tmk.megakernel_kwargs(ts, "wang")
    nj = {k: v for k, v in kw.items() if k != "jitter"}
    plain_kw = {k: v for k, v in nj.items() if k != "dialect"}
    rows = tmk._scene_rows(ts, ts.accel)
    xs, ys, _ = tr._swizzled_grid(W, H, device="cuda")
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    st, rng = tmk.emit_tiles(ts, xs_p, ys_p, OFFSET, rows=rows, **kw)
    b_stats, c_stats = {}, {}
    b_p = tmk.bounce_step_tiles_plain(rows, st, rng, ts.diffuse_bounce,
                                      dialect="cpuonly", stats=b_stats,
                                      **plain_kw)
    r_p = tmk.resume_tiles_plain(rows, st, rng, ts.max_bounces,
                                 ts.diffuse_bounce, dialect="cpuonly",
                                 stats=c_stats, **plain_kw)
    tmk.reset_launch_counts()
    b_k = tmk.bounce_step_tiles(ts, st, rng, rows=rows, **nj)
    r_k = tmk.resume_tiles(ts, st, rng, rows=rows, **nj)
    for a, b in zip(b_k + r_k, b_p + r_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    groups = b_stats["groups"] + c_stats["groups"]
    walks = b_stats["group_walks"] + c_stats["group_walks"]
    assert tmk.bounce_group_counts() == {"cuda:0": (groups, walks)}
    assert 0 < b_stats["groups"] < b_stats["group_walks"]
    assert walks <= samples * groups


@pytest.mark.cuda
def test_cuda_the_bounce_group_counter_adds_no_copy_to_a_call():
    """B's and C's group counter, kept on the card: soft B and C calls
    (the first after a reset keeps the card's total, on the card) copy
    nothing to the host in the profiler's session; the read is the one
    copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    from torch.profiler import ProfilerActivity, profile

    ts = _soft_mirror("cuda")
    kw = tmk.megakernel_kwargs(ts, "center")
    nj = {k: v for k, v in kw.items() if k != "jitter"}
    rows = tmk._scene_rows(ts, ts.accel)
    xs, ys, _ = tr._swizzled_grid(W, H, device="cuda")
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    st, rng = tmk.emit_tiles(ts, xs_p, ys_p, OFFSET, rows=rows, **kw)
    tmk.bounce_step_tiles(ts, st, rng, rows=rows, **nj)  # warm: the build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tmk.reset_launch_counts()
        for _ in range(2):
            tmk.bounce_step_tiles(ts, st, rng, rows=rows, **nj)
            tmk.resume_tiles(ts, st, rng, rows=rows, **nj)
        torch.cuda.synchronize()
    copies = [e.name for e in prof.events() if "Memcpy DtoH" in e.name]
    assert not copies, copies
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (groups, walks), = tmk.bounce_group_counts().values()
        torch.cuda.synchronize()
    copies = [e.name for e in prof.events() if "Memcpy DtoH" in e.name]
    assert len(copies) == 1, copies
    assert 0 < groups <= walks <= 32 * groups


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_the_headline_frog_bounces_count_no_group(device):
    """The headline frog's B and C (gpu dialect, one point light) walk no
    soft group: ``bounce_group_counts()`` reads (0, 0), on the card as
    in the plain versions."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    ts = tr.frog_scene(64, 32, device=device)
    rows = tmk._scene_rows(ts, ts.accel)
    xs, ys, _ = tr._swizzled_grid(64, 32, device=device)
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    st, rng = tmk.emit_tiles(ts, xs_p, ys_p, OFFSET, rows=rows)
    tmk.reset_launch_counts()
    b = tmk.bounce_step_tiles(ts, st, rng, rows=rows)
    tmk.resume_tiles(ts, st, rng, rows=rows)
    key = str(torch.device(device)) + (":0" if device == "cuda" else "")
    assert tmk.bounce_group_counts() == {key: (0, 0)}
    assert bool((b[0].reshape(-1, 16, b[0].shape[1])[:, 12] > 0).any())
    tmk.reset_launch_counts()


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_the_headline_frog_lists_its_walks_and_no_group(device):
    """The headline frog (gpu dialect, one point light): kernel A lists
    one walk a facing ray whose segment passes a block's slab test, as
    before the soft groups, and counts no group.  The walks are counted
    here apart from the tally, from the shadow walks the plain version
    makes."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    ts = tr.frog_scene(64, 32, device=device)
    rows = tmk._scene_rows(ts, ts.accel)
    xs, ys, _ = tr._swizzled_grid(64, 32, device=device)
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    work = torch.ones(xs_p.numel() // tmk.RAY_TILE, dtype=torch.bool,
                      device=device)
    listed, real = [], tmk._occluded_plain

    def walk(rows_, p, ld, dist, facing, det_eps, tmin, tmax=None, **k):
        inv = tuple(1.0 / c for c in ld)
        slabs = tmk._slab(rows_.aabb.T[:, None, :],
                          tuple(c[:, None] for c in p),
                          tuple(c[:, None] for c in inv),
                          torch.full_like(dist, tmin)[:, None],
                          dist[:, None])
        listed.append(int((slabs.any(dim=1) & facing).sum()))
        return real(rows_, p, ld, dist, facing, det_eps, tmin, tmax, **k)

    tmk._occluded_plain = walk
    try:
        tmk.emit_tiles_plain(rows, xs_p, ys_p, work, OFFSET,
                             ts.diffuse_bounce)
    finally:
        tmk._occluded_plain = real
    tmk.reset_launch_counts()
    tmk.emit_tiles(ts, xs_p, ys_p, OFFSET, rows=rows)
    key = str(torch.device(device)) + (":0" if device == "cuda" else "")
    assert len(listed) == 1 and listed[0] > 0
    assert tmk.shadow_walk_counts() == {key: listed[0]}
    assert tmk.shadow_group_counts() == {key: 0}
    tmk.reset_launch_counts()


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
    assert tmk.bounce_group_counts()["cuda:0"][0] > 0
