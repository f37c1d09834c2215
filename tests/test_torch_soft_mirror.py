"""Soft shadows of more than 16 disk samples on the port's fused kernels.

The JAX package refuses its fused kernels above 16 shadow samples (a
static unroll in Pallas); the port's kernels loop over the samples at run
time, so it keeps no such bound (ROADMAP §3): the CPUOnly mirror scene
with a 17- and a 32-sample area light (radius 0.15), 8 bounces and
diffuse bounces renders on the fused route, kernel D's plain version or
the staged wavefront's A, B and C at a forced capacity.  Held here, at
48x24 and seeded sample offsets:

- the fused frames against the port's staged integrator (E and F, one F
  walk a disk sample, ``accumulate_samples``) and against the JAX
  package's render, which takes its staged integrator;
- the route counter (``render.renderer.route_counts``) and the shadow
  walks that kernel A lists (``ops.megakernel.shadow_walk_counts``; on
  the card in ``test_torch_walk_tally.py``);
- the port against the benchmark's plain CPUOnly tracer
  (``bench_port/reference/cpuonly.py``) on the benchmark's configuration,
  within the cell's limits, which the tracer in bfloat16 fails.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from raytracinginonesemester_tpu.render import renderer as jr
from raytracinginonesemester_tpu_torch.io.image import quantize
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.render import renderer as tr

from _torch_parity import REPO, one_torch_thread, torch_from_jax  # noqa: F401
from conftest import assert_images_close
from test_megakernel_cpuonly import _cpuonly_scene

if REPO not in sys.path:
    sys.path.insert(0, REPO)

from bench_port.entries.render_cpuonly import build_scene  # noqa: E402
from bench_port.reference import cpuonly as ref  # noqa: E402
from bench_port.reference import cpuonly_scene as ref_scene  # noqa: E402
from bench_port.reference.render_frames import compare  # noqa: E402

W, H = 48, 24
# seeded first sample indices: a frame's rng streams start from them
OFFSETS = [int(o) for o in np.random.default_rng(20).integers(0, 2 ** 30, 2)]
CELL = "mirror_1080p.soft"


@pytest.fixture(scope="module", params=[17, 32])
def soft(request):
    js = _cpuonly_scene(width=W, height=H, kr_ball=0.7, max_bounces=8,
                        diffuse_bounce=True, radius=0.15,
                        shadow_samples=request.param)
    return js, torch_from_jax(js)


def _staged(ts, offset):
    """One frame through the staged integrator (E, and F a disk sample)."""
    xs, ys, (hp, wp) = tr._swizzled_grid(W, H)
    acc = tr.accumulate_samples(ts, xs, ys, 1, "center",
                                sample_offset=offset)
    return tr.unswizzle(acc, W, H, hp, wp)


def test_more_than_16_samples_take_the_fused_kernels(soft):
    js, ts = soft
    assert tmk.megakernel_ineligible_reason(ts, "center") is None
    assert tmk.megakernel_ineligible_reason(ts, "wang") is None
    # the JAX package keeps its unroll bound
    from raytracinginonesemester_tpu.ops.megakernel import (
        megakernel_ineligible_reason as j_reason)

    assert "> 16 (static soft-shadow unroll bound)" in j_reason(js, "center")


def test_the_fused_route_equals_the_staged_one_and_jax(soft):
    """Kernel D's plain version (the route at this size: no capacity is
    calibrated) and the staged wavefront at a forced capacity of 4 tiles
    (A, B, and C on overflow) against E and F and the JAX render.  The
    port's two routes keep one op order and one rng stream (one disk draw
    a sample a hit ray, then the Russian-roulette draw), so they agree to
    float32 rounding: 4e-5 measured, 2e-4 allowed on radiance up to ~2.
    The JAX render takes XLA:CPU's contracted FMAs; its images are held
    by ``assert_images_close``, as every parity test holds them."""
    js, ts = soft
    tr.reset_route_counts()
    fused = tr.render_scene_frames(ts, 1, "auto", OFFSETS[0])
    waved = tr.render_scene_frames(ts, 1, "auto", OFFSETS[0],
                                   capacity_tiles=4)
    assert tr.route_counts() == {"render": 1, "wavefront": 1}
    staged = _staged(ts, OFFSETS[0])
    for got in (fused[0], waved[0]):
        torch.testing.assert_close(got, staged, rtol=0, atol=2e-4)
        assert_images_close(quantize(got.numpy(), "cpuonly"),
                            quantize(staged.numpy(), "cpuonly"),
                            context="fused vs staged")
    want = np.asarray(jr.render_scene(js, "auto", sample_offset=OFFSETS[0]))
    assert_images_close(quantize(fused[0].numpy(), "cpuonly"),
                        quantize(want, "cpuonly"), context="fused vs JAX")
    assert float(fused[0].max()) > 1.0  # unclamped, as CPUOnly
    assert float(fused[0].std()) > 0.05


def test_the_route_counter(soft):
    """One count a render call: fused at 17 and 32 samples; the
    ``reference_cpu`` jitter, which the fused kernels refuse, staged
    with its reason."""
    _, ts = soft
    small = dataclasses.replace(ts, max_bounces=1)
    tr.reset_route_counts()
    tr.render_scene(small)
    tr.render_scene_frames(small, 1)
    tr.render_scene(small, "reference_cpu")
    counts = tr.route_counts()
    staged = [k for k in counts if k.startswith("staged: ")]
    assert counts["render"] == 2 and len(staged) == 1, counts
    assert "jitter_mode='reference_cpu'" in staged[0]
    assert counts[staged[0]] == 1
    tr.reset_route_counts()
    assert tr.route_counts() == {}


def test_the_shadow_walk_tally(soft):
    """Kernel A's listed walks (each hit ray's disk samples whose segment
    passes a block's slab test) counted on the rays' device, read only by
    ``shadow_walk_counts``; the plain version counts what the kernel
    lists, and the tally adds each emit's count."""
    _, ts = soft
    kw = tmk.megakernel_kwargs(ts, "center")
    xs, ys, _ = tr._swizzled_grid(W, H)
    stats = {}
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    rows = tmk._scene_rows(ts, ts.accel)
    has_work = torch.ones(xs_p.shape[0] // tmk.RAY_TILE, dtype=torch.bool)
    tmk.emit_tiles_plain(rows, xs_p, ys_p, has_work, OFFSETS[1],
                         ts.diffuse_bounce, kw["det_eps"],
                         shadow_eps=kw["shadow_eps"],
                         shadow_tmin=kw["shadow_tmin"], dialect="cpuonly",
                         jitter="center", shadow_samples=kw["shadow_samples"],
                         stats=stats)
    samples = kw["shadow_samples"]
    tmk.reset_launch_counts()
    assert tmk.shadow_walk_counts() == {}
    for _ in range(2):
        tmk.emit_tiles(ts, xs, ys, OFFSETS[1], **kw)
    assert tmk.shadow_walk_counts() == {"cpu": 2 * stats["walks"]}
    # at most every pixel's every sample; here each ray facing the light
    # lists its every sample (57 rays)
    assert samples <= stats["walks"] <= W * H * samples
    tmk.reset_launch_counts()
    assert tmk.shadow_walk_counts() == {}


def test_the_bounds_that_stay():
    """What binds now: kernel A's int32 shadow-list index (rays x lights x
    samples), and at least one walk a light."""
    js = _cpuonly_scene(width=W, height=H, radius=0.15, shadow_samples=2)
    ts = torch_from_jax(js)
    rays = 8 * tmk.RAY_TILE  # the 48x24 frame is one 8-tile group
    many = dataclasses.replace(ts, lights=dataclasses.replace(
        ts.lights, shadow_samples=((2 ** 31 - 1) // rays + 1,)))
    assert "int32 index" in tmk.megakernel_ineligible_reason(many, "center")
    fits = dataclasses.replace(ts, lights=dataclasses.replace(
        ts.lights, shadow_samples=((2 ** 31 - 1) // rays,)))
    assert tmk.megakernel_ineligible_reason(fits, "center") is None
    with pytest.raises(ValueError, match="at least one walk"):
        tmk._Shade(True, dialect="cpuonly", shadow_samples=0)


def _cell_config(samples: int) -> dict:
    with open(os.path.join(REPO, "bench_port", "configs",
                           "mirror_1080p.json")) as f:
        cfg = json.load(f)
    cfg["camera"].update(pixel_width=W, pixel_height=H)
    cfg["light"]["shadow_samples"] = samples
    return cfg


@pytest.mark.parametrize("samples", [17, 32])
def test_the_port_agrees_with_the_plain_reference(samples):
    """The port's fused frames of the benchmark's configuration, built by
    the cell's entry, against the benchmark's plain CPUOnly tracer on
    every pixel, at depth 8 with diffuse bounces: within the cell's own
    limits (``bench_port/limits``): ``bad_share``, the share of channels
    off by more than two 8-bit steps, for the rare last-bit tie that
    sends a walk or a bounce another way (none of 3,456 measured), and
    ``mean_abs`` (2e-9 measured).  The tracer computed in bfloat16 (the
    nearest lower precision) in the port's place fails them on a quarter
    of the pixels (0.25 and 0.1 measured)."""
    cfg = _cell_config(samples)
    settings = {"max_bounces": 8, "diffuse_bounce": True}
    scene = build_scene(cfg, settings, REPO, "cpu")
    jitter = tr.resolve_jitter_mode(scene, "auto", 1)
    frames = tr.render_scene_frames(scene, 1, "auto", OFFSETS[1])
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    px = torch.stack([torch.full((W * H,), OFFSETS[1]), xs.reshape(-1),
                      ys.reshape(-1)], 1).long()
    arrays = ref_scene.build(cfg, settings, REPO)
    want = ref.pixels(arrays, px, jitter, "cpu")
    with open(os.path.join(REPO, "bench_port", "limits",
                           f"{CELL}.json")) as f:
        limits = {k: v["limit"] for k, v in json.load(f)["numbers"].items()}
    got = compare(frames[0].reshape(-1, 3), want)
    assert all(got[k] <= limits[k] for k in limits), got
    low = compare(ref.pixels(arrays, px[::4], jitter, "cpu", torch.bfloat16),
                  want[::4])
    assert not all(low[k] <= limits[k] for k in limits), low
