"""Scenes over the plane budget on the port's fused kernels.

The plane budget (``ops/block_kernels.py`` ``fits_vmem``) is the JAX
package's rule for its TPU kernels' VMEM: the JAX package renders a grid
over it through its streamed kernels.  The port's fused kernels A-D read
the planes from global memory, so ``render_scene_frames`` takes such a
grid on the staged wavefront (A and B, the binned plan), and only the
staged integrator (``reference_cpu`` jitter, differentiable scenes) keeps
G and I.  Held here, with the budget lowered so that a small scene goes
over it: the fused kernels' eligibility, the route and its kernels, and
the image against the staged integrator's G and I and against the JAX
package's streamed render, in both dialects, by ``assert_images_close``;
a mesh subdivided (``scene/subdivide.py``) renders the image of the mesh
it came from; a grid whose block AABBs exceed the kernels' shared memory
takes the staged integrator; a binned plan's build is counted
(``plan_counts``) and spanned (``rt.dispatch.plan``, with the capacity's
calibration, ``rt.dispatch.calibrate``).  The card's test of the
1,270,912-triangle frog is ``test_torch_large_mesh_card.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import raytracinginonesemester_tpu.ops.pallas_kernels as pk
from raytracinginonesemester_tpu.ops import megakernel as jmk
from raytracinginonesemester_tpu.render import renderer as jr
from raytracinginonesemester_tpu_torch.io.image import quantize
from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.ops import wavefront as twf
from raytracinginonesemester_tpu_torch.render import renderer as tr

from _torch_parity import (assert_images_close, jax_two_frog,
                           regridded, staged_image, torch_from_jax)
from test_torch_streamed import (CPUONLY_LIGHTS, STREAMED,  # noqa: F401
                                 _cpuonly_mirror, _spheres, calls, low_budget)

FUSED = ("emit_tiles", "bounce_step_tiles", "resume_tiles")
# the gpu sphere scene (wang jitter) and the cpuonly mirror scene with
# chip_smoke.py phase 8's area light at 4 disk samples (auto: centres)
DIALECTS = {"gpu": (_spheres, {}, "wang"),
            "cpuonly": (_cpuonly_mirror, CPUONLY_LIGHTS["area"], "auto")}


@pytest.fixture(scope="module", params=sorted(DIALECTS))
def over_budget(request):
    """(dialect, the port's scene, jitter, the JAX package's render of the
    scene over its lowered budget: its streamed kernels, interpret
    mode)."""
    build, light, jitter = DIALECTS[request.param]
    js = build(**light)
    budget = 4 * pk._grid_bytes(1, 128)
    jax.clear_caches()
    saved = pk._VMEM_TRI_BUDGET_BYTES
    pk._VMEM_TRI_BUDGET_BYTES = budget
    try:
        assert pk.num_chunks_for(js.accel) > 1
        assert "VMEM budget" in jmk.megakernel_ineligible_reason(
            js, "wang" if request.param == "gpu" else "center")
        want = np.asarray(jr.render_scene(js, jitter))
    finally:
        pk._VMEM_TRI_BUDGET_BYTES = saved
        jax.clear_caches()
    return request.param, torch_from_jax(js), jitter, want


@pytest.fixture
def fused(monkeypatch):
    """Counts the wavefront's launches of kernels A-C by name."""
    seen = {}
    for name in FUSED:
        fn = getattr(twf, name)

        def spy(*a, _fn=fn, _name=name, **k):
            seen[_name] = seen.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(twf, name, spy)
    return seen


def _quantized(img, dialect):
    return quantize(np.asarray(img), dialect)


def test_the_fused_kernels_take_a_grid_over_the_plane_budget(over_budget,
                                                             low_budget):
    dialect, ts, jitter, _ = over_budget
    assert not bk.fits_vmem(ts.accel) and bk.num_chunks_for(ts.accel) > 1
    jm = tr.resolve_jitter_mode(ts, jitter, 1)
    assert tmk.megakernel_ineligible_reason(ts, jm) is None
    # reference_cpu keeps the staged integrator, for its jitter alone
    assert "reference_cpu" in tmk.megakernel_ineligible_reason(
        ts, "reference_cpu")


@pytest.mark.parametrize("capacity", [None, 8])
def test_over_budget_frames_take_a_fused_route_and_match_g_and_i(
        over_budget, low_budget, calls, fused, monkeypatch, capacity):
    """No E-I on the renderer's route: at this size the calibration finds
    no capacity, so the dispatch takes kernel D; at a capacity of the
    frame's 8 tiles, the wavefront with A and B, as the 1080p frame does.
    Each image against the staged integrator's G and I on the same scene,
    jitter and sample offset."""
    dialect, ts, jitter, _ = over_budget
    rendered = []
    real = tmk.render_tiles

    def render_tiles(*a, **k):
        rendered.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tmk, "render_tiles", render_tiles)
    tr.reset_route_counts()
    got = tr.render_scene_frames(ts, 1, jitter, sample_offset=3,
                                 capacity_tiles=capacity)[0]
    assert not calls
    if capacity is None:
        # the calibration's emit runs A; the frame itself is D's
        assert tr.route_counts() == {"render": 1} and rendered
        assert "bounce_step_tiles" not in fused
    else:
        assert tr.route_counts() == {"wavefront": 1} and not rendered
        assert fused["emit_tiles"] >= 1 and fused["bounce_step_tiles"] >= 1
    staged = staged_image(ts, jitter, sample_offset=3)
    assert set(calls) == set(STREAMED)
    assert float(staged.std()) > 0.05
    assert_images_close(_quantized(got, dialect), _quantized(staged, dialect),
                        context=f"{dialect}: fused vs staged G/I")


@pytest.mark.parametrize("capacity", [None, 8])
def test_over_budget_frames_match_the_jax_streamed_render(
        over_budget, low_budget, capacity):
    """Kernel D's frame (the dispatch's at this size) and the wavefront's
    with A and B (a capacity of the frame's 8 tiles) against the JAX
    package's streamed render."""
    dialect, ts, jitter, want = over_budget
    tr.reset_route_counts()
    got = tr.render_scene_frames(ts, 1, jitter, capacity_tiles=capacity)[0]
    assert tr.route_counts() == {
        "render" if capacity is None else "wavefront": 1}
    assert_images_close(_quantized(got, dialect), _quantized(want, dialect),
                        context=f"{dialect}: fused vs the JAX streamed render")


def test_a_subdivided_frog_renders_the_frogs_image():
    """Each level splits a triangle into 4 coplanar children with their
    normals averaged, so the surface, the interpolated normal and the
    image stay; the global ids change, so ties may part."""
    ts = dataclasses.replace(torch_from_jax(jax_two_frog(width=64, height=32)),
                             max_bounces=3)
    base, fine = regridded(ts, 0), regridded(ts, 1)
    assert fine.geometry.num_triangles == 4 * base.geometry.num_triangles
    tr.reset_route_counts()
    want = tr.render_scene_frames(base, 2, "wang", sample_offset=5,
                                  capacity_tiles=8)
    got = tr.render_scene_frames(fine, 2, "wang", sample_offset=5,
                                 capacity_tiles=8)
    assert tr.route_counts() == {"wavefront": 2}
    hit = (want != torch.as_tensor(ts.miss_color)).any(dim=-1)
    assert float(hit.float().mean()) > 0.1
    for f in range(2):
        assert_images_close(_quantized(got[f], "gpu"),
                            _quantized(want[f], "gpu"),
                            context=f"frame {f}: subdivided vs the frog")


def test_a_grid_past_the_fused_kernels_shared_memory_is_staged(monkeypatch):
    """Kernels A-D stage every block's AABB in a CTA's shared memory
    (about 8,400 blocks fit; the card's library answers,
    ``test_torch_large_mesh_card.py``): a grid past it keeps the staged
    integrator."""
    ts = torch_from_jax(jax_two_frog(width=64, height=32))
    assert tmk.megakernel_ineligible_reason(ts, "wang") is None
    monkeypatch.setattr(tmk, "_shared_memory_fits", lambda scene: False)
    reason = tmk.megakernel_ineligible_reason(ts, "wang")
    assert reason == (f"{ts.accel.num_blocks} blocks' AABBs exceed the "
                      "fused kernels' shared memory")
    tr.reset_route_counts()
    tr.render_scene_frames(ts, 1, "wang")
    assert tr.route_counts() == {f"staged: {reason}": 1}


def test_a_plan_build_is_counted_and_spanned():
    """A cold call builds the binned plan once, inside
    ``rt.dispatch.plan``, and calibrates inside ``rt.dispatch.calibrate``;
    ``plan_counts`` holds its chunks and padded pairs, and a warm call
    builds nothing."""
    from torch.profiler import ProfilerActivity, profile

    from raytracinginonesemester_tpu_torch.ops.binned import CHUNK

    ts = torch_from_jax(_spheres())
    tr.reset_plan_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.render_scene_frames(ts, 1, "wang")
    names = {e.name for e in prof.events()}
    assert {"rt.dispatch.plan", "rt.dispatch.calibrate"} <= names
    counts = tr.plan_counts()
    assert counts["plans"] == 1 and counts["chunks"] > 0
    assert counts["padded_pairs"] == counts["chunks"] * CHUNK * tmk.RAY_TILE
    tr.render_scene_frames(ts, 1, "wang", sample_offset=1)
    assert tr.plan_counts() == counts
    tr.reset_plan_counts()
    assert tr.plan_counts() == {"plans": 0, "chunks": 0, "padded_pairs": 0}
