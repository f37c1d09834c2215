"""The port's spans (``utils/timing.py`` ``span``): ``rt.<layer>.<what>``
``torch.profiler`` annotations at each host layer of a call, recorded
only under a profiler session.

On the CPU: the no-op without a profiler; the spans of a render call
(the staged wavefront, the staged integrator, the monolithic kernel's
frame loop) nested in its root on its thread; a training step's spans;
a recording span's nesting on the profiler's clock; the launch spans
against the launch counters; images and gradients bit for bit with the profiler on and off.
On the card: every launch has its span."""

from __future__ import annotations

import dataclasses
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracinginonesemester_tpu_torch.diff import inverse
from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
from raytracinginonesemester_tpu_torch.ops import diff_gather as dg
from raytracinginonesemester_tpu_torch.ops import megakernel as mk
from raytracinginonesemester_tpu_torch.render import renderer
from raytracinginonesemester_tpu_torch.scene.build import load_scene
from raytracinginonesemester_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 32
KEYS = ("albedo", "light_intensity", "vertices")
# the paths of a render call at test size: the staged wavefront (a forced
# capacity), the staged integrator (the oracle's jitter) and the
# monolithic kernel's frame loop (no capacity), each with the spans that
# only it records
PATHS = {
    "wavefront": (dict(capacity_tiles=4),
                  {"rt.glue.setup", "rt.glue.emit", "rt.glue.compact",
                   "rt.glue.ladder", "rt.glue.unsort", "rt.sync.overflow",
                   "rt.sync.wavefront_alive"}),
    "integrator": (dict(jitter_mode="reference_cpu"),
                   {"rt.glue.frame", "rt.glue.depth",
                    "rt.sync.integrator_alive", "rt.sync.diffuse_select",
                    "rt.sync.unit_vector", "rt.sync.light_radii"}),
    "monolithic": (dict(), {"rt.glue.frame"}),
}


def _launches() -> int:
    return sum({**mk.launch_counts(), **bk.launch_counts(),
                **dg.launch_counts()}.values())


def _spans(prof):
    """(thread, start ns, end ns, name) of every rt.* host event."""
    return [(e.start_thread_id(), e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("rt.")
            and e.device_type() == torch.autograd.DeviceType.CPU]


def _recorded(fn, device="cpu"):
    """``fn()`` under a profiler session -> (result, rt.* events,
    launches counted during it)."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = _launches()
    with profile(activities=acts) as prof:
        out = fn()
    return out, _spans(prof), _launches() - before


def _nested_in(events, root: str):
    """The one ``root`` event, after checking that every other event of
    its thread lies inside it."""
    roots = [e for e in events if e[3] == root]
    assert len(roots) == 1, roots
    tid, s, e, _ = roots[0]
    for t, s2, e2, name in events:
        if t == tid:
            assert s <= s2 and e2 <= e, (name, root)
    return roots[0]


@pytest.fixture(scope="module")
def frog():
    return renderer.frog_scene(width=W, height=H, device="cpu")


def _spheres(device):
    """The grad-bench spheres scene (``bench.py --grad``) at 64x32, 2
    bounces, differentiable; its parameters perturbed by 5% and its own
    render as the target."""
    from raytracinginonesemester_tpu_torch.core.camera import Camera

    scene = load_scene(os.path.join(REPO, "tests/assets/scenes/"
                                    "gpu_spheres.json"), device=device)
    cam = Camera.create(position=(0.0, -2.5, 1.2), look_at=(0.0, 0.0, 0.5),
                        up=(0, 0, 1), focal_length_mm=24.0, width=W,
                        height=H, device=device)
    scene = dataclasses.replace(scene, camera=cam, differentiable=True,
                                max_bounces=2, spp=1)
    gen = torch.Generator().manual_seed(0)
    start = {k: v.detach() * (1.0 + 0.05 * torch.randn(
        v.shape, generator=gen).to(device))
        for k, v in inverse.extract_params(scene, KEYS).items()}
    with torch.no_grad():
        target = renderer.render_scene(scene, "center", spp_override=1)
    return scene, start, target


def _train_step(scene, start, target):
    """A fresh ``make_train_step`` step from ``start``."""
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    step = inverse.make_train_step(torch.optim.Adam(list(params.values()),
                                                    lr=1e-3))
    return lambda: step(params, scene, target)


@pytest.fixture(scope="module")
def spheres():
    return _spheres("cpu")


def test_without_a_profiler_a_span_is_the_shared_no_op(frog):
    assert not torch.autograd._profiler_enabled()
    assert timing.span("rt.a.b") is timing.span("rt.c.d")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    with timing.span("rt.dispatch.test"):
        pass
    renderer.render_scene_frames(frog, 1, capacity_tiles=4)
    # the session above recorded nothing of the calls after it
    assert _spans(prof) == []
    assert not torch.autograd._profiler_enabled()


def test_a_recording_span_nests_on_the_profilers_clock():
    def nested():
        with timing.span("rt.dispatch.outer"):
            for _ in range(3):
                with timing.span("rt.sync.inner"):
                    time.sleep(0.01)

    _, events, _ = _recorded(nested)
    assert sorted(e[3] for e in events) == ["rt.dispatch.outer"] + [
        "rt.sync.inner"] * 3
    outer = _nested_in(events, "rt.dispatch.outer")
    inner = sorted(e for e in events if e[3] == "rt.sync.inner")
    # one after another, each 10 ms and more, on the outer span's thread
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))
    assert all(e - s >= 10_000_000 for _, s, e, _ in inner)
    assert outer[2] - outer[1] >= sum(e - s for _, s, e, _ in inner)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_render_call_nests_its_spans_in_its_root(frog, path):
    kw, own = PATHS[path]
    _, events, launches = _recorded(
        lambda: renderer.render_scene_frames(frog, 2, **kw))
    names = {e[3] for e in events}
    assert {"rt.dispatch.frames", "rt.dispatch.resolve", "rt.dispatch.grid",
            "rt.dispatch.unswizzle"} | own <= names, names
    _nested_in(events, "rt.dispatch.frames")
    # the plain versions launch nothing, and record no launch span
    assert launches == 0
    assert not {n for n in names if n.startswith("rt.launch.")}


def test_a_training_step_records_its_layers(spheres):
    scene = spheres[0]
    _, events, _ = _recorded(_train_step(*spheres))
    names = {e[3] for e in events}
    assert {"rt.dispatch.step", "rt.dispatch.apply_params",
            "rt.dispatch.scene", "rt.glue.backward", "rt.glue.adam",
            "rt.glue.oracle", "rt.glue.depth",
            "rt.sync.light_radii"} <= names, names
    root = _nested_in(events, "rt.dispatch.step")
    # every span of the step lies inside its root, whatever its thread
    assert all(root[1] <= s and e <= root[2] for _, s, e, _ in events)
    assert sum(e[3] == "rt.glue.depth" for e in events) == scene.max_bounces


def test_images_are_the_same_with_the_profiler_on(frog):
    for kw, _ in PATHS.values():
        off = renderer.render_scene_frames(frog, 2, sample_offset=3, **kw)
        on, _, _ = _recorded(lambda: renderer.render_scene_frames(
            frog, 2, sample_offset=3, **kw))
        assert torch.equal(on, off)


def test_gradients_are_the_same_with_the_profiler_on(spheres):
    scene, start, target = spheres

    def grads():
        params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        loss = inverse.render_loss(params, scene, target)
        loss.backward()
        return loss.detach(), {k: p.grad for k, p in params.items()}

    loss_off, off = grads()
    (loss_on, on), _, _ = _recorded(grads)
    assert torch.equal(loss_on, loss_off)
    for k in KEYS:
        assert torch.equal(on[k], off[k]), k


@pytest.mark.cuda
def test_cuda_every_launch_has_its_span():
    """On the card: on the staged wavefront, the monolithic kernel, the
    staged integrator and a training step (whose kernel J launches on
    autograd's device thread), the rt.launch.<key> spans equal, key by
    key, the launch counters' change over the call, and the paths that
    read the device record sync spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    frog = renderer.frog_scene(width=256, height=144, device="cuda")

    def counts():
        return {**mk.launch_counts(), **bk.launch_counts(),
                **dg.launch_counts()}

    cases = [(lambda: renderer.render_scene_frames(frog, 2, capacity_tiles=8),
              True),
             (lambda: renderer.render_scene_frames(
                 dataclasses.replace(frog, max_bounces=1,
                                     diffuse_bounce=False), 2), False),
             (lambda: renderer.render_scene_frames(
                 frog, 1, jitter_mode="reference_cpu"), True),
             (_train_step(*_spheres("cuda")), True)]
    for fn, syncs in cases:
        fn()
        torch.cuda.synchronize()
        before = counts()
        _, events, launches = _recorded(fn, "cuda")
        after = counts()
        spans = {}
        for e in events:
            if e[3].startswith("rt.launch."):
                key = e[3][len("rt.launch."):]
                spans[key] = spans.get(key, 0) + 1
        assert launches > 0
        assert spans == {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        assert any(e[3].startswith("rt.sync.") for e in events) == syncs
