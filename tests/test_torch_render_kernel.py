"""The port's monolithic render (kernel D, ``megakernel.render_tiles``)
and the dispatch that reaches it.

``render_tiles`` on CPU tensors runs ``render_tiles_plain``; it is held
against the JAX package's ``render_tiles`` in Pallas interpret mode on
the same block-grid planes, at spp 2 from sample offset 3: the gpu
dialect's terminal pass (V1), its full bounce loop (V2), and both with
the binned depth 0.  Tolerance on the per-pixel sums: 4 ulp or 5e-5, the
emit bound of ``test_torch_megakernel.py``.  XLA:CPU's FMA contraction
in the reference moves the ill-conditioned barycentrics of a hit by an
ulp, so the hit point and shading normal differ in the last bits.  In
the terminal pass the specular lobe (ndoth ** 32) turns that into
~1e-5: measured max 1.35e-5 on one pixel here.  In V2 the depth-0
throughput (albedo * 2 N.L) carries it into the later bounces: measured
max 1.53e-5 on pixel 412's red sum, flat and binned alike, whose depth-0
throughput row already differs by 1.08e-5 (two sums of 6144 are beyond
1e-5, none beyond 5e-5).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from raytracinginonesemester_tpu.io.image import quantize
from raytracinginonesemester_tpu.ops import binned as jb
from raytracinginonesemester_tpu.ops import megakernel as jmk
from raytracinginonesemester_tpu.render import renderer as jr
from raytracinginonesemester_tpu_torch.ops import binned as tb
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.ops import wavefront as twf
from raytracinginonesemester_tpu_torch.render import renderer as tr

from _torch_parity import (
    REPO, jax_two_frog, one_torch_thread, torch_from_jax, ulp_close)
from conftest import assert_images_close

W, H, SPP, OFFSET = 64, 32, 2, 3
TOL = {"terminal": 5e-5, "bounce": 5e-5}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for kind, diffuse in (("terminal", False), ("bounce", True)):
        js = jax_two_frog(width=W, height=H, max_bounces=3,
                          diffuse_bounce=diffuse)
        out[kind] = (js, torch_from_jax(js))
    assert out["terminal"][0].terminal_only and out["bounce"][0].diffuse_bounce
    return out


def _plans(js, ts):
    xs, ys, _ = jr._swizzled_grid(W, H)
    xs_p, ys_p, _, _ = jmk._pad_tiles(xs, ys)
    jp = jb.build_camera_candidate_plan(js.camera, xs_p, ys_p, js.accel,
                                        jmk.RAY_TILE, nq=1, chunk=128)
    txs, tys, _ = tr._swizzled_grid(W, H)
    txs_p, tys_p, _, _ = tmk._pad_tiles(txs, tys)
    tp = tb.build_camera_candidate_plan(ts.camera, txs_p, tys_p, ts.accel,
                                        tmk.RAY_TILE, chunk=128)
    return jp, tp


@pytest.mark.parametrize("binned", [False, True])
@pytest.mark.parametrize("kind", ["terminal", "bounce"])
def test_render_tiles_matches_jax(scenes, kind, binned):
    js, ts = scenes[kind]
    jp, tp = _plans(js, ts) if binned else (None, None)
    xs, ys, _ = jr._swizzled_grid(W, H)
    want = np.asarray(jmk.render_tiles(js, xs, ys, SPP, OFFSET,
                                       interpret=True, cand_plan=jp))
    txs, tys, _ = tr._swizzled_grid(W, H)
    tmk.reset_launch_counts()
    got = tmk.render_tiles(ts, txs, tys, SPP, OFFSET, cand_plan=tp).numpy()
    assert tmk.launch_counts()["render"] == 0  # CPU tensors: plain version
    assert got.shape == want.shape == (W * H, 3)
    ok = ulp_close(got, want, ulps=4, atol=TOL[kind])
    assert ok.all(), (f"{(~ok).sum()} sums differ, max "
                      f"{np.abs(got - want).max()}")
    assert want.std() > 0.05 and (want > 0).any()


def test_render_kernel_equals_the_wavefront(scenes):
    """Kernel D and the wavefront give the same per-pixel sums (the
    JAX contract: bit-identical), staged or not."""
    _, ts = scenes["bounce"]
    xs, ys, _ = tr._swizzled_grid(W, H)
    d = tmk.render_tiles(ts, xs, ys, SPP, OFFSET)
    for cap in (None, 4):
        wf = twf.render_tiles_wavefront(ts, xs, ys, SPP, OFFSET,
                                        capacity_tiles=cap)
        torch.testing.assert_close(wf, d, rtol=0, atol=0)


def test_render_plain_sky_tiles_and_sample_offset(scenes):
    """gpu sky tiles add clip(miss) once per sample; the offset moves the
    jitter (another image), and spp sums are the frames' sums."""
    _, ts = scenes["bounce"]
    xs, ys, _ = tr._swizzled_grid(W, H)
    two = tmk.render_tiles(ts, xs, ys, 2, 5)
    one = [tmk.render_tiles(ts, xs, ys, 1, 5 + s) for s in range(2)]
    torch.testing.assert_close(two, one[0] + one[1], rtol=0, atol=0)
    assert not torch.equal(one[0], one[1])
    rows = tmk._scene_rows(ts, ts.accel)
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    order, entry = tmk.camera_tile_plan(ts.camera, xs_p, ys_p, ts.accel)
    sky = ~(entry[:, 0] < float("inf"))
    assert sky.any()
    r, g, b = tmk.render_tiles_plain(rows, xs_p, ys_p, ~sky, 3, 0, 3, False,
                                     True)
    miss = torch.clamp(rows.cam[12:15], 0.0, 1.0)
    for c, ch in enumerate((r, g, b)):
        assert torch.equal(ch[sky], torch.full_like(ch[sky], 0.0)
                           + miss[c] + miss[c] + miss[c])


class _Spy:
    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def spy(*a, **k):
            self.calls += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, name, spy)


def _route(monkeypatch, ts, frames=1):
    d = _Spy(monkeypatch, tmk, "render_tiles")
    wf = _Spy(monkeypatch, twf, "render_tiles_wavefront_frames")
    img = tr.render_scene_frames(ts, frames, "wang", 0)
    assert img.shape == (frames, H, W, 3)
    return d.calls, wf.calls


@pytest.mark.parametrize("case", ["wavefront_off", "terminal", "no_capacity",
                                  "staged"])
def test_dispatch_matches_jax(scenes, monkeypatch, case):
    """``RT_WAVEFRONT=0``, a terminal scene and a scene whose capacity
    calibration returns None each reach kernel D, as in the JAX
    package; a calibrated capacity reaches the wavefront."""
    monkeypatch.setenv("RT_WAVEFRONT_CAP", "auto")
    kind = "terminal" if case == "terminal" else "bounce"
    js, ts = scenes[kind]
    if case == "wavefront_off":
        monkeypatch.setenv("RT_WAVEFRONT", "0")
    if case == "staged":
        monkeypatch.setenv("RT_WAVEFRONT_CAP", "4")
    want = jr.resolve_wavefront(dataclasses.replace(js, use_pallas=True),
                                "wang", 1)
    got = tr.resolve_wavefront(ts, "wang", 1)
    assert got == want
    assert got[0] == (case == "staged")
    d_calls, wf_calls = _route(monkeypatch, ts, frames=2)
    if case == "staged":
        assert (d_calls, wf_calls) == (0, 1)
    else:
        assert (d_calls, wf_calls) == (2, 0)  # one D render per frame


def test_render_scene_spp_goes_through_the_kernel(scenes, monkeypatch):
    """spp > 1 without a wavefront is one D call over all samples."""
    monkeypatch.setenv("RT_WAVEFRONT", "0")
    _, ts = scenes["bounce"]
    d = _Spy(monkeypatch, tmk, "render_tiles")
    img = tr.render_scene(ts, "wang", spp_override=3)
    assert d.calls == 1 and img.shape == (H, W, 3)


def test_terminal_reference_image_for_the_card(monkeypatch):
    """The terminal two-frog image ``chip_smoke.py`` holds the card's D
    render against (``scripts/make_torch_golden.py``, JAX interpret
    mode) also holds for the plain version, at the production block
    size."""
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    from _torch_parity import two_frog_config

    ref = np.load(os.path.join(
        REPO, "tests/goldens/torch_two_frog_terminal_128x64.npy"))
    monkeypatch.setenv("RT_BLOCK_SIZE", "512")
    scene = build_scene(two_frog_config(
        SceneConfig, SceneNodeConfig, Transform, width=128, height=64,
        diffuse_bounce=False), device="cpu")
    assert scene.terminal_only
    got = tr.render_scene_frames(scene, ref.shape[0], "wang", 0).numpy()
    assert np.abs(got - ref).max() <= 1e-4  # as test_torch_render.py's
    for f in range(ref.shape[0]):
        assert_images_close(quantize(got[f], "gpu"), quantize(ref[f], "gpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("binned", [False, True])
@pytest.mark.parametrize("kind", ["terminal", "bounce"])
def test_cuda_render_kernel_matches_plain(scenes, kind, binned):
    """Kernel D against its plain version on the card: exact sums (the
    two keep one op order, without FMA contraction)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    ts = torch_from_jax(scenes[kind][0], device="cuda")
    xs, ys, _ = tr._swizzled_grid(W, H, device="cuda")
    xs_p, ys_p, n, _ = tmk._pad_tiles(xs, ys)
    rows = tmk._scene_rows(ts, ts.accel)
    plan = (tb.build_camera_candidate_plan(ts.camera, xs_p, ys_p, ts.accel,
                                           tmk.RAY_TILE, chunk=128)
            if binned else None)
    work = (plan.meta[:, 1] > 0 if binned else
            tmk.camera_tile_plan(ts.camera, xs_p, ys_p, ts.accel)[1][:, 0]
            < float("inf"))
    tmk.reset_launch_counts()
    got = tmk.render_tiles(ts, xs, ys, SPP, OFFSET, cand_plan=plan, rows=rows)
    want = tmk.render_tiles_plain(rows, xs_p, ys_p, work, SPP, OFFSET,
                                  ts.max_bounces, kind == "terminal",
                                  ts.diffuse_bounce, cand_plan=plan)
    want = torch.stack([c.reshape(-1)[:n] for c in want], dim=1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tmk.launch_counts()["render"] == 1
