"""The cpuonly dialect (``HW2/CPUOnly``'s ``TraceRay``) in the port's
kernels A (emit), B (bounce_step), C (resume) and D (render).

Each plain version is held against the JAX package's Pallas kernel in
interpret mode on the same planes, for a point light with a mirror ball
(diffuse off, pixel-center jitter: the ``cpuonly_mirror.json`` scene)
and an area light (radius 0.15, 4 disk-sampled shadow walks) with
diffuse bounces and the same mirror (Wang jitter, spp 2).  Alive and rng
rows must match exactly: the disk samples and the RR draw decide every
later bounce.  Float tolerances are the gpu dialect's, for the same
cause (XLA:CPU's FMA contraction in the reference, see
``test_torch_megakernel.py``): 4 ulp or 5e-5 on emit states, 4 ulp or
1e-5 on B and C fed the JAX emit state and on D's sums (measured max
3.3e-6 for the point light, 9.1e-6 for the area light).

Then the port renders ``cpuonly_point.json`` and ``cpuonly_mirror.json``
at their own 160x100 against the C++ oracle's PNGs, within one
quantization step, as ``test_golden_cpuonly.py`` holds the JAX fused
kernels.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginonesemester_tpu.ops import megakernel as jmk
from raytracinginonesemester_tpu.ops.wavefront import bounce_tile_plan
from raytracinginonesemester_tpu.render.renderer import _swizzled_grid as j_grid
from raytracinginonesemester_tpu_torch.io.image import quantize, read_png
from raytracinginonesemester_tpu_torch.ops import binned as tb
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.render.renderer import (
    _swizzled_grid as t_grid, render_scene)
from raytracinginonesemester_tpu_torch.scene.build import load_scene

from _torch_parity import REPO, one_torch_thread, torch_from_jax, ulp_close
from test_megakernel_cpuonly import _cpuonly_scene

W, H = 48, 24
CASES = {
    # name: (scene kwargs, jitter, spp)
    "point_mirror": (dict(kr_ball=0.7, max_bounces=4), "center", 1),
    "area_diffuse": (dict(kr_ball=0.7, max_bounces=3, diffuse_bounce=True,
                          radius=0.15, shadow_samples=4, spp=2), "wang", 2),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw, jitter, spp = CASES[request.param]
    js = _cpuonly_scene(width=W, height=H, **kw)
    js = dataclasses.replace(js, terminal_only=False)
    ts = torch_from_jax(js)
    jkw = jmk.megakernel_kwargs(js, jitter)
    tkw = tmk.megakernel_kwargs(ts, jitter)
    assert {k: v for k, v in jkw.items() if k != "det_eps"} == \
        {k: v for k, v in tkw.items() if k != "det_eps"}
    assert np.float32(jkw["det_eps"]) == np.float32(tkw["det_eps"])
    xs, ys, _ = j_grid(W, H)
    st, rng = jmk.emit_tiles(js, xs, ys, 0, interpret=True, **jkw)
    return dict(name=request.param, js=js, ts=ts, jkw=jkw, tkw=tkw,
                jitter=jitter, spp=spp, st=np.asarray(st), rng=np.asarray(rng))


def _no_jitter(kw):
    return {k: v for k, v in kw.items() if k != "jitter"}


def _assert_state_close(got_st, got_rng, want_st, want_rng, atol):
    nt = want_st.shape[0] // 16
    a = np.asarray(got_st).reshape(nt, 16, -1)
    b = np.asarray(want_st).reshape(nt, 16, -1)
    np.testing.assert_array_equal(a[:, 12], b[:, 12])  # alive
    np.testing.assert_array_equal(np.asarray(got_rng), np.asarray(want_rng))
    for r in range(16):
        ok = ulp_close(a[:, r], b[:, r], ulps=4, atol=atol)
        assert ok.all(), (f"row {r}: {(~ok).sum()} elements, max diff "
                          f"{np.abs(a[:, r] - b[:, r]).max()}")


def test_emit_matches_jax(case):
    xs, ys, _ = t_grid(W, H)
    st, rng = tmk.emit_tiles(case["ts"], xs, ys, 0, **case["tkw"])
    _assert_state_close(st, rng, case["st"], case["rng"], 5e-5)
    alive = case["st"].reshape(-1, 16, tmk.RAY_TILE)[:, 12]
    assert 0 < alive.sum() < alive.size


def test_binned_emit_matches_flat_emit(case):
    """cpuonly keeps every tile on the full path (no sky shortcut); the
    binned walk gives the same states bit for bit."""
    ts = case["ts"]
    xs, ys, _ = t_grid(W, H)
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    plan = tb.build_camera_candidate_plan(ts.camera, xs_p, ys_p, ts.accel,
                                          tmk.RAY_TILE, chunk=128)
    flat = tmk.emit_tiles(ts, xs, ys, 0, **case["tkw"])
    binned = tmk.emit_tiles(ts, xs, ys, 0, cand_plan=plan, **case["tkw"])
    for a, b in zip(flat, binned):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bounce_step_cross_fed_from_jax_emit(case):
    st, rng = case["st"], case["rng"]
    order, entry = bounce_tile_plan(jnp.asarray(st), case["js"].accel)
    want = jmk.bounce_step_tiles(case["js"], jnp.asarray(st), jnp.asarray(rng),
                                 order, entry, interpret=True,
                                 **_no_jitter(case["jkw"]))
    got = tmk.bounce_step_tiles(case["ts"], torch.from_numpy(st.copy()),
                                torch.from_numpy(rng.copy()),
                                **_no_jitter(case["tkw"]))
    _assert_state_close(got[0], got[1], want[0], want[1], 1e-5)


def test_resume_cross_fed_from_jax_emit(case):
    st, rng = case["st"], case["rng"]
    want = jmk.resume_tiles(case["js"], jnp.asarray(st), jnp.asarray(rng),
                            interpret=True, **_no_jitter(case["jkw"]))
    got = tmk.resume_tiles(case["ts"], torch.from_numpy(st.copy()),
                           torch.from_numpy(rng.copy()),
                           **_no_jitter(case["tkw"]))
    for g, w in zip(got, want):
        ok = ulp_close(g.numpy(), np.asarray(w), ulps=4, atol=1e-5)
        assert ok.all(), f"{(~ok).sum()} differ, max {np.abs(g.numpy() - w).max()}"


def test_render_tiles_matches_jax(case):
    xs, ys, _ = j_grid(W, H)
    want = np.asarray(jmk.render_tiles(case["js"], xs, ys, case["spp"], 1,
                                       interpret=True, **case["jkw"]))
    txs, tys, _ = t_grid(W, H)
    got = tmk.render_tiles(case["ts"], txs, tys, case["spp"], 1,
                           **case["tkw"]).numpy()
    ok = ulp_close(got, want, ulps=4, atol=1e-5)
    assert ok.all(), f"{(~ok).sum()} sums differ, max {np.abs(got - want).max()}"
    assert want.max() > 1.0 * case["spp"]  # no per-sample clamp


def test_ineligible_cpuonly_scenes_raise(case, monkeypatch):
    """The cpuonly scenes the fused kernels refuse (more than 16 shadow
    samples, ``reference_cpu`` jitter; the JAX package's reasons) no
    longer raise: they take the staged integrator, whose renders
    ``test_torch_integrator.py`` holds against the JAX package."""
    from raytracinginonesemester_tpu_torch.render import renderer

    ts = case["ts"]
    many = dataclasses.replace(ts, lights=dataclasses.replace(
        ts.lights, shadow_samples=(17,)))
    assert "shadow_samples=17 > 16" in tmk.megakernel_ineligible_reason(
        many, case["jitter"])
    assert "jitter_mode='reference_cpu'" in tmk.megakernel_ineligible_reason(
        ts, "reference_cpu")
    staged = []

    def accumulate(scene, xs, ys, spp, jitter_mode, *rest):
        staged.append(jitter_mode)
        return torch.zeros(xs.shape[0], 3)

    monkeypatch.setattr(renderer, "accumulate_samples", accumulate)
    render_scene(many)
    render_scene(ts, jitter_mode="reference_cpu")
    assert staged == [renderer.resolve_jitter_mode(many, "auto", many.spp),
                      "reference_cpu"]


@pytest.mark.parametrize("name", ["cpuonly_point", "cpuonly_mirror"])
def test_cpuonly_golden(name):
    """The C++ oracle (``HW2/CPUOnly``) at the scene's own 160x100: at
    most one quantization step per channel."""
    scene = load_scene(os.path.join(REPO, "tests/assets/scenes", f"{name}.json"),
                       device="cpu")
    assert scene.dialect == "cpuonly"
    img = render_scene(scene).numpy()
    ours = quantize(img, "cpuonly").astype(int)
    gold = read_png(os.path.join(REPO, "tests/goldens", f"{name}.png")).astype(int)
    assert ours.shape == gold.shape
    assert np.abs(ours - gold).max() <= 1


def test_read_png_needs_no_pillow():
    """The port's zlib PNG reader decodes the goldens as Pillow does."""
    from raytracinginonesemester_tpu.io.image import read_png as pil_read

    for name in ("cpuonly_point", "cpuonly_mirror", "gpu_frog", "hw1_sphere"):
        path = os.path.join(REPO, "tests/goldens", f"{name}.png")
        np.testing.assert_array_equal(read_png(path), pil_read(path))


@pytest.mark.cuda
def test_cuda_cpuonly_kernels_match_plain(case):
    """A, B, C and D of the cpuonly dialect against their plain versions
    on the card: alive and rng rows and every float exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    ts = torch_from_jax(case["js"], device="cuda")
    kw, nj = case["tkw"], _no_jitter(case["tkw"])
    plain_kw = {k: v for k, v in nj.items() if k != "dialect"}
    rows = tmk._scene_rows(ts, ts.accel)
    xs, ys, _ = t_grid(W, H, device="cuda")
    xs_p, ys_p, n, _ = tmk._pad_tiles(xs, ys)
    work = torch.ones(xs_p.numel() // tmk.RAY_TILE, dtype=torch.bool,
                      device="cuda")
    st, rng = tmk.emit_tiles(ts, xs_p, ys_p, 0, rows=rows, **kw)
    pst, prng = tmk.emit_tiles_plain(rows, xs_p, ys_p, work, 0,
                                     ts.diffuse_bounce, dialect="cpuonly",
                                     jitter=case["jitter"], **plain_kw)
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
    d_k = tmk.render_tiles(ts, xs, ys, case["spp"], 1, rows=rows, **kw)
    d_p = tmk.render_tiles_plain(rows, xs_p, ys_p, work, case["spp"], 1,
                                 ts.max_bounces, False, ts.diffuse_bounce,
                                 dialect="cpuonly", jitter=case["jitter"],
                                 **plain_kw)
    torch.testing.assert_close(
        d_k, torch.stack([c.reshape(-1)[:n] for c in d_p], dim=1),
        rtol=0, atol=0)
