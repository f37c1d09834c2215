"""The staged integrator of the PyTorch port: ``core.rng``'s samplers,
``ops.intersect.make_hit_frame``, ``ops.brdf``, ``ops.shading``,
``ops.integrator.trace_rays`` and the renderer's fallback
(``accumulate_samples``) for the scenes the fused kernels refuse.

Each is held against its JAX counterpart on the same inputs (numpy,
seeded; the two-frog scene's planes at block size 128, or the cpuonly
test scene of ``test_megakernel_cpuonly.py``), the JAX side with
``use_pallas=True`` in interpret mode where kernels E and F run, and
once with ``use_pallas=False`` (its XLA block walks).  rng rows,
visibility and hit flags must match exactly.  Floats: 4 ulp or 1e-5 on
the samplers, the BRDF, hit frames and direct light (both sides shade
the same hits); radiance and images within 1e-4 and
``assert_images_close`` (measured: 1.2e-5 on the cpuonly trace, whose
radiance is not clamped, 8.3e-6 on the gpu trace, 5.0e-6 on the image).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginonesemester_tpu.core import rng as jrng
from raytracinginonesemester_tpu.ops import accel as jaccel
from raytracinginonesemester_tpu.ops import brdf as jbrdf
from raytracinginonesemester_tpu.ops import intersect as jint
from raytracinginonesemester_tpu.ops import shading as jshade
from raytracinginonesemester_tpu.ops.integrator import trace_rays as j_trace
from raytracinginonesemester_tpu.render import renderer as jr
from raytracinginonesemester_tpu_torch.core import rng as trng
from raytracinginonesemester_tpu_torch.io.image import quantize
from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
from raytracinginonesemester_tpu_torch.ops import brdf as tbrdf
from raytracinginonesemester_tpu_torch.ops import intersect as tint
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.ops import shading as tshade
from raytracinginonesemester_tpu_torch.ops import wavefront as twf
from raytracinginonesemester_tpu_torch.ops.integrator import (
    make_bounce_step, trace_rays)
from raytracinginonesemester_tpu_torch.render import renderer as tr

from _torch_parity import (
    jax_two_frog, one_torch_thread, torch_from_jax, ulp_close)
from conftest import assert_images_close
from test_megakernel_cpuonly import _cpuonly_scene

W, H = 48, 24
ATOL_FRAME = 1e-5  # hit frames and direct light
ATOL_IMAGE = 1e-4


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _close(got, want, atol, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    ok = ulp_close(got, want, atol=atol)
    assert ok.all(), (f"{what}: {(~ok).sum()} of {ok.size} differ, max "
                      f"{np.abs(got - want)[~ok].max()}")


@pytest.fixture(scope="module")
def frog():
    js = jax_two_frog(width=W, height=H, max_bounces=3)
    return js, torch_from_jax(js)


def _camera_rays(js, sample=0):
    """The swizzled pixel stream's reference_cpu camera rays and seeds."""
    xs, ys, _ = jr._swizzled_grid(W, H)
    off = jrng.jittered_samples(1, 42, centered=True)[0]
    o, d = js.camera.get_rays(xs.astype(jnp.float32) + off[0],
                              ys.astype(jnp.float32) + off[1])
    seeds = jrng.make_rng_seed(xs, ys, sample)
    return np.asarray(o), np.asarray(d), np.asarray(seeds)


# --- samplers ---------------------------------------------------------


@pytest.mark.parametrize("spp,seed", [(1, 42), (7, 42), (16, 12345)])
def test_jittered_samples_bit_for_bit(spp, seed):
    for centered in (True, False):
        np.testing.assert_array_equal(
            trng.jittered_samples(spp, seed, centered),
            jrng.jittered_samples(spp, seed, centered))


def test_random_on_hemisphere_matches_jax():
    rng = np.random.default_rng(3)
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    state = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    js, jv = jrng.random_on_hemisphere(jnp.asarray(n), jnp.asarray(state))
    ts, tv = trng.random_on_hemisphere(_t(n), _t(state.astype(np.int64)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    _close(tv, jv, 1e-5, "hemisphere")
    assert ((tv * _t(n)).sum(dim=1) >= 0).all()
    jt, jb = jrng.make_basis(jnp.asarray(n))
    tt, tb = trng.make_basis(_t(n))
    _close(tt, jt, 1e-5, "basis t")
    _close(tb, jb, 1e-5, "basis b")


# --- hit frame, BRDF, direct light ------------------------------------


@pytest.fixture(scope="module")
def hits(frog):
    """Camera rays of sample 0 and their closest hits (JAX XLA walk)."""
    js, _ = frog
    o, d, seeds = _camera_rays(js)
    h = jaccel.block_closest(jnp.asarray(o), jnp.asarray(d), js.accel, 1e-4)
    th = tint.HitData(t=_t(h.t), u=_t(h.u), v=_t(h.v), tri_idx=_t(h.tri_idx),
                      hit=_t(h.hit))
    return o, d, seeds, h, th


@pytest.mark.parametrize("mode", ["hw1", "cpuonly", "gpu"])
def test_make_hit_frame_matches_jax(frog, hits, mode):
    js, ts = frog
    o, d, _, jh, th = hits
    want = jint.make_hit_frame(jnp.asarray(o), jnp.asarray(d), jh,
                               js.geometry.vertices, js.geometry.normals,
                               mode=mode)
    got = tint.make_hit_frame(_t(o), _t(d), th, ts.geometry.vertices,
                              ts.geometry.normals, mode=mode)
    hit = th.hit.numpy()
    assert 0 < hit.sum() < hit.size
    _close(got[0][hit], np.asarray(want[0])[hit], ATOL_FRAME, "p")
    _close(got[1][hit], np.asarray(want[1])[hit], ATOL_FRAME, "normal")
    np.testing.assert_array_equal(got[2].numpy()[hit], np.asarray(want[2])[hit])


def test_evaluate_brdf_matches_jax(frog):
    js, ts = frog
    rng = np.random.default_rng(5)
    n_r = 4096

    def unit(a):
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)

    n, v, l = (unit(rng.normal(size=(n_r, 3))) for _ in range(3))
    obj = rng.integers(0, 2, n_r).astype(np.int32)
    want = jbrdf.evaluate_brdf(js.materials.gather(jnp.asarray(obj)),
                               jnp.asarray(n), jnp.asarray(v), jnp.asarray(l))
    got = tbrdf.evaluate_brdf(ts.materials.gather(_t(obj)), _t(n), _t(v), _t(l))
    _close(got, want, 1e-5, "brdf")
    assert 0 < int((got.sum(dim=1) > 0).sum()) < n_r


def _shade_inputs(js, hits):
    """Shade points (misses parked at 1e30), normals and winner ids of
    the JAX hit frame, which both sides then shade."""
    o, d, _, jh, _ = hits
    jp, jn, _ = jint.make_hit_frame(jnp.asarray(o), jnp.asarray(d), jh,
                                    js.geometry.vertices,
                                    js.geometry.normals, mode=js.dialect)
    p = np.where(np.asarray(jh.hit)[:, None], np.asarray(jp), 1e30)
    return p.astype(np.float32), np.asarray(jn), np.asarray(jh.tri_idx)


@pytest.mark.parametrize("case", ["gpu", "cpuonly_area4", "cpuonly_area17"])
def test_shade_direct_matches_jax(frog, hits, case):
    """gpu: hard shadows per light; cpuonly: an area light's disk-sampled
    soft shadows (4 and 17 samples), rng rows exact.  Both sides shade
    the same points and trace their shadow rays through their own
    block-grid occlusion (JAX: the XLA walk; port: kernel F's plain
    version)."""
    js, ts = frog
    if case != "gpu":
        samples = int(case.rsplit("area", 1)[1])
        light = dict(radius=jnp.full_like(js.lights.radius, 0.15))
        js = dataclasses.replace(
            js, dialect="cpuonly",
            lights=dataclasses.replace(js.lights, shadow_samples=(samples,) * 2,
                                       **light))
        ts = torch_from_jax(js)
    dialect = js.dialect
    o, d, seeds, _, _ = hits
    p, n, idx = _shade_inputs(js, hits)
    obj = np.asarray(js.geometry.obj_id)[np.maximum(idx, 0)]
    eps = 1e-8 if dialect == "gpu" else 1.1920929e-7

    def j_occ(oo, dd, tmin, tmax):
        return jaccel.block_occluded(oo, dd, js.accel, tmin, tmax, det_eps=eps)

    def t_occ(oo, dd, tmin, tmax):
        return bk.block_occluded(oo, dd, ts.accel, tmin, tmax, det_eps=eps)

    want, w_state = jshade.shade_direct(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(p), jnp.asarray(n),
        js.materials.gather(jnp.asarray(obj)), js.lights, j_occ,
        jnp.asarray(seeds), dialect=dialect)
    got, g_state = tshade.shade_direct(
        _t(o), _t(d), _t(p), _t(n), ts.materials.gather(_t(obj)), ts.lights,
        t_occ, trng.to_u32(_t(seeds)), dialect=dialect)
    np.testing.assert_array_equal(g_state.numpy(),
                                  np.asarray(w_state).astype(np.int64))
    _close(got, want, ATOL_FRAME, "direct light")
    if case != "gpu":
        assert (g_state.numpy() != seeds.astype(np.int64)).any()


# --- trace_rays -------------------------------------------------------


def _trace_case(name):
    if name == "gpu_diffuse":
        js = jax_two_frog(width=W, height=H, max_bounces=3)
    else:
        js = _cpuonly_scene(width=W, height=H, kr_ball=0.7, max_bounces=3,
                            diffuse_bounce=True, radius=0.15,
                            shadow_samples=17)
    return dataclasses.replace(js, use_pallas=True)


@pytest.mark.parametrize("name", ["gpu_diffuse", "cpuonly_area17"])
def test_trace_rays_matches_jax(name):
    """Depth 3 with diffuse bounces: the gpu dialect (E with fused
    normals and shadows) and cpuonly with a 17-sample area light (E, and
    F per sample), against JAX's Pallas kernels in interpret mode."""
    js = _trace_case(name)
    ts = torch_from_jax(js)
    o, d, seeds = _camera_rays(js)
    want = np.asarray(jax.jit(lambda a, b, c: j_trace(a, b, c, js))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(seeds)))
    got = trace_rays(_t(o), _t(d), _t(seeds.astype(np.int64)), ts)
    _close(got, want, ATOL_IMAGE, name)
    assert want.std() > 0.05
    if name == "gpu_diffuse":
        assert want.max() <= 1.0
    else:
        assert want.max() > 1.0  # no clamp in cpuonly


def test_bounce_step_refuses_what_waits_for_later_slices(frog):
    """Triangle sharding builds a bounce step for forward and
    differentiable scenes (it runs in ``test_torch_parallel.py``); an
    oracle serves differentiable scenes only, and no triangle-sharded
    one; differentiable scenes trace (their modes are held against JAX
    in ``test_torch_diff.py``)."""
    _, ts = frog
    diff = dataclasses.replace(ts, differentiable=True)
    group = object()  # a process group; building the step calls nothing
    for scene in (ts, diff):
        assert callable(make_bounce_step(scene, model_axis=group))
    with pytest.raises(ValueError, match="oracle"):
        make_bounce_step(ts, oracle={})
    with pytest.raises(ValueError, match="triangle-sharded"):
        make_bounce_step(diff, model_axis=group, oracle={})
    rays = [_t(a) for a in _camera_rays(frog[0])]
    got = trace_rays(*rays, diff)
    want = trace_rays(*rays, ts)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# --- the renderer's staged path ---------------------------------------


@pytest.fixture(scope="module")
def ref_render(frog):
    js, ts = frog
    img = tr.render_scene(ts, "reference_cpu", spp_override=2).numpy()
    return js, ts, img


@pytest.mark.parametrize("use_pallas", [True, False])
def test_render_scene_reference_cpu_matches_jax(ref_render, use_pallas):
    """reference_cpu, spp 2: JAX with its Pallas kernels (interpret) and
    with its XLA block walks."""
    js, _, got = ref_render
    want = np.asarray(jr.render_scene(
        dataclasses.replace(js, use_pallas=use_pallas), "reference_cpu",
        spp_override=2))
    _close(got, want, ATOL_IMAGE, f"image use_pallas={use_pallas}")
    assert_images_close(quantize(got, "gpu"), quantize(want, "gpu"),
                        context=f"use_pallas={use_pallas}")


def test_ray_tile_does_not_change_the_image(ref_render):
    _, ts, whole = ref_render
    for tile in (500, 4096):
        img = tr.render_scene(ts, "reference_cpu", spp_override=2,
                              ray_tile=tile).numpy()
        np.testing.assert_array_equal(img, whole)


def test_render_scene_frames_fallback_equals_single_frames(frog):
    """Every frame of the staged fallback equals the single-frame render
    at its sample offset (reference_cpu: jitter offset 0 every frame,
    seeds by sample)."""
    _, ts = frog
    frames = tr.render_scene_frames(ts, 2, "reference_cpu", 5).numpy()
    for f in range(2):
        one = tr.render_scene(ts, "reference_cpu", spp_override=1,
                              sample_offset=5 + f).numpy()
        np.testing.assert_array_equal(frames[f], one)
    assert not np.array_equal(frames[0], frames[1])


# --- dispatch ---------------------------------------------------------


@pytest.fixture
def spy(monkeypatch):
    """Counts calls of the staged path and of the fused kernels' wrappers."""
    calls = {"staged": 0, "fused": 0}
    staged = tr.accumulate_samples

    def count_staged(*a, **k):
        calls["staged"] += 1
        return staged(*a, **k)

    monkeypatch.setattr(tr, "accumulate_samples", count_staged)
    for mod, name in ((tmk, "render_tiles"), (tmk, "emit_tiles"),
                      (twf, "emit_tiles")):
        fn = getattr(mod, name)

        def count_fused(*a, _fn=fn, **k):
            calls["fused"] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, count_fused)
    return calls


def _small_cpuonly(**kw):
    return torch_from_jax(_cpuonly_scene(width=32, height=16, **kw))


@pytest.mark.parametrize("case", ["gpu_reference_cpu", "gpu_center",
                                  "cpuonly_reference_cpu", "cpuonly_17",
                                  "no_accel"])
def test_fused_refusals_render_on_the_staged_path(frog, spy, case):
    _, ts = frog
    jitter = "reference_cpu"
    if case == "gpu_center":
        jitter = "center"
    elif case == "cpuonly_reference_cpu":
        ts = _small_cpuonly()
    elif case == "cpuonly_17":
        # a 17-sample area light: the fused kernels take it at "auto"
        # (ROADMAP §3), so the oracle's jitter keeps it on E and F
        ts = _small_cpuonly(radius=0.15, shadow_samples=17)
    elif case == "no_accel":
        # brute force over every triangle: the small scene keeps it quick
        ts, jitter = dataclasses.replace(_small_cpuonly(), accel=None), "auto"
    img = tr.render_scene(ts, jitter)
    assert spy == {"staged": 1, "fused": 0}
    assert torch.isfinite(img).all() and float(img.std()) > 0.02


@pytest.mark.parametrize("case", ["gpu_wang", "cpuonly_center"])
def test_fused_scenes_still_take_the_fused_kernels(frog, spy, case):
    _, ts = frog
    if case == "cpuonly_center":
        ts = _small_cpuonly(radius=0.15, shadow_samples=16)
    tr.render_scene(ts, "auto")
    assert spy["staged"] == 0 and spy["fused"] >= 1


def test_differentiable_scenes_still_raise(frog, spy, recwarn):
    """Differentiable scenes no longer raise: they render on the staged
    path without a fallback warning (the fused kernels have no
    gradient), and under triangle sharding in the detached mode (the
    oracle serves no sharded grid)."""
    _, ts = frog
    diff = dataclasses.replace(ts, differentiable=True)
    img = tr.render_scene(diff)
    frames = tr.render_scene_frames(diff, 1)
    assert spy == {"staged": 2, "fused": 0}
    assert not [w for w in recwarn if "fused kernels" in str(w.message)]
    assert torch.isfinite(img).all() and float(img.std()) > 0.02
    torch.testing.assert_close(frames[0], img, rtol=0, atol=0)
    from raytracinginonesemester_tpu_torch.ops.diff_oracle import (
        oracle_eligible)

    assert oracle_eligible(diff) and not oracle_eligible(diff, object())


# --- on the card ------------------------------------------------------


@pytest.mark.cuda
def test_cuda_staged_render_matches_cpu(frog):
    """The staged render on the card (kernels E and F) equals the CPU
    render (their plain versions) within the image tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    js, ts = frog
    tc = torch_from_jax(js, device="cuda")
    bk.reset_launch_counts()
    got = tr.render_scene(tc, "reference_cpu", spp_override=2).cpu().numpy()
    assert bk.launch_counts()["closest"] > 0
    want = tr.render_scene(ts, "reference_cpu", spp_override=2).numpy()
    _close(got, want, ATOL_IMAGE, "card vs cpu")
