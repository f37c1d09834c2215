"""The large-scene path of the PyTorch port: ``scene/subdivide.py``, the
tile visit plan (``ops/accel.py``), the plane-budget rule and the streamed
kernels G and I and the block-major kernel H (``ops/block_kernels.py``),
and the staged integrator's dispatch to them (``ops/integrator.py``).

Each is held against the JAX package on the CPU: its numpy subdivision,
its ``tile_visit_plan_fast``, its Pallas kernels in interpret mode
(``pallas_block_closest_streamed``, ``pallas_block_occluded_streamed``,
``pallas_block_closest_blockmajor``, ``pallas_block_occluded_blockmajor``)
and its render with the plane budget lowered so that a small scene goes
over it.  Bounds: subdivided arrays, plan counts and active sets, gates,
winner ids and blocked flags exact; plan entries and t within 4 ulp or
1e-5 (the plan's interval products are contracted into FMAs by XLA:CPU,
ROADMAP section 3); u and v within 4 ulp or 2e-4 (kernel E's measured
bound); images within 1e-4 and ``assert_images_close``.  The CUDA
kernels themselves run only on a card (``cuda`` marker, and
``chip_smoke.py`` at full width).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracinginonesemester_tpu as jrt
import raytracinginonesemester_tpu.ops.pallas_kernels as pk
from raytracinginonesemester_tpu.core.camera import Camera as JCamera
from raytracinginonesemester_tpu.ops import accel as jaccel
from raytracinginonesemester_tpu.ops import diff_oracle as jdo
from raytracinginonesemester_tpu.ops import megakernel as jmk
from raytracinginonesemester_tpu.render import renderer as jr
from raytracinginonesemester_tpu.scene import subdivide as jsub
from raytracinginonesemester_tpu.scene.build import build_scene as jbuild
from raytracinginonesemester_tpu.scene.config import load_scene_config
from raytracinginonesemester_tpu_torch.ops import accel as taccel
from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
from raytracinginonesemester_tpu_torch.ops import diff_oracle as tdo
from raytracinginonesemester_tpu_torch.ops import integrator as tint
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.ops import wavefront as twf
from raytracinginonesemester_tpu_torch.ops.accel import BlockGrid
from raytracinginonesemester_tpu_torch.render import renderer as tr
from raytracinginonesemester_tpu_torch.scene import subdivide as tsub

from _torch_parity import (REPO, jax_two_frog,  # noqa: F401
                           one_torch_thread, staged_image, torch_from_jax,
                           ulp_close)
from conftest import assert_images_close

UV_ATOL = 2e-4  # kernel E's measured bound on the frog (ROADMAP section 3)
ATOL_IMAGE = 1e-4
W, H = 48, 24
STREAMED = ("block_closest_streamed", "block_occluded_streamed")
BLOCKMAJOR = ("block_closest_blockmajor", "block_occluded_blockmajor")
RESIDENT = ("block_closest", "block_occluded")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _torch_grid(grid) -> BlockGrid:
    return BlockGrid(*(torch.from_numpy(np.array(getattr(grid, n)))
                       for n in ("tri", "norm", "tri_index", "obj", "aabb")),
                     block_size=grid.block_size)


def _assert_hits(got, want):
    np.testing.assert_array_equal(got.tri_idx.numpy(), np.asarray(want.tri_idx))
    for name, atol in (("t", 1e-5), ("u", UV_ATOL), ("v", UV_ATOL)):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        ok = ulp_close(a, b, atol=atol)
        assert ok.all(), f"{name}: {(~ok).sum()} differ"
    assert 0 < int(got.hit.sum()) < got.hit.numel()


# --- scene/subdivide.py ----------------------------------------------


@pytest.fixture(scope="module")
def frog():
    js = jax_two_frog(width=64, height=32)
    return js, torch_from_jax(js)


@pytest.mark.parametrize("levels", [1, 2])
def test_subdivide_matches_jax(frog, levels):
    js, ts = frog
    want = jsub.subdivide_geometry(js.geometry, levels)
    got = tsub.subdivide_geometry(ts.geometry, levels)
    assert got.num_triangles == want.num_triangles == (
        4 ** levels * js.geometry.num_triangles)
    for name in ("vertices", "normals", "obj_id"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    t = js.geometry.num_triangles
    arrays = [np.asarray(a)[:t] for a in (js.geometry.vertices,
                                          js.geometry.normals,
                                          js.geometry.obj_id)]
    for a, b in zip(tsub.subdivide_tris(*arrays, levels),
                    jsub.subdivide_tris(*arrays, levels)):
        np.testing.assert_array_equal(a, b)


# --- the plan, the budget rule, the operands --------------------------


def _frog_rays(js, seed=5):
    """Camera rays of the two-frog scene plus seeded rays inside its box,
    the last 512 of them parked at 1e30, each set padded as G pads."""
    ys, xs = np.mgrid[0:js.camera.height, 0:js.camera.width]
    co, cd = (np.asarray(a) for a in js.camera.get_rays(
        jnp.asarray(xs.ravel() + 0.5, jnp.float32),
        jnp.asarray(ys.ravel() + 0.5, jnp.float32)))
    r = co.shape[0]
    rng = np.random.default_rng(seed)
    aabb = np.asarray(js.accel.aabb)
    lo, hi = aabb[:3].min(axis=1), aabb[3:].max(axis=1)
    bo = (lo + rng.uniform(0, 1, (r, 3)) * (hi - lo)).astype(np.float32)
    bd = rng.normal(size=(r, 3)).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    bo[-512:] = 1e30
    return {"camera": (co, cd), "bounce": (bo, bd)}


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_tile_visit_plan_matches_jax(frog, rays):
    """Counts and active sets exact, entries within 4 ulp, and the order
    wherever the entries differ by more (an FMA-contracted entry may swap
    two near-equal superblocks; winners do not depend on the order)."""
    js, ts = frog
    o, d = _frog_rays(js)[rays]
    jrays, _ = pk._prep_rays(jnp.asarray(o), jnp.asarray(d), 1e-4, pk.F32_MAX)
    jo, je, jc = jaccel.tile_visit_plan_fast(
        jrays[:, 0:3], jrays[:, 3:6], js.accel, jrays[:, 6], jrays[:, 7], 512)
    trays, _ = bk._prep_rays(_t(o), _t(d), 1e-4, bk.F32_MAX)
    np.testing.assert_array_equal(trays.numpy(), np.asarray(jrays))
    to, te, tc = taccel.tile_visit_plan_fast(
        trays[:, 0:3], trays[:, 3:6], ts.accel, trays[:, 6], trays[:, 7],
        512)
    jo, je = np.asarray(jo), np.asarray(je)
    to, te = to.numpy(), te.numpy()
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert to.dtype == np.int32 and tc.numpy().max() > 0
    rows = np.arange(jo.shape[0])[:, None]
    j_by = np.empty_like(je)
    j_by[rows, jo] = je
    t_by = np.empty_like(te)
    t_by[rows, to] = te
    np.testing.assert_array_equal(np.isfinite(t_by), np.isfinite(j_by))
    fin = np.isfinite(j_by)
    assert ulp_close(t_by[fin], j_by[fin], atol=0.0).all()
    # the port's order sorts JAX's entries up to 4 ulp
    walked = j_by[rows, to]
    step = np.diff(walked, axis=1)
    ok = ~np.isfinite(walked[:, 1:]) | (step >= 0) | ulp_close(
        walked[:, 1:], walked[:, :-1], atol=0.0)
    assert ok.all()


def test_plane_budget_rule_matches_jax(frog, monkeypatch):
    js, ts = frog
    assert bk._VMEM_TRI_BUDGET_BYTES == pk._VMEM_TRI_BUDGET_BYTES
    assert bk.fits_vmem(ts.accel) and bk.num_chunks_for(ts.accel) == 1
    one = pk._grid_bytes(1, 128)
    for budget in (3 * one, 17 * one, 60 * one):
        monkeypatch.setattr(pk, "_VMEM_TRI_BUDGET_BYTES", budget)
        monkeypatch.setattr(bk, "_VMEM_TRI_BUDGET_BYTES", budget)
        assert bk.fits_vmem(ts.accel) == pk.fits_vmem(js.accel)
        assert bk.num_chunks_for(ts.accel) == pk.num_chunks_for(js.accel) > 1
        assert bk._grid_bytes(7, 512) == pk._grid_bytes(7, 512)


def test_stream_operands_match_jax(frog):
    js, ts = frog
    for got, want in zip(bk._stream_grid_operands(ts.accel),
                         pk._stream_grid_operands(js.accel)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # H's slabs: its padded block AABBs and the slabs' union rows
    aabb, union, nj = bk._slab_aabbs(ts.accel, 8)
    _, _, want_aabb, want_union, want_nj = pk._blockmajor_operands(
        js.accel, 8)
    np.testing.assert_array_equal(
        aabb.T.numpy(), np.asarray(want_aabb)[:aabb.shape[1], :6])
    np.testing.assert_array_equal(union.numpy(), np.asarray(want_union))
    assert nj == want_nj


# --- kernels G and I --------------------------------------------------


@pytest.fixture(scope="module")
def random_scene():
    """``test_pallas.py``'s streamed setup: 4096 random triangles at block
    size 128, 1024 rays from one point."""
    rs = np.random.RandomState(7)
    tris = jnp.asarray(rs.uniform(-1, 1, (4096, 3, 3)).astype(np.float32))
    grid = jaccel.build_block_grid(tris, jnp.asarray(4096), block_size=128)
    o = np.tile([0.0, -3.0, 0.0], (1024, 1)).astype(np.float32)
    d = rs.uniform(-1, 1, (1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return grid, _torch_grid(grid), o, d


def test_streamed_kernels_match_pallas_on_random_triangles(random_scene):
    grid, tg, o, d = random_scene
    want = pk.pallas_block_closest_streamed(jnp.asarray(o), jnp.asarray(d),
                                            grid, 1e-4, interpret=True)
    _assert_hits(bk.block_closest_streamed(_t(o), _t(d), tg, 1e-4), want)
    tmax = np.full(1024, 2.5, np.float32)
    want = np.asarray(pk.pallas_block_occluded_streamed(
        jnp.asarray(o), jnp.asarray(d), grid, 1e-4, jnp.asarray(tmax),
        interpret=True))
    got = bk.block_occluded_streamed(_t(o), _t(d), tg, 1e-4, _t(tmax))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_streamed_kernels_match_pallas_on_the_two_frog_grid(frog):
    """The two-frog grid's camera rays (G), then shadow rays from their
    hits toward the first light, misses parked at 1e30 (I)."""
    js, ts = frog
    co, cd = _frog_rays(js)["camera"]
    want = pk.pallas_block_closest_streamed(jnp.asarray(co), jnp.asarray(cd),
                                            js.accel, 1e-4, interpret=True)
    got = bk.block_closest_streamed(_t(co), _t(cd), ts.accel, 1e-4)
    _assert_hits(got, want)
    hit = np.asarray(want.hit)
    p = co + np.asarray(want.t)[:, None] * cd
    p[~hit] = 1e30
    to = np.asarray(js.lights.position)[0] - p
    with np.errstate(over="ignore"):
        dist = np.sqrt((to * to).sum(axis=1)).astype(np.float32)
    sd = (to / np.maximum(dist, 1e-20)[:, None]).astype(np.float32)
    want = np.asarray(pk.pallas_block_occluded_streamed(
        jnp.asarray(p), jnp.asarray(sd), js.accel, 1e-3, jnp.asarray(dist),
        interpret=True))
    got = bk.block_occluded_streamed(_t(p), _t(sd), ts.accel, 1e-3,
                                     _t(dist)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < hit.sum() and not got[~hit].any()


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_plain_streamed_equal_plain_e_and_f(frog, rays):
    """G's walk gives E's winners and I's F's flags bit for bit (the take
    rule does not depend on the order, and the culling is conservative)."""
    _, ts = frog
    o, d = (_t(a) for a in _frog_rays(frog[0])[rays])
    s_g, s_e = {}, {}
    g = bk.block_closest_streamed_plain(o, d, ts.accel, 1e-4, stats=s_g)
    e = bk.block_closest_plain(o, d, ts.accel, 1e-4, stats=s_e)
    for a, b in ((g.t, e.t), (g.u, e.u), (g.v, e.v), (g.tri_idx, e.tri_idx)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert 0 < s_g["staged_blocks"] and 0 < s_g["pairs"]
    tmax = torch.full((o.shape[0],), 0.3)
    torch.testing.assert_close(
        bk.block_occluded_streamed_plain(o, d, ts.accel, 1e-4, tmax),
        bk.block_occluded_plain(o, d, ts.accel, 1e-4, tmax), rtol=0, atol=0)


# --- kernel H ---------------------------------------------------------


def test_blockmajor_kernels_and_gate_match_pallas(random_scene):
    """4096 rays at ``chunk_tiles=4``, ``slab_blocks=8``: 2 ray chunks by
    4 scene slabs, and a gate that turns one chunk away from some slabs."""
    grid, tg, _, _ = random_scene
    rs = np.random.RandomState(11)
    r = 4096
    o = (np.tile([0.0, -3.0, 0.0], (r, 1))
         + 0.1 * rs.uniform(-1, 1, (r, 3))).astype(np.float32)
    d = rs.uniform(-1, 1, (r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # the second chunk looks along -y only: away from every slab in front
    d[2048:, 1] = -np.abs(d[2048:, 1]) - 2.0
    d[2048:] /= np.linalg.norm(d[2048:], axis=1, keepdims=True)
    kw = dict(chunk_tiles=4, slab_blocks=8)
    jrays, _ = pk._prep_rays(jnp.asarray(o), jnp.asarray(d), 1e-4, pk.F32_MAX)
    _, _, _, union, nj = pk._blockmajor_operands(grid, 8)
    want_gate = np.asarray(pk._chunk_slab_gate(jrays, 2048, union, nj))
    trays, _ = bk._prep_rays(_t(o), _t(d), 1e-4, bk.F32_MAX)
    _, tunion, tnj = bk._slab_aabbs(tg, 8)
    gate = bk._chunk_slab_gate(trays, 2048, tunion, tnj).numpy()
    np.testing.assert_array_equal(gate, want_gate)
    assert gate.shape == (2, 4) and gate[0].all() and not gate[1].all()
    want = pk.pallas_block_closest_blockmajor(
        jnp.asarray(o), jnp.asarray(d), grid, 1e-4, interpret=True, **kw)
    got = bk.block_closest_blockmajor(_t(o), _t(d), tg, 1e-4, **kw)
    _assert_hits(got, want)
    e = bk.block_closest_plain(_t(o), _t(d), tg, 1e-4)
    torch.testing.assert_close(got.tri_idx, e.tri_idx.to(torch.int32),
                               rtol=0, atol=0)
    tmax = np.full(r, 2.5, np.float32)
    want = np.asarray(pk.pallas_block_occluded_blockmajor(
        jnp.asarray(o), jnp.asarray(d), grid, 1e-4, jnp.asarray(tmax),
        interpret=True, **kw))
    got = bk.block_occluded_blockmajor(_t(o), _t(d), tg, 1e-4, _t(tmax), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


# --- the integrator over the budget -----------------------------------


def _spheres(differentiable=False):
    """``gpu_spheres.json`` with the grad bench's camera at 48x24, depth 3
    (its mirror bounces), the JAX side with its Pallas kernels."""
    js = jrt.load_scene(f"{REPO}/tests/assets/scenes/gpu_spheres.json",
                        accel="blocks")
    cam = JCamera.create(position=(0.0, -2.5, 1.2), look_at=(0.0, 0.0, 0.5),
                         up=(0, 0, 1), focal_length_mm=24.0, width=W,
                         height=H)
    return dataclasses.replace(js, camera=cam, max_bounces=3, spp=1,
                               use_pallas=True,
                               differentiable=differentiable)


@pytest.fixture
def low_budget(monkeypatch):
    """Both packages' plane budget at four blocks of 128 lanes (the
    24-block sphere grid then needs 8 chunks), the JAX caches cleared
    around it as ``test_pallas.py`` does."""
    budget = 4 * pk._grid_bytes(1, 128)
    jax.clear_caches()
    monkeypatch.setattr(pk, "_VMEM_TRI_BUDGET_BYTES", budget)
    monkeypatch.setattr(bk, "_VMEM_TRI_BUDGET_BYTES", budget)
    yield
    jax.clear_caches()


@pytest.fixture
def calls(monkeypatch):
    """Counts the integrator's calls of each intersection wrapper."""
    seen = {}
    for name in STREAMED + BLOCKMAJOR + RESIDENT:
        fn = getattr(tint, name)

        def spy(*a, _fn=fn, _name=name, **k):
            seen.setdefault(_name, []).append(k)
            return _fn(*a, **k)

        monkeypatch.setattr(tint, name, spy)
    return seen


@pytest.fixture(scope="module")
def streamed_image():
    """The JAX render of the over-budget sphere scene (its streamed
    kernels, interpret mode) and the port's scene."""
    js = _spheres()
    budget = 4 * pk._grid_bytes(1, 128)
    jax.clear_caches()
    saved = pk._VMEM_TRI_BUDGET_BYTES
    pk._VMEM_TRI_BUDGET_BYTES = budget
    try:
        assert pk.num_chunks_for(js.accel) > 1
        reason = jmk.megakernel_ineligible_reason(js, "wang")
        want = np.asarray(jr.render_scene(js, "wang"))
    finally:
        pk._VMEM_TRI_BUDGET_BYTES = saved
        jax.clear_caches()
    return js, torch_from_jax(js), want, reason


def test_over_budget_scene_renders_through_g_and_i(streamed_image,
                                                   low_budget, calls):
    js, ts, want, reason = streamed_image
    # the JAX package refuses the grid to its fused kernels; the port's
    # take it, and its staged integrator walks it with G and I
    assert "VMEM budget" in reason
    assert tmk.megakernel_ineligible_reason(ts, "wang") is None
    got = staged_image(ts, "wang").numpy()
    assert set(calls) == set(STREAMED)
    _close_images(got, want)
    assert want.std() > 0.05


def _close_images(got, want):
    from raytracinginonesemester_tpu_torch.io.image import quantize

    ok = ulp_close(got, want, atol=ATOL_IMAGE)
    assert ok.all(), f"{(~ok).sum()} differ, max {np.abs(got - want).max()}"
    assert_images_close(quantize(got, "gpu"), quantize(want, "gpu"))


def test_blockmajor_flag_gives_the_same_image(streamed_image, low_budget,
                                              calls, monkeypatch):
    _, ts, _, _ = streamed_image
    base = staged_image(ts, "wang").numpy()
    monkeypatch.setattr(tint, "_STREAM_BLOCKMAJOR", True)
    got = staged_image(ts, "wang").numpy()
    assert set(calls) == set(STREAMED + BLOCKMAJOR)
    np.testing.assert_array_equal(got, base)


def test_differentiable_over_budget_takes_the_detached_streamed_mode(
        low_budget, calls, monkeypatch):
    """Over the budget the oracle refuses a differentiable scene in both
    packages; the port's render runs G and I on detached rays (no kernel
    B) and matches the JAX package's detached render, and a loss over it
    has finite, nonzero gradients."""
    js = _spheres(differentiable=True)
    ts = torch_from_jax(js)
    assert not tdo.oracle_eligible(ts) and not jdo.oracle_eligible(js, None)
    want = np.asarray(jr.render_scene(js, "center"))

    def no_oracle(*a, **k):
        raise AssertionError("the oracle ran for an over-budget scene")

    monkeypatch.setattr(tdo, "fused_bounce_oracle", no_oracle)
    vertices = ts.geometry.vertices.clone().requires_grad_(True)
    scene = dataclasses.replace(ts, geometry=dataclasses.replace(
        ts.geometry, vertices=vertices))
    got = tr.render_scene(scene, "center")
    assert set(calls) == set(STREAMED)
    _close_images(got.detach().numpy(), want)
    got.sum().backward()
    assert torch.isfinite(vertices.grad).all() and (vertices.grad != 0).any()


# --- the cpuonly dialect over the budget --------------------------------

# chip_smoke.py phase 8's area light (radius 0.15, diffuse bounces) with a
# few shadow samples: I traces the disk-sampled soft shadows
CPUONLY_LIGHTS = {"point": {},
                  "area": dict(radius=0.15, shadow_samples=4,
                               diffuse_bounce=True)}


def _cpuonly_mirror(**light):
    """``cpuonly_mirror.json`` at 48x24, built by the JAX package with its
    Pallas kernels, its light changed as ``chip_smoke.py``'s
    ``cpuonly_scene`` changes it."""
    path = f"{REPO}/tests/assets/scenes/cpuonly_mirror.json"
    cfg = dataclasses.replace(load_scene_config(path), pixel_width=W,
                              pixel_height=H)
    if "diffuse_bounce" in light:
        cfg = dataclasses.replace(cfg,
                                  diffuse_bounce=light.pop("diffuse_bounce"))
    if light:
        cfg = dataclasses.replace(
            cfg, lights=[{**l, **light} for l in cfg.lights])
    return dataclasses.replace(jbuild(cfg, scene_path=path), use_pallas=True)


@pytest.fixture(scope="module", params=sorted(CPUONLY_LIGHTS))
def cpuonly_image(request):
    """The JAX render of the over-budget cpuonly mirror scene (its
    streamed kernels, interpret mode; ``auto`` jitter: pixel centres) and
    the port's scene on the same planes."""
    js = _cpuonly_mirror(**CPUONLY_LIGHTS[request.param])
    budget = 4 * pk._grid_bytes(1, 128)
    jax.clear_caches()
    saved = pk._VMEM_TRI_BUDGET_BYTES
    pk._VMEM_TRI_BUDGET_BYTES = budget
    try:
        assert pk.num_chunks_for(js.accel) > 1
        reason = jmk.megakernel_ineligible_reason(js, "auto")
        want = np.asarray(jr.render_scene(js, "auto"))
    finally:
        pk._VMEM_TRI_BUDGET_BYTES = saved
        jax.clear_caches()
    return request.param, js, torch_from_jax(js), want, reason


@pytest.fixture
def no_fused(monkeypatch):
    """Kernels A-D (emit, bounce_step, resume, render) raise if called."""
    def fused(*a, **k):
        raise AssertionError("a fused kernel ran on the staged route")

    monkeypatch.setattr(tmk, "render_tiles", fused)
    for name in ("emit_tiles", "bounce_step_tiles", "resume_tiles"):
        monkeypatch.setattr(twf, name, fused)


def test_cpuonly_over_budget_renders_through_g_and_i(cpuonly_image,
                                                     low_budget, calls,
                                                     no_fused):
    """det_eps = FLT_EPSILON, the sky-gradient misses and (area light) the
    disk-sampled soft shadows through G and I, against the JAX package's
    streamed render."""
    name, js, ts, want, reason = cpuonly_image
    assert ts.dialect == js.dialect == "cpuonly"
    assert ts.lights.shadow_samples == js.lights.shadow_samples == (
        (4,) if name == "area" else (1,))
    assert "VMEM budget" in reason
    assert tmk.megakernel_ineligible_reason(
        ts, tr.resolve_jitter_mode(ts, "auto", 1)) is None
    got = staged_image(ts, "auto").numpy()
    assert set(calls) == set(STREAMED)
    _close_images(got, want)
    assert want.std() > 0.05


# --- on the card ------------------------------------------------------


@pytest.mark.cuda
def test_cuda_streamed_kernels_match_plain_versions(frog):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    js, _ = frog
    tc = torch_from_jax(js, device="cuda")
    o, d = (_t(a).cuda() for a in _frog_rays(js)["camera"])
    tmax = torch.full((o.shape[0],), 0.3, device="cuda")
    bk.reset_launch_counts()
    for kernel, plain in (
            (bk.block_closest_streamed, bk.block_closest_streamed_plain),
            (bk.block_closest_blockmajor, bk.block_closest_blockmajor_plain)):
        got, want = kernel(o, d, tc.accel, 1e-4), plain(o, d, tc.accel, 1e-4)
        for a, b in ((got.t, want.t), (got.tri_idx, want.tri_idx)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    # and the shadow rays of every camera ray toward the first light, as
    # the integrator spawns them: the missed rays' shade points parked at
    # 1e30, where the direction comes out 0 and the distance inf
    hits = bk.block_closest_streamed_plain(o, d, tc.accel, 1e-4)
    p = torch.where(hits.hit[:, None], o + hits.t[:, None] * d, 1e30)
    to = tc.lights.position[0] - p
    dist = torch.sqrt((to * to).sum(dim=1))
    sd = to / torch.clamp(dist, min=1e-20)[:, None]
    assert bool((sd[~hits.hit] == 0.0).all()) and bool(hits.hit.any())
    for kernel, plain in (
            (bk.block_occluded_streamed, bk.block_occluded_streamed_plain),
            (bk.block_occluded_blockmajor, bk.block_occluded_blockmajor_plain)):
        torch.testing.assert_close(kernel(o, d, tc.accel, 1e-4, tmax),
                                   plain(o, d, tc.accel, 1e-4, tmax),
                                   rtol=0, atol=0)
        got = kernel(p, sd, tc.accel, 1e-4, dist)
        torch.testing.assert_close(got, plain(p, sd, tc.accel, 1e-4, dist),
                                   rtol=0, atol=0)
        assert not bool(got[~hits.hit].any())
    counts = bk.launch_counts()
    assert counts["closest_streamed"] == counts["closest_blockmajor"] == 1
    assert counts["occluded_streamed"] == counts["occluded_blockmajor"] == 2
