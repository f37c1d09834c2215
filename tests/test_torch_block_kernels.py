"""Kernels E (closest hit) and F (occlusion) of the staged integrator in
the PyTorch port (``ops/block_kernels.py``).

Their plain versions are held against the JAX package's Pallas kernels
(``pallas_block_closest`` / ``pallas_block_occluded``, interpret mode)
and its XLA block walks (``accel.block_closest`` / ``block_occluded``)
on the two-frog scene's planes at block size 128: 64x32 camera rays,
seeded random bounce rays with a share parked at 1e30, and shadow rays
from the camera hits toward a light with per-ray tmax (misses parked at
1e30).  Winner ids, shadow visibility and blocked flags must match
exactly; t within 4 ulp or 1e-5.  u, v within 4 ulp or 2e-4 and the
shading normal within 4 ulp or 5e-5: the reference's Moller-Trumbore
barycentrics are contracted into FMAs by XLA:CPU and, on the frog's
small triangles (det ~1e-7), ill-conditioned.  Measured on the jittered
camera rays: u differs by up to 9.2e-5, v by 2.8e-5, the normal by
1.9e-5, t by 2.1e-7; at the worst ray (det 1.37e-7) u is 0.09445602 in
the port, 0.09436368 in JAX and 0.09438746 in float64, so both sides
are off the truth (ROADMAP section 3).  The kernels themselves run only
on a card (``cuda`` marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginonesemester_tpu.ops import accel as jaccel
from raytracinginonesemester_tpu.ops.pallas_kernels import (
    pallas_block_closest, pallas_block_occluded)
from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk

from _torch_parity import (
    jax_two_frog, one_torch_thread, torch_from_jax, ulp_close)

W, H = 64, 32
R = W * H
N_PARKED = 256
UV_ATOL = 2e-4  # the FMA-contracted reference, see the module docstring
NORMAL_ATOL = 5e-5


def _rays(o, d):
    return (torch.from_numpy(np.array(o, np.float32)),
            torch.from_numpy(np.array(d, np.float32)))


@pytest.fixture(scope="module")
def setup():
    js = jax_two_frog(width=W, height=H)
    ts = torch_from_jax(js)
    rng = np.random.default_rng(7)
    ys, xs = np.mgrid[0:H, 0:W]
    px = (xs.ravel() + rng.uniform(0, 1, R)).astype(np.float32)
    py = (ys.ravel() + rng.uniform(0, 1, R)).astype(np.float32)
    co, cd = (np.asarray(a) for a in js.camera.get_rays(jnp.asarray(px),
                                                        jnp.asarray(py)))
    # bounce rays: origins in the scene's box, random directions; the
    # last N_PARKED parked at 1e30 (half of them with every component of
    # d negative, so their slab test passes and the triangles decide)
    aabb = np.asarray(js.accel.aabb)
    lo, hi = aabb[:3].min(axis=1), aabb[3:].max(axis=1)
    bo = (lo + rng.uniform(0, 1, (R, 3)) * (hi - lo)).astype(np.float32)
    bd = rng.normal(size=(R, 3)).astype(np.float32)
    bd[-N_PARKED // 2:] = -np.abs(bd[-N_PARKED // 2:])
    bd = (bd / np.linalg.norm(bd, axis=1, keepdims=True)).astype(np.float32)
    bo[-N_PARKED:] = 1e30
    # the JAX fused camera pass: hits, gpu normals, two lights' visibility
    lights = js.lights.position
    hits, normal, vis = pallas_block_closest(
        jnp.asarray(co), jnp.asarray(cd), js.accel, 1e-4, interpret=True,
        return_normal=True, shadow_lights=lights)
    t = np.asarray(hits.t)
    hit = np.asarray(hits.hit)
    n = np.asarray(normal)
    p = co + t[:, None] * cd + n * np.float32(1e-3)
    p[~hit] = 1e30
    to = np.asarray(lights)[0] - p
    with np.errstate(over="ignore"):  # parked shade points: dist = inf
        dist = np.sqrt((to * to).sum(axis=1)).astype(np.float32)
    sd = (to / np.maximum(dist, 1e-20)[:, None]).astype(np.float32)
    return dict(js=js, ts=ts, cam=(co, cd), bounce=(bo, bd),
                shadow=(p.astype(np.float32), sd, dist),
                jax_cam=(hits, normal, vis))


def _assert_hits(got, want, parked=0):
    np.testing.assert_array_equal(got.tri_idx.numpy(), np.asarray(want.tri_idx))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    for name, atol in (("t", 1e-5), ("u", UV_ATOL), ("v", UV_ATOL)):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        ok = ulp_close(a, b, atol=atol)
        assert ok.all(), (f"{name}: {(~ok).sum()} differ, max "
                          f"{np.abs(a - b)[~ok].max()}")
    if parked:
        assert not got.hit[-parked:].any()
    assert 0 < int(got.hit.sum()) < got.hit.numel()


@pytest.mark.parametrize("shared", [False, True])
def test_closest_with_normals_and_shadows_matches_pallas(setup, shared):
    """Camera rays, gpu normals and two point lights' fused visibility;
    the port ignores ``shared_origin`` and must give the same bits."""
    js, ts = setup["js"], setup["ts"]
    co, cd = setup["cam"]
    if shared:
        want = pallas_block_closest(
            jnp.asarray(co), jnp.asarray(cd), js.accel, 1e-4, interpret=True,
            return_normal=True, shadow_lights=js.lights.position,
            shared_origin=True)
    else:
        want = setup["jax_cam"]
    o, d = _rays(co, cd)
    got = bk.block_closest(o, d, ts.accel, 1e-4, return_normal=True,
                           shadow_lights=ts.lights.position,
                           shared_origin=shared)
    _assert_hits(got[0], want[0])
    ok = ulp_close(got[1].numpy(), np.asarray(want[1]), atol=NORMAL_ATOL)
    assert ok.all(), f"normal: {(~ok).sum()} differ"
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < float(got[2].sum()) < got[2].numel()
    other = bk.block_closest(o, d, ts.accel, 1e-4, return_normal=True,
                             shadow_lights=ts.lights.position,
                             shared_origin=not shared)
    for a, b in zip((got[0].t, got[0].u, got[0].v, got[0].tri_idx, got[1],
                     got[2]), (other[0].t, other[0].u, other[0].v,
                               other[0].tri_idx, other[1], other[2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_closest_without_normals_matches_pallas(setup, rays):
    """The cpuonly case (no in-kernel normal); bounce rays include
    parked ones, which must miss."""
    js, ts = setup["js"], setup["ts"]
    o_np, d_np = setup["cam"] if rays == "camera" else setup["bounce"]
    want = pallas_block_closest(jnp.asarray(o_np), jnp.asarray(d_np),
                                js.accel, 1e-4, det_eps=1.1920929e-7,
                                interpret=True)
    got = bk.block_closest(*_rays(o_np, d_np), ts.accel, 1e-4,
                           det_eps=1.1920929e-7)
    _assert_hits(got, want, parked=N_PARKED if rays == "bounce" else 0)


def test_closest_matches_xla_block_walk(setup):
    js, ts = setup["js"], setup["ts"]
    bo, bd = setup["bounce"]
    want = jaccel.block_closest(jnp.asarray(bo), jnp.asarray(bd), js.accel,
                                1e-4)
    _assert_hits(bk.block_closest(*_rays(bo, bd), ts.accel, 1e-4), want,
                 parked=N_PARKED)


def _occlusion_case(setup, rays):
    """(origins, dirs, tmin (R,), tmax (R,)) of a ray set."""
    rng = np.random.default_rng(11)
    if rays == "shadow":
        p, sd, dist = setup["shadow"]
        return p, sd, np.full(R, 1e-4, np.float32), dist
    o, d = setup["cam" if rays == "camera" else "bounce"]
    tmax = rng.uniform(0.05, 1.0, R).astype(np.float32)
    tmin = rng.uniform(0.0, 0.02, R).astype(np.float32)
    return o, d, tmin, tmax


@pytest.mark.parametrize("rays", ["camera", "bounce", "shadow"])
def test_occluded_matches_pallas(setup, rays):
    """Per-ray [tmin, tmax]; parked rays and parked shade points come
    out unblocked."""
    js, ts = setup["js"], setup["ts"]
    o, d, tmin, tmax = _occlusion_case(setup, rays)
    want = np.asarray(pallas_block_occluded(
        jnp.asarray(o), jnp.asarray(d), js.accel, jnp.asarray(tmin),
        jnp.asarray(tmax), interpret=True))
    got = bk.block_occluded(*_rays(o, d), ts.accel, torch.from_numpy(tmin),
                            torch.from_numpy(tmax)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    parked = o[:, 0] >= 1e29
    assert parked.any() == (rays != "camera")
    assert not got[parked].any()


def test_occluded_matches_xla_block_walk(setup):
    js, ts = setup["js"], setup["ts"]
    o, d, tmin, tmax = _occlusion_case(setup, "shadow")
    want = np.asarray(jaccel.block_occluded(
        jnp.asarray(o), jnp.asarray(d), js.accel, jnp.asarray(tmin),
        jnp.asarray(tmax)))
    got = bk.block_occluded(*_rays(o, d), ts.accel, torch.from_numpy(tmin),
                            torch.from_numpy(tmax)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rays", ["camera", "bounce", "shadow"])
def test_cooperative_occluded_matches_the_plain_walk(setup, rays,
                                                     monkeypatch):
    """Kernel F's walk (the rays that pass some block's slab test listed,
    the list walked 8 rays to a warp by ``occluded_coop``) gives the
    plain version's flags bit for bit,
    on per-ray windows with parked rays and with NaN windows (every 7th
    ray's tmax, every 11th ray's tmin), which fail every slab test."""
    from _torch_parity import list_occluded

    ts = setup["ts"]
    o, d, tmin, tmax = _occlusion_case(setup, rays)
    tmin, tmax = tmin.copy(), tmax.copy()
    tmax[::7] = np.nan
    tmin[::11] = np.nan
    args = (*_rays(o, d), ts.accel, torch.from_numpy(tmin),
            torch.from_numpy(tmax))
    want = bk.block_occluded_plain(*args)
    listed = []

    def walk(*a, **k):
        got = list_occluded(*a, **k)
        listed.append(int(got[0].sum()))
        return got

    monkeypatch.setattr(bk, "_occluded_plain", walk)
    got = bk.block_occluded_plain(*args)
    assert listed and torch.equal(got, want)
    assert 0 < int(got.sum()) and not got[::7].any() and not got[::11].any()
    assert not got[torch.from_numpy(o[:, 0] >= 1e29)].any()


def test_slab_test_matches_reference_on_hazards():
    """The per-ray slab test keeps the reference's NaN -> +-inf rule and
    its ``far * 1.0000004`` stretch bit for bit: axis-parallel rays on a
    box face (0 * inf = NaN), rays grazing a face, a hit exactly at the
    far plane, parked origins, and the parked shade points' shadow rays:
    a zero direction with an infinite window (gpu dialect: every slab
    opens) and a NaN direction with a NaN window (cpuonly soft shadows:
    the NaN bound fails the test)."""
    box = np.array([[0.0], [0.0], [0.0], [1.0], [1.0], [1.0]], np.float32)
    nan = np.float32(np.nan)
    o = np.array([[0.0, 0.5, 0.5], [1.0, 0.5, -1.0], [-1.0, 0.5, 0.5],
                  [0.5, 0.5, -2.0], [1e30, 1e30, 1e30], [1e30, 1e30, 1e30],
                  [-1.0, 1.0, 0.5], [0.5, -1.0, 1.0000001],
                  [1e30, 1e30, 1e30], [1e30, 1e30, 1e30]], np.float32)
    d = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0],
                  [0.0, 0.0, 1.0], [0.6, 0.0, 0.8], [-0.6, -0.0, -0.8],
                  [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-0.0, -0.0, -0.0],
                  [nan, nan, nan]], np.float32)
    tmin = np.full(len(o), 1e-4, np.float32)
    tmax = np.array([3.4e38, 3.4e38, 3.4e38, 2.0, 3.4e38, 3.4e38, 2.0, 5.0,
                     np.inf, nan], np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = (1.0 / d).astype(np.float32)
    want, _ = jaccel._slab_entry(tuple(jnp.asarray(o[:, k]) for k in range(3)),
                                 tuple(jnp.asarray(inv[:, k]) for k in range(3)),
                                 jnp.asarray(box), jnp.asarray(tmin),
                                 jnp.asarray(tmax))
    row = torch.from_numpy(np.concatenate([box[:, 0], [0.0, 0.0]]).astype(
        np.float32))
    got = tmk._slab(row, tuple(torch.from_numpy(o[:, k]) for k in range(3)),
                    tuple(torch.from_numpy(inv[:, k]) for k in range(3)),
                    torch.from_numpy(tmin), torch.from_numpy(tmax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, 0])
    assert got[:4].all() and not got[4] and got[8] and not got[9]


def test_plain_versions_count_pairs(setup):
    """``stats["pairs"]``: the ray-triangle tests the kernels make, here
    bounded by the rays times the live triangles, and larger with the
    shadow walks than without."""
    ts = setup["ts"]
    o, d = _rays(*setup["cam"])
    live = int((ts.accel.tri_index >= 0).sum())
    plain, fused = {}, {}
    bk.block_closest_plain(o, d, ts.accel, stats=plain)
    bk.block_closest_plain(o, d, ts.accel, return_normal=True,
                           shadow_lights=ts.lights.position, stats=fused)
    assert 0 < plain["pairs"] < fused["pairs"] <= 3 * R * live
    occ = {}
    bk.block_occluded_plain(o, d, ts.accel, 1e-4, 1.0, stats=occ)
    assert 0 < occ["pairs"] <= R * live


def test_wrappers_refuse_bad_rays(setup):
    ts = setup["ts"]
    o, d = _rays(*setup["cam"])
    with pytest.raises(ValueError, match="float32"):
        bk.block_closest(o.double(), d, ts.accel)
    with pytest.raises(ValueError, match="shapes"):
        bk.block_occluded(o[:, :2], d[:, :2], ts.accel)


# --- on the card: each CUDA kernel against its plain version ---------


@pytest.fixture
def cuda_setup(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return dict(setup, ts=torch_from_jax(setup["js"], device="cuda"))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_setup):
    ts = cuda_setup["ts"]
    o, d = (t.cuda() for t in _rays(*cuda_setup["cam"]))
    lights = ts.lights.position
    bk.reset_launch_counts()
    got = bk.block_closest(o, d, ts.accel, return_normal=True,
                           shadow_lights=lights)
    want = bk.block_closest_plain(o, d, ts.accel, return_normal=True,
                                  shadow_lights=lights)
    torch.testing.assert_close(got[0].tri_idx, want[0].tri_idx, rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    for a, b in ((got[0].t, want[0].t), (got[1], want[1])):
        assert ulp_close(a.cpu().numpy(), b.cpu().numpy()).all()
    po, pd, tmin, tmax = (torch.from_numpy(a).cuda()
                          for a in _occlusion_case(cuda_setup, "bounce"))
    torch.testing.assert_close(
        bk.block_occluded(po, pd, ts.accel, tmin, tmax),
        bk.block_occluded_plain(po, pd, ts.accel, tmin, tmax), rtol=0, atol=0)
    assert {k: n for k, n in bk.launch_counts().items() if n} == {
        "closest": 1, "occluded": 1}
