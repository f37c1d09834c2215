"""Kernel B's oracle rows (``bounce_step_tiles(diff_out=True)``), its
binned depth 0 and ``ops.diff_oracle`` of the PyTorch port.

The port's plain version runs on the CPU against the JAX kernel in
interpret mode, on the same packed state: the camera rays of the
differentiable grad-bench scene (``gpu_spheres.json`` with
``bench.py --grad``'s camera) at 48x32, block size 128.  Bounds: the
oracle's id, visibility and decision rows exact, t within 1e-5, u and v
within 4 ulp or 2e-4 (kernel E's measured bound, ROADMAP section 3), the
state rows at kernel B's bounds (alive and rng exact, floats 4 ulp or
1e-5).  The binned depth 0 gives the flat walk's rows exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginonesemester_tpu.core import rng as jrng
from raytracinginonesemester_tpu.ops import diff_oracle as jdo
from raytracinginonesemester_tpu.ops import megakernel as jmk
from raytracinginonesemester_tpu.render import renderer as jr
from raytracinginonesemester_tpu_torch.ops import binned as tbin
from raytracinginonesemester_tpu_torch.ops import diff_oracle as tdo
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk

from _torch_parity import (grad_scene, one_torch_thread,  # noqa: F401
                           torch_from_jax, ulp_close)

W, H = 48, 32
KW = dict(det_eps=1e-8, tmin=1e-4, shadow_eps=1e-3, shadow_tmin=1e-4)


@pytest.fixture(scope="module")
def scenes():
    js = grad_scene(W, H)
    return js, torch_from_jax(js)


def _rays(js):
    """The swizzled pixel stream's pixel-center camera rays and seeds."""
    xs, ys, _ = jr._swizzled_grid(W, H)
    o, d = js.camera.get_rays(xs.astype(jnp.float32) + 0.5,
                              ys.astype(jnp.float32) + 0.5)
    return (np.asarray(o), np.asarray(d),
            np.asarray(jrng.make_rng_seed(xs, ys, 0)))


def _pack(o, d, seeds):
    """The oracle's packed state (``diff_oracle.fused_bounce_oracle``)."""
    r = o.shape[0]
    rp = r + (-r) % (8 * 512)
    nt = rp // 512
    st = np.zeros((16, rp), np.float32)
    st[0:3] = 1e30
    st[5] = 1.0
    st[0:3, :r], st[3:6, :r] = o.T, d.T
    st[6:9] = 1.0
    st[12, :r] = 1.0
    rng = np.zeros((8, rp), np.int32)
    rng[0, :r] = seeds.view(np.int32)
    st = st.reshape(16, nt, 512).transpose(1, 0, 2).reshape(nt * 16, 512)
    rng = rng.reshape(8, nt, 512).transpose(1, 0, 2).reshape(nt * 8, 512)
    return np.ascontiguousarray(st), np.ascontiguousarray(rng)


@pytest.fixture(scope="module")
def jax_steps(scenes):
    """JAX's kernel B with diff_out at depths 0 and 1, each on the state
    JAX itself produced: [(state in, rng in, state out, rng out, rows)]."""
    js, _ = scenes
    st, rng = _pack(*_rays(js))
    nt = st.shape[0] // 16
    ls = -(-js.accel.num_blocks // 8)
    zeros_i = jnp.zeros((nt, ls), jnp.int32)
    zeros_f = jnp.zeros((nt, ls), jnp.float32)
    steps = []
    for _ in range(2):
        out = jmk.bounce_step_tiles(js, jnp.asarray(st), jnp.asarray(rng),
                                    zeros_i, zeros_f, interpret=True,
                                    diff_out=True, dialect="gpu", **KW)
        out = [np.asarray(a) for a in out]
        steps.append((st, rng, *out))
        st, rng = out[0], out[1]
    return steps


def _check_rows(got, want, what):
    """Oracle rows (nt*8, 512): id, vis, dec exact; t 1e-5; u, v 4 ulp
    or 2e-4; rows 6 and 7 zero."""
    g = got.reshape(-1, 8, 512)
    w = want.reshape(-1, 8, 512)
    for row in (3, 4, 5):
        np.testing.assert_array_equal(g[:, row], w[:, row],
                                      err_msg=f"{what} row {row}")
    assert ulp_close(g[:, 0], w[:, 0], atol=1e-5).all(), f"{what} t"
    for row in (1, 2):
        ok = ulp_close(g[:, row], w[:, row], atol=2e-4)
        assert ok.all(), (f"{what} row {row}: max "
                          f"{np.abs(g[:, row] - w[:, row]).max()}")
    assert not g[:, 6:].any()


def _check_state(got_st, got_rng, want_st, want_rng, what):
    """Alive and rng exact, rows 0-8 within 4 ulp or 1e-5; the radiance
    rows 9-11 within 1e-5 or 2e-5 of their value: the box's highlight
    (shininess 64, intensity 5) reaches 19.6, and pow(N.H, 64) turns the
    reference's FMA-moved normal into a relative 1.2e-5 (measured 2.27e-4
    at depth 0; ROADMAP section 3)."""
    a = got_st.reshape(-1, 16, 512)
    b = want_st.reshape(-1, 16, 512)
    np.testing.assert_array_equal(a[:, 12], b[:, 12], err_msg=f"{what} alive")
    np.testing.assert_array_equal(got_rng, want_rng, err_msg=f"{what} rng")
    assert ulp_close(a[:, :9], b[:, :9], atol=1e-5).all(), f"{what} rows 0-8"
    rd_a, rd_b = a[:, 9:12].astype(np.float64), b[:, 9:12]
    tol = np.maximum(1e-5, 2e-5 * np.abs(rd_b))
    assert (np.abs(rd_a - rd_b) <= tol).all(), f"{what} radiance rows"


@pytest.mark.parametrize("depth", [0, 1])
def test_bounce_diff_rows_match_jax(scenes, jax_steps, depth):
    _, ts = scenes
    st, rng, want_st, want_rng, want_diff = jax_steps[depth]
    got_st, got_rng, diff = tmk.bounce_step_tiles(
        ts, torch.from_numpy(st), torch.from_numpy(rng), diff_out=True, **KW)
    _check_rows(diff.numpy(), want_diff, f"depth {depth}")
    _check_state(got_st.numpy(), got_rng.numpy(), want_st, want_rng,
                 f"depth {depth}")
    dec = want_diff.reshape(-1, 8, 512)[:, 5].astype(np.int32)
    # hits, misses, mirror bounces and survivors are all present
    assert (dec & 1).any() and not (dec & 1).all()
    assert (dec & 4).any() and (dec & 8).any()
    assert (want_diff.reshape(-1, 8, 512)[:, 4] > 0).any()


def test_binned_depth0_rows_equal_flat(scenes, jax_steps):
    """The binned walk of depth 0 gives the flat walk's oracle rows and
    state bit for bit (the plan is a conservative superset and the take
    rule does not depend on visit order)."""
    _, ts = scenes
    st, rng = (torch.from_numpy(a) for a in jax_steps[0][:2])
    xs, ys, _ = jr._swizzled_grid(W, H)
    xs_p, ys_p, _, _ = tmk._pad_tiles(torch.from_numpy(np.asarray(xs)),
                                      torch.from_numpy(np.asarray(ys)))
    plan = tbin.build_camera_candidate_plan(ts.camera, xs_p, ys_p, ts.accel,
                                            512, chunk=64)
    assert int(plan.meta[:, 1].sum()) > 0
    flat = tmk.bounce_step_tiles(ts, st, rng, diff_out=True, **KW)
    binned = tmk.bounce_step_tiles(ts, st, rng, diff_out=True, cand_plan=plan,
                                   **KW)
    for a, b in zip(flat, binned):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_oracle(scenes):
    js, _ = scenes
    o, d, seeds = _rays(js)
    out = jdo.fused_bounce_oracle(jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(seeds), js, 2, interpret=True,
                                  **KW)
    return {k: [np.asarray(a) for a in v] for k, v in out.items()}


@pytest.mark.parametrize("bounces", [1, 2])
def test_fused_bounce_oracle_matches_jax(scenes, jax_oracle, bounces):
    js, ts = scenes
    o, d, seeds = _rays(js)
    got = tdo.fused_bounce_oracle(torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(seeds.astype(np.int64)),
                                  ts, bounces, **KW)
    assert sorted(got) == sorted(jax_oracle)
    for k in range(bounces):
        for key in ("idx", "vis", "dec"):
            assert got[key][k].dtype == torch.int32
            np.testing.assert_array_equal(got[key][k].numpy(),
                                          jax_oracle[key][k],
                                          err_msg=f"{key} depth {k}")
        assert ulp_close(got["t"][k].numpy(), jax_oracle["t"][k],
                         atol=1e-5).all()
        for key in ("u", "v"):
            assert ulp_close(got[key][k].numpy(), jax_oracle[key][k],
                             atol=2e-4).all(), key
        assert got["t"][k].shape == (W * H,)


def test_oracle_eligible(scenes):
    _, ts = scenes
    assert tdo.oracle_eligible(ts)
    assert not tdo.oracle_eligible(ts, model_axis="model")
    assert not tdo.oracle_eligible(dataclasses.replace(ts, accel=None))
    assert not tdo.oracle_eligible(dataclasses.replace(ts, dialect="cpuonly"))
    for n in (0, 25):
        lights = dataclasses.replace(
            ts.lights, position=torch.zeros(n, 3), color=torch.ones(n, 3),
            intensity=torch.ones(n), radius=torch.zeros(n))
        assert not tdo.oracle_eligible(dataclasses.replace(ts, lights=lights))


def test_diff_out_refusals(scenes, jax_steps):
    _, ts = scenes
    st, rng = (torch.from_numpy(a) for a in jax_steps[0][:2])
    cpu = dataclasses.replace(ts, dialect="cpuonly")
    with pytest.raises(ValueError, match="gpu dialect"):
        tmk.bounce_step_tiles(cpu, st, rng, diff_out=True, dialect="cpuonly")
    xs, ys, _ = jr._swizzled_grid(W, H)
    xs_p, ys_p, _, _ = tmk._pad_tiles(torch.from_numpy(np.asarray(xs)),
                                      torch.from_numpy(np.asarray(ys)))
    plan = tbin.build_camera_candidate_plan(ts.camera, xs_p, ys_p, ts.accel,
                                            512, chunk=64)
    with pytest.raises(ValueError, match="diff_out"):
        tmk.bounce_step_tiles(ts, st, rng, cand_plan=plan)
    other = dataclasses.replace(ts, camera=dataclasses.replace(
        ts.camera, center=ts.camera.center.clone()))
    with pytest.raises(ValueError, match="camera"):
        tmk.bounce_step_tiles(other, st, rng, diff_out=True, cand_plan=plan)


@pytest.mark.cuda
def test_cuda_bounce_diff_rows_equal_plain(scenes, jax_steps):
    """Kernel B's oracle rows and state on the card, flat and binned,
    equal its plain version exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    js, _ = scenes
    tc = torch_from_jax(js, device="cuda")
    st, rng = (torch.from_numpy(a).cuda() for a in jax_steps[0][:2])
    xs, ys, _ = jr._swizzled_grid(W, H)
    xs_p, ys_p, _, _ = tmk._pad_tiles(torch.from_numpy(np.asarray(xs)).cuda(),
                                      torch.from_numpy(np.asarray(ys)).cuda())
    plan = tbin.build_camera_candidate_plan(tc.camera, xs_p, ys_p, tc.accel,
                                            512, chunk=64)
    rows = tmk._scene_rows(tc, tc.accel)
    for cand in (None, plan):
        got = tmk.bounce_step_tiles(tc, st, rng, diff_out=True,
                                    cand_plan=cand, rows=rows, **KW)
        want = tmk.bounce_step_tiles_plain(rows, st, rng, tc.diffuse_bounce,
                                           diff_out=True, cand_plan=cand, **KW)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
