"""The differentiable training path of the PyTorch port: ``diff/inverse.py``
over the integrator's oracle, detached and brute modes.

``render_loss`` and its gradients with respect to ``albedo``,
``light_intensity`` and ``vertices`` (perturbed by 5%, ``RandomState(0)``,
as ``bench.py --grad``) on the grad-bench scene at 48x32, 2 bounces,
block size 128, against the JAX package in the same mode: oracle (JAX
``use_pallas=True``, interpret), detached (``RT_DIFF_ORACLE=0`` against
JAX ``use_pallas=False``) and brute (``accel=None``).  Bounds: the loss
within 1e-5 relative, each gradient within 2e-4 of its largest entry
(the JAX package's own detached-vs-brute contract,
``tests/test_diff.py:182-186``).  Then the JAX package's contracts,
restated for the port, and two Adam steps against two ``optax.adam``
steps (parameters within 1e-6 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import raytracinginonesemester_tpu.ops.integrator as jint
from raytracinginonesemester_tpu.diff import inverse as jinv
from raytracinginonesemester_tpu_torch.core.camera import Camera
from raytracinginonesemester_tpu_torch.diff import inverse as tinv
from raytracinginonesemester_tpu_torch.ops import diff_oracle as tdo
from raytracinginonesemester_tpu_torch.ops import integrator as tint
from raytracinginonesemester_tpu_torch.render import renderer as tr

from _torch_parity import grad_scene, one_torch_thread, torch_from_jax  # noqa: F401

W, H = 48, 32
KEYS = ("albedo", "light_intensity", "vertices")
MODES = ("oracle", "detached", "brute")


@pytest.fixture(scope="module")
def base():
    """(JAX scene, port scene, perturbed params as numpy, target image):
    the target is the port's render of the unperturbed scene."""
    js = grad_scene(W, H)
    ts = torch_from_jax(js)
    p = jinv.extract_params(js, keys=KEYS)
    rs = np.random.RandomState(0)
    params = {k: np.asarray(v) * (1.0 + 0.05 * rs.standard_normal(
        np.asarray(v).shape).astype(np.float32)) for k, v in p.items()}
    with torch.no_grad():
        target = tr.render_scene(ts, jitter_mode="center",
                                 spp_override=1).numpy()
    return js, ts, params, target


def _jax_scene(js, mode):
    if mode == "oracle":
        return js
    if mode == "detached":
        return dataclasses.replace(js, use_pallas=False)
    return dataclasses.replace(js, accel=None, use_pallas=False)


def _torch_scene(ts, mode):
    return dataclasses.replace(ts, accel=None) if mode == "brute" else ts


@pytest.fixture(scope="module")
def jax_vg(base):
    """One jitted value_and_grad per mode, compiled once per module."""
    js, _, _, target = base
    cache = {}

    def get(mode):
        if mode not in cache:
            scene = _jax_scene(js, mode)
            cache[mode] = jax.jit(jax.value_and_grad(lambda q: jinv.render_loss(
                q, scene, jnp.asarray(target), jitter_mode="center",
                spp_override=1)))
        return cache[mode]

    return get


def _torch_vg(ts, params_np, target, mode, monkeypatch=None):
    if mode == "detached" and monkeypatch is not None:
        monkeypatch.setattr(tint, "_DIFF_ORACLE", False)
    params = tinv.params_from_numpy(params_np, ts)
    loss = tinv.render_loss(params, _torch_scene(ts, mode),
                            torch.from_numpy(target), "center", 1)
    loss.backward()
    return float(loss), {k: v.grad.numpy() for k, v in params.items()}


def _grads_close(got, want, scale_of, rel, what):
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        scale = np.abs(scale_of[k]).max()
        assert scale > 0, f"{what}: gradient of {k} is identically zero"
        assert np.isfinite(b).all(), f"{what}: gradient of {k} not finite"
        np.testing.assert_allclose(b, a, rtol=0, atol=rel * scale,
                                   err_msg=f"{what}: grad {k}")


@pytest.mark.parametrize("mode", MODES)
def test_render_loss_matches_jax(base, jax_vg, monkeypatch, mode):
    js, ts, params, target = base
    if mode == "detached":
        monkeypatch.setattr(jint, "_DIFF_ORACLE", False)
    jl, jg = jax_vg(mode)({k: jnp.asarray(v) for k, v in params.items()})
    loss, grads = _torch_vg(ts, params, target, mode, monkeypatch)
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    _grads_close(grads, jg, jg, 2e-4, mode)


def _counting_oracle(monkeypatch):
    """Record, per oracle call, whether its depth 0 walked a binned plan."""
    seen = []
    real = tdo.fused_bounce_oracle

    def spy(*a, cand_plan=None, **k):
        seen.append(cand_plan is not None)
        return real(*a, cand_plan=cand_plan, **k)

    monkeypatch.setattr(tdo, "fused_bounce_oracle", spy)
    return seen


@pytest.mark.parametrize("scene", ["gpu_spheres", "gpu_diffuse"])
def test_oracle_matches_detached(monkeypatch, scene):
    """The JAX package's oracle-vs-detached contract
    (``test_diff_oracle.py:67-81``): loss within 2e-3, gradients within
    5e-2 of the largest; ``gpu_diffuse`` adds two lights and diffuse
    bounces (the oracle's decision bits drive the rng)."""
    js = grad_scene(W, H, scene=scene)
    ts = torch_from_jax(js)
    keys = KEYS if scene == "gpu_spheres" else ("albedo", "light_intensity")
    with torch.no_grad():
        target = tr.render_scene(ts, "center", spp_override=1).numpy()
    p0 = {k: v.detach().numpy() * 1.03
          for k, v in tinv.extract_params(ts, keys).items()}
    seen = _counting_oracle(monkeypatch)
    l1, g1 = _torch_vg(ts, p0, target, "oracle")
    assert len(seen) == 1  # one oracle per trace
    monkeypatch.setattr(tint, "_DIFF_ORACLE", False)
    l0, g0 = _torch_vg(ts, p0, target, "detached")
    assert len(seen) == 1  # the detached mode runs no oracle
    np.testing.assert_allclose(l1, l0, rtol=2e-3, atol=1e-7)
    _grads_close(g1, g0, g0, 5e-2, f"{scene} oracle vs detached")


def test_detached_matches_brute(base, monkeypatch):
    """Detached vs brute within 2e-4 of the largest gradient
    (``test_diff.py:182-186``)."""
    _, ts, params, target = base
    monkeypatch.setattr(tint, "_DIFF_ORACLE", False)
    _, gd = _torch_vg(ts, params, target, "detached")
    _, gb = _torch_vg(ts, params, target, "brute")
    _grads_close(gd, gb, gb, 2e-4, "detached vs brute")


def test_differentiable_image_equals_block_render(base):
    """The differentiable render (oracle rows, recomputed hit frames)
    equals the forward render of the same scene (kernel E with its own
    normals and shadows) within 1e-6."""
    _, ts, _, _ = base
    fwd = tr.render_scene(dataclasses.replace(ts, differentiable=False),
                          "center", spp_override=1)
    diff = tr.render_scene(ts, "center", spp_override=1)
    assert fwd.std() > 0.05
    torch.testing.assert_close(diff, fwd, rtol=0, atol=1e-6)


def _moved(ts, params):
    """The vertices moved by 0.01 (``RandomState(1)``), inside a 0.05
    slack, and the plan context built before the move."""
    rs = np.random.RandomState(1)
    moved = dict(params)
    moved["vertices"] = (params["vertices"] + 0.01 * rs.standard_normal(
        params["vertices"].shape)).astype(np.float32)
    start = tinv.apply_params(ts, tinv.params_from_numpy(params, ts))
    return moved, tinv.camera_candidate_context(start, slack=0.05, chunk=64)


def test_binned_oracle_loss_is_bit_identical(base, monkeypatch):
    """``test_oracle_binned_depth0_matches``: after the vertices move
    inside the plan's slack, the binned depth 0 (its stream regathered
    from the rebuilt grid) gives the flat walk's loss and gradients bit
    for bit."""
    _, ts, params, target = base
    moved, ctx = _moved(ts, params)
    seen = _counting_oracle(monkeypatch)
    l0, g0 = _torch_vg(ts, moved, target, "oracle")
    with ctx:
        l1, g1 = _torch_vg(ts, moved, target, "oracle")
    assert seen == [False, True]
    assert l0 == l1
    for k in g0:
        np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)


def test_plan_of_another_camera_does_not_engage(base, monkeypatch):
    """A context built for another camera of the same size takes the
    flat walk (the JAX package checks the tile count alone, ROADMAP
    section 3) and leaves the loss unchanged."""
    _, ts, params, target = base
    other = dataclasses.replace(ts, camera=Camera.create(
        position=(0.3, -2.4, 1.3), look_at=(0.0, 0.0, 0.5), up=(0, 0, 1),
        focal_length_mm=24.0, width=W, height=H, device="cpu"))
    ctx = tinv.camera_candidate_context(other, slack=0.05, chunk=64)
    seen = _counting_oracle(monkeypatch)
    l0, _ = _torch_vg(ts, params, target, "oracle")
    with ctx:
        l1, _ = _torch_vg(ts, params, target, "oracle")
    assert seen == [False, False]
    assert l0 == l1


def test_albedo_gradient_matches_finite_differences(base):
    """``test_gradients_match_finite_differences`` on the oracle mode:
    albedo has smooth influence, so central differences agree."""
    _, ts, _, _ = base
    target = torch.zeros(H, W, 3)
    params = tinv.extract_params(ts, ("albedo",))
    tinv.render_loss(params, ts, target, "center", 1).backward()
    g = params["albedo"].grad.numpy()
    albedo = params["albedo"].detach().numpy()
    eps = 1e-2
    rs = np.random.RandomState(0)
    for _ in range(4):
        m, c = rs.randint(albedo.shape[0]), rs.randint(3)
        loss = []
        for sign in (1.0, -1.0):
            a = albedo.copy()
            a[m, c] += sign * eps
            with torch.no_grad():
                loss.append(float(tinv.render_loss(
                    {"albedo": torch.from_numpy(a)}, ts, target, "center", 1)))
        fd = (loss[0] - loss[1]) / (2 * eps)
        assert g[m, c] == pytest.approx(fd, rel=5e-2, abs=1e-5), (m, c)


def test_vertex_params_need_a_differentiable_grid(base):
    _, ts, _, _ = base
    plain = dataclasses.replace(ts, differentiable=False)
    with pytest.raises(ValueError, match="accel"):
        tinv.apply_params(plain, {"vertices": plain.geometry.vertices})
    # a differentiable scene rebuilds its grid from the detached vertices
    v = ts.geometry.vertices.clone().requires_grad_(True)
    s = tinv.apply_params(ts, {"vertices": v})
    assert s.accel is not ts.accel and not s.accel.tri.requires_grad
    assert torch.equal(s.accel.tri, ts.accel.tri)


def test_extract_apply_params_roundtrip(base):
    _, ts, _, _ = base
    p = tinv.extract_params(ts, ("vertices", "camera_center", "albedo",
                                 "light_intensity"))
    assert all(v.is_leaf and v.requires_grad for v in p.values())
    assert tuple(p["camera_center"].shape) == (3,)
    s2 = tinv.apply_params(ts, p)
    with torch.no_grad():
        a = tr.render_scene(ts, "center", spp_override=1)
        b = tr.render_scene(s2, "center", spp_override=1)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _params_close(got, want, what):
    """Within 1e-6 of the tensor's largest entry: optax takes Adam's bias
    corrections in float32, torch in float64, which moves an update by up
    to 7e-6 of itself (1.1e-8 at lr 1e-3, measured), so an elementwise
    relative bound fails on coordinates near zero (ROADMAP section 3)."""
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


def test_two_adam_steps_match_optax(base, jax_vg, monkeypatch):
    """Two ``make_train_step`` steps of ``torch.optim.Adam`` (lr 1e-3)
    against two ``optax.adam`` steps of the JAX package (the detached mode
    on both sides) on the albedo and light parameters, the vertices held
    at their perturbed values: within 1e-6 of each tensor's largest entry.
    (Vertex coordinates whose gradient is near Adam's eps magnify the
    gradients' 2e-4 parity bound: ROADMAP section 3; the optimiser itself
    is held on equal gradients below.)"""
    _, ts, params, target = base
    monkeypatch.setattr(jint, "_DIFF_ORACLE", False)
    monkeypatch.setattr(tint, "_DIFF_ORACLE", False)
    keys = ("albedo", "light_intensity")
    vg = jax_vg("detached")
    opt = optax.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init({k: jp[k] for k in keys})
    tp = tinv.params_from_numpy(params, ts)
    step = tinv.make_train_step(torch.optim.Adam([tp[k] for k in keys],
                                                 lr=1e-3))
    for _ in range(2):
        jl, g = vg(jp)
        sub = {k: jp[k] for k in keys}
        updates, state = opt.update({k: g[k] for k in keys}, state, sub)
        jp.update(optax.apply_updates(sub, updates))
        tl = step(tp, ts, torch.from_numpy(target))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_array_equal(tp["vertices"].detach().numpy(),
                                  params["vertices"])
    for k in keys:
        want = np.asarray(jp[k])
        assert not np.array_equal(want, params[k])
        _params_close(tp[k], want, k)


def test_adam_matches_optax_on_the_same_gradients(base, jax_vg):
    """``optimize``'s optimiser (``torch.optim.Adam`` with optax's
    defaults) against ``optax.adam`` for two steps on the same (JAX)
    gradients of all three parameters: within 1e-6 of each tensor's
    largest entry."""
    _, ts, params, _ = base
    vg = jax_vg("oracle")
    opt = optax.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = tinv.params_from_numpy(params, ts)
    adam = torch.optim.Adam(list(tp.values()), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8)
    for _ in range(2):
        _, g = vg(jp)
        for k in tp:
            tp[k].grad = torch.from_numpy(np.array(g[k]))
        adam.step()
        updates, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
    for k in KEYS:
        _params_close(tp[k], np.asarray(jp[k]), k)
