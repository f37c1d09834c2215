"""Parity of the port's soft renderer, checkpoints and utilities with the
JAX package.

``render_soft`` and the gradients of ``soft_render_loss`` (by
``torch.autograd``) against the JAX package's (by ``jax.grad``) on a
small triangle scene with an occluder, in both shadow modes: images
within 4 ulp or 1e-5, gradients within 1e-5 of each tensor's largest
entry.  Checkpoints round-trip, and a resumed optimisation equals the
straight run bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracinginonesemester_tpu.diff.inverse import extract_params as j_extract
from raytracinginonesemester_tpu.diff.soft import render_soft as j_soft
from raytracinginonesemester_tpu.diff.soft import soft_render_loss as j_loss
from raytracinginonesemester_tpu_torch.diff.checkpoint import (
    latest_step, load_checkpoint, save_checkpoint, to_tensors)
from raytracinginonesemester_tpu_torch.diff.inverse import extract_params
from raytracinginonesemester_tpu_torch.diff.soft import (render_soft,
                                                          soft_render_loss)

from _torch_parity import REPO, one_torch_thread, torch_from_jax, ulp_close

KEYS = ("vertices", "albedo", "camera_center", "light_intensity")


def jax_tri_scene(width=32, height=18, shift=(0.0, 0.0, 0.0)):
    """A large triangle facing the camera and a small one between it and
    the point light, which casts a shadow on it (the scene of
    ``tests/test_diff_geom.py`` with an occluder), padded to 8."""
    from raytracinginonesemester_tpu.core.camera import Camera
    from raytracinginonesemester_tpu.scene.build import (Scene,
                                                         geometry_from_mesh)
    from raytracinginonesemester_tpu.scene.material import (Lights,
                                                            MaterialTable)

    verts = np.array(
        [[[-1.2, 2.0, -1.0], [1.2, 2.0, -1.0], [0.0, 2.0, 1.4]],
         [[-0.9, 1.2, -0.1], [-0.5, 1.2, -0.3], [-0.6, 1.2, 0.3]]],
        np.float32) + np.asarray(shift, np.float32)
    normals = np.broadcast_to(np.array([0.0, -1.0, 0.0], np.float32),
                              (2, 3, 3)).copy()
    return Scene(
        geometry=geometry_from_mesh(verts, normals, np.array([0, 1], np.int32),
                                    pad_to=8),
        materials=MaterialTable.from_dicts(
            [dict(albedo=(0.7, 0.3, 0.2), kd=1.0, ks=0.2),
             dict(albedo=(0.2, 0.6, 0.3), kd=1.0, ks=0.1)]),
        lights=Lights.from_dicts([dict(position=(-2.0, -2.0, 2.0),
                                       color=(1.0, 1.0, 1.0), intensity=4.0)]),
        camera=Camera.create(position=(0.0, -1.5, 0.0),
                             look_at=(0.0, 1.0, 0.0), up=(0, 0, 1),
                             focal_length_mm=24.0, width=width, height=height),
        max_bounces=1, spp=1, diffuse_bounce=False, background_kind="miss",
        dialect="gpu", miss_color=jnp.asarray([0.1, 0.1, 0.3], jnp.float32),
        accel=None, terminal_only=True)


@pytest.fixture(scope="module")
def scenes():
    js = jax_tri_scene()
    target = np.array(j_soft(jax_tri_scene(shift=(0.05, 0.0, 0.02)),
                             sigma=0.02, shadows="none"))
    return js, torch_from_jax(js), target


@pytest.mark.parametrize("shadows", ["none", "hard_detached"])
def test_render_soft_matches_jax(scenes, shadows):
    js, ts, _ = scenes
    want = np.asarray(j_soft(js, sigma=0.02, shadows=shadows))
    got = render_soft(ts, sigma=0.02, shadows=shadows)
    assert tuple(got.shape) == want.shape == (18, 32, 3)
    assert ulp_close(got.numpy(), want).all()
    assert want.std() > 0.05


def test_hard_shadow_darkens(scenes):
    """The occluder's hard shadow falls on the large triangle."""
    _, ts, _ = scenes
    lit = render_soft(ts, sigma=0.02, shadows="none")
    shaded = render_soft(ts, sigma=0.02, shadows="hard_detached")
    assert float((lit - shaded).amax()) > 0.05
    assert bool((shaded <= lit + 1e-6).all())


@pytest.mark.parametrize("shadows", ["none", "hard_detached"])
def test_soft_loss_gradients_match_jax(scenes, shadows):
    js, ts, target = scenes
    jp = j_extract(js, keys=KEYS)
    jl, jg = jax.value_and_grad(lambda p: j_loss(
        p, js, jnp.asarray(target), sigma=0.02, shadows=shadows))(jp)
    tp = extract_params(ts, keys=KEYS)
    tl = soft_render_loss(tp, ts, torch.from_numpy(target), sigma=0.02,
                          shadows=shadows)
    grads = torch.autograd.grad(tl, list(tp.values()))
    assert ulp_close(tl.detach().numpy(), np.asarray(jl)).all()
    for key, g in zip(tp, grads):
        want = np.asarray(jg[key])
        scale = np.abs(want).max()
        assert scale > 0.0, key
        assert torch.isfinite(g).all(), key
        np.testing.assert_allclose(g.numpy(), want, rtol=0.0,
                                   atol=1e-5 * scale, err_msg=key)


def test_soft_converges_to_hard():
    """As sigma, gamma -> 0 the soft image approaches the port's hard
    render away from the silhouettes and the shadow's edge
    (``tests/test_diff_geom.py``'s size and bounds: the hard render's
    pixel centers lie half a pixel from the soft render's rays, so the
    bands cover a larger share of a smaller frame)."""
    from raytracinginonesemester_tpu_torch.render.renderer import render_scene

    ts = torch_from_jax(jax_tri_scene(width=64, height=36))
    hard = render_scene(ts, jitter_mode="center", spp_override=1).numpy()
    soft = render_soft(ts, sigma=1e-4, gamma=1e-3).numpy()
    diff = np.abs(hard - soft).max(axis=-1)
    assert (diff < 2e-2).mean() > 0.97
    assert np.median(diff) < 1e-3


def _train(ts, target, params, opt, steps):
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = soft_render_loss(params, ts, target, sigma=0.02,
                                shadows="none")
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def test_checkpoint_resume_bit_exact(scenes, tmp_path):
    """Four Adam steps straight equal two steps, a checkpoint, a new
    optimizer loaded from it and two more steps, bit for bit."""
    _, ts, target = scenes
    target = torch.from_numpy(target)

    def fresh():
        p = extract_params(ts, keys=("vertices", "albedo"))
        return p, torch.optim.Adam(list(p.values()), lr=0.01)

    p, opt = fresh()
    straight = _train(ts, target, p, opt, 4)

    p2, opt2 = fresh()
    first = _train(ts, target, p2, opt2, 2)
    d = str(tmp_path / "ck")
    path = save_checkpoint(d, 2, p2, opt2.state_dict(), first)
    assert os.path.basename(path) == "ckpt_00000002.pkl"
    assert latest_step(d) == 2
    step, saved, opt_state, losses = load_checkpoint(d)
    assert step == 2 and losses == first
    assert all(isinstance(v, np.ndarray) for v in saved.values())
    p3 = {k: torch.from_numpy(v).requires_grad_(True) for k, v in saved.items()}
    opt3 = torch.optim.Adam(list(p3.values()), lr=0.01)
    opt3.load_state_dict(to_tensors(opt_state))
    resumed = first + _train(ts, target, p3, opt3, 2)
    assert resumed == straight
    for k in p:
        torch.testing.assert_close(p3[k], p[k], rtol=0, atol=0)


def test_checkpoint_steps_and_missing(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    os.makedirs(d)
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(d)
    save_checkpoint(d, 3, {"a": torch.arange(4.0)}, losses=[2.0, 1.0])
    save_checkpoint(d, 7, {"a": torch.arange(4.0) * 2}, losses=[0.5])
    assert latest_step(d) == 7
    step, params, opt_state, losses = load_checkpoint(d, 3)
    assert step == 3 and opt_state is None and losses == [2.0, 1.0]
    np.testing.assert_array_equal(params["a"], np.arange(4.0))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(d, 5)


def test_metrics_logger_and_progress_bar(tmp_path, capsys):
    from raytracinginonesemester_tpu_torch.utils.logging import (
        MetricsLogger, progress_bar)

    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(path)
    log.log("step", loss=0.5, i=3)
    log.log("done", loss=0.1)
    log.close()
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["event"] == "step" and lines[0]["loss"] == 0.5
    assert lines[1]["event"] == "done"
    assert "[step] loss=0.5 i=3" in capsys.readouterr().err
    s = progress_bar(20, 40, width=10)
    assert "50%" in s and s.count("=") == 5


def test_inverse_render_example(tmp_path, monkeypatch):
    """``examples/inverse_render_torch.py`` on the CPU at 24x16: it
    writes its PNGs into the working directory, and a second run with
    the same checkpoint directory resumes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "inverse_render_torch",
        os.path.join(REPO, "examples", "inverse_render_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.chdir(tmp_path)
    args = ["--device", "cpu", "--width", "24", "--height", "16"]
    assert mod.main(args + ["--steps", "2"]) == 0
    for name in ("inverse_target.png", "inverse_result.png",
                 "inverse_metrics.jsonl"):
        assert os.path.getsize(tmp_path / name) > 0
    assert latest_step(str(tmp_path / "inverse_ckpt")) == 1
    assert mod.main(args + ["--steps", "3"]) == 0
