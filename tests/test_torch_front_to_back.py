"""The depth-0 binned walk on a plan ordered front to back
(``ops.binned.order_front_to_back``), with no JAX: this file runs on the
card with ``--noconftest``.

Kernels A (``emit_kernel``) and D (``render_kernel``) walk a tile's
chunks with ``closest_binned_cta``; in an ordered plan a warp skips the
chunks whose near bound lies above each of its rays' best t.  The
winners are the unordered walk's, so A's state and rng rows and D's
frames on the ordered plan equal those on the unordered plan bit for
bit: on the two-frog scene (beside the plain versions), at full width on
the 1,270,912-triangle frog (A) and on the terminal frog (D).  The
warp-chunks the walks schedule and test (``binned_chunk_counts``) are
counted on the card as ``_torch_parity.warp_chunk_counts`` counts them
on the plain versions' rays, with no copy to the host until they are
read."""

import dataclasses

import pytest
import torch

from raytracinginonesemester_tpu_torch.ops import binned
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.render import renderer as tr

from _torch_parity import (counting_binned_walk,  # noqa: F401
                           one_torch_thread, regridded)

W, H = 128, 64
OFFSET = 912_345


def _two_frog(device, monkeypatch):
    """The two-frog scene through a 135 mm lens (a tile sees part of the
    frog, its front and its back), 512-triangle blocks, depth 3."""
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    from _torch_parity import two_frog_config

    monkeypatch.setenv("RT_BLOCK_SIZE", "512")
    cfg = dataclasses.replace(
        two_frog_config(SceneConfig, SceneNodeConfig, Transform, width=W,
                        height=H), focal_length_mm=135.0)
    return build_scene(cfg, device=device)


class _Plans:
    """A scene's padded pixel stream and its binned plan, as built and
    ordered front to back."""

    def __init__(self, scene):
        self.scene = scene
        xs, ys, _ = tr._swizzled_grid(scene.camera.width,
                                      scene.camera.height,
                                      device=scene.device)
        self.xs, self.ys, _, _ = tmk._pad_tiles(xs, ys)
        self.rows = tmk._scene_rows(scene, scene.accel)
        self.built = binned.build_camera_candidate_plan(
            scene.camera, self.xs, self.ys, scene.accel, tmk.RAY_TILE)
        self.ordered = binned.order_front_to_back(self.built, scene.camera)
        self.kw = tmk.megakernel_kwargs(scene, "wang")
        self.kw.setdefault("jitter", "wang")

    def emit(self, plan):
        return tmk.emit_tiles(self.scene, self.xs, self.ys, OFFSET,
                              cand_plan=plan, rows=self.rows, **self.kw)

    def render(self, plan, spp=1):
        return tmk.render_tiles(self.scene, self.xs, self.ys, spp, OFFSET,
                                cand_plan=plan, rows=self.rows, **self.kw)

    def counted(self, fn):
        """fn's result and the warp-chunks the card counted."""
        tmk.reset_launch_counts()
        out = fn()
        (counts,) = tmk.binned_chunk_counts().values()
        return out, counts

    def plain_counted(self, fn, monkeypatch):
        """fn's result and the warp-chunks of its plain binned walks
        (``warp_chunk_counts``)."""
        counts = torch.zeros(2, dtype=torch.int64)
        with monkeypatch.context() as m:
            m.setattr(tmk, "_closest_binned_plain", counting_binned_walk(
                tmk._closest_binned_plain, counts))
            out = fn()
        return out, tuple(counts.tolist())


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_plain_walks_count_the_chunks_they_schedule_and_test(
        monkeypatch):
    """On the CPU: emit and render on the ordered plan equal the unordered
    plan's bit for bit; by the kernels' rule (``warp_chunk_counts``) the
    unordered plan tests every chunk it schedules and the ordered one
    fewer, the same chunks scheduled in both, a render's once a sample;
    the plain versions count nothing on ``binned_chunk_counts``."""
    p = _Plans(_two_frog("cpu", monkeypatch))
    (st, rng), built = p.plain_counted(lambda: p.emit(p.built), monkeypatch)
    (st_o, rng_o), ordered = p.plain_counted(lambda: p.emit(p.ordered),
                                             monkeypatch)
    _equal((st_o, rng_o), (st, rng))
    assert built[0] == built[1] == ordered[0] > ordered[1] > 0
    frame, _ = p.plain_counted(lambda: p.render(p.built, spp=2),
                               monkeypatch)
    frame_o, two = p.plain_counted(lambda: p.render(p.ordered, spp=2),
                                   monkeypatch)
    assert torch.equal(frame_o, frame)
    assert two[0] == 2 * ordered[0] and 0 < two[1] < two[0]
    assert tmk.binned_chunk_counts() == {}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")


@pytest.mark.cuda
def test_cuda_ordered_walks_match_the_unordered_and_the_plain(monkeypatch):
    """Two-frog 128x64: A's state and rng rows and D's sums on the ordered
    plan equal the unordered plan's and the plain versions', bit for bit;
    the card's chunk counts equal ``warp_chunk_counts`` on the plain
    versions' rays, and the walk skips some."""
    _cuda()
    p = _Plans(_two_frog("cuda", monkeypatch))
    sh = tmk._Shade(p.scene.diffuse_bounce, dialect=p.scene.dialect)
    work = tmk._has_work(p.scene, p.xs, p.ys, sh, None, p.ordered)
    pkw = {k: v for k, v in p.kw.items() if k not in ("dialect", "jitter")}
    (st, rng), counts = p.counted(lambda: p.emit(p.ordered))
    want, plain = p.plain_counted(lambda: tmk.emit_tiles_plain(
        p.rows, p.xs, p.ys, work, OFFSET, p.scene.diffuse_bounce,
        jitter="wang", cand_plan=p.ordered, **pkw), monkeypatch)
    _equal((st, rng), want)
    _equal((st, rng), p.emit(p.built))
    assert counts == plain
    assert 0 < counts[1] < counts[0]
    frame, counts = p.counted(lambda: p.render(p.ordered))
    sums, plain = p.plain_counted(lambda: tmk.render_tiles_plain(
        p.rows, p.xs, p.ys, work, 1, OFFSET, p.scene.max_bounces, False,
        p.scene.diffuse_bounce, jitter="wang", cand_plan=p.ordered, **pkw),
        monkeypatch)
    assert torch.equal(frame, torch.stack([s.reshape(-1) for s in sums],
                                          1)[:frame.shape[0]])
    assert torch.equal(frame, p.render(p.built))
    assert counts == plain


@pytest.mark.cuda
def test_cuda_full_width_ordered_walks_match_the_unordered():
    """1920x1080: A on the 1,270,912-triangle frog and D on the terminal
    frog (depth 4, no diffuse bounce) give on the ordered plan the
    unordered plan's outputs bit for bit, and skip chunks there."""
    _cuda()
    large = _Plans(regridded(tr.frog_scene(1920, 1080, device="cuda"), 3))
    assert large.scene.geometry.num_triangles == 1_270_912
    (st, rng), counts = large.counted(lambda: large.emit(large.ordered))
    _equal((st, rng), large.emit(large.built))
    assert 0 < counts[1] < counts[0]
    del large, st, rng
    term = _Plans(tr.frog_scene(1920, 1080, max_bounces=4,
                                diffuse_bounce=False, device="cuda"))
    assert term.scene.terminal_only
    frame, counts = term.counted(lambda: term.render(term.ordered))
    assert torch.equal(frame, term.render(term.built))
    assert 0 < counts[1] < counts[0]
