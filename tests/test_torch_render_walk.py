"""Kernel D of the PyTorch port as the card runs it (``csrc/megakernel.cu``
``render_kernel``), emulated on the CPU.

Four threads own a pixel over its samples, 8 pixels a warp.  Each
sample runs depth 0 on every pixel of a tile with work: with a binned
plan the CTA stages the tile's chunks and a pixel's four threads split
them (``closest_binned_cta<4>``, A's walk: four candidates at the window
a thread's best t had before them, taken in order, then the first (t,
id) minimum of the four); without one, and at every later depth, the
pixel's first thread holds the path and a (ray, block) pair's triangles
are tested by the warp's 32 lanes at the owner's window, a xor tree
keeping the (t, id, slot) minimum (``closest_coop``), and the shadow
rays are walked the same way, 128 triangles between votes
(``occluded_coop``).  The bounce loop runs while a path of the warp is
alive; a lane without a live path takes part in the others' walks and
keeps its state.  The sample adds clip(rd) (gpu) or rd (cpuonly),
samples in ascending order.

The emulation does the same with torch ops -- the walks of
``test_torch_megakernel`` (B's and A's), the bounce of the plain
version, and the depth loop run warp by warp -- and is held bit for bit
against ``render_tiles_plain`` in both dialects, terminal and with the
full loop, binned and flat, and with two samples from a sample offset.
The C constants the design relies on are held to their Python
counterparts.
"""

import dataclasses
import functools
import os
import re

import pytest
import torch

from raytracinginonesemester_tpu_torch.ops import binned
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.render.renderer import (
    _swizzled_grid as t_grid)

from _torch_parity import (REPO, counting_binned_walk,  # noqa: F401
                           one_torch_thread)
from test_torch_megakernel import (_coop_closest, _coop_occluded,
                                   _cta_closest_binned)

W, H = 48, 24
WARP = 32
RENDER_SPLIT = 4  # kRenderSplit: the threads of a path
FOCAL_MM = 300.0


def _render_emulated(rows, xs_p, ys_p, work, spp, offset, max_bounces,
                     terminal, sh, jitter, plan):
    """``render_kernel`` on a padded pixel stream -> (r, g, b) sums, each
    (nt, RAY_TILE), with the walks already in place of the plain ones."""
    sky = [torch.clamp(rows.cam[12 + c], 0.0, 1.0) for c in range(3)]
    acc = [torch.zeros(xs_p.numel()) for _ in range(3)]
    warp_depths = 0
    for k in range(spp):
        st = tmk._primary_state(rows, xs_p, ys_p, offset + k, jitter, work)
        tmk._bounce_plain(rows, st, sh, plan)  # depth 0
        for _ in range(1, 1 if terminal else max_bounces):
            warps = (st["alive"] > 0.0).reshape(
                -1, WARP // RENDER_SPLIT).any(dim=1)
            if not bool(warps.any()):
                break
            warp_depths += int(warps.sum())
            # every lane of a warp with a live path runs the bounce; the
            # lanes whose path has died pass through it unchanged
            lanes = warps.repeat_interleave(
                WARP // RENDER_SPLIT).nonzero().squeeze(1)
            sub = {key: ([c[lanes] for c in v] if isinstance(v, list)
                         else v[lanes]) for key, v in st.items()}
            tmk._bounce_plain(rows, sub, sh)
            for key, v in sub.items():
                if isinstance(v, list):
                    st[key] = [a.index_put((lanes,), b)
                               for a, b in zip(st[key], v)]
                else:
                    st[key] = st[key].index_put((lanes,), v)
        for c in range(3):
            rd = st["rd"][c] if sh.cpuonly else torch.clamp(st["rd"][c],
                                                            0.0, 1.0)
            acc[c] = acc[c] + torch.where(work.repeat_interleave(
                tmk.RAY_TILE), rd, sky[c])
    return tuple(a.reshape(-1, tmk.RAY_TILE) for a in acc), warp_depths


def _scene(dialect, terminal, monkeypatch):
    """Two-frog 48x24 at 128-triangle blocks through a 300 mm lens (a
    tile sees part of the frog), depth 4; terminal: no diffuse bounce
    (every kr is 0); cpuonly with an area light of radius 0.15 and 2 disk
    samples."""
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    from _torch_parity import two_frog_config

    monkeypatch.setenv("RT_BLOCK_SIZE", "128")
    cfg = dataclasses.replace(
        two_frog_config(SceneConfig, SceneNodeConfig, Transform, width=W,
                        height=H, max_bounces=4, diffuse_bounce=not terminal,
                        dialect=dialect), focal_length_mm=FOCAL_MM)
    if dialect == "cpuonly":
        cfg = dataclasses.replace(cfg, lights=[
            {**l, "radius": 0.15, "shadow_samples": 2} for l in cfg.lights])
    return build_scene(cfg, device="cpu")


@pytest.mark.parametrize("dialect,terminal,binned_plan,spp,offset", [
    ("gpu", False, True, 1, 0),
    ("gpu", False, False, 2, 5),
    ("gpu", True, True, 1, 3),
    ("gpu", True, False, 2, 0),
    ("cpuonly", False, True, 1, 3),
    ("cpuonly", False, False, 1, 3),
])
def test_render_walk_matches_the_plain_walk(dialect, terminal, binned_plan,
                                            spp, offset, monkeypatch):
    """D's walks and its warp-uniform depth loop give the plain version's
    r, g, b sums bit for bit; its binned depth 0 walks a plan ordered
    front to back, its warps skipping the chunks behind their paths'
    hits, and schedules and tests the warp-chunks that
    ``_torch_parity.warp_chunk_counts`` counts."""
    ts = _scene(dialect, terminal, monkeypatch)
    rows = tmk._scene_rows(ts, ts.accel)
    assert rows.block_size == 128
    kw = tmk.megakernel_kwargs(ts, "wang")
    jitter = kw.pop("jitter", "wang")
    sh = tmk._plain_shade(ts.diffuse_bounce, kw.get("det_eps", 1e-8), 1e-4,
                          kw.get("shadow_eps", 1e-3),
                          kw.get("shadow_tmin", 1e-4), dialect,
                          kw.get("shadow_samples", 1), jitter)
    is_terminal = (bool(ts.terminal_only) and not ts.diffuse_bounce
                   and dialect == "gpu")
    assert is_terminal == terminal
    xs, ys, _ = t_grid(W, H)
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    plan = (binned.order_front_to_back(binned.build_camera_candidate_plan(
        ts.camera, xs_p, ys_p, ts.accel, tmk.RAY_TILE, chunk=126), ts.camera)
        if binned_plan else None)
    work = tmk._has_work(ts, xs_p, ys_p, sh, None, plan)
    chunks = [torch.zeros(2, dtype=torch.int64) for _ in range(2)]
    monkeypatch.setattr(tmk, "_closest_binned_plain", counting_binned_walk(
        tmk._closest_binned_plain, chunks[0]))
    want = tmk.render_tiles_plain(
        rows, xs_p, ys_p, work, spp, offset, ts.max_bounces, terminal,
        ts.diffuse_bounce, jitter=jitter, cand_plan=plan,
        **{k: v for k, v in kw.items() if k != "dialect"}, dialect=dialect)

    calls = {"binned": 0, "closest": 0, "shadow": 0, "blocked": 0}

    def counted(key, fn):
        def f(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return f

    def shadow(*a, **k):
        calls["shadow"] += 1
        blocked, tests = _coop_occluded(*a, **k)
        calls["blocked"] += int(blocked.sum())
        return blocked, tests

    monkeypatch.setattr(tmk, "_closest_binned_plain", counted(
        "binned", functools.partial(_cta_closest_binned, chunks=chunks[1],
                                    split=RENDER_SPLIT)))
    monkeypatch.setattr(tmk, "_closest_plain",
                        counted("closest", _coop_closest))
    monkeypatch.setattr(tmk, "_occluded_plain", shadow)
    got, warp_depths = _render_emulated(rows, xs_p, ys_p, work, spp, offset,
                                        ts.max_bounces, terminal, sh, jitter,
                                        plan)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert calls["binned" if binned_plan else "closest"] >= spp
    assert torch.equal(chunks[0], chunks[1])
    if binned_plan:
        assert 0 < int(chunks[0][1]) < int(chunks[0][0])
    assert calls["shadow"] > 0 and calls["blocked"] > 0
    assert (warp_depths > 0) == (not terminal)
    assert 0.0 < float(want[0].max())


def test_render_constants_match_the_kernel_source():
    """``csrc/megakernel.cu``: a CTA of the render lies in one tile (its
    paths divide RAY_TILE), and the threads a path or a ray has in the
    render's and emit's binned walks are the emulations'."""
    from test_torch_megakernel import _SPLIT

    path = os.path.join(REPO, "raytracinginonesemester_tpu_torch", "csrc",
                        "megakernel.cu")
    with open(path) as f:
        text = f.read()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", text)
                  .group(1))
    assert int(re.search(r"constexpr int kEmitSplit = (\d+);", text)
               .group(1)) == _SPLIT
    split = int(re.search(r"constexpr int kRenderSplit = (\d+);", text)
                .group(1))
    assert split == RENDER_SPLIT and WARP % split == 0
    assert tmk.RAY_TILE % (threads // split) == 0 and threads % WARP == 0
    render = re.search(
        r"W == kRender\)\s*h = cta_hit\(closest_binned_cta<(\w+)>", text)
    emit = re.search(r"W == kList\)\s*h = closest_binned_cta<(\w+)>", text)
    assert render.group(1) == "kRenderSplit"
    assert emit.group(1) == "kEmitSplit"
