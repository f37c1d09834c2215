"""The comparison that decides ``correct``, at test sizes on the CPU: the
reference agrees with the port's plain CPU path on both entries, and the
control (the reference in bfloat16 in the program's place) and every
fault that a cell can have come out not correct."""

from __future__ import annotations

import io
import json

import pytest
import torch

from bench_port import calibrate, harness

RENDER = ["frog_1080p.wavefront", "frog_1080p.terminal", "frog_1080p.staged"]
SEED = 2 ** 31 + 12345  # a seed past 32 signed bits


def _run(root, cell, seed=SEED, seconds=0.0):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, seed, seconds, False, 0.0, device="cpu",
                     root=root, out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().splitlines()[-1])


def _entry(root, cell, seed=SEED):
    import types

    c = harness.Cell(cell, root)
    run = types.SimpleNamespace(root=root, cfg=c.cfg, traffic=c.traffic,
                                seed=seed, device="cpu", keep_pixels=None)
    return c, c.entry_module().Entry(run)


def _correct(cell, numbers) -> bool:
    limits = {k: v["limit"] for k, v in cell.limits["numbers"].items()}
    return all(harness._ok(numbers[k], limits[k]) for k in limits)


@pytest.mark.parametrize("cell", RENDER)
def test_the_reference_agrees_with_the_port(small_root, cell):
    result = _run(small_root, cell, seconds=0.5)
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0


# At 64x32 one pixel is 1/2,048 of the image, and the block grid's and
# the brute force's last bits send about one pixel a render another way
# (a shadow ray that grazes the jagged perturbed spheres): on six seeds
# the gaps read up to 0.005 (loss) and 0.012 (gradient, update) here,
# against 4e-5 to 2e-3 at the cell's 960x540, where each pixel weighs
# less; the control and the faults read 0.17 to 50 at this size.
SMALL_TRAIN_GAP = 0.05


def test_the_training_reference_agrees_with_the_port(small_root):
    # the test copy restarts every 3 steps: the window's steps cross a
    # restart, and its last step is checked from the state saved before it
    result = _run(small_root, "spheres_540p.train", seconds=0.5)
    numbers = {k: v["value"] for k, v in result["check"].items()}
    gaps = {"loss_gap", "grad_gap", "update_gap", "last_loss_gap",
            "last_grad_gap", "last_update_gap"}
    assert set(numbers) == gaps | {"start_gap", "drift"}
    assert numbers["start_gap"] == 0.0
    assert 0.0 < numbers["drift"] <= 0.05
    assert all(numbers[k] <= SMALL_TRAIN_GAP for k in gaps), numbers
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("cell", RENDER + ["spheres_540p.train"])
def test_the_control_is_not_correct(small_root, cell):
    c, entry = _entry(small_root, cell, seed=7)
    for i in range(2):
        entry.call()
        entry.keep(i)
    entry.release()
    assert not _correct(c, entry.control())


@pytest.mark.parametrize("fault", calibrate.FAULTS["render_frames"])
@pytest.mark.parametrize("cell", RENDER)
def test_a_broken_render_is_not_correct(small_root, cell, fault):
    with calibrate.planted(fault, "render_frames"):
        result = _run(small_root, cell, seconds=0.5)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("fault", calibrate.FAULTS["train_step"])
def test_a_broken_training_step_is_not_correct(small_root, fault):
    with calibrate.planted(fault):
        result = _run(small_root, "spheres_540p.train")
    assert not result["correct"], result["check"]


def test_a_run_without_a_card_fails(small_root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run("frog_1080p.terminal", 1, 1.0, False, 0.0,
                     device="cuda", root=small_root, out=out, err=err)
    assert rc != 0 and out.getvalue() == ""


def test_a_run_that_loaded_jax_prints_nothing(small_root, monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run("frog_1080p.terminal", 1, 0.0, False, 0.0,
                     device="cpu", root=small_root, out=out, err=err)
    assert rc != 0 and out.getvalue() == ""
    assert "jax" in err.getvalue()
