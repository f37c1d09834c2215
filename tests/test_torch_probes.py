"""The TPU probes P1-P3 of ``scripts/`` in the PyTorch port
(``raytracinginonesemester_tpu_torch/probes``), held against the probes'
own Pallas kernels on the CPU.

The scripts run their TPU timing when imported, so the kernels are taken
out of their source with ``ast``: imports, constant assignments and the
named kernel functions, nothing else (no ``jax.config`` call, no timing,
no ``pallas_call``), with ``VISITS`` overridden where a case asks.  The
test wraps them in ``pl.pallas_call(..., interpret=True)`` with the
scripts' specs.  Every comparison is exact.  Two hazards of the
reference shape the rules:

- interpret mode reads a ref in a ``while_loop`` condition at its value on
  entry, so P1's loop never sees its outputs reach 3: there ``scalar``
  gives 156 and ``both`` the count of set boxes, where the kernel's own
  function (the CUDA kernel's and the plain version's) is ``min(3, ·)``;
- P1 ``grid``'s store of a (1, 512) row into the (8, 512) block does not
  trace, so ``grid`` is held against a float32 numpy evaluation of its
  formula (the row broadcast over the block), and its mask against the
  Pallas kernel's through ``both``'s counts; P2b's bf16 x bf16 -> f32 dot
  does not run in interpret mode on XLA:CPU, so ``mm22`` is held against
  the script's out-of-kernel ``mm_out``/``mm_attr`` formula (under
  ``jax.jit``), summed in the kernel's order.

The CUDA kernels run only on a card (``cuda`` marker; ``chip_smoke.py``
phase 12 at full width).
"""

import ast
import os
import re
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracinginonesemester_tpu_torch import probes
from raytracinginonesemester_tpu_torch.ops import _native
from raytracinginonesemester_tpu_torch.probes import dyn_reads as dr
from raytracinginonesemester_tpu_torch.probes import mm_select as ms
from raytracinginonesemester_tpu_torch.probes import toy_mask as tm

from _torch_parity import REPO, one_torch_thread  # noqa: F401


def _load(script, names, visits=None):
    """The imports, constants and ``names`` functions of
    ``scripts/<script>``, executed apart from the rest of the script."""
    path = os.path.join(REPO, "scripts", script)
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            keep.append(node)
        elif isinstance(node, ast.Assign) and all(
                isinstance(t, (ast.Name, ast.Tuple)) for t in node.targets):
            try:
                ast.literal_eval(node.value)
            except ValueError:
                continue
            keep.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name in names:
            keep.append(node)
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    assert set(names) <= set(ns)
    if visits is not None:
        ns["VISITS"] = visits
    return ns


# --- P1: probe_toy_mask.py --------------------------------------------


def _p1_jax(mode, rays, aabb):
    """The script's ``run`` in interpret mode: 8 programs of (8, 512)."""
    ns = _load("probe_toy_mask.py", {"kernel"})
    rt, lp = ns["RT"], ns["LP"]
    call = pl.pallas_call(
        partial(ns["kernel"], mode),
        out_shape=[jax.ShapeDtypeStruct((64, rt), jnp.float32)],
        grid=(8,),
        in_specs=[pl.BlockSpec((8, rt), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=[pl.BlockSpec((8, rt), lambda i: (i, 0),
                                memory_space=pltpu.VMEM)],
        scratch_shapes=[pltpu.VMEM((lp, 1), jnp.float32)],
        interpret=True)
    return np.asarray(call(jnp.asarray(rays.numpy()),
                           jnp.asarray(aabb.numpy()))[0])


P1_INPUTS = {"script": lambda: tm.script_inputs("cpu"),
             "hazards": lambda: tm.hazard_inputs(0, "cpu")}


@pytest.mark.parametrize("mode", ["scalar", "both"])
@pytest.mark.parametrize("inputs", sorted(P1_INPUTS))
def test_toy_mask_loop_matches_jax(inputs, mode):
    rays, aabb = P1_INPUTS[inputs]()
    want = _p1_jax(mode, rays, aabb)
    got = tm.toy_mask(mode, rays, aabb).numpy()
    np.testing.assert_array_equal(got, np.minimum(np.float32(3), want))
    if mode == "both":
        # interpret mode's count is the mask's: the port's slab test
        # sets the same number of boxes in every block
        counts = tm.box_mask(rays, aabb).sum(dim=1).numpy()
        np.testing.assert_array_equal(want.reshape(8, -1).max(axis=1), counts)
        np.testing.assert_array_equal(want.reshape(8, -1).min(axis=1), counts)
        if inputs == "hazards":
            assert {0, 1} <= set(counts.tolist()) and counts.max() > 3


def _grid_numpy(rays, aabb):
    """The ``grid`` kernel's formula in float32 numpy, NaN-propagating
    min and max, the (1, 512) row stored into all 8 rows."""
    out = np.empty_like(rays)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(rays.shape[0] // 8):
            blk = rays[8 * i:8 * i + 8]
            t0 = np.full((aabb.shape[0], blk.shape[1]), np.float32(1e-4))
            t1 = np.broadcast_to(blk[6:7], t0.shape)
            for a in range(3):
                si = np.float32(1.0) / blk[3 + a:4 + a]
                lo = (aabb[:, a:a + 1] - blk[a:a + 1]) * si
                hi = (aabb[:, a + 3:a + 4] - blk[a:a + 1]) * si
                t0 = np.maximum(t0, np.minimum(lo, hi))
                t1 = np.minimum(t1, np.maximum(lo, hi))
            mask0 = np.float32((t0[0] <= t1[0]).any())
            out[8 * i:8 * i + 8] = mask0 + blk[6:7]
    return out


@pytest.mark.parametrize("inputs", sorted(P1_INPUTS))
def test_toy_mask_grid_matches_numpy(inputs):
    rays, aabb = P1_INPUTS[inputs]()
    got = tm.toy_mask("grid", rays, aabb).numpy()
    want = _grid_numpy(rays.numpy(), aabb.numpy())
    np.testing.assert_array_equal(got, want)  # NaN where dist is NaN
    if inputs == "hazards":
        assert np.isnan(got).any()
        first = got[::8, 0] - rays.numpy()[6::8, 0]
        assert {0.0, 1.0} <= set(np.round(first, 3).tolist())


# --- P2: probe_mm_select.py -------------------------------------------


def _near_511():
    """The script's q and a win within 12 lanes of 511, so that the
    visits wrap past lane 511."""
    win, q, qsel = ms.script_inputs("cpu")
    win = (500 + torch.arange(ms.RT, dtype=torch.int32) % 12).reshape(-1, 1)
    return win, q, qsel


P2_CASES = {"16": (16, lambda: ms.script_inputs("cpu")),
            "33": (33, lambda: ms.script_inputs("cpu")),
            "16-wrap": (16, _near_511)}


@pytest.mark.parametrize("case", sorted(P2_CASES))
def test_sel7_matches_jax(case):
    visits, inputs = P2_CASES[case]
    win, q, _ = inputs()
    ns = _load("probe_mm_select.py", {"_pick", "sel_kernel"}, visits)
    want = pl.pallas_call(
        ns["sel_kernel"], out_shape=jax.ShapeDtypeStruct((1, ms.RT),
                                                         jnp.float32),
        interpret=True)(jnp.asarray(win.numpy()), jnp.asarray(q.numpy()))
    got = ms.sel7(win, q, visits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split3_and_qsel_match_the_script():
    _, q, qsel = ms.script_inputs("cpu")
    ns = _load("probe_mm_select.py", {"split3"})
    want = ns["split3"](jnp.asarray(q.numpy()))
    for a, b in zip(ms.split3(q), want):
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))
    hi, mid, lo = (np.asarray(p) for p in want)
    pack = jnp.zeros((ms.B, 128), jnp.bfloat16)
    pack = pack.at[:, 0:ms.F].set(hi.T).at[:, 32:32 + ms.F].set(mid.T).at[
        :, 64:64 + ms.F].set(lo.T)  # probe_mm_select.py:81-83
    np.testing.assert_array_equal(qsel.view(torch.int16).numpy(),
                                  np.asarray(pack).view(np.int16))


@pytest.mark.parametrize("case", ["16", "33-wrap"])
def test_mm22_matches_the_script_formula(case):
    """``mm22`` against ``probe_mm_select.py:126-128`` visit by visit:
    ``mm_out`` of each visit's one-hot pick, its ``mm_attr``, summed into
    each ray attribute after attribute, visit after visit."""
    visits = int(case.split("-")[0])
    win, _, qsel = (_near_511() if case.endswith("wrap")
                    else ms.script_inputs("cpu"))
    F, lanes = ms.F, ms.B

    @jax.jit
    def mm_attr(pick, qsel):
        mm_out = jnp.dot(pick.astype(jnp.bfloat16), qsel,
                         preferred_element_type=jnp.float32)
        return (mm_out[:, 0:F] + mm_out[:, 32:32 + F]
                + mm_out[:, 64:64 + F]).T

    jq = jnp.asarray(qsel.view(torch.int16).numpy()).view(jnp.bfloat16)
    w0 = win.numpy().reshape(-1)
    acc = np.zeros(w0.shape[0], np.float32)
    for k in range(visits):
        pick = np.zeros((w0.shape[0], lanes), np.float32)
        pick[np.arange(w0.shape[0]), (w0 + k) % lanes] = 1.0
        for row in np.asarray(mm_attr(jnp.asarray(pick), jq)):
            acc = acc + row
    got = ms.mm22(win, qsel, visits)
    np.testing.assert_array_equal(got.numpy(), acc[None, :])


# --- P3: probe_dyn_reads.py -------------------------------------------


@pytest.mark.parametrize("name", ["dyn12", "blk1"])
def test_dyn_reads_match_jax(name):
    q = dr.script_inputs("cpu")
    ns = _load("probe_dyn_reads.py", {f"{name}_kernel"})
    assert ns["VISITS"] == dr.VISITS == 4096
    want = pl.pallas_call(
        ns[f"{name}_kernel"],
        out_shape=jax.ShapeDtypeStruct((1, dr.B), jnp.float32),
        interpret=True)(jnp.asarray(q.numpy()))
    got = getattr(dr, name)(q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the wrappers ------------------------------------------------------


def test_wrappers_refuse_what_the_kernels_do_not_take():
    rays, aabb = tm.script_inputs("cpu")
    win, q, qsel = ms.script_inputs("cpu")
    bad = [
        lambda: tm.toy_mask("nope", rays, aabb),
        lambda: tm.toy_mask("grid", rays[:60], aabb),
        lambda: tm.toy_mask("grid", rays, torch.ones(tm.LP + 1, 8)),
        lambda: ms.sel7(win.to(torch.int64), q),
        lambda: ms.sel7(win, q[:6]),
        lambda: ms.mm22(win, qsel.to(torch.float32)),
        lambda: ms.mm22(win[:20], qsel),
        lambda: ms.mm22(win, qsel[:, :80]),
        lambda: dr.dyn12(dr.script_inputs("cpu")[:100]),
        lambda: dr.blk1(dr.script_inputs("cpu"), visits=-1),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    probes.reset_launch_counts()
    tm.toy_mask("scalar", rays, aabb)  # the CPU runs no kernel
    assert set(probes.launch_counts().values()) == {0}


# --- the C interface --------------------------------------------------


class _Lib:
    """Stands in for a loaded library: every ``rt_*`` attribute is an
    object that takes ``argtypes`` and ``restype``."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, SimpleNamespace())


@pytest.mark.parametrize("source", _native.SOURCES)
def test_c_interface_matches_its_ctypes_declaration(source):
    """Every ``rt_*`` function of ``csrc/<source>.cu`` is declared to
    ctypes with as many arguments as its C signature takes (ctypes raises
    at the call, on the card only, when they differ)."""
    path = os.path.join(REPO, "raytracinginonesemester_tpu_torch", "csrc",
                        f"{source}.cu")
    with open(path) as f:
        text = f.read()
    sigs = {m.group(1): len([p for p in m.group(2).split(",") if p.strip()])
            for m in re.finditer(r"\b(rt_\w+)\(([^)]*)\)\s*\{", text)}
    lib = _Lib()
    _native._declare(source, lib)
    declared = {k: len(v.argtypes) for k, v in lib.fns.items()}
    assert declared == sigs


# --- on the card ------------------------------------------------------


@pytest.mark.cuda
def test_cuda_probes_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    probes.reset_launch_counts()
    for rays, aabb in (tm.script_inputs(), tm.hazard_inputs(0)):
        for mode in tm.MODES:
            torch.testing.assert_close(
                tm.toy_mask(mode, rays, aabb),
                tm.toy_mask_plain(mode, rays, aabb), rtol=0, atol=0,
                equal_nan=True)
    win, q, qsel = ms.script_inputs()
    torch.testing.assert_close(ms.sel7(win, q), ms.sel7_plain(win, q),
                               rtol=0, atol=0)
    torch.testing.assert_close(ms.mm22(win, qsel), ms.mm22_plain(win, qsel),
                               rtol=0, atol=0)
    q = dr.script_inputs()
    torch.testing.assert_close(dr.dyn12(q), dr.dyn12_plain(q), rtol=0, atol=0)
    torch.testing.assert_close(dr.blk1(q), dr.blk1_plain(q), rtol=0, atol=0)
    assert probes.launch_counts() == {"toy_mask": 6, "sel7": 1, "mm22": 1,
                                      "dyn12": 1, "blk1": 1}
