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
phase 12 at full width).  Their schedules are emulated here with torch
ops and held bit for bit against the plain versions: mm22's register A
fragment of the one-hot pick, its packed shared-memory operand read back
by the descriptor's address formula, its product and chain through the
staging ring; P3's period-unrolled loop with its read-ahead window and tail;
sel7's deal of the rays to warps by bank class, its staged rows with
their repeated lanes and its stretches of visits with their read-ahead
window, wrap and int32 split; and P1's clusters, a CTA a chunk of boxes
and warp votes merged into words, with the loop in closed form.  The
constants they use are read from ``csrc/probes.cu``.
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
    ns["L"], ns["RT"] = aabb.shape[0], rays.shape[1]
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


def _narrow(rt, device="cpu"):
    """The seeded hazards' first ``rt`` rays of each block (fewer rays than
    a cluster has CTAs for ``rt`` < 8; blocks 1 and 2 keep the rays aimed
    at their nearest boxes)."""
    rays, aabb = tm.hazard_inputs(0, device)
    return rays[:, :rt].contiguous(), aabb


def _toy_mask_cluster(mode, rays, aabb):
    """``toy_mask_kernel``'s schedule: a cluster of 8 CTAs a block, CTA r
    testing boxes [r c, r c + c) (c = ceil(L / 8)) into a word a ray
    (bit l - r c), each warp's words ORed (a last warp of RT mod 32 rays
    alone), the warps' ORed into the CTA's word; thread j of CTA r stores
    that word into CTAs j, j + RT, ... (so every CTA gets it at any RT,
    below 8 too); every CTA then holds the block's 8 words and writes its
    row: ``both`` min(3, popcount), ``scalar`` min(3, L), ``grid`` (word 0
    bit 0) + dist."""
    nb, rt, n_boxes = rays.shape[0] // 8, rays.shape[1], aabb.shape[0]
    hits = tm.slab_hits(rays, aabb).numpy()  # (nb, L, rt)
    chunk = -(-n_boxes // 8)
    assert chunk <= 32
    out = np.empty((nb, 8, rt), np.float32)
    dist = rays.numpy().reshape(nb, 8, rt)[:, 6]
    for b in range(nb):
        got = [[None] * 8 for _ in range(8)]  # got[c][r]: CTA c's words[r]
        for r in range(8):
            l0, l1 = r * chunk, min(n_boxes, r * chunk + chunk)
            ray_words = np.zeros(rt, np.uint64)
            for l in range(l0, l1):
                ray_words |= hits[b, l].astype(np.uint64) << np.uint64(l - l0)
            word = 0
            for w0 in range(0, rt, 32):  # a warp's vote, then the CTA's OR
                word |= int(np.bitwise_or.reduce(ray_words[w0:w0 + 32]))
            for j in range(min(rt, 8)):  # the cluster exchange
                for c in range(j, 8, rt):
                    got[c][r] = word
        for r in range(8):
            words = got[r]
            assert None not in words
            if mode == "scalar":
                out[b, r] = np.float32(min(3, n_boxes))
            elif mode == "both":
                out[b, r] = np.float32(min(3, sum(bin(w).count("1")
                                                  for w in words)))
            else:
                out[b, r] = np.float32(words[0] & 1) + dist[b]
    return out.reshape(nb * 8, rt)


P1_SETS = {**P1_INPUTS, **{f"L={n} RT=100": (lambda n=n: tm.count_inputs(
    n, 100, 0, "cpu")) for n in (1, 2, 3, 156, 160)},
    **{f"hazards RT={rt}": (lambda rt=rt: _narrow(rt)) for rt in (1, 7)}}


@pytest.mark.parametrize("mode", tm.MODES)
@pytest.mark.parametrize("inputs", sorted(P1_SETS))
def test_toy_mask_closed_form_matches_loop(inputs, mode):
    """The kernel's clusters, warp votes and closed form give the plain
    version's loop bit for bit (NaN where a distance is NaN, in
    ``grid``); ``scalar`` and ``both`` also against the script's kernel
    in interpret mode (L and RT set to the inputs'), whose loop reads
    its condition at entry (``min(3, ·)`` of its output), and the new
    sets cover 0, 1, 2, 3 and more set boxes in a block."""
    rays, aabb = P1_SETS[inputs]()
    want = tm.toy_mask_plain(mode, rays, aabb).numpy()
    got = _toy_mask_cluster(mode, rays, aabb)
    np.testing.assert_array_equal(got, want)
    if mode != "grid":
        jax_out = _p1_jax(mode, rays, aabb)
        np.testing.assert_array_equal(got, np.minimum(np.float32(3),
                                                      jax_out))
    if inputs.startswith("L="):
        counts = tm.box_mask(rays, aabb).sum(dim=1).tolist()
        n_boxes = aabb.shape[0]
        assert counts == [min(c, n_boxes) for c in (0, 1, 2, 3, 4, 7, 20,
                                                    98)]


# --- P2: probe_mm_select.py -------------------------------------------


def _near_511():
    """The script's q and a win within 12 lanes of 511, so that the
    visits wrap past lane 511."""
    win, q, qsel = ms.script_inputs("cpu")
    win = (500 + torch.arange(ms.RT, dtype=torch.int32) % 12).reshape(-1, 1)
    return win, q, qsel


def _int32_edge():
    """500 lanes and a win whose rays reach 2^31 - 1 within 24 visits:
    the lane jumps where win + k wraps to -2^31."""
    wins, q = ms.hazard_inputs(500, "cpu")
    return wins["int32 edge"].reshape(-1, 1), q, None


P2_CASES = {"16": (16, lambda: ms.script_inputs("cpu")),
            "33": (33, lambda: ms.script_inputs("cpu")),
            "16-wrap": (16, _near_511),
            "33-int32-500": (33, _int32_edge)}


@pytest.mark.parametrize("case", sorted(P2_CASES))
def test_sel7_matches_jax(case):
    visits, inputs = P2_CASES[case]
    win, q, _ = inputs()
    ns = _load("probe_mm_select.py", {"_pick", "sel_kernel"}, visits)
    ns["B"] = q.shape[1]
    want = pl.pallas_call(
        ns["sel_kernel"], out_shape=jax.ShapeDtypeStruct((1, ms.RT),
                                                         jnp.float32),
        interpret=True)(jnp.asarray(win.numpy()), jnp.asarray(q.numpy()))
    got = ms.sel7(win, q, visits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- P2a's CUDA schedule, emulated -----------------------------------


def test_sel7_constants_match_the_kernel():
    assert _cu_const("kSelRows") == ms.SEL_ROWS
    assert _cu_const("kSelStretch") == ms.SEL_STRETCH
    assert _cu_const("kSelMaxLanes") == ms.SEL_MAX_LANES
    assert _cu_const("kSelAhead") == ms.SEL_AHEAD
    assert _cu_const("kSelBanks") == ms.SEL_BANKS == 32
    assert ms.SEL_ROWS * ms.SEL_STRETCH % ms.SEL_AHEAD == 0


def _sel7_deal(win, lanes):
    """``sel7_kernel``'s deal -> (warps, 32) ray of each thread, -1 for
    none: a ray's class is floor_mod(win, lanes) mod 32; a histogram and
    its exclusive scan give each class its first sorted position, and a
    chunk of 32 rays at a time, a ray takes its class's next position plus
    the lanes of its class before it (``__match_any_sync``); sorted
    position p goes to warp p mod warps, lane p // warps."""
    w = win.reshape(-1).numpy().astype(np.int64)
    n, warps = w.shape[0], -(-w.shape[0] // 32)
    cls = (w % lanes) & (ms.SEL_BANKS - 1)
    count = np.bincount(cls, minlength=ms.SEL_BANKS)
    nxt = np.cumsum(count) - count
    deal = np.full((warps, 32), -1)
    for base in range(0, n, 32):
        chunk = cls[base:base + 32]
        pos = [nxt[c] + int((chunk[:lane] == c).sum())
               for lane, c in enumerate(chunk)]
        for c in set(chunk.tolist()):
            nxt[c] += int((chunk == c).sum())
        for lane, p in enumerate(pos):
            assert deal[p % warps, p // warps] == -1
            deal[p % warps, p // warps] = base + lane
    assert sorted(deal[deal >= 0].tolist()) == list(range(n))
    return deal


def _sel7_walk(sq, w, n, lanes, acc):
    """``sel7_walk`` for each thread (``w``, ``n``, ``acc`` arrays): whole
    stretches of ``SEL_STRETCH`` visits, read i = 7 u + f of a stretch at
    w + f * stride + u, each issued ``SEL_AHEAD`` adds ahead in a window
    whose slot i mod ``SEL_AHEAD`` wraps into the next stretch (read at
    the next stretch's lane, w + stretch mod lanes less lanes once it
    passes); then the tail of n mod ``SEL_STRETCH`` visits from w.  A
    thread whose stretches are done idles (its count is its own)."""
    rows, stretch, ahead = ms.SEL_ROWS, ms.SEL_STRETCH, ms.SEL_AHEAD
    stride = ms.SEL_MAX_LANES + stretch
    reads = rows * stretch
    off = [(i % rows) * stride + i // rows for i in range(reads)]
    step = stretch % lanes
    x = [sq[w + off[i]] for i in range(ahead)]
    stretches = n // stretch
    for t in range(int(stretches.max(initial=0))):
        act = t < stretches
        wn = w + step
        wn = np.where(wn >= lanes, wn - lanes, wn)
        for i in range(reads):
            v = x[i % ahead]
            base = w if i + ahead < reads else wn
            x[i % ahead] = np.where(act, sq[base + off[(i + ahead) % reads]],
                                    x[i % ahead])
            acc = np.where(act, acc + v, acc)
        w = np.where(act, wn, w)
    tail = n - stretches * stretch
    for u in range(int(tail.max(initial=0))):
        for f in range(rows):
            acc = np.where(u < tail, acc + sq[w + f * stride + u], acc)
    return acc


def _sel7_schedule(win, q, visits):
    """``sel7_kernel`` in numpy: the 7 rows staged at a stride of
    ``SEL_MAX_LANES + SEL_STRETCH`` floats with lanes past B holding lane
    x mod B (the rest NaN: a read there would show), the rays dealt, and
    each thread's walk in two segments: the visits before win + k passes
    2^31 - 1 from floor_mod(win, B), the rest from floor_mod(-2^31, B);
    out written at each thread's ray."""
    lanes, stretch = q.shape[1], ms.SEL_STRETCH
    stride = ms.SEL_MAX_LANES + stretch
    sq = np.full(ms.SEL_ROWS * stride, np.nan, np.float32)
    x = np.arange(lanes + stretch)
    for f in range(ms.SEL_ROWS):
        sq[f * stride + x] = q[f].numpy()[np.where(x < lanes, x, x % lanes)]
    deal = _sel7_deal(win, lanes)
    ray = deal[deal >= 0]
    wv = win.reshape(-1).numpy().astype(np.int64)[ray]
    n1 = np.minimum(np.where(wv > 0, 2 ** 31 - wv, visits), visits)
    acc = np.zeros(ray.shape[0], np.float32)
    acc = _sel7_walk(sq, wv % lanes, n1, lanes, acc)
    acc = _sel7_walk(sq, np.full_like(wv, -2 ** 31 % lanes), visits - n1,
                     lanes, acc)
    out = np.empty(wv.shape[0], np.float32)
    out[ray] = acc
    return torch.from_numpy(out)[None, :]


SEL_WINS = sorted(ms.hazard_inputs(ms.B, "cpu")[0])
SEL_VISITS = [0, 1, "edge", 31, 32, 33, "lanes", "lanes+1", 4096]


@pytest.mark.parametrize("visits", SEL_VISITS)
@pytest.mark.parametrize("lanes", [512, 500, ms.SEL_MAX_LANES])
@pytest.mark.parametrize("win", SEL_WINS)
def test_sel7_schedule_matches_plain(win, lanes, visits):
    """The kernel's deal, staging, stretches with their read-ahead window
    and the int32 split give ``sel7_plain`` bit for bit: visit counts on
    the edges of a stretch and of the lanes (``edge``: ray 0's first wrap,
    lanes - floor_mod(win[0], lanes)), lanes 512, 500 and the most the
    staging holds (its rows' last lanes on the stride), and wins near
    lane 511, negative, all equal, 32 lanes apart (every ray in one bank
    class) and within 24 visits of 2^31 - 1.  With the script's win the
    deal leaves at most 2 rays of a bank class in a warp (5 in index
    order)."""
    wins, q = ms.hazard_inputs(lanes, "cpu")
    w = wins[win]
    v = {"edge": lanes - int(w[0]) % lanes, "lanes": lanes,
         "lanes+1": lanes + 1}.get(visits, visits)
    got = _sel7_schedule(w, q, v)
    want = ms.sel7_plain(w, q, v)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if win == "script" and lanes == 512:
        cls = (w.numpy().astype(np.int64) % lanes) & 31
        deal = _sel7_deal(w, lanes)
        assert max(np.bincount(cls[d[d >= 0]]).max() for d in deal) == 2
        assert max(np.bincount(cls[32 * g:32 * g + 32]).max()
                   for g in range(16)) == 5


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


# --- P2b's CUDA schedule, emulated ------------------------------------


def _cu_const(name):
    """``constexpr int <name> = N;`` of ``csrc/probes.cu``."""
    path = os.path.join(REPO, "raytracinginonesemester_tpu_torch", "csrc",
                        "probes.cu")
    with open(path) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


def test_mm22_constants_match_the_kernel():
    assert _cu_const("kMmSlots") == ms.MM_SLOTS
    assert _cu_const("kMmRingVisits") == ms.MM_COPY
    assert _cu_const("kMmKBlock") == ms.MM_KBLOCK
    assert _cu_const("kMmGroupRays") == ms.MM_GROUP
    assert _cu_const("kMmCols") == len(ms.MM_COLS) == 72
    assert _cu_const("kMmAttrs") == ms.F
    assert _cu_const("kMmStepBytes") == 2304
    assert _cu_const("kMmKBlock") == 2 * _cu_const("kMmStageSteps") * 16


def _a_fragment(p0, p1, q, s):
    """The kernel's four A registers at k-step ``s`` of a thread whose
    rows' lanes are ``p0`` (row g) and ``p1`` (row g + 8), -1 for no ray,
    and whose quad is ``q`` (``mm22_product``)."""
    regs = []
    for p, col8 in ((p0, 0), (p1, 0), (p0, 4), (p1, 4)):
        one = 0x3F800000 if p & 1 else 0x3F80
        regs.append(one if (p >> 4) == s and ((p & 15) >> 1) == q + col8
                    else 0)
    return regs


def _picks_from_fragments(lanes_of_rows, s):
    """The 64 x 16 bf16 bits of k-step ``s`` as the 128 threads' registers
    lay them out: thread (warp w, lane g * 4 + q), register e, half h ->
    row 16w + g + 8 (e & 1), column 2q + h + 8 (e >> 1); and how often
    each (row, column) is written."""
    bits = np.zeros((64, 16), np.int64)
    seen = np.zeros((64, 16), np.int64)
    for w in range(4):
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            r0 = 16 * w + g
            regs = _a_fragment(lanes_of_rows[r0], lanes_of_rows[r0 + 8], q, s)
            for e, reg in enumerate(regs):
                for h in range(2):
                    row, col = r0 + 8 * (e & 1), 2 * q + h + 8 * (e >> 1)
                    bits[row, col] = (reg >> (16 * h)) & 0xFFFF
                    seen[row, col] += 1
    return bits, seen


def _near_511_win():
    return _near_511()[0]


A_TILES = {"script tile 0": (lambda: ms.script_inputs("cpu")[0], 0),
           "script tile 7": (lambda: ms.script_inputs("cpu")[0], 7),
           "near 511": (_near_511_win, 3),
           "partial tile": (lambda: ms.script_inputs("cpu")[0][:48], 0)}


@pytest.mark.parametrize("visit", [0, 5, 300])
@pytest.mark.parametrize("case", sorted(A_TILES))
def test_mm22_a_fragment_rebuilds_the_pick(case, visit):
    """Every k-step's register fragment of a 64-ray tile is that tile's
    one-hot pick in bf16 (1.0 = 0x3f80), each (row, column) written once;
    rows past the last ray pick nothing."""
    make, tile = A_TILES[case]
    win = make().reshape(-1).to(torch.int64)
    lanes = ms.B
    rows = torch.arange(64 * tile, 64 * tile + 64)
    valid = rows < win.shape[0]
    p = torch.where(valid, (win[rows.clamp(max=win.shape[0] - 1)] + visit)
                    % lanes, torch.full_like(rows, -1)).tolist()
    want = np.zeros((64, lanes), np.int64)
    for r, lane in enumerate(p):
        if lane >= 0:
            want[r, lane] = 0x3F80
    for s in range(lanes // 16):
        bits, seen = _picks_from_fragments(p, s)
        assert (seen == 1).all()
        np.testing.assert_array_equal(bits, want[:, 16 * s:16 * s + 16])


def _unpack(packed, lanes):
    """The kernel's B operand read back as the tensor cores address it:
    element (n, k) of k-step s at byte s * kMmStepBytes + (k // 8) *
    kMmLbo + (n // 8) * kMmSbo + (n % 8) * 16 + (k % 8) * 2 (K-major,
    no swizzle) -> (lanes, 72) int16 bits, and how often each packed
    element is read."""
    step, lbo, sbo = (_cu_const(n) for n in ("kMmStepBytes", "kMmLbo",
                                             "kMmSbo"))
    bits = packed.view(torch.int16).numpy()
    ksteps = bits.shape[0] * 2 // step
    n = np.arange(72)[None, :, None]
    k = np.arange(16)[None, None, :]
    s = np.arange(ksteps)[:, None, None]
    byte = s * step + (k // 8) * lbo + (n // 8) * sbo + (n % 8) * 16 + \
        (k % 8) * 2
    got = bits[byte // 2]  # (ksteps, 72, 16)
    reads = np.bincount((byte // 2).reshape(-1), minlength=bits.shape[0])
    return got.transpose(0, 2, 1).reshape(ksteps * 16, 72), reads


@pytest.mark.parametrize("lanes", [512, 48])
def test_pack_qsel_unpacks_by_the_descriptor(lanes):
    """``pack_qsel`` read back by the descriptor's address formula gives
    qsel's 72 read columns bit for bit, then zero rows up to a multiple of
    ``MM_KBLOCK``; every packed element is read once."""
    rng = np.random.default_rng(lanes)
    q = torch.from_numpy(rng.standard_normal((ms.F, lanes))
                         .astype(np.float32))
    qsel = ms.make_qsel(q)
    got, reads = _unpack(ms.pack_qsel(qsel), lanes)
    assert got.shape[0] % ms.MM_KBLOCK == 0 and (reads == 1).all()
    want = qsel[:, ms.MM_COLS].view(torch.int16).numpy()
    np.testing.assert_array_equal(got[:lanes], want)
    assert not got[lanes:].any()
    # the read columns hold hi, mid and lo of attribute f at f, 24 + f
    # and 48 + f
    cols = np.asarray(ms.MM_COLS)
    np.testing.assert_array_equal(cols[:22], ms.PARTS[0] + np.arange(22))
    np.testing.assert_array_equal(cols[24:46], ms.PARTS[1] + np.arange(22))
    np.testing.assert_array_equal(cols[48:70], ms.PARTS[2] + np.arange(22))


def _mm22_schedule(win, qsel, visits):
    """``mm22_kernel``'s schedule in torch: the product of visit v, read
    from the packed operand as the tensor cores address it, goes to ring
    slot v mod ``MM_SLOTS`` ([group][slot][attribute][32 rays]) once the
    chain has published that slot's previous visit as landed, running as
    far ahead as the ring lets it; the chain's filler lands copy i of
    ``MM_COPY`` visits once its products are made and copy i - kMmRing
    has been added (publishing every kMmPublish freed copies), and the
    adding warp adds them onto each ray's sum visit after visit,
    attribute after attribute."""
    w = win.reshape(-1).to(torch.int64)
    rt, lanes = w.shape[0], qsel.shape[0]
    groups = -(-rt // ms.MM_GROUP)
    slots, copy = ms.MM_SLOTS, ms.MM_COPY
    bits, _ = _unpack(ms.pack_qsel(qsel), lanes)
    bcols = torch.from_numpy(bits[:lanes].copy()).view(torch.bfloat16) \
        .to(torch.float32)  # (lanes, 72)
    ring = torch.full((groups, slots, ms.F, ms.MM_GROUP), float("nan"))
    acc = torch.zeros(groups * ms.MM_GROUP)
    ring_copies, publish = _cu_const("kMmRing"), _cu_const("kMmPublish")
    made = landed = 0
    for i, lo in enumerate(range(0, visits, copy)):
        hi = min(visits, lo + copy)
        freed = i - ring_copies  # the filler waited for it to be added
        if freed >= 0 and freed % publish == publish - 1:
            landed = (freed + 1) * copy
        while made < visits and made - slots < landed:  # its slot is free
            pick = torch.zeros(rt, lanes)
            pick[torch.arange(rt), (w + made) % lanes] = 1.0
            d = pick @ bcols  # one nonzero term a sum: exact
            attr = torch.full((groups * ms.MM_GROUP, ms.F), float("nan"))
            attr[:rt] = (d[:, 0:22] + d[:, 24:46]) + d[:, 48:70]
            ring[:, made % slots] = attr.reshape(
                groups, ms.MM_GROUP, ms.F).transpose(1, 2)
            made += 1
        assert made >= hi
        block = ring[:, lo % slots:lo % slots + hi - lo].clone()  # lands
        for v in range(hi - lo):
            for f in range(ms.F):
                acc = acc + block[:, v, f, :].reshape(-1)
    return acc[:rt][None, :]


MM_VISITS = [0, 1, ms.MM_COPY - 1, ms.MM_COPY, ms.MM_COPY + 1, 33, 257,
             ms.MM_SLOTS - 1, ms.MM_SLOTS, ms.MM_SLOTS + 1]


@pytest.mark.parametrize("win", ["script", "wrap", "48 rays"])
@pytest.mark.parametrize("visits", MM_VISITS)
def test_mm22_ring_schedule_matches_plain(visits, win):
    """The product running ahead through the staging ring and the chain
    landing it a copy at a time equal ``mm22_plain`` bit for bit: across
    the edges of a copy and of the ring, with and without visits that
    wrap past lane 511 (the script's win, and all rays within 12 lanes of
    511), and with a partial tile and group (48 rays)."""
    w, _, qsel = _near_511() if win == "wrap" else ms.script_inputs("cpu")
    if win == "48 rays":
        w = w[:48]
    got = _mm22_schedule(w, qsel, visits)
    want = ms.mm22_plain(w, qsel, visits)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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


def _dyn_schedule(q, visits, block_major):
    """``dyn_reads_kernel``'s loop in torch: whole periods of L visits,
    read i of a period at row i (block-major) or (i mod 12) L + i // 12
    (plane-major), each read issued ``kDynAhead`` adds ahead in a window
    whose slot i mod ``kDynAhead`` wraps into the next period; then the
    tail of visits mod L from the period's start."""
    ahead, rows = _cu_const("kDynAhead"), dr.PLANES * dr.L
    assert rows % ahead == 0 and _cu_const("kDynBlocks") == dr.L
    row = [i if block_major else (i % dr.PLANES) * dr.L + i // dr.PLANES
           for i in range(rows)]
    x = [q[row[i]] for i in range(ahead)]
    acc = torch.zeros(q.shape[1])
    periods = visits // dr.L
    for _ in range(periods):
        for i in range(rows):
            v = x[i % ahead]
            x[i % ahead] = q[row[(i + ahead) % rows]]
            acc = acc + v
    for i in range((visits - periods * dr.L) * dr.PLANES):
        acc = acc + q[row[i]]
    return acc[None, :]


@pytest.mark.parametrize("visits", [0, 1, 38, 39, 40, 79, 4096])
@pytest.mark.parametrize("name", ["dyn12", "blk1"])
def test_dyn_reads_period_schedule_matches_plain(name, visits):
    q = dr.script_inputs("cpu")
    got = _dyn_schedule(q, visits, name == "blk1")
    want = getattr(dr, f"{name}_plain")(q, visits)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
    # the chunk edges of mm22 and the period edges of P3
    for inputs in (ms.script_inputs, lambda: _near_511_cuda()):
        win, _, qsel = inputs()
        for visits in MM_VISITS + [2 * ms.MM_SLOTS + 1]:
            assert torch.equal(ms.mm22(win, qsel, visits),
                               ms.mm22_plain(win, qsel, visits))
        assert torch.equal(ms.mm22(win[:48], qsel, 513),
                           ms.mm22_plain(win[:48], qsel, 513))
    for visits in (0, 1, 38, 39, 40, 79):
        assert torch.equal(dr.dyn12(q, visits), dr.dyn12_plain(q, visits))
        assert torch.equal(dr.blk1(q, visits), dr.blk1_plain(q, visits))
    # sel7 at the edges of its stretch and of the lanes, on every hazard win
    for lanes in (ms.B, 500, 999, ms.SEL_MAX_LANES):
        wins, q = ms.hazard_inputs(lanes)
        for w in wins.values():
            for visits in (0, 1, lanes - int(w[0]) % lanes, 31, 32, 33,
                           lanes, lanes + 1, ms.VISITS):
                assert torch.equal(ms.sel7(w, q, visits),
                                   ms.sel7_plain(w, q, visits))
    # P1 on sets of 0, 1, 2, 3 and more set boxes, 100 rays a block
    for n_boxes in (1, 2, 3, 156, tm.LP):
        rays, aabb = tm.count_inputs(n_boxes, 100, 0)
        for mode in tm.MODES:
            torch.testing.assert_close(
                tm.toy_mask(mode, rays, aabb),
                tm.toy_mask_plain(mode, rays, aabb), rtol=0, atol=0,
                equal_nan=True)
    # P1 with fewer rays a block than a cluster has CTAs
    for rt in (1, 7):
        rays, aabb = _narrow(rt, "cuda")
        for mode in tm.MODES:
            torch.testing.assert_close(
                tm.toy_mask(mode, rays, aabb),
                tm.toy_mask_plain(mode, rays, aabb), rtol=0, atol=0,
                equal_nan=True)


def _near_511_cuda():
    return tuple(t.cuda() for t in _near_511())
