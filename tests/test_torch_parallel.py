"""The sharded port (``raytracinginonesemester_tpu_torch.parallel``) against
its unsharded renders and the JAX package's ``parallel`` on the CPU.

Without a process group: the hit merge's selection (``select_hits``)
against JAX's ``merge_hits_over_axis`` in ``shard_map`` over 4 virtual
devices, exactly; ``_sort_key`` and ``shard_scene_blocks`` against JAX's,
exactly; a grid padded by ``shard_scene_blocks`` whose padding blocks hold
triangles in front of every ray gives kernels E's and F's plain versions
the unpadded results on the hazard ray set (the blocks are never entered).

One gloo job of 4 ranks, set up as 2 "hosts" x 2 through torchrun's
environment (``initialize_multihost``, ``host_chip_mesh``), runs
``tests/_torch_parallel_worker.py`` while this process makes the
references, and one ``dryrun_multichip(4, "gloo", "cpu")`` (its default,
the card, refuses without one).  Measured
(plain versions on the CPU): the dp4 fast path equals ``render_scene``
bit for bit (gpu_spheres and cpuonly_point at 64x32, the 33x7 camera);
the dp2 x tp2 image (``reference_cpu``) equals the port's unsharded image
bit for bit, plain, compacted and compacted at capacity 8 (the overflow
branch), so those are asserted exactly; it is 4.6e-6 from JAX's dp2 x tp4
image, as the unsharded image is (bound 2e-5, ``tests/test_parallel.py``);
the dp4 training step's gradients are within 1.1e-7 of each one's largest
entry of the single-rank step's (bound 1e-5: the ranks sum their pixels'
shares in another order), and its loss equals the single-rank loss.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from raytracinginonesemester_tpu.ops.integrator import (
    merge_hits_over_axis as j_merge)
from raytracinginonesemester_tpu.ops.intersect import HitData as JHits
from raytracinginonesemester_tpu.parallel import sharded as jsh
from raytracinginonesemester_tpu.parallel import wavefront_sharded as jws
from raytracinginonesemester_tpu.scene import build as jbuild
from raytracinginonesemester_tpu.scene import config as jconfig
from raytracinginonesemester_tpu_torch.diff import inverse
from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
from raytracinginonesemester_tpu_torch.ops.integrator import select_hits
from raytracinginonesemester_tpu_torch.parallel import sharded as tsh
from raytracinginonesemester_tpu_torch.parallel import wavefront_sharded as tws
from raytracinginonesemester_tpu_torch.parallel.dryrun import (
    dryrun_multichip, free_port)
from raytracinginonesemester_tpu_torch.render.renderer import render_scene

import _torch_parallel_worker as worker
from _torch_parity import one_torch_thread, poisoned_padding, torch_from_jax

TP_ATOL = 2e-5    # tp images: the JAX bound (tests/test_parallel.py)
GRAD_REL = 1e-5   # dp gradients, of each one's largest entry
RANKS = 4


class Job:
    """The worker ranks, started when the module starts."""

    def __init__(self, out):
        self.out, self.port = out, free_port()
        self.procs, self.logs = [], []
        for r in range(RANKS):
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(self.port), WORLD_SIZE=str(RANKS),
                       RANK=str(r), LOCAL_WORLD_SIZE="2",
                       LOCAL_RANK=str(r % 2), OMP_NUM_THREADS="1",
                       PYTHONPATH=worker.REPO)
            log = open(out / f"log{r}.txt", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, worker.__file__, str(out)], env=env,
                stdout=log, stderr=subprocess.STDOUT))
        self.ranks = None

    def results(self):
        """Every rank's (arrays, info), once all ranks exited with 0."""
        if self.ranks is None:
            try:
                rcs = [p.wait(timeout=300) for p in self.procs]
            finally:
                self.close()
            logs = "\n---\n".join((self.out / f"log{r}.txt").read_text()
                                  for r in range(RANKS))
            assert rcs == [0] * RANKS, f"worker ranks {rcs}:\n{logs}"
            self.ranks = [
                (dict(np.load(self.out / f"rank{r}.npz")),
                 json.loads((self.out / f"rank{r}.json").read_text()))
                for r in range(RANKS)]
        return self.ranks

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()


@pytest.fixture(scope="module", autouse=True)
def job(tmp_path_factory):
    j = Job(tmp_path_factory.mktemp("parallel"))
    yield j
    j.close()


@pytest.fixture(scope="module")
def spheres():
    return worker.scene_at("gpu_spheres")


# --- no process group ----------------------------------------------------

def _candidates(seed, s=4, r=64, k=3):
    """Per-shard closest-hit candidates (S, R): t from a few values, so
    that shards tie, misses (id -1, t F32_MAX) in every shard, ids unique
    per shard as a partition of the triangles makes them."""
    rng = np.random.default_rng(seed)
    t = rng.choice(np.float32([0.5, 1.0, 1.0, 2.0]), (s, r))
    idx = np.stack([rng.permutation(1000)[:r] + 1000 * j
                    for j in range(s)]).astype(np.int32)
    miss = rng.uniform(size=(s, r)) < 0.3
    miss[:, :4] = True  # rays that every shard misses
    t = np.where(miss, np.float32(np.finfo(np.float32).max), t)
    idx = np.where(miss, -1, idx).astype(np.int32)
    u = rng.uniform(size=(s, r)).astype(np.float32)
    v = rng.uniform(size=(s, r)).astype(np.float32)
    nrm = rng.normal(size=(s, r, k)).astype(np.float32)
    return t, u, v, idx, nrm


def test_select_hits_matches_jax_merge():
    t, u, v, idx, nrm = _candidates(3)
    s, r = t.shape
    mesh = jsh.make_mesh((s,), ("model",), devices=jax.devices()[:s])

    @jax.jit
    def merged(t, u, v, idx, nrm):
        def body(t, u, v, idx, nrm):
            h = JHits(t=t, u=u, v=v, tri_idx=idx, hit=idx >= 0)
            m, n = j_merge(h, "model", extra=nrm)
            return m.t, m.u, m.v, m.tri_idx, m.hit, n

        return shard_map(body, mesh=mesh, in_specs=(P("model"),) * 5,
                         out_specs=P(), check_vma=False)(t, u, v, idx, nrm)

    want = merged(*(jnp.asarray(a.reshape((s * r,) + a.shape[2:]))
                    for a in (t, u, v, idx, nrm)))
    hits, n = select_hits(*(torch.from_numpy(a) for a in (t, u, v, idx)),
                          torch.from_numpy(nrm))
    got = (hits.t, hits.u, hits.v, hits.tri_idx, hits.hit, n)
    for name, g, w in zip(("t", "u", "v", "tri_idx", "hit", "normal"), got,
                          want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (hits.tri_idx[:4] == -1).all()  # every shard missed these


def test_sort_key_and_bounds_match_jax():
    rng = np.random.default_rng(5)
    verts = rng.uniform(-2, 3, (50, 3, 3)).astype(np.float32)
    o = rng.uniform(-3, 4, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d[::9, 1] = 0.0  # a zero component: not negative for the octant
    alive = rng.uniform(size=512) < 0.7

    @dataclasses.dataclass
    class Geo:
        vertices: object

    @dataclasses.dataclass
    class Sc:
        geometry: Geo

    jlo, jspan = jws._scene_bounds(Sc(Geo(jnp.asarray(verts))))
    tlo, tspan = tws._scene_bounds(Sc(Geo(torch.from_numpy(verts))))
    for a, b in zip(jlo + jspan, tlo + tspan):
        assert float(a) == float(b)
    want = np.asarray(jws._sort_key(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(alive), jlo, jspan))
    got = tws._sort_key(torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(alive), tlo, tspan)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shards", [3, 4])
def test_shard_scene_blocks_matches_jax(shards):
    path = os.path.join(worker.SCENES, "gpu_spheres.json")
    js = jbuild.load_scene(path)
    want = jsh.shard_scene_blocks(js, shards).accel
    got = tsh.shard_scene_blocks(torch_from_jax(js), shards).accel
    assert got.num_blocks % shards == 0 and got.num_blocks == want.num_blocks
    for name in ("tri", "norm", "tri_index", "obj", "aabb"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    loc = [tsh._local_blocks(tsh.shard_scene_blocks(torch_from_jax(js),
                                                    shards), i, shards)
           for i in range(shards)]
    ids = torch.cat([s.accel.tri_index for s in loc])
    assert torch.equal(ids, got.tri_index)  # global ids, contiguous slices


def test_padded_blocks_never_entered(spheres):
    """Padding blocks holding a box of triangles around the scene behind
    their empty AABBs (``poisoned_padding``): E's and F's plain versions
    (whose block walks A's and B's plain versions share) give the
    unpadded results on camera-like, bounce, parked and NaN-window
    rays."""
    grid = spheres.accel
    padded = poisoned_padding(spheres).accel
    rng = np.random.default_rng(7)
    r = 2048
    o = torch.from_numpy(rng.uniform(-1, 1, (r, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(r, 3)).astype(np.float32)), dim=1)
    o[-r // 8:] = 1e30
    d[-r // 16:] = -d[-r // 16:].abs()
    tmin = torch.from_numpy(rng.uniform(0, 0.02, r).astype(np.float32))
    tmax = torch.from_numpy(rng.uniform(0.05, 50.0, r).astype(np.float32))
    tmax[::7], tmin[::11] = float("nan"), float("nan")
    for kw in (dict(), dict(return_normal=True)):
        want = bk.block_closest(o, d, grid, 1e-4, **kw)
        got = bk.block_closest(o, d, padded, 1e-4, **kw)
        for a, b in zip(_fields(got), _fields(want)):
            assert torch.equal(a, b)
    for t0, t1 in ((1e-4, 1e30), (tmin, tmax)):
        assert torch.equal(bk.block_occluded(o, d, padded, t0, t1),
                           bk.block_occluded(o, d, grid, t0, t1))
    # the poison is live: with the padding blocks' AABBs around the box,
    # the box is hit
    n0 = grid.num_blocks
    box = torch.cat([grid.aabb[:3].amin(dim=1) - 1.0,
                     grid.aabb[3:].amax(dim=1) + 1.0])
    opened = dataclasses.replace(padded, aabb=torch.cat(
        [padded.aabb[:, :n0],
         box[:, None].expand(6, padded.num_blocks - n0)], dim=1))
    assert bool((bk.block_closest(o, d, opened, 1e-4).tri_idx >= 10 ** 6)
                .any())


def _fields(out):
    out = out if isinstance(out, tuple) else (out,)
    h = out[0]
    return (h.t, h.u, h.v, h.tri_idx, h.hit) + out[1:]


def _shard_rule(cap, n_data):
    """The sharded renderer's per-rank capacity as it was first written
    (``parallel/sharded.py`` ``_shard_capacity``): the full frame's
    capacity divided over the data ranks, rounded up to a power of two
    >= 8."""
    per = -(-cap // n_data)
    out = 8
    while out < per:
        out *= 2
    return out


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_rank_capacity_is_the_shard_rule(spheres, monkeypatch, ranks):
    """``rank_capacity`` is that rule, and ``resolve_route`` over a mesh
    of ``ranks`` data ranks (no process group: rank 0's broadcast is its
    own value) takes it of the calibrated capacity, with the plan of the
    stream padded for as many ranks."""
    from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
    from raytracinginonesemester_tpu_torch.ops import wavefront as twf
    from raytracinginonesemester_tpu_torch.render import renderer as tr

    for cap in (8, 16, 24, 64, 100, 128, 512, 1000):
        assert twf.rank_capacity(cap, ranks) == _shard_rule(cap, ranks)
    monkeypatch.setattr(twf, "auto_capacity_tiles", lambda *a, **k: 100)
    mesh = tsh.Mesh({"data": ranks}, {"data": 0}, {"data": None})
    stream = tr.pixel_stream(worker.W, worker.H, ranks=ranks)
    route = tr.resolve_route(spheres, stream, "wang", 1, mesh=mesh)
    assert route.name == "wavefront"
    assert route.capacity == _shard_rule(100, ranks)
    assert (int(route.cand_plan.meta.shape[0]) * tmk.RAY_TILE
            == int(stream[0].shape[0]))


# --- the gloo job --------------------------------------------------------

@pytest.fixture(scope="module")
def refs(spheres):
    """The port's unsharded renders and the JAX dp2 x tp4 image, made
    while the ranks run."""
    out = {"fast_gpu": render_scene(spheres),
           "fast_cpuonly": render_scene(worker.scene_at("cpuonly_point")),
           "uneven": render_scene(worker.uneven_scene()),
           "tp": render_scene(spheres, "reference_cpu")}
    path = os.path.join(worker.SCENES, "gpu_spheres.json")
    cfg = dataclasses.replace(jconfig.load_scene_config(path),
                              pixel_width=worker.W, pixel_height=worker.H)
    js = jbuild.build_scene(cfg, scene_path=path)
    out["tp_jax"] = np.asarray(jsh.render_scene_sharded(
        js, jsh.make_mesh((2, 4), ("data", "model")), "reference_cpu",
        model_axis="model"))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("key", ["fast_gpu", "fast_cpuonly", "uneven"])
def test_dp4_fast_path_bit_identical(job, refs, key):
    for arrays, _ in job.results():
        np.testing.assert_array_equal(arrays[key], refs[key])


def test_dp2_tp2_matches_unsharded_and_jax(job, refs):
    for arrays, _ in job.results():
        np.testing.assert_array_equal(arrays["tp_plain"], refs["tp"])
        np.testing.assert_allclose(arrays["tp_plain"], refs["tp_jax"],
                                   atol=TP_ATOL, rtol=0)


def test_dp2_tp2_compacted_and_overflow(job):
    for arrays, _ in job.results():
        np.testing.assert_array_equal(arrays["tp_compact"], arrays["tp_plain"])
        np.testing.assert_array_equal(arrays["tp_cap8"], arrays["tp_plain"])


def test_alive_flag_guard_changes_nothing(job):
    """The MAX over the model ranks of the per-depth alive flag (a guard
    against a hang) was read and never differed from a rank's own flag."""
    for _, info in job.results():
        assert info["alive_reads_tp"] > 0
        assert info["alive_changed"] == 0


def test_dp4_training_step_matches_single_rank(job):
    ranks = job.results()
    arrays = ranks[0][0]
    scene = worker.grad_scene()
    params = inverse.params_from_numpy(worker.start_params(scene), scene)
    step = inverse.make_train_step(torch.optim.Adam(list(params.values()),
                                                    lr=1e-3))
    loss = step(params, scene, torch.from_numpy(arrays["target"]))
    np.testing.assert_allclose(arrays["loss"], loss.numpy(), rtol=1e-6)
    for k, p in params.items():
        g = p.grad.numpy()
        scale = np.abs(g).max()
        assert scale > 0 and np.isfinite(g).all()
        err = np.abs(arrays[f"grad_{k}"] - g).max()
        assert err <= GRAD_REL * scale, (k, err, scale)
        for other, _ in ranks[1:]:  # every rank took the same step
            np.testing.assert_array_equal(other[f"grad_{k}"],
                                          arrays[f"grad_{k}"])
            np.testing.assert_array_equal(other[f"param_{k}"],
                                          arrays[f"param_{k}"])


def test_two_hosts_mesh(job):
    """2 "hosts" of 2 ranks: the model axis inside a host, the data axis
    across hosts."""
    for r, (_, info) in enumerate(job.results()):
        mesh = info["tp_mesh"]
        assert info["multihost"]
        assert mesh["shape"] == {"data": 2, "model": 2}
        assert mesh["coords"] == {"data": r // 2, "model": r % 2}
        assert mesh["groups"]["model"] == [r // 2 * 2, r // 2 * 2 + 1]
        assert mesh["groups"]["data"] == [r % 2, r % 2 + 2]


def test_dryrun_multichip(monkeypatch, capfd):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dryrun_multichip(RANKS, "gloo", "cpu")
    assert "forward ok, train loss" in capfd.readouterr().out


def test_dryrun_defaults_to_the_card(monkeypatch):
    """The dry run runs on the card unless the caller names the CPU: with
    no card its default raises before any rank is spawned."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(RANKS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(RANKS, "gloo", "cuda")
