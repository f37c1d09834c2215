"""One rank of ``tests/test_torch_parallel.py``'s gloo job (4 ranks as 2
"hosts" x 2, set up through torchrun's environment variables).

Imports torch and the port only.  Every rank renders and trains through
``raytracinginonesemester_tpu_torch.parallel`` and writes what it got to
``<out>/rank<r>.npz`` and ``<out>/rank<r>.json``; the test compares.

    python tests/_torch_parallel_worker.py OUT_DIR   # with RANK etc. set
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "tests", "assets", "scenes")
W, H = 64, 32
GRAD_W, GRAD_H = 48, 32
GRAD_KEYS = ("albedo", "light_intensity", "vertices")


def scene_at(name, width=W, height=H):
    """A JSON test scene at another pixel size, on the CPU."""
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        load_scene_config)

    path = os.path.join(SCENES, f"{name}.json")
    cfg = dataclasses.replace(load_scene_config(path), pixel_width=width,
                              pixel_height=height)
    return build_scene(cfg, scene_path=path, device="cpu")


def uneven_scene():
    """gpu_spheres under ``tests/test_parallel.py``'s 33x7 camera."""
    from raytracinginonesemester_tpu_torch.core.camera import Camera

    cam = Camera.create(position=(0.0, -2.5, 1.2), look_at=(0.0, 0.0, 0.5),
                        up=(0, 0, 1), focal_length_mm=24.0, width=33,
                        height=7, device="cpu")
    return dataclasses.replace(scene_at("gpu_spheres"), camera=cam)


def grad_scene():
    """The grad bench's scene (``bench.py --grad``) at 48x32."""
    from raytracinginonesemester_tpu_torch.core.camera import Camera

    cam = Camera.create(position=(0.0, -2.5, 1.2), look_at=(0.0, 0.0, 0.5),
                        up=(0, 0, 1), focal_length_mm=24.0, width=GRAD_W,
                        height=GRAD_H, device="cpu")
    return dataclasses.replace(scene_at("gpu_spheres"), camera=cam,
                               max_bounces=2, spp=1, differentiable=True)


def start_params(scene):
    """The grad bench's start: every parameter perturbed by 5%
    (``RandomState(0)``)."""
    from raytracinginonesemester_tpu_torch.diff import inverse

    rs = np.random.RandomState(0)
    out = {}
    for k, v in inverse.extract_params(scene, GRAD_KEYS).items():
        v = v.detach().numpy()
        out[k] = v * (1.0 + 0.05 * rs.standard_normal(v.shape)
                      .astype(np.float32))
    return out


def record_alive_flags(log):
    """Wrap ``any_alive`` where the integrator and the compacted scheduler
    read it: every call logs whether this rank's own flag differed from
    the flag reduced over the model ranks."""
    from raytracinginonesemester_tpu_torch.ops import integrator
    from raytracinginonesemester_tpu_torch.parallel import wavefront_sharded

    real = integrator.any_alive

    def recorded(alive, group=None):
        out = real(alive, group)
        log.append([group is not None, bool(alive.any()) != out])
        return out

    integrator.any_alive = recorded
    wavefront_sharded.any_alive = recorded


def main(out_dir):
    import torch.distributed as dist

    from raytracinginonesemester_tpu_torch.diff import inverse
    from raytracinginonesemester_tpu_torch.parallel import multihost
    from raytracinginonesemester_tpu_torch.parallel.sharded import (
        _render_sharded_staged, make_mesh, make_train_step_sharded,
        render_scene_sharded)

    torch.set_num_threads(1)
    if not multihost.initialize_multihost("gloo"):
        raise AssertionError("the launcher's environment must initialise")
    rank = dist.get_rank()
    info = {"multihost": multihost.is_multihost(), "seconds": {}}
    mesh_tp = multihost.host_chip_mesh(("data", "model"),
                                      model_parallel_per_host=2)
    info["tp_mesh"] = dict(
        shape=mesh_tp.shape, coords=mesh_tp.coords,
        groups={a: dist.get_process_group_ranks(mesh_tp.group(a))
                for a in ("data", "model")})
    mesh_dp = make_mesh((4,), ("data",))
    alive_log = []
    record_alive_flags(alive_log)
    out = {}

    def run(key, fn):
        t0 = time.time()
        out[key] = fn().detach().numpy()
        info["seconds"][key] = round(time.time() - t0, 3)

    spheres = scene_at("gpu_spheres")
    run("fast_gpu", lambda: render_scene_sharded(spheres, mesh_dp))
    run("fast_cpuonly", lambda: render_scene_sharded(
        scene_at("cpuonly_point"), mesh_dp))
    run("uneven", lambda: render_scene_sharded(uneven_scene(), mesh_dp))
    run("tp_plain", lambda: _render_sharded_staged(
        spheres, mesh_tp, "reference_cpu", 0, spheres.spp, "model"))
    run("tp_compact", lambda: render_scene_sharded(
        spheres, mesh_tp, "reference_cpu", model_axis="model"))
    run("tp_cap8", lambda: _render_sharded_staged(
        spheres, mesh_tp, "reference_cpu", 0, spheres.spp, "model",
        compacted=True, capacity=8))

    scene = grad_scene()
    with torch.no_grad():
        out["target"] = render_scene_sharded(scene, mesh_dp, "center").numpy()
    p0 = start_params(scene)
    params = inverse.params_from_numpy(p0, scene)
    step = make_train_step_sharded(
        torch.optim.Adam(list(params.values()), lr=1e-3), mesh_dp)
    t0 = time.time()
    out["loss"] = step(params, scene, torch.from_numpy(out["target"])).numpy()
    info["seconds"]["train_step"] = round(time.time() - t0, 3)
    for k, p in params.items():
        out[f"grad_{k}"] = p.grad.numpy()
        out[f"param_{k}"] = p.detach().numpy()

    info["alive_reads"] = len(alive_log)
    info["alive_reads_tp"] = sum(tp for tp, _ in alive_log)
    info["alive_changed"] = sum(ch for _, ch in alive_log)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
