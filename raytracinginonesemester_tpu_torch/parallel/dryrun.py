"""Dry run of the sharded pipeline on ``n`` spawned ranks.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``,
with its three steps at 64x32 on the frog scene:

1. the dp x tp forward render of the depth-8 diffuse frog, triangle
   blocks over "model", through the compacted scheduler
   (``wavefront_sharded``);
2. the pure-dp forward render through the fused kernels' fast path (the
   capacity calibrated on data rank 0);
3. one dp training step: the differentiable depth-4 frog, albedo, light
   intensity and vertices, the gradients summed over the data ranks and
   one Adam step on every rank.

    python -m raytracinginonesemester_tpu_torch.parallel.dryrun 4 gloo cpu
    torchrun --nproc-per-node 4 --no-python python3 -m \
        raytracinginonesemester_tpu_torch.parallel.dryrun 4 gloo cpu

The first spawns its ranks; under a launcher (``RANK`` set) the process
is one rank of the launcher's job.  The device is the card unless the
caller names ``cpu``; without a card "cuda" raises.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import sys

import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip"]


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(rank: int, backend: str, device: str) -> str:
    """A rank's device: NCCL takes one card a rank; gloo ranks on the
    card share card 0.  Raises for "cuda" without a card."""
    if torch.device(device).type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun: no CUDA device (pass device='cpu' to "
                           "run on the CPU)")
    return f"cuda:{rank}" if backend == "nccl" else "cuda:0"


def _steps(n: int, dev: str) -> float:
    from ..diff.inverse import extract_params
    from ..render.renderer import frog_scene
    from .sharded import (make_mesh, make_train_step_sharded,
                          render_scene_sharded)

    shape = (n // 2, 2) if n % 2 == 0 else (n, 1)
    mesh = make_mesh(shape, ("data", "model"))
    scene = frog_scene(64, 32, max_bounces=8, diffuse_bounce=True, device=dev)
    img = render_scene_sharded(scene, mesh, model_axis="model")
    if img.shape != (32, 64, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"dp x tp forward: {tuple(img.shape)}, finite "
                             f"{bool(torch.isfinite(img).all())}")

    mesh_dp = make_mesh((n,), ("data",))
    img = render_scene_sharded(scene, mesh_dp)
    if img.shape != (32, 64, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("dp fast path: bad image")

    scene_d = dataclasses.replace(
        frog_scene(64, 32, max_bounces=4, diffuse_bounce=False, device=dev),
        differentiable=True)
    target = torch.zeros(32, 64, 3, device=dev)
    params = extract_params(scene_d, ("albedo", "light_intensity",
                                      "vertices"))
    step = make_train_step_sharded(
        torch.optim.Adam(list(params.values()), lr=1e-2), mesh_dp,
        jitter_mode="auto")
    loss = float(step(params, scene_d, target))
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"train loss {loss}")
    return loss


def _rank_main(rank: int, n: int, backend: str, device: str, port: int):
    dev = rank_device(rank, backend, device)
    if dev.startswith("cuda"):
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        loss = _steps(n, dev)
        if rank == 0:
            print(f"dryrun_multichip({n}, {backend!r}, {device!r}): forward "
                  f"ok, train loss {loss:.6f}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, backend: str = "gloo",
                     device: str = "cuda") -> None:
    """Run the three steps on ``n_devices`` spawned ranks of ``backend`` on
    ``device`` ("cuda": gloo ranks share card 0, NCCL ranks take a card
    each; or "cpu" when the caller asks for it).  Raises without a card
    for "cuda", and if any rank fails.  On the card the kernels are built
    here first, so that the ranks do not build them at once."""
    if torch.device(device).type == "cuda":
        rank_device(0, backend, device)
        if backend == "nccl" and n_devices > torch.cuda.device_count():
            raise ValueError(f"NCCL takes one card a rank: {n_devices} ranks, "
                             f"{torch.cuda.device_count()} cards")
        from ..ops import _native

        _native.build_all()
    torch.multiprocessing.start_processes(
        _rank_main, args=(n_devices, backend, device, free_port()),
        nprocs=n_devices, join=True, start_method="spawn")


def _launched_rank(n: int, backend: str, device: str) -> None:
    """One rank of a launcher's job (torchrun: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)."""
    from .multihost import initialize_multihost

    if int(os.environ["WORLD_SIZE"]) != n:
        raise ValueError(f"{n} ranks asked for, the launcher started "
                         f"{os.environ['WORLD_SIZE']}")
    dev = rank_device(int(os.environ.get("LOCAL_RANK", "0")), backend,
                      device)
    if dev.startswith("cuda"):
        torch.cuda.set_device(dev)
    if not initialize_multihost(backend):
        raise ValueError("one rank: run without a launcher")
    try:
        loss = _steps(n, dev)
        if dist.get_rank() == 0:
            print(f"dryrun ({n} launched ranks, {backend!r}, {device!r}): "
                  f"forward ok, train loss {loss:.6f}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    backend = sys.argv[2] if len(sys.argv) > 2 else "gloo"
    device = sys.argv[3] if len(sys.argv) > 3 else "cuda"
    run = _launched_rank if "RANK" in os.environ else dryrun_multichip
    run(n, backend, device)
