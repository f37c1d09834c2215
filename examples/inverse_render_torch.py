"""Inverse-rendering demo on the PyTorch port: recover material albedos
from a target image, with checkpoint and resume.

The counterpart of ``examples/inverse_render.py``: render a target with
known materials, perturb them, and recover them by Adam (lr 0.03) on the
pixel loss, through ``raytracinginonesemester_tpu_torch``.  It writes
``inverse_target.png``, ``inverse_result.png`` and
``inverse_metrics.jsonl`` into the working directory, and checkpoints
every 10 steps into ``--ckpt-dir``; a second run with the same
directory resumes after the last checkpoint.

Usage: python examples/inverse_render_torch.py [scene.json] [--steps N]
       [--device cuda|cpu]
"""

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?",
                    default=os.path.join(os.path.dirname(__file__), "..",
                                         "tests/assets/scenes/gpu_spheres.json"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="inverse_ckpt")
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=90)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs the "
                    "plain versions)")
    args = ap.parse_args(argv)

    import torch

    import raytracinginonesemester_tpu_torch as rt
    from raytracinginonesemester_tpu_torch.core.camera import Camera
    from raytracinginonesemester_tpu_torch.diff.checkpoint import (
        latest_step, load_checkpoint, save_checkpoint, to_tensors)
    from raytracinginonesemester_tpu_torch.diff.inverse import (
        apply_params, extract_params, make_train_step)
    from raytracinginonesemester_tpu_torch.io.image import write_png
    from raytracinginonesemester_tpu_torch.utils.logging import MetricsLogger

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")
    scene = rt.load_scene(args.scene, accel="none", device=dev)
    cam = Camera.create(
        position=(0.0, -2.5, 1.2), look_at=(0.0, 0.0, 0.5), up=(0, 0, 1),
        focal_length_mm=24.0, width=args.width, height=args.height,
        device=dev)
    scene = dataclasses.replace(scene, camera=cam, max_bounces=2, spp=1)

    with torch.no_grad():
        target = rt.render_scene(scene, jitter_mode="center", spp_override=1)
    write_png("inverse_target.png", target.cpu().numpy(), mode="gpu")

    true_albedo = extract_params(scene, keys=("albedo",))["albedo"].detach()
    rs = np.random.RandomState(0)
    init = np.clip(true_albedo.cpu().numpy() + rs.uniform(
        -0.3, 0.3, tuple(true_albedo.shape)), 0.05, 1.0).astype(np.float32)
    params = {"albedo": torch.from_numpy(init).to(dev).requires_grad_(True)}
    opt = torch.optim.Adam(list(params.values()), lr=0.03)
    logger = MetricsLogger("inverse_metrics.jsonl")

    start, losses = 0, []
    if latest_step(args.ckpt_dir) is not None:
        start, saved, opt_state, losses = load_checkpoint(args.ckpt_dir)
        params = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
                  for k, v in saved.items()}
        opt = torch.optim.Adam(list(params.values()), lr=0.03)
        opt.load_state_dict(to_tensors(opt_state, dev))
        losses = list(losses or [])
        print(f"resumed after step {start}")
    step_fn = make_train_step(opt, jitter_mode="center", spp_override=1)

    for i in range(start, args.steps):
        losses.append(float(step_fn(params, scene, target)))
        if i % 10 == 0:
            logger.log("inverse_step", step=i, loss=losses[-1])
            # the count of steps done: a resume starts with step i + 1
            save_checkpoint(args.ckpt_dir, i + 1, params, opt.state_dict(),
                            losses)

    with torch.no_grad():
        final = rt.render_scene(apply_params(scene, params),
                                jitter_mode="center", spp_override=1)
    write_png("inverse_result.png", final.cpu().numpy(), mode="gpu")
    err = float((params["albedo"].detach() - true_albedo).abs().mean())
    final_loss = losses[-1] if losses else float("nan")
    logger.log("inverse_done", final_loss=final_loss, albedo_mae=err)
    logger.close()
    print(f"final loss {final_loss:.2e}, albedo MAE {err:.4f}")
    print("wrote inverse_target.png / inverse_result.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
