"""Precision of the soft renderer and its gradients: float32 against
float64.

    python scripts/soft_grad_precision.py [--device cpu|cuda ...]

The problem is ``chip_smoke.py`` phase 14's (``chip_smoke.soft_problem``:
``gpu_spheres.json`` at 160x90, the target from a camera moved by 2 cm,
the gradients of ``soft_render_loss`` with respect to vertices, albedo,
camera center and light intensity).  For each device named (default: the
CPU), the float32 image and gradients are compared with the float64 ones
on the CPU: the image's largest difference and its channels beyond 4 ulp
or 1e-5, each gradient's largest difference over the tensor's largest
entry, and for the ten triangles whose vertex gradients differ most the
|cos| of their face normal and the direction from the camera (beside
its median over all triangles).  This is the measurement behind
``chip_smoke.SOFT_IMAGE_TOL`` and
``SOFT_GRAD_TOL``: on the silhouettes the soft render is ill-conditioned
in float32, so two float32 evaluations may differ by much more than a
few ulp.  Prints one JSON object per device.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def gradients(device, dtype):
    import torch

    from chip_smoke import SOFT_KEYS, soft_problem
    from raytracinginonesemester_tpu_torch.diff.soft import (render_soft,
                                                              soft_render_loss)

    s, target, p = soft_problem(torch.device(device), dtype)
    with torch.no_grad():
        img = render_soft(s, sigma=0.02).cpu().double()
    t0 = time.time()
    loss = soft_render_loss(p, s, target, sigma=0.02)
    grads = torch.autograd.grad(loss, [p[k] for k in SOFT_KEYS])
    seconds = time.time() - t0
    return (float(loss.detach()), img,
            [g.detach().cpu().double() for g in grads], seconds)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", nargs="+", default=["cpu"])
    args = ap.parse_args(argv)

    import torch

    from chip_smoke import SOFT_KEYS

    from chip_smoke import soft_problem

    loss64, img64, ref, _ = gradients("cpu", torch.float64)
    scene = soft_problem(torch.device("cpu"), torch.float64)[0]
    v = scene.geometry.vertices[:scene.geometry.num_triangles]
    n = torch.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], dim=-1)
    view = v.mean(dim=1) - scene.camera.center
    cos = ((n * view).sum(-1) / (n.norm(dim=-1) * view.norm(dim=-1))).abs()
    for device in args.device:
        loss32, img32, got, seconds = gradients(device, None)
        # 4 ulp of float32 at the float64 value, or 1e-5
        tol = torch.clamp(4 * 2.0 ** (torch.floor(torch.log2(
            img64.abs().clamp_min(1e-30))) - 23), min=1e-5)
        diff = (img32 - img64).abs()
        tri_diff = (got[0] - ref[0]).abs().amax(dim=(1, 2))[:v.shape[0]]
        worst = torch.argsort(tri_diff, descending=True)[:10]
        name = (torch.cuda.get_device_name(0) if device.startswith("cuda")
                else "cpu")
        print(json.dumps({
            "device": name, "loss_float32": loss32, "loss_float64": loss64,
            "seconds_float32": round(seconds, 3),
            "image_max_abs_diff": float(diff.max()),
            "image_channels_beyond_4ulp_or_1e-5": int((diff > tol).sum()),
            "image_channels": diff.numel(),
            "max_diff_over_max": {
                k: float((g - r).abs().max() / r.abs().max())
                for k, g, r in zip(SOFT_KEYS, got, ref)},
            "worst_triangles_abs_cos": [round(float(c), 4)
                                        for c in cos[worst]],
            "median_abs_cos": float(cos.median())}))


if __name__ == "__main__":
    main()
