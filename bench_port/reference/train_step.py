"""Reference of the training cell: the first Adam steps of the
inverse-rendering job, followed from the same start parameters, one step
from the state that the program saved before its window's last step, and
the comparison that decides ``correct``.  That step is followed from the
program's state because the reference cannot follow the program's
hundreds of steps before it; the start and the first steps are checked
by themselves.

The job: render the scene at its pixel centres, take the mean squared
difference to a target (the same scene rendered with its own
parameters), and step Adam on the albedo table, the light intensity and
the vertices.  The reference renders its own target, differentiates its
own brute-force renders (``tracer.py``: the winners and the shadow tests
carry no gradient, as in the detached estimator of the course's
differentiable path) and runs Adam written out, with ``torch.optim.Adam``'s
defaults (betas 0.9 and 0.999, eps 1e-8, bias-corrected).
"""

from __future__ import annotations

import math

import torch

from . import tracer

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def render(arrays, device, dtype, params=None) -> torch.Tensor:
    """(H, W, 3) image at the pixel centres, in ``dtype``."""
    sc = tracer.scene_tensors(arrays, device, dtype, params)
    w, h = arrays.camera["width"], arrays.camera["height"]
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    x, y = xs.reshape(-1), ys.reshape(-1)
    o, d, seeds = tracer.pixel_rays(sc, x, y, torch.zeros_like(x), "center")
    return tracer.trace(sc, o, d, seeds).reshape(h, w, 3)


def _adam_step(arrays, params: dict, target, m: dict, v2: dict, t: int,
               lr: float, device, dtype):
    """One step of the job on ``params`` (leaves that require their
    gradient), Adam written out at step ``t`` on the moments ``m`` and
    ``v2``, all in place -> (loss, gradient)."""
    for p in params.values():
        p.grad = None
    loss = torch.mean((render(arrays, device, dtype, params) - target) ** 2)
    loss.backward()
    with torch.no_grad():
        grad = {k: p.grad.clone() for k, p in params.items()}
        for k, p in params.items():
            g = p.grad
            m[k].lerp_(g, 1 - BETAS[0])
            v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
            denom = (v2[k].sqrt() / math.sqrt(1 - BETAS[1] ** t)).add_(ADAM_EPS)
            p.addcdiv_(m[k], denom, value=-lr / (1 - BETAS[0] ** t))
    return float(loss.detach()), grad


def _leaves(tensors: dict, device) -> dict:
    return {k: v.detach().to(device).float().clone().requires_grad_(True)
            for k, v in tensors.items()}


def follow(arrays, start: dict, steps: int, lr: float, device,
           dtype=torch.float32) -> dict:
    """``steps`` Adam steps from ``start`` (name -> float32 tensor) ->
    the losses, the first gradient as Adam's first moment holds it after
    one step, and the parameters after the last step (float32, host)."""
    with torch.no_grad():
        target = render(arrays, device, dtype)
    params = _leaves(start, device)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        losses.append(_adam_step(arrays, params, target, m, v2, t, lr,
                                 device, dtype)[0])
        if t == 1:
            grad1 = {k: (m[k] / (1 - BETAS[0])).cpu() for k in m}
    return {"losses": losses, "grad1": grad1,
            "params": {k: p.detach().cpu().clone() for k, p in params.items()}}


def follow_from(arrays, before: dict, lr: float, device,
                dtype=torch.float32) -> dict:
    """One Adam step from a saved state (name -> {"params", "exp_avg",
    "exp_avg_sq", "step"}, the step count before it) -> its loss, its
    gradient and the parameters after it (float32, host)."""
    with torch.no_grad():
        target = render(arrays, device, dtype)
    params = _leaves({k: b["params"] for k, b in before.items()}, device)
    m = {k: b["exp_avg"].to(device).float().clone() for k, b in before.items()}
    v2 = {k: b["exp_avg_sq"].to(device).float().clone()
          for k, b in before.items()}
    t = int(round(next(iter(before.values()))["step"])) + 1
    loss, grad = _adam_step(arrays, params, target, m, v2, t, lr, device, dtype)
    return {"loss": loss, "grad": {k: g.cpu() for k, g in grad.items()},
            "params": {k: p.detach().cpu().clone() for k, p in params.items()}}


def _worst_leaf(got: dict, want: dict, keep) -> float:
    """The largest gap between the two sides' norms of a leaf, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger, over the leaves in ``keep``."""
    norms = {k: float(want[k].double().norm()) for k in keep}
    med = sorted(norms.values())[len(norms) // 2]
    gaps = [abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], med)
            for k in keep]
    return max(float("inf") if g != g else g for g in gaps)


def _moved(grad: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: Adam moves the others by round-off alone."""
    norm = {k: float(v.double().norm()) for k, v in grad.items()}
    med = sorted(norm.values())[len(norm) // 2]
    return [k for k in norm if norm[k] >= 1e-3 * med]


def _rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if got == got else float("inf")


def compare(prog: dict, ref: dict, start: dict) -> dict:
    """The numbers compared.  ``prog``: ``losses``, ``grad1`` and
    ``params`` of the first steps, ``start``, ``drift`` and ``last``
    (the window's last step: ``loss``, ``grad``, ``params`` after it,
    ``before`` it); ``ref``: the reference's, from ``start``, its own
    (``follow``) and from the same saved state (``last``, ``follow_from``).

    ``start_gap``: the largest gap between the two sides' start (exact);
    ``loss_gap``, the relative gap of the first step's loss; ``grad_gap``,
    the worst leaf's gap of the first gradient's norm; ``update_gap``, the
    same of the parameters' change over the first steps; ``last_*``, the
    same three of the window's last step; ``drift``, the furthest a
    vertex moved from the start in the window.  The later first steps'
    losses are not compared: Adam's first step moves every coordinate by
    about the learning rate whatever its gradient's size, so the sign of
    a gradient that is nought to rounding sends the two sides' vertices
    1e-3 apart, and the losses of steps 2 and 3 part by up to 0.4% on
    sound runs (PERF.md)."""
    start_gap = max(float((prog["start"][k] - start[k]).abs().max())
                    for k in start)
    keep = _moved(ref["grad1"])
    delta_p = {k: prog["params"][k] - start[k] for k in keep}
    delta_r = {k: ref["params"][k] - start[k] for k in keep}
    pl, rl = prog["last"], ref["last"]
    before = pl["before"]
    keep_last = _moved(rl["grad"])
    step_p = {k: pl["params"][k] - before[k] for k in keep_last}
    step_r = {k: rl["params"][k] - before[k] for k in keep_last}
    return {"start_gap": start_gap,
            "loss_gap": _rel(prog["losses"][0], ref["losses"][0]),
            "grad_gap": _worst_leaf(prog["grad1"], ref["grad1"], keep),
            "update_gap": _worst_leaf(delta_p, delta_r, keep),
            "last_loss_gap": _rel(pl["loss"], rl["loss"]),
            "last_grad_gap": _worst_leaf(pl["grad"], rl["grad"], keep_last),
            "last_update_gap": _worst_leaf(step_p, step_r, keep_last),
            "drift": prog["drift"]}
