"""Training window: one Adam step a call of ``diff/inverse.py``'s
``make_train_step``, inside the binned depth-0 context built for the start
parameters.  The context's candidates hold while every vertex stays
within its slack of the start, so the window runs episodes of
``restart_every`` steps (at most slack / lr): after each, the parameters
go back to the start and Adam's state to nought, as a fresh run of the
job would begin.

Set-up builds the step with its parameters and optimizer state, renders
the target from the scene's own parameters, starts from those parameters
perturbed by 5% from the seed (on the card, one draw a leaf), and drives
the window's own call through the first three steps; the same objects
then go into the window.  What the check compares: those three steps'
losses, the first gradient as Adam's state holds it after one step, the
parameters after the third; and the window's last step, from the state
saved before it (its loss, its gradient as Adam's state holds it, the
parameters after it); and how far a vertex moved from the start.
"""

from __future__ import annotations

import time

import torch

from .. import program
from ..reference import scene as ref_scene
from ..reference import train_step as reference

KEYS = ("albedo", "light_intensity", "vertices")
CHECKED_STEPS = 3


def start_params(base: dict, traffic: dict, seed: int, device) -> dict:
    """The start: each leaf of ``base`` times 1 + perturbation x a normal
    draw from the seed, on the card, one draw a leaf in ``KEYS`` order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {k: base[k].detach() * (1.0 + float(traffic["perturbation"])
                                   * torch.randn(base[k].shape, generator=gen,
                                                 device=device)) for k in KEYS}


def base_params(arrays, device) -> dict:
    """The scene's own parameters, from the benchmark's loader."""
    return {"albedo": torch.as_tensor(arrays.materials["albedo"], device=device),
            "light_intensity": torch.as_tensor(arrays.lights["intensity"],
                                               device=device),
            "vertices": torch.as_tensor(arrays.vertices, device=device)}


class Entry:
    unit = "step"

    def __init__(self, run):
        from raytracinginonesemester_tpu_torch.diff import inverse

        self.run = run
        t = run.traffic
        self.lr = float(t["lr"])
        self.restart_every = int(t["restart_every"])
        if self.restart_every < CHECKED_STEPS:
            raise ValueError(f"restart_every under the {CHECKED_STEPS} "
                             "checked steps")
        self.scene = program.build_scene(run.cfg, t, run.root, run.device,
                                         differentiable=True)
        self.start = start_params(inverse.extract_params(self.scene, KEYS), t,
                                  run.seed, run.device)
        with torch.no_grad():
            self.target = inverse.render_scene(self.scene, t["jitter"],
                                               spp_override=1)
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in self.start.items()}
        self.opt = torch.optim.Adam(list(self.params.values()), lr=self.lr)
        self.step = inverse.make_train_step(self.opt, t["jitter"],
                                            spp_override=1)
        self.ctx = inverse.camera_candidate_context(
            inverse.apply_params(self.scene, self.params),
            slack=float(t["plan_slack"]))
        self.done = 0  # steps of the running episode
        self.before = None  # the state the last step started from
        self.drift = torch.zeros((), device=run.device)
        self.harness_s = 0.0
        losses = []
        for i in range(CHECKED_STEPS):
            self.call()
            losses.append(self.loss)
            if i == 0:
                beta1 = self.opt.param_groups[0]["betas"][0]
                # a step that kept no state passed on no gradient
                grad1 = {k: (self._adam(p)[0] / (1 - beta1)).cpu()
                         for k, p in self.params.items()}
        self.outputs = {"losses": [float(x) for x in losses], "grad1": grad1,
                        "params": {k: p.detach().cpu().clone()
                                   for k, p in self.params.items()}}
        self.harness_s = 0.0

    def _adam(self, p):
        """Adam's (first moment, second moment, step) of ``p``; nought
        where it keeps no state."""
        st = self.opt.state.get(p)
        if not st:
            z = torch.zeros_like(p)
            return z, z, 0.0
        return st["exp_avg"], st["exp_avg_sq"], float(st["step"])

    def _restart(self) -> None:
        """Back to the start: the parameters, Adam's moments and steps."""
        with torch.no_grad():
            vert = self.params["vertices"]
            self.drift = torch.maximum(self.drift, (
                vert - self.start["vertices"]).abs().amax())
            torch._foreach_copy_(list(self.params.values()),
                                 [self.start[k] for k in KEYS])
        for st in self.opt.state.values():
            for v in st.values():
                v.zero_()
        self.done = 0

    def _save(self) -> None:
        """The state the next step starts from: parameters, Adam's moments
        and steps, copied on the card without a wait."""
        src, steps = [], {}
        for k, p in self.params.items():
            m, v, n = self._adam(p)
            src += [p, m, v]
            steps[k] = n
        with torch.no_grad():
            if self.before is None:
                self.before = {"tensors": [torch.empty_like(x) for x in src]}
            torch._foreach_copy_(self.before["tensors"], src)
        self.before["steps"] = steps

    def call(self) -> int:
        h0 = time.perf_counter()
        if self.done >= self.restart_every:
            self._restart()
        self._save()
        h1 = time.perf_counter()
        with self.ctx:
            self.loss = self.step(self.params, self.scene, self.target)
        self.done += 1
        self.harness_s += h1 - h0
        return 1

    def keep(self, i: int) -> None:
        pass

    def release(self) -> None:
        """Keep the window's last step on the host, free the rest."""
        with torch.no_grad():
            self.drift = torch.maximum(self.drift, (
                self.params["vertices"] - self.start["vertices"]).abs().amax())
        b = iter(x.cpu() for x in self.before["tensors"])
        before = {k: {"params": next(b), "exp_avg": next(b),
                      "exp_avg_sq": next(b), "step": self.before["steps"][k]}
                  for k in KEYS}
        moment = {k: self._adam(p)[0].cpu() for k, p in self.params.items()}
        self.last = {"before": before, "loss": float(self.loss),
                     "exp_avg": moment,
                     "params": {k: p.detach().cpu().clone()
                                for k, p in self.params.items()}}
        self.outputs["drift"] = float(self.drift)
        self.start = {k: v.cpu() for k, v in self.start.items()}
        self.scene = self.params = self.opt = self.step = None
        self.ctx = self.target = self.before = self.loss = None

    def _inputs(self):
        """The benchmark's own scene and start, from the files and the
        seed: nothing of the program's."""
        arrays = ref_scene.build(self.run.cfg, self.run.traffic, self.run.root)
        start = start_params(base_params(arrays, self.run.device),
                             self.run.traffic, self.run.seed, self.run.device)
        return arrays, {k: v.cpu() for k, v in start.items()}

    def _reference(self, dtype, arrays, start):
        first = reference.follow(arrays, start, CHECKED_STEPS, self.lr,
                                 self.run.device, dtype)
        first["last"] = reference.follow_from(arrays, self.last["before"],
                                              self.lr, self.run.device, dtype)
        return first

    def _program(self) -> dict:
        """The program's outputs, the window's last step's gradient worked
        out from Adam's first moment before and after it."""
        beta1 = reference.BETAS[0]
        b = self.last["before"]
        grad = {k: (m - beta1 * b[k]["exp_avg"]) / (1 - beta1)
                for k, m in self.last["exp_avg"].items()}
        last = {"loss": self.last["loss"], "grad": grad,
                "params": self.last["params"],
                "before": {k: v["params"] for k, v in b.items()}}
        return dict(self.outputs, start=self.start, last=last)

    def check(self, dtype=torch.float32) -> dict:
        arrays, start = self._inputs()
        ref = self._reference(dtype, arrays, start)
        self.reference_losses = ref["losses"]
        return reference.compare(self._program(), ref, start)

    def control(self, dtype=torch.bfloat16) -> dict:
        arrays, start = self._inputs()
        low = self._reference(dtype, arrays, start)
        before = {k: v["params"] for k, v in self.last["before"].items()}
        low = dict(low, start=start, drift=self.outputs["drift"],
                   last=dict(low["last"], before=before))
        return reference.compare(low, self._reference(torch.float32, arrays,
                                                      start), start)
