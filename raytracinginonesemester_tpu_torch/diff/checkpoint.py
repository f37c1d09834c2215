"""Checkpoint and resume for inverse-rendering optimisation.

Port of ``raytracinginonesemester_tpu.diff.checkpoint`` in the layout of
its pickle fallback: ``ckpt_{step:08d}.pkl`` holding ``step``,
``params``, ``opt_state`` and ``losses``, with numpy arrays in place of
tensors (``opt_state``: a ``torch.optim`` optimizer's ``state_dict()``).
``to_tensors`` turns a loaded nest back into tensors on a device, for
``torch.optim.Optimizer.load_state_dict`` and new parameter leaves.
Checkpoints are pickles: load only files this program wrote.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "to_tensors"]


def _to_host(tree):
    """Tensors in a nest of dicts, lists and tuples -> numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def to_tensors(tree, device="cpu"):
    """numpy arrays in a nest of dicts, lists and tuples -> tensors on
    ``device`` (an optimizer state's ``step`` counters stay on the CPU, as
    ``torch.optim`` keeps them)."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy()).to(device)
    if isinstance(tree, dict):
        return {k: (torch.from_numpy(np.array(v)) if k == "step"
                    and isinstance(v, np.ndarray) else to_tensors(v, device))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_tensors(v, device) for v in tree)
    return tree


def save_checkpoint(directory: str, step: int, params, opt_state=None,
                    losses=None) -> str:
    """Write ``ckpt_{step:08d}.pkl`` into ``directory``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "step": int(step),
        "params": _to_host(params),
        "opt_state": _to_host(opt_state),
        "losses": list(losses) if losses is not None else None,
    }
    path = os.path.join(directory, f"ckpt_{step:08d}.pkl")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # write, then rename into place
        pickle.dump(payload, f)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The newest step saved in ``directory`` (the JAX package's file
    prefixes ``ckpt_``, ``ocp_`` and ``meta_``), or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        for prefix in ("ckpt_", "ocp_", "meta_"):
            if name.startswith(prefix):
                digits = name[len(prefix):].split(".")[0]
                if digits.isdigit():
                    steps.append(int(digits))
    return max(steps) if steps else None


def load_checkpoint(directory: str,
                    step: Optional[int] = None) -> Tuple[int, Any, Any, Any]:
    """Load (step, params, opt_state, losses), numpy arrays in place of
    tensors; the newest checkpoint if ``step`` is None."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.pkl")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return (payload["step"], payload["params"], payload["opt_state"],
            payload["losses"])
