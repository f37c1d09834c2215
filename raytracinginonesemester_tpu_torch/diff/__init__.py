"""Differentiable rendering: parameter plumbing and inverse optimisation
(PyTorch port of ``raytracinginonesemester_tpu.diff``; the soft renderer
and checkpointing are not ported yet)."""

from .inverse import (
    apply_params,
    camera_candidate_context,
    extract_params,
    make_train_step,
    optimize,
    params_from_numpy,
    render_loss,
)

__all__ = [
    "apply_params",
    "camera_candidate_context",
    "extract_params",
    "make_train_step",
    "optimize",
    "params_from_numpy",
    "render_loss",
]
