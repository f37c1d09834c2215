"""Differentiable rendering: parameter plumbing, inverse optimisation,
checkpointing (``diff.checkpoint``) and the edge-aware soft renderer
(PyTorch port of ``raytracinginonesemester_tpu.diff``)."""

from .inverse import (
    apply_params,
    camera_candidate_context,
    extract_params,
    make_train_step,
    optimize,
    params_from_numpy,
    render_loss,
)
from .soft import render_soft, soft_render_loss

__all__ = [
    "apply_params",
    "camera_candidate_context",
    "extract_params",
    "make_train_step",
    "optimize",
    "params_from_numpy",
    "render_loss",
    "render_soft",
    "soft_render_loss",
]
