"""The three TPU probes of ``scripts/`` on the card: each Pallas kernel of
``probe_toy_mask.py`` (P1), ``probe_mm_select.py`` (P2) and
``probe_dyn_reads.py`` (P3) as a CUDA kernel (``csrc/probes.cu``) beside
its plain PyTorch version.

None lies on a render or training path.  Each probe asked the TPU a
question of layout (what blows scoped VMEM, MXU one-hot selection
against lane reductions, plane-major against block-major reads); its
port's time on the card answers the same question for Hopper.

- ``toy_mask``  — P1: ``toy_mask(mode, rays, aabb)``, modes grid, scalar
  and both
- ``mm_select`` — P2: ``sel7`` (7 lane reductions a visit) and ``mm22``
  (the one-hot product on the tensor cores), ``split3``, ``make_qsel``
- ``dyn_reads`` — P3: ``dyn12`` (plane-major) and ``blk1`` (block-major)

Each module's wrappers launch their kernel on CUDA tensors (a build or
launch failure raises) and run the plain version on CPU tensors, and
each has a ``main()`` that prints what its script prints, timed on the
card: ``python -m raytracinginonesemester_tpu_torch.probes.<name>``.
"""

from __future__ import annotations

__all__ = ["launch_counts", "reset_launch_counts"]


def launch_counts() -> dict:
    """Kernel launches per probe wrapper since the last reset."""
    from . import dyn_reads, mm_select, toy_mask

    return {fn.__name__: fn.launches for fn in (
        toy_mask.toy_mask, mm_select.sel7, mm_select.mm22, dyn_reads.dyn12,
        dyn_reads.blk1)}


def reset_launch_counts() -> None:
    from . import dyn_reads, mm_select, toy_mask

    for fn in (toy_mask.toy_mask, mm_select.sel7, mm_select.mm22,
               dyn_reads.dyn12, dyn_reads.blk1):
        fn.launches = 0
