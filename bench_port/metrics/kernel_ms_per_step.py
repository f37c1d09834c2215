"""``kernel_ms_per_step``: the program's own kernels' device time over
the steps of the traced window; ``kernel_ms_per_frame``'s reader, which
divides by the window's units of work, frames or steps."""

from .kernel_ms_per_frame import read  # noqa: F401
