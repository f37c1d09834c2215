"""``glue_ms_per_step``: the glue's device time over the steps of the
traced window; ``glue_ms_per_frame``'s reader, which divides by the
window's units of work, frames or steps."""

from .glue_ms_per_frame import read  # noqa: F401
