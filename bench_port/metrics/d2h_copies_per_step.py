"""``d2h_copies_per_step``: the device-to-host copies over the steps of
the traced window; ``d2h_copies_per_frame``'s reader, which divides by
the window's units of work, frames or steps."""

from .d2h_copies_per_frame import read  # noqa: F401
