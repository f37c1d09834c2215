"""``kernel_ms_per_frame``: device time of the program's own kernels (the
``__global__`` functions of its ``csrc/``, any Triton kernel it defines)
over the frames of the traced window."""

from ._common import per_unit


def read(record: dict, name: str):
    return per_unit(record, "kernel_s", 1e3) or None
