"""``glue_ms_per_frame``: device time of every other kernel, copy and memset
(the torch glue between the program's kernels, autograd, the optimizer)
over the frames of the traced window."""

from ._common import per_unit


def read(record: dict, name: str):
    return per_unit(record, "glue_s", 1e3)
