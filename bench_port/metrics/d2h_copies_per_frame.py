"""``d2h_copies_per_frame``: device-to-host copies in the device trace (the
host's waits on the card) over the frames of the traced window."""

from ._common import per_unit


def read(record: dict, name: str):
    return per_unit(record, "d2h_copies")
